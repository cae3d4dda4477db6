"""The port's tensor- and sequence-parallel decode steps at Llama-2-7B
geometry: their agreement with the whole-stack step (kernel 7), their wall
time and where their device time goes.

    python3 scripts/profile_torch_parallel.py                  # one card
    torchrun --nproc_per_node N scripts/profile_torch_parallel.py [--sp S]
    torchrun --nproc_per_node N scripts/profile_torch_parallel.py \
        --fused_collectives

With no launcher it starts a one-process NCCL group on a free local port;
under ``torchrun`` it joins the launcher's group and lays the N ranks out
as tp = N / S, sp = S (S = 1 by default).  Every rank makes the same
random weights (seed 0; head group 1 when tp > 1, so that the head groups
divide over tp) and keeps them whole beside its shard.  Printed from
rank 0:

1. agreement: a 600-token prefill (kernel 4: at sp 2 or 4 the rows then
   fill the first shards and reach into the next), then 16 greedy tokens
   through the tp step and through the sp step, each against kernel 7's
   step on the whole weights (teacher-forced on the same tokens): the
   largest logit difference over the largest logit, and the steps whose
   tokens differ where kernel 7's top-2 gap exceeds 0.1 (none allowed);
2. wall ms per step of the tp step, the sp step and kernel 7's step at
   pos 600 of a 1024-row cache (host clock, 20 steps each, before any
   profiler runs in the process);
3. the tp step's host time by function over 20 steps (``cProfile``, own
   time; a ctypes call's C time counts in its caller);
4. each step's device time by kernel name over 5 steps (``torch.profiler``)
   and its device busy share.

``--fused_collectives`` (tp only, S = 1) adds the tp step built with
``make_sharded_decode_step(fused_collectives=True)`` (kernel 7 per rank
with kernel 13 inside it, kernel 14 for the logits) to parts 1, 2 and 4,
and times kernel 13 beside ``dist.all_reduce`` on the same bytes (the tp
step's [1, 4096] float32), and kernel 14 beside ``all_gather_into_tensor``
on the logits' shards, as mean ms per call between CUDA events over 200
calls.  Kernels 13 and 14 need peer access between the cards.

Exits non-zero if a check fails.  Needs a CUDA card per rank.
"""

from __future__ import annotations

import argparse
import cProfile
import functools
import os
import pstats
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import profiling  # noqa: E402

from clusterfusion_tpu_torch import parallel as par  # noqa: E402
from clusterfusion_tpu_torch.config import LlamaConfig, MeshConfig  # noqa: E402
from clusterfusion_tpu_torch.models import llama as model  # noqa: E402

POS = 600
N_CHECK = 16


def init_group() -> None:
    if "RANK" in os.environ:                 # torchrun
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl")
        return
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sp", type=int, default=1,
                    help="ranks on the sequence axis (the rest on tp)")
    ap.add_argument("--fused_collectives", action="store_true",
                    help="also the tp step with the reduces inside kernel 7 "
                         "(kernels 13 and 14), and those kernels beside NCCL")
    args = ap.parse_args()
    if args.fused_collectives and args.sp != 1:
        ap.error("--fused_collectives runs the tp step: --sp must be 1")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    init_group()
    try:
        return run(args.sp, args.fused_collectives)
    finally:
        par.collective.release_communicators()
        dist.destroy_process_group()


def steps_to_run(fused: bool):
    """(name, step maker, cache spec) of each sharded step."""
    out = [("tp", par.make_sharded_decode_step, par.cache_pspec()),
           ("sp", par.make_sp_sharded_decode_step, par.cache_pspec_2d())]
    if fused:
        out.insert(1, ("tp fused", functools.partial(
            par.make_sharded_decode_step, fused_collectives=True),
            par.cache_pspec()))
    return out


def collectives_beside_nccl(mesh, dev, say) -> None:
    """Kernels 13 and 14 beside NCCL on the tp step's bytes."""
    col = par.collective
    group, tp = mesh.groups["tp"], mesh.shape["tp"]
    comm = col.communicator(mesh, "tp")
    x = torch.randn((1, 4096), device=dev)
    y = torch.zeros((1, 4096), device=dev)
    shard = torch.randn(32000 // tp, device=dev)
    buf = torch.empty(32000 // tp * tp, device=dev)

    def timed(fn, reps=200):
        for _ in range(5):
            fn()
        dist.barrier()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    for what, mine, nccl in (
            ("all-reduce [1, 4096] f32", lambda: comm.all_reduce(x),
             lambda: dist.all_reduce(y, group=group)),
            (f"all-gather [{32000 // tp}] f32 -> [32000]",
             lambda: comm.all_gather(shard),
             lambda: dist.all_gather_into_tensor(buf, shard, group=group))):
        t_mine, t_nccl = timed(mine), timed(nccl)
        say(f"{what} at tp {tp}: kernel {13 if 'reduce' in what else 14} "
            f"{t_mine * 1e3:.2f} us, NCCL {t_nccl * 1e3:.2f} us per call "
            "(CUDA events, 200 calls)")
    comm.check()


def check(cfg, mesh, full, params, dev, say, fused: bool) -> bool:
    """Part 1: the sharded steps' greedy streams against kernel 7's."""
    prompt = [(i * 37 + 11) % cfg.vocab_size for i in range(600)]
    k0, v0 = model.init_cache(cfg, max_seq=1024, device=dev)
    lg, k0, v0 = model.prefill(full, k0, v0, prompt, cfg)
    first = int(torch.argmax(lg[-1]))
    ok = True
    for name, make, spec in steps_to_run(fused):
        step = make(cfg, mesh)
        kc = par.shard_cache(k0.clone(), mesh, spec)
        vc = par.shard_cache(v0.clone(), mesh, spec)
        kr, vr = k0.clone(), v0.clone()
        tok, toks, bad, rel = first, [], [], 0.0
        for i in range(N_CHECK):
            lg, kc, vc = step(params, kc, vc, tok, len(prompt) + i)
            ref, kr, vr = model.decode_step(full, kr, vr, tok,
                                            len(prompt) + i, cfg)
            top = torch.topk(ref, 2).values
            gap = (top[0] - top[1]).item()
            tok = int(torch.argmax(lg))
            if gap > 0.1 and tok != int(torch.argmax(ref)):
                bad.append(i)
            rel = max(rel, (lg - ref).abs().max().item()
                      / ref.abs().max().item())
            toks.append(tok)
        say(f"{name} step vs kernel 7: {N_CHECK} tokens {toks[:8]}..., "
            f"logits max diff / max logit {rel:.4g} (limit 0.05), "
            f"disagree where gap > 0.1: {bad}")
        ok = ok and not bad and rel < 0.05
    return ok


def run(sp: int, fused: bool) -> int:
    rank, world = dist.get_rank(), dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = LlamaConfig.llama2_7b()
    if world % sp:
        raise ValueError(f"--sp {sp} does not divide the {world} ranks")
    mcfg = MeshConfig(tp=world // sp, sp=sp)
    mesh = par.build_mesh(mcfg)
    say(f"mesh tp={mcfg.tp} sp={mcfg.sp} over {world} process(es)")
    full = model.init_params(cfg, seed=0,
                             head_group=1 if mcfg.tp > 1 else None,
                             device=dev)
    params = par.shard_params(full, cfg, mesh)
    ok = check(cfg, mesh, full, params, dev, say, fused)
    if fused and mcfg.tp > 1:
        collectives_beside_nccl(mesh, dev, say)

    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :POS].normal_()
    vc[:, :, :POS].normal_()
    steps = {name: (make(cfg, mesh), params, par.shard_cache(kc, mesh, spec),
                    par.shard_cache(vc, mesh, spec))
             for name, make, spec in steps_to_run(fused)}
    steps["stack (kernel 7, whole weights)"] = (
        lambda p, k, v, t, pos: model.decode_step(p, k, v, t, pos, cfg),
        full, kc.clone(), vc.clone())
    walls = {}
    for name, (fn, p, k, v) in steps.items():
        for _ in range(3):
            fn(p, k, v, 7, POS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn(p, k, v, 7, POS)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3 / 20
        say(f"{name} step (pos {POS}): {walls[name]:.3f} ms wall per step, "
            "no profiler yet")
    fn, p, k, v = steps["tp"]
    host = cProfile.Profile()
    host.enable()
    for _ in range(20):
        fn(p, k, v, 7, POS)
    torch.cuda.synchronize()
    host.disable()
    stats = sorted(pstats.Stats(host).stats.items(),
                   key=lambda kv: -kv[1][2])[:12]
    say("tp step, host time by function over 20 steps (cProfile, own "
        "time):")
    for (fname, line, func), (_, ncalls, tottime, _, _) in stats:
        say(f"  {tottime * 1e6 / 20:9.1f} us/step {ncalls / 20:7.1f}x  "
            f"{Path(fname).name}:{line}({func})")
    for name, (fn, p, k, v) in steps.items():
        # one attempt: a retry on one rank alone would leave the others'
        # collectives waiting
        ev, wall = profiling.profile_calls(
            functools.partial(fn, p, k, v, 7, POS), 5, attempts=1)
        total = sum(b - a for a, b, _ in ev) / 1e3 / 5
        say(f"{name} step: device {total:.4f} ms per step over "
            f"{wall:.3f} ms profiled wall (busy {100 * total / wall:.1f} "
            f"%; {100 * total / walls[name]:.1f} % of the unprofiled "
            f"wall); {len(ev) / 5:g} kernels per step")
        for kname, ms, n in profiling.by_kernel(ev, 5):
            say(f"  {ms:9.4f} ms {n:6g}x  {kname[:90]}")
    say("OK" if ok else "FAILED: a step disagrees with kernel 7")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
