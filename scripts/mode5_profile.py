"""Time and profile the tp-2 mode-5 step of ``chip_smoke.py`` phase 15 on one
card, for one checkout.

    python3 scripts/mode5_profile.py [--tree DIR] [--reps 20] [--timeline N]

Runs the package of ``--tree`` (default: this checkout; an unpacked ``git
archive`` of another commit, to compare two commits on one card, in turns)
on phase 15's inputs: Llama-2-7B with random weights (seed 0), a random
cache at pos 600 (seed 2), two tp shards, one virtual rank per CUDA stream
over a loopback communicator, each rank one
``fused_decoder_stack(reduce_axis="tp")`` without the LM head.  Prints the
pair's ms per step (host clock around ``--reps`` steps of both ranks,
before any profiler), then its device time by pass (``torch.profiler`` over
8 steps; ``profiling.TP_STEP_PASSES``, each kernel charged from the end of
those before it), with each pass's µs per launch: kernel 13's launches
where the checkout has them, and the norms that wait for a reduce where it
has those.  ``--timeline N`` also prints the first N kernels of one more
profiled step: each one's stream (a virtual rank's), start, end and name.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE.parent))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--timeline", type=int, default=0, metavar="N",
                    help="also print the first N kernels of one profiled "
                         "step of both ranks: stream, start and length")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, str(HERE))
    import torch
    if not torch.cuda.is_available():
        print("mode5_profile: no CUDA device", file=sys.stderr)
        return 1
    import profiling
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import _build
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.lib()
    eng = Llama.synthetic(LlamaConfig.llama2_7b(), seed=0, fused=True,
                          device=dev)
    cfg, p, pos, tp = eng.cfg, eng.params, 600, 2
    lw = p["layers"]
    gen = torch.Generator(device=dev).manual_seed(2)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    x = p["embed"][torch.tensor([7], device=dev)]
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, eps=cfg.norm_eps)
    # every kernel of the path loaded before a virtual rank spins
    sk.fused_decoder_stack(x, lw["attn_norm"], lw["ffn_norm"], cos, sin,
                           lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"],
                           kc.clone(), vc.clone(), pos, **kw)
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards = [par.shard_params(p, cfg, m) for m in meshes]
        caches = [(par.shard_cache(kc, m), par.shard_cache(vc, m))
                  for m in meshes]
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]

        def both():
            for r in range(tp):
                streams[r].wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(streams[r]):
                    sl = shards[r]["layers"]
                    sk.fused_decoder_stack(
                        x, sl["attn_norm"], sl["ffn_norm"], cos, sin,
                        sl["wqkv_f"], sl["wo_f"], sl["w13"], sl["w2"],
                        *caches[r], pos, reduce_axis="tp", mesh=meshes[r],
                        **kw)
            for s in streams:
                torch.cuda.current_stream(dev).wait_stream(s)

        for _ in range(3):
            both()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            both()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / args.reps
        lb.check()
        reps = 8
        ev, wall = profiling.profile_calls(both, reps)
        lb.check()
        if args.timeline:
            one, _ = profiling.profile_calls(both, 1, streams=True)
            for line in profiling.timeline(one, 0, args.timeline):
                print(f"[mode5_timeline] {line}", flush=True)
            lb.check()
    finally:
        lb.close()
    rows = profiling.breakdown(ev, reps, profiling.TP_STEP_PASSES)
    print(f"[mode5_profile] tree={tree} card={torch.cuda.get_device_name(0)!r} "
          f"tp={tp} pos={pos} kernels_per_rank_step={sk.last_step_kernels} "
          f"both_ranks_ms_per_step={ms:.4f} "
          f"device_busy_ms_per_step={profiling.busy_ms(ev) / reps:.4f} "
          f"profiled_wall_ms_per_step={wall:.4f}", flush=True)
    for k, (c, own, n) in rows.items():
        if n:
            print(f"[mode5_profile] part={k} charged_ms_per_step={c:.4f} "
                  f"own_ms_per_step={own:.4f} launches_per_step={n:g} "
                  f"charged_us_per_launch={c / n * 1e3:.2f} "
                  f"own_us_per_launch={own / n * 1e3:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
