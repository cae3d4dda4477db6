"""Variants of the ring GEMV (kernels 7, 3 and 8) and kernel 7's launch chain,
timed on one card.

    python3 scripts/tune_torch_gemv.py [--variants 4x32c1,6x32c1,3x32c1,4x64c1]
                                       [--threads 256,128,512] [--fused_step]
                                       [--verify] [--int8]

A variant ``SxRcP[rT]`` rebuilds the port's kernels with ``G1_STAGES = S``
and ``G1_ROWS = R`` in ``csrc/common.cuh`` (ring stages and weight rows per
stage of the one-row GEMV; a stage holds R x 512 bytes), optionally
``RG_STAGES = T`` (the rows GEMV's ring stages, 17 KB each), ``+NAME=VALUE``
suffixes set any other ``constexpr int`` of ``csrc/``, and ``PDL_CHAIN`` =
P in ``csrc/stack_kernel.cu`` (1: kernel 7's
norms, split and merge are launched with programmatic dependent launch
like its GEMVs; 0: plainly) into ``build/gemv_variants/``.  Variants run in the order given (repeat one to
see the drift: A,B,B,A).  For each variant and each ``gemv_threads``
(consumer threads per block) it prints, on random Llama-2-7B weights
(seed 0):

- kernel 7's step at pos 600 (CUDA events, median of 20 steps);
- kernel 3 at the step's five GEMV shapes (QKV, O, gate/up as one
  [4096, 22528] matrix, down, LM head): ms per call from CUDA events over
  20 back-to-back calls, each reading its own of four weight copies (L2
  cold), and the rate in TB/s; ``torch.mm`` the same way, once;
- with ``--verify``, the rows GEMV (kernels 8 and 9's products) at the
  five shapes at M 4 and 5 (gate/up as the SwiGLU pair, bf16 act out), L2
  cold as above, and kernel 8 at pos 600, n 5 and 9 (CUDA events, median
  of 20 calls);
- with ``--int8``, the rows GEMV's int8 instance (kernels 8 and 9's int8
  modes) at the same five shapes, M 4 and 5, on int8 codes with float32
  scales (L2 cold as above; the rate counts the codes), and kernel 8's
  int8 mode at pos 600, n 5 and 9, on the 7B weights regrouped to hg 8
  and quantized as ``chip_smoke.py`` phase 17 does (median of 20 calls);
- with ``--fused_step``, ``chip_smoke.py``'s phase 15 (b and c): mode 5
  of kernel 7 and the fused-collective tp 2 step on two virtual ranks.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig  # noqa: E402
from clusterfusion_tpu_torch.models import llama as model  # noqa: E402
from clusterfusion_tpu_torch.models.generation import Llama  # noqa: E402
from clusterfusion_tpu_torch.ops import _build  # noqa: E402
from clusterfusion_tpu_torch.ops import stack_kernel as sk  # noqa: E402
from clusterfusion_tpu_torch.ops import stack_verify as sv  # noqa: E402

gv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
SHAPES = (("qkv", 4096, 12288), ("o", 4096, 4096), ("gate_up", 4096, 22528),
          ("down", 11264, 4096), ("lm_head", 4096, 32000))


def variant_lib(name: str):
    """Build (or reuse) the kernels of variant ``name`` (``SxRcP``)."""
    base, *sets = name.split("+")
    m = re.fullmatch(r"(\d+)x(\d+)c([01])(?:r(\d+))?", base)
    if m is None:
        raise ValueError(f"variant {name!r} is not SxRcP[rT]")
    stages, rows, chain = (int(g) for g in m.groups()[:3])
    rg_stages = m.group(4)
    out = ROOT / "build" / "gemv_variants" / name
    csrc = out / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(_build.CSRC, csrc)
    for fname, subs in (
            ("common.cuh", ((r"constexpr int G1_STAGES = \d+;",
                             f"constexpr int G1_STAGES = {stages};"),
                            (r"constexpr int G1_ROWS = \d+;",
                             f"constexpr int G1_ROWS = {rows};"))
             + (((r"constexpr int RG_STAGES = \d+;",
                  f"constexpr int RG_STAGES = {rg_stages};"),)
                if rg_stages else ())),
            ("stack_kernel.cu", ((r"constexpr bool PDL_CHAIN = \w+;",
                                  "constexpr bool PDL_CHAIN = "
                                  f"{'true' if chain else 'false'};"),))):
        src = (csrc / fname).read_text()
        for pat, rep in subs:
            src, n = re.subn(pat, rep, src)
            if n != 1:
                raise RuntimeError(f"{pat} not found in {fname}")
        (csrc / fname).write_text(src)
    for k, v in (a.split("=") for a in sets):    # +NAME=VALUE, in any source
        hits = 0
        for f in csrc.glob("*.cu*"):
            src, n = re.subn(rf"constexpr int {k} = \d+;",
                             f"constexpr int {k} = {v};", f.read_text())
            if n:
                f.write_text(src)
                hits += n
        if hits != 1:
            raise RuntimeError(f"{k} found {hits} times in csrc")
    return _build.load(_build.build(csrc, out))


def events_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """ms per call: CUDA events around ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def step_ms(fn, reps: int = 20) -> float:
    """Median ms of one call between CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="4x32c1,6x32c1,3x32c1,4x64c1")
    ap.add_argument("--threads", default="256,128,512")
    ap.add_argument("--fused_step", action="store_true")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--int8", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    variants = args.variants.split(",")
    threads = [int(t) for t in args.threads.split(",")]
    libs = {v: variant_lib(v) for v in dict.fromkeys(variants)}

    cfg = LlamaConfig.llama2_7b()
    eng = Llama.synthetic(cfg, seed=0, fused=True, device=dev)
    p, lw, pos = eng.params, eng.params["layers"], 600
    gen = torch.Generator(device=dev).manual_seed(2)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    x = p["embed"][torch.tensor([7], device=dev)]
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, eps=cfg.norm_eps,
              final_norm=p["final_norm"], lm_head=p["lm_head"])
    stack_args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
                  lw["wo_f"], lw["w13"], lw["w2"], kc, vc, pos)
    verify_args = {}
    for n in (5, 9):
        cos_n, sin_n = model.rope_rows(cfg, pos, n, dev)
        verify_args[n] = (p["embed"][torch.arange(n, device=dev) * 37 + 11],
                          lw["attn_norm"], lw["ffn_norm"], cos_n, sin_n,
                          lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc,
                          vc, pos)
    mats = {}
    for name, K, N in SHAPES:
        xs = torch.randn((1, K), generator=gen, device=dev).bfloat16()
        ws = [torch.randn((K, N), generator=gen, device=dev).bfloat16()
              for _ in range(4)]
        mats[name] = (xs, ws)

    def rotating(fn, ws):
        i = [0]

        def call():
            i[0] += 1
            return fn(ws[i[0] % len(ws)])
        return call

    # the rows GEMV's x per (M, shape), bf16; the gate/up product runs as
    # the SwiGLU pair (its [4096, 22528] weights read as gate and up
    # [2, 4096, 11264]) and writes bf16 act
    rows_x = {(M, name): torch.randn((M, K), generator=gen,
                                     device=dev).bfloat16()
              for M in (4, 5) for name, K, _ in SHAPES}
    rows_y = torch.empty((5, max(N for _, _, N in SHAPES)), device=dev)
    rows_act = torch.empty((5, 11264), dtype=torch.bfloat16, device=dev)

    def rows_gemv(x, w, M, K, N, pair):
        _build.check(_build.lib().cf_gemv_rows(
            x.data_ptr(), x.shape[1], int(pair), w.data_ptr(),
            rows_y.data_ptr(), rows_act.data_ptr() if pair else None, M, K,
            N // 2 if pair else N, torch.cuda.current_stream().cuda_stream),
            "cf_gemv_rows")

    int8 = {}
    if args.int8:
        import chip_smoke
        w8 = chip_smoke.quant_stack_weights(
            lw, model.default_head_group(cfg),
            model.default_head_group(cfg, "int8"))
        int8["verify"] = {
            n: (a[:5] + (w8["wqkv_f"], w8["wo_f"], w8["w13"], w8["w2"])
                + a[9:]) for n, a in verify_args.items()}
        for name, K, N in SHAPES:
            shape = (2, K, N // 2) if name == "gate_up" else (K, N)
            int8[name] = [
                (torch.randint(-127, 128, shape, generator=gen, device=dev,
                               dtype=torch.int8),
                 torch.rand(shape[:-2] + (shape[-1],), generator=gen,
                            device=dev) * 1e-2)
                for _ in range(4)]

    def rows_gemv8(x, qs, M, K, N, pair):
        q, sc = qs
        _build.check(_build.lib().cf_gemv_rows8(
            x.data_ptr(), x.shape[1], int(pair), q.data_ptr(), sc.data_ptr(),
            0, None if pair else rows_y.data_ptr(),
            rows_act.data_ptr() if pair else None, M, K,
            N // 2 if pair else N, 2 if pair else 1,
            torch.cuda.current_stream().cuda_stream), "cf_gemv_rows8")

    lib_rates = {}
    for name, K, N in SHAPES:
        xs, ws = mats[name]
        ms = events_ms(rotating(
            lambda w: torch.mm(xs, w, out_dtype=torch.float32), ws))
        lib_rates[name] = ms
    print("torch.mm " + " ".join(
        f"{n}={ms:.4f}ms/{(K * N * 2) / ms / 1e9:.3f}TBps"
        for (n, K, N), ms in zip(SHAPES, lib_rates.values())), flush=True)

    for v in variants:
        _build._lib = libs[v]
        for t in threads:
            kcfg = KernelConfig(gemv_threads=t)
            ms7 = step_ms(lambda: sk.fused_decoder_stack(*stack_args,
                                                         kcfg=kcfg, **kw))
            parts = []
            for name, K, N in SHAPES:
                xs, ws = mats[name]
                ms = events_ms(rotating(lambda w: gv.gemv(xs, w, kcfg), ws))
                parts.append(f"{name}={ms:.4f}ms/"
                             f"{(K * N * 2) / ms / 1e9:.3f}TBps")
            print(f"variant={v} gemv_threads={t} "
                  f"kernel7_step_ms={ms7:.4f} " + " ".join(parts), flush=True)
        if args.verify:
            parts = []
            for M in (4, 5):
                for name, K, N in SHAPES:
                    ms = events_ms(rotating(
                        lambda w, M=M, K=K, N=N, name=name: rows_gemv(
                            rows_x[(M, name)], w, M, K, N, name == "gate_up"),
                        mats[name][1]))
                    parts.append(f"M{M}_{name}={ms:.4f}ms/"
                                 f"{(K * N * 2) / ms / 1e9:.3f}TBps")
            print(f"variant={v} rows_gemv " + " ".join(parts), flush=True)
            print(f"variant={v} " + " ".join(
                f"kernel8_n{n}_ms="
                f"{step_ms(lambda a=a: sv.fused_verify_stack(*a, **kw)):.4f}"
                for n, a in verify_args.items()), flush=True)
        if args.int8:
            parts = []
            for M in (4, 5):
                for name, K, N in SHAPES:
                    ms = events_ms(rotating(
                        lambda qs, M=M, K=K, N=N, name=name: rows_gemv8(
                            rows_x[(M, name)], qs, M, K, N, name == "gate_up"),
                        int8[name]))
                    parts.append(f"M{M}_{name}={ms:.4f}ms/"
                                 f"{K * N / ms / 1e9:.3f}TBps")
            print(f"variant={v} rows_gemv8 " + " ".join(parts), flush=True)
            print(f"variant={v} " + " ".join(
                f"kernel8_int8_n{n}_ms="
                f"{step_ms(lambda a=a: sv.fused_verify_stack(*a, **kw)):.4f}"
                for n, a in int8["verify"].items()), flush=True)
        if args.fused_step:
            import chip_smoke
            print(f"variant={v} phase 15:", flush=True)
            shards = chip_smoke.phase_mode5(eng, dev)
            chip_smoke.phase_fused_step(eng, dev, shards)
            del shards
    return 0


if __name__ == "__main__":
    sys.exit(main())
