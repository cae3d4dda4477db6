"""Kernels 6 (``_fused_decoder_layer``) and 5 (``fused_ffn``) alone at the
cells of ``chip_smoke.py`` phases 13 and 10, on one card.

    python3 scripts/profile_torch_layer_halves.py [--tree DIR] [--reps N]

Kernel 6: one Llama-2-7B layer (hidden 4096, 32 kv heads of 128, head
group 4) with random weights, full mode with the append at pos 600 of a
4096-row cache (kv_split 64).  Kernel 5: DeepSeek-V2-Lite's dense FFN,
hidden 2048 x f_pad 11264.  For each: the device time per call
(``torch.profiler``, the kernels' own durations summed, and their
intervals merged), the bound (the bytes read once at 3.35 TB/s), the
kernels per call and, where the tree's wrapper has them, its launch plan
(``launch_plan``: cluster size, blocks, stages, clusters the card holds)
and the time of each phase inside the launch (``phase_stamps``:
%globaltimer at the phase boundaries; the mean over blocks of each phase,
when the blocks reach the ends of streaming, of the fold and of the launch
as percentiles, the launch's span, the blocks' start skew and how far the
last block ends after the mean).

``--cold`` also times each kernel with a 128 MB read before every call,
which evicts L2 as the other layers of a decode step do (only the port's
kernels are counted).  ``--tree DIR`` imports the package from another checkout (an unpacked
``git archive`` of an older commit) to compare two versions on one card:
run A B B A in one call.  ``--set NAME=VALUE`` (repeatable) rebuilds the
tree's kernels with ``constexpr int NAME = VALUE`` in ``csrc`` (e.g.
``DL_STAGES``, ``FFN_STAGES``, ``DL_FOLD_GROUP``; ``OL_MAX_STAGES`` caps
the stages) under ``build/layer_variants/``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import profiling  # noqa: E402

HBM = 3.35e12
K6_PHASES = ("norm", "qkv", "rope", "split_kv", "merge", "oproj", "fold")
K5_PHASES = ("norm", "gate_up", "act", "down", "cluster_sum", "fold",
             "end")


def device_ms(fn, reps, evict=None):
    """(kernels' own ms summed, merged busy ms, kernels) per call of fn; with
    ``evict``, that runs before every call and its kernels are left out
    (``profiling.profile_calls``: markers, whole-count retry)."""
    ev, _ = profiling.profile_calls(
        fn, reps, before=evict, warmup=3,
        keep=None if evict is None else (lambda n: "anonymous namespace" in n))
    own = sum(b - a for a, b, _ in ev)
    return own / 1e3 / reps, profiling.busy_ms(ev) / reps, len(ev) / reps


def phases(mod, fn, rows, names):
    """Mean µs per phase over blocks and the launch's span in µs, from the
    wrapper's phase stamps (None where the wrapper has none)."""
    if not hasattr(mod, "phase_stamps"):
        return None
    st = torch.zeros((rows, 8), dtype=torch.int64, device="cuda")
    mod.phase_stamps = st
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        mod.phase_stamps = None
    s = st[st[:, 0] != 0].double()
    out = {}
    for k, name in enumerate(names):
        ok = (s[:, k + 1] != 0) & (s[:, k] != 0)
        out[name] = ((s[ok, k + 1] - s[ok, k]).mean().item() / 1e3
                     if ok.any() else float("nan"))
    t0 = s[:, 0].min()
    for k in (4, 6, 7):                 # when the blocks reach these stamps
        q = torch.quantile(s[:, k] - t0, torch.tensor(
            [0.1, 0.5, 0.9, 1.0], dtype=s.dtype, device=s.device))
        out[f"at{k}_p10/50/90/max"] = "/".join(f"{v / 1e3:.1f}"
                                             for v in q.tolist())
    out["span"] = (s[:, 7].max() - s[:, 0].min()).item() / 1e3
    out["start_skew"] = (s[:, 0].max() - s[:, 0].min()).item() / 1e3
    out["end_spread"] = (s[:, 7].max() - s[:, 7].mean()).item() / 1e3
    out["blocks"] = s.shape[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None,
                    help="import the package from this checkout")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--cold", action="store_true",
                    help="also time each kernel after a 128 MB read that "
                         "evicts L2 (as a decode step's other layers do)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="rebuild with constexpr int NAME = VALUE in csrc")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    root = Path(args.tree).resolve() if args.tree else \
        Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    dl = importlib.import_module("clusterfusion_tpu_torch.ops.decoder_layer")
    ffn = importlib.import_module("clusterfusion_tpu_torch.ops.ffn")
    sets = [a.split("=") for a in args.set]
    if sets:
        build = importlib.import_module("clusterfusion_tpu_torch.ops._build")
        out = root / "build" / "layer_variants" / "_".join(
            f"{k}{v}" for k, v in sets)
        csrc = out / "csrc"
        if csrc.exists():
            shutil.rmtree(csrc)
        shutil.copytree(build.CSRC, csrc)
        for name, val in sets:
            hits = 0
            for f in csrc.glob("*.cu*"):
                src, n = re.subn(rf"constexpr int {name} = \d+;",
                                 f"constexpr int {name} = {val};",
                                 f.read_text())
                if n:
                    f.write_text(src)
                    hits += n
            if hits != 1:
                raise RuntimeError(f"{name} found {hits} times in csrc")
        build._lib = build.load(build.build(csrc, out))
        print("variant: " + " ".join(f"{k}={v}" for k, v in sets))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"tree {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    junk = torch.ones(64 << 20, dtype=torch.float16, device=dev)
    sink = torch.empty(1, dtype=torch.float32, device=dev)

    def evict():
        sink.copy_(junk.sum(dtype=torch.float32))

    def cold(name, fn):
        if args.cold:
            own, _, n = device_ms(fn, args.reps, evict)
            print(f"{name} after a 128 MB read (L2 cold): {own:.4f} ms per "
                  f"call, {n:g} kernels per call")

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).bfloat16()

    # kernel 6: Llama-2-7B layer, pos 600 of 4096 rows
    hidden, kv, hd, hg, pos, cap = 4096, 32, 128, 4, 600, 4096
    G = kv // hg
    wqkv = rnd((G, hidden, hg * 3 * hd), hidden ** -0.5)
    wo = rnd((G, hg * hd, hidden), hd ** -0.5)
    kc, vc = rnd((1, kv, cap, hd)), rnd((1, kv, cap, hd))
    x, res = rnd((1, hidden)), rnd((1, hidden))
    norm = 1 + 0.1 * rnd((hidden,))
    ang = pos * 10000.0 ** (-torch.arange(hd // 2, device=dev) / (hd // 2))
    cos = torch.cat([ang.cos(), ang.cos()])[None]
    sin = torch.cat([ang.sin(), ang.sin()])[None]

    def k6():
        return dl._fused_decoder_layer(
            x, res, norm, cos, sin, wqkv, wo, kc, vc, pos, 0, group=1,
            head_dim=hd, rope_style="neox", fuse_residual=True, eps=1e-5,
            append_kv=True)
    nbytes6 = (wqkv.numel() + wo.numel()) * 2 + 2 * kv * pos * hd * 2
    if hasattr(dl, "launch_plan"):
        print(f"kernel 6 plan: {dl.launch_plan(hidden, kv, 1, hd)}")
    own, busy, n = device_ms(k6, args.reps)
    k6()
    print(f"kernel 6 (7B layer, pos {pos}): own {own:.4f} ms, busy "
          f"{busy:.4f} ms per call, {n:g} kernels per call "
          f"(last_call_kernels {dl.last_call_kernels}); bound "
          f"{nbytes6 / HBM * 1e3:.4f} ms; {nbytes6 / busy / 1e9:.3f} TB/s")
    cold("kernel 6", k6)
    ph = phases(dl, k6, 16 * kv, K6_PHASES)
    if ph:
        print("kernel 6 phases (us, mean over blocks): " + " ".join(
            f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in ph.items()))
    del wqkv, wo, kc, vc

    # kernel 5: DeepSeek-V2-Lite's dense FFN
    hidden, f_pad = 2048, 11264
    w13 = rnd((2, hidden, f_pad), hidden ** -0.5)
    w2 = rnd((f_pad, hidden), f_pad ** -0.5)
    nw = 1 + 0.1 * rnd((hidden,))
    x, res = rnd((1, hidden)), rnd((1, hidden))

    def k5():
        return ffn.fused_ffn(x, res, nw, w13, w2, eps=1e-6)
    nbytes5 = (w13.numel() + w2.numel()) * 2
    if hasattr(ffn, "launch_plan"):
        print(f"kernel 5 plan: {ffn.launch_plan(hidden, f_pad)}")
    own, busy, n = device_ms(k5, args.reps)
    print(f"kernel 5 ({hidden} x {f_pad}): own {own:.4f} ms, busy "
          f"{busy:.4f} ms per call, {n:g} kernels per call; bound "
          f"{nbytes5 / HBM * 1e3:.4f} ms; {nbytes5 / busy / 1e9:.3f} TB/s")
    cold("kernel 5", k5)
    ph = phases(ffn, k5, f_pad // 8 + 8, K5_PHASES)
    if ph:
        print("kernel 5 phases (us, mean over blocks): " + " ".join(
            f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in ph.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
