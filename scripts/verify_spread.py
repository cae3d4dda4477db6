"""Kernel 8's check of ``chip_smoke.py`` phase 9, repeated, on one card.

    python3 scripts/verify_spread.py [--reps 12] [--kv_splits 64]

Runs ``fused_verify_stack`` on phase 9's inputs (random Llama-2-7B weights,
seed 0; pos 600 of a 1024-row cache filled from seed 9, large stale rows
above pos; n 5 and 9) ``--reps`` times per kv_split against one run of its
plain twin, and prints for every call the logits' error over the largest
logit (phase 9's limit: 2e-2), layer 0's appended-row error (limit 0.05)
and the deepest-row margin, error − (0.05 + 1e-2·|row|), at its worst
layer (limit 0), and whether the call gave the first call's bits; then
per case the count of calls that failed, the call's ms (CUDA events), its
kernels per call and its device busy time by pass (``torch.profiler``,
passes named by kernel, each kernel charged from the end of those before
it; ``profiling.py``'s markers and whole-count retry).

It imports ``chip_smoke`` from the working directory, so it also runs in
an unpacked older tree: ``cd OLD && python3 NEW/scripts/verify_spread.py``.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, os.getcwd())
import chip_smoke as cs  # noqa: E402
import profiling  # noqa: E402

# kernel 8's passes by kernel name (the M = n products, the split pass,
# the norms and the merge)
PASSES = (("gemv", "gemv_kernel"), ("split", "split_kernel"),
          ("norms", "resnorm_kernel"), ("merge", "merge_kernel"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--kv_splits", default="64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.phase_card()
    cs.phase_build()
    eng = Llama.synthetic(LlamaConfig.llama2_7b(), seed=0, fused=True,
                          device=dev)
    cfg, p = eng.cfg, eng.params
    lw = p["layers"]
    pos = 600
    gen = torch.Generator(device=dev).manual_seed(9)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc.copy_(torch.randn(kc.shape, generator=gen, device=dev))
    vc.copy_(torch.randn(vc.shape, generator=gen, device=dev))
    kc[:, :, pos:] *= 8
    vc[:, :, pos:] *= 8
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, eps=cfg.norm_eps,
              final_norm=p["final_norm"], lm_head=p["lm_head"])
    for ks in (int(k) for k in args.kv_splits.split(",")):
        kcfg = KernelConfig(kv_split=ks)
        for n in (5, 9):
            x = p["embed"][torch.arange(n, device=dev) * 37 + 11]
            cos, sin = model.rope_rows(cfg, pos, n, dev)
            a = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
                 lw["wo_f"], lw["w13"], lw["w2"])
            kr, vr = kc.clone(), vc.clone()
            ref = sv.fused_verify_stack_plain(*a, kr, vr, pos, kv_split=ks,
                                              **kw)
            new = slice(pos, pos + n)
            mag = torch.maximum(
                kr[:, :, new].float().abs().amax(dim=(1, 2, 3)),
                vr[:, :, new].float().abs().amax(dim=(1, 2, 3)))
            first, fails = None, 0
            for r in range(args.reps):
                kk, vk = kc.clone(), vc.clone()
                out = sv.fused_verify_stack(*a, kk, vk, pos, kcfg=kcfg, **kw)
                torch.cuda.synchronize()
                lg = ((out[0] - ref[0]).abs().max()
                      / ref[0].abs().max()).item()
                err = torch.maximum(
                    (kk[:, :, new].float() - kr[:, :, new].float())
                    .abs().amax(dim=(1, 2, 3)),
                    (vk[:, :, new].float() - vr[:, :, new].float())
                    .abs().amax(dim=(1, 2, 3)))
                margin = err - (0.05 + 1e-2 * mag)
                worst = int(margin.argmax())
                ok = (lg <= 2e-2 and bool(err[0] <= 0.05)
                      and bool((margin <= 0).all()))
                fails += not ok
                same = None if first is None else torch.equal(out[0], first)
                if first is None:
                    first = out[0].clone()
                print(f"[spread] kv_split={ks} n={n} rep={r} "
                      f"logits_err_over_max={lg:.5f} "
                      f"row_err_layer0={err[0].item():.4g} "
                      f"worst_layer={worst} "
                      f"margin={margin[worst].item():.4g} ok={ok} "
                      f"same_bits_as_first={same}", flush=True)
                del kk, vk, out
            kk, vk = kc.clone(), vc.clone()
            call = lambda: sv.fused_verify_stack(*a, kk, vk, pos, kcfg=kcfg,  # noqa: E731
                                                 **kw)
            ms = cs.time_ms(call, 20)
            busy, _, own, parts, counts = profiling.timeline_by_pass(
                call, PASSES)
            print(f"[spread_sum] kv_split={ks} n={n} "
                  f"fails={fails}/{args.reps} ms={ms:.4f} busy_ms={busy:.4f} "
                  f"kernels_own_sum_ms={own:.4f} kernels_per_call="
                  f"{sum(counts.values()):g} " + " ".join(
                      f"{k}={t:.4f}" for k, t in parts.items()) + " " +
                  " ".join(f"{k}_launches={c:g}" for k, c in counts.items()),
                  flush=True)
            del kk, vk, kr, vr, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
