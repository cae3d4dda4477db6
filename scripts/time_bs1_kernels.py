"""Time kernels 4, 6, 7 and 8 without a window, on the tree at ``--root``.

    python3 scripts/time_bs1_kernels.py --root DIR [--label NAME]

Imports ``clusterfusion_tpu_torch`` from DIR (a checkout, e.g. an unpacked
older commit beside this one; its kernels build into DIR/build at first
use) and prints one JSON line of medians of CUDA-event times in ms, so
that two trees run in turns on one card (A B B A) compare their window-0
paths:

- ``flash_*``: kernel 4 at Llama-2-7B's heads (kv 32, group 1, hd 128) over
  T 512 and T 4096, and at Mistral-7B's (kv 8, group 4) over T 4608;
- ``stack_pos600``: kernel 7, one Llama-2-7B step (32 layers, bf16, the LM
  head) at pos 600 of a 1024-row cache; ``stack_fp8_pos600`` the same on
  an fp8 e4m3 copy of the cache;
- ``layer6_pos600`` / ``layer6_fp8_pos600``: kernel 6, the attention half
  of layer 1 of those weights with the append, on the bf16 and the fp8
  cache: device ms a call with 20 calls queued behind a spin kernel
  between two CUDA events (``_queued_ms``; one call alone is shorter than
  its launch), the median of ``--reps`` such runs;
- ``verify_n5`` / ``verify_n9``: kernel 8 at n 5 and n 9, pos 600.

Each figure is the median of ``--reps`` calls, each between two CUDA
events, after 3 warm-up calls; then ``*_busy`` and ``*_by_pass``, the
device's busy ms a call and its passes' (``profiling.timeline_by_pass``,
``torch.profiler``; this script's own copy of ``profiling`` reads both
trees).  Weights are random (seed 0), caches random bf16 rows.  Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys


def _time_ms(torch, fn, reps):
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


def _queued_ms(torch, fn, reps, n=20):
    """Device ms a call of ``fn`` with ``n`` calls queued behind a spin
    kernel long enough that the host has queued them all before the first
    starts (the host's pace left out), the median of ``reps`` runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        if a.query():
            raise RuntimeError("the spin ended before the calls were queued")
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


PASSES = (("split", "attn_split_kernel"), ("merge", "merge_kernel"),
          ("gemv", "gemv"), ("norms", "norm"))


def _busy(out, name, fn):
    """The profiler's busy ms a call of ``fn`` and by pass, into ``out``."""
    from profiling import LostEvents, timeline_by_pass
    try:
        busy, _, _, by_pass, _ = timeline_by_pass(fn, PASSES)
    except LostEvents:
        out[name + "_busy"] = None
        return
    out[name + "_busy"] = busy
    out[name + "_by_pass"] = {k: round(v, 4) for k, v in by_pass.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    if not torch.cuda.is_available():
        print("time_bs1_kernels: no CUDA device", file=sys.stderr)
        return 1
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = dict(label=a.label, root=os.path.abspath(a.root),
               package=os.path.dirname(fp.__file__))
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, kv, g, T in (("flash_kv32_T512", 32, 1, 512),
                           ("flash_kv32_T4096", 32, 1, 4096),
                           ("flash_kv8_g4_T4608", 8, 4, 4608)):
        q = torch.randn((kv, T, g, 128), generator=gen, device=dev).bfloat16()
        k = torch.randn((kv, T, 128), generator=gen, device=dev).bfloat16()
        v = torch.randn((kv, T, 128), generator=gen, device=dev).bfloat16()
        call = functools.partial(fp.flash_prefill_attention, q, k, v)
        out[name] = _time_ms(torch, call, a.reps)
        _busy(out, name, call)
        del q, k, v, call
    eng = Llama.synthetic(LlamaConfig.llama2_7b(), seed=0, fused=True,
                          device=dev)
    cfg, p = eng.cfg, eng.params
    lw, pos = p["layers"], 600
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc.copy_(torch.randn(kc.shape, generator=gen, device=dev))
    vc.copy_(torch.randn(vc.shape, generator=gen, device=dev))
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, eps=cfg.norm_eps,
              final_norm=p["final_norm"], lm_head=p["lm_head"])
    w = (lw["attn_norm"], lw["ffn_norm"])
    proj = (lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"])
    cos, sin = model.rope_row(cfg, pos, dev)
    x = p["embed"][torch.tensor([7], device=dev)]
    step = functools.partial(sk.fused_decoder_stack, x, *w, cos, sin, *proj,
                             kc, vc, pos, **kw)
    out["stack_pos600"] = _time_ms(torch, step, a.reps)
    _busy(out, "stack_pos600", step)
    kf, vf = kc.to(torch.float8_e4m3fn), vc.to(torch.float8_e4m3fn)
    step8 = functools.partial(sk.fused_decoder_stack, x, *w, cos, sin, *proj,
                              kf, vf, pos, **kw)
    out["stack_fp8_pos600"] = _time_ms(torch, step8, a.reps)
    _busy(out, "stack_fp8_pos600", step8)
    res = p["embed"][torch.tensor([9], device=dev)]
    for name, k_, v_ in (("layer6_pos600", kc, vc),
                         ("layer6_fp8_pos600", kf, vf)):
        call = functools.partial(
            dl._fused_decoder_layer, x, res, lw["attn_norm"], cos, sin,
            lw["wqkv_f"], lw["wo_f"], k_, v_, pos, 1, group=kw["group"],
            head_dim=kw["head_dim"], rope_style=kw["rope_style"],
            fuse_residual=True, eps=kw["eps"], append_kv=True)
        out[name] = _queued_ms(torch, call, a.reps)
    del kf, vf
    for n in (5, 9):
        x = p["embed"][torch.arange(n, device=dev) * 37 + 11]
        cos, sin = model.rope_rows(cfg, pos, n, dev)
        call = functools.partial(sv.fused_verify_stack, x, *w, cos, sin,
                                 *proj, kc, vc, pos, **kw)
        out[f"verify_n{n}"] = _time_ms(torch, call, a.reps)
        _busy(out, f"verify_n{n}", call)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
