"""Time kernels 9 and 10 without a window, on the tree at ``--root``.

    python3 scripts/time_paged_kernels.py --root DIR [--label NAME]

Imports ``clusterfusion_tpu_torch`` from DIR (a checkout, e.g. an unpacked
older commit beside this one; its kernels build into DIR/build at first
use) and prints one JSON line of medians of CUDA-event times in ms, so
that two trees run in turns on one card (A B B A) compare the window-0
paths of the paged kernels, at the cells of ``chip_smoke.py``'s kernels
line:

- ``k10_7b`` / ``k10_7b_fp8``: kernel 10 (``paged_attention``) at
  Llama-2-7B's heads (kv 32, group 1, hd 128, page 16), B 8 at lens 0, 1,
  15, 16, 255, 511, 1000 and 2047, on bf16 and e4m3 pools (phases 6 and
  41);
- ``k10_gqa_8000``: kernel 10 at Mistral-7B's heads (kv 8, group 4), B 8
  at lens 8000;
- ``k9_b4`` / ``k9_b4_fp8``: kernel 9 (``llama_decoder_layer_paged``) on
  a random bf16 layer at Llama-2-7B's widths, B 4 at lens 128 and three
  padding rows on the NULL page, on bf16 and e4m3 pools (phases 7 and 42).

Each figure is the median of ``--reps`` calls, each between two CUDA
events, after 3 warm-up calls, then ``*_busy``: the device's busy ms a
call (``profiling.timeline_by_pass``, ``torch.profiler``; this script's
own copy of ``profiling`` reads both trees).  Inputs are random from fixed
seeds, NaN in every pool row no request owns.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys

SERVE_LENS = [0, 1, 15, 16, 255, 511, 1000, 2047]


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


def _busy(fn):
    from profiling import LostEvents, timeline_by_pass
    try:
        return timeline_by_pass(fn, ())[0]
    except LostEvents:
        return None


def _pools(torch, dev, L, kv, hd, page, lens, seed):
    """Random bf16 pools over a shuffled block table (request b owns
    lens[b] // page + 1 pages, page 0 none), NaN in every unowned row."""
    need = [n // page + 1 for n in lens]
    n_pages = 1 + sum(need)
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    table = torch.zeros((len(lens), max(need)), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at:at + n]
        at += n
    shape = (L, n_pages, kv, page, hd)
    kp = torch.randn(shape, generator=gen).bfloat16().to(dev)
    vp = torch.randn(shape, generator=gen).bfloat16().to(dev)
    table, lens = table.to(dev), torch.tensor(lens, dtype=torch.int32,
                                              device=dev)
    owned = torch.zeros((n_pages, page), dtype=torch.bool, device=dev)
    for b, n in enumerate(lens.tolist()):
        j = torch.arange(n, device=dev)
        owned[table[b, j // page].long(), j % page] = True
    free = ~owned[None, :, None, :, None].expand(kp.shape)
    kp[free] = float("nan")
    vp[free] = float("nan")
    return kp, vp, table, lens


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=50)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    if not torch.cuda.is_available():
        print("time_paged_kernels: no CUDA device", file=sys.stderr)
        return 1
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fp8 = torch.float8_e4m3fn
    out = dict(label=a.label, root=os.path.abspath(a.root),
               package=os.path.dirname(pd.__file__))
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, kv, g, lens_l in (("k10_7b", 32, 1, SERVE_LENS),
                                ("k10_gqa_8000", 8, 4, [8000] * 8)):
        B = len(lens_l)
        kp, vp, table, lens = _pools(torch, dev, 2, kv, 128, 16, lens_l, 4)
        q = torch.randn((B, kv, g, 128), generator=gen, device=dev).bfloat16()
        kn = torch.randn((B, kv, 128), generator=gen, device=dev).bfloat16()
        for suffix, k, v in (("", kp, vp), ("_fp8", kp.to(fp8), vp.to(fp8))):
            if suffix and name != "k10_7b":
                continue
            call = functools.partial(pd.paged_attention, q, kn, kn, k, v,
                                     table, lens, 1)
            out[name + suffix] = _time_ms(torch, call, a.reps)
            out[name + suffix + "_busy"] = _busy(call)
        del kp, vp
    cfg = LlamaConfig.llama2_7b()
    hidden, kv, hd = cfg.hidden_dim, cfg.kv_heads, cfg.head_dim_
    G, hg = 4, 8
    wq = (torch.randn((2, G, hidden, hg * 3 * hd), generator=gen, device=dev)
          * hidden ** -0.5).bfloat16()
    wo = (torch.randn((2, G, hg * hd, hidden), generator=gen, device=dev)
          * hidden ** -0.5).bfloat16()
    norm = torch.ones((hidden,), dtype=torch.bfloat16, device=dev)
    cos_t, sin_t = model.rope_table(cfg, device=dev)
    kp, vp, table, lens = _pools(torch, dev, 2, kv, hd, 16, [128, 0, 0, 0], 6)
    table[1:] = 0                      # padding rows on the NULL page
    x = torch.randn((4, hidden), generator=gen, device=dev).bfloat16()
    res = torch.randn((4, hidden), generator=gen, device=dev).bfloat16()
    for suffix, k, v in (("", kp, vp), ("_fp8", kp.to(fp8), vp.to(fp8))):
        call = functools.partial(
            pd.llama_decoder_layer_paged, x, res, wq, wo, table, lens, lens,
            k, v, 1, norm, cfg.norm_eps, cos_t, sin_t, group=1,
            rope_style=cfg.rope_style)
        out["k9_b4" + suffix] = _time_ms(torch, call, a.reps)
        out["k9_b4" + suffix + "_busy"] = _busy(call)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
