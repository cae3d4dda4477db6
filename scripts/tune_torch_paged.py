"""Time the split length of kernels 10 and 12 on one card.

    python3 scripts/tune_torch_paged.py

Kernel 10 (``paged_attention``) at the cells of ``chip_smoke.py`` phase 6
(7B: B 8, 32 kv heads, page 16, the serving lens up to 2047; GQA: 8 kv
heads of group 4; a lone 4095-row request) with ``SPLIT`` set to each of
64, 128 and 256 rows, and kernels 12 and 11 (``deepseek_decoder_stack_layer``
at pos 600, ``deepseek_decoder_layer_fused`` over 4096 rows, DeepSeek-V2-Lite
widths) with ``MLA_SPLIT`` set to 16, 32 and 64.  Each setting is checked
against the plain twin at the same split (the twins round p per split)
and timed as device busy time (``torch.profiler``, the kernels' intervals
merged), in the order A B C C B A; the card's name and power limit come
first.  Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
import profiling  # noqa: E402
from clusterfusion_tpu_torch.ops import deepseek_layer as dl  # noqa: E402
from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd  # noqa: E402

PAGED = (("7b", 32, 1, cs.SERVE_LENS), ("gqa", 8, 4, cs.SERVE_LENS),
         ("long", 32, 1, [4095]))
PAGED_SPLITS = (64, 128, 256)
MLA_SPLITS = (16, 32, 64)


def paged_cases(dev):
    """Per cell: a call of kernel 10 and its twin at the current SPLIT."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for label, kv, g, lens_l in PAGED:
        kp, vp, table, lens = cs.paged_pools(dev, 2, kv, 128, 16, lens_l, 4)
        cs.nan_unowned(kp, vp, table, lens)
        q = torch.randn((len(lens_l), kv, g, 128), generator=gen,
                        device=dev).bfloat16()
        kn = torch.randn((len(lens_l), kv, 128), generator=gen,
                         device=dev).bfloat16()
        args = (q, kn, kn, kp, vp, table, lens, 1)
        out[label] = (lambda a=args: pd.paged_attention(*a),
                      lambda a=args: pd.paged_attention_plain(
                          *a[:3], a[3].clone(), a[4].clone(), *a[5:]))
    return out


def mla_cases(dev):
    """Kernel 12 at pos 600 and kernel 11 over 4096 rows, with twins."""
    from clusterfusion_tpu_torch.models import deepseek as ds
    cfg, lw = cs.deepseek_layer_weights(dev)
    dims = dict(n_heads=cfg.n_heads, nope_dim=cfg.nope_head_dim,
                rope_dim=cfg.rope_head_dim, lora_rank=cfg.kv_lora_rank,
                eps=cfg.norm_eps)
    cos_t, sin_t = ds.rope_table(cfg, max_pos=4096, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((1, cfg.hidden_dim), generator=gen, device=dev).bfloat16()
    cache = ds.init_cache(cfg, max_seq=4096, device=dev)
    cache.copy_(torch.randn(cache.shape, generator=gen, device=dev))
    c576 = cache[1, :, :cfg.mla_head_dim].contiguous()
    w = [lw[k][1] for k in ("wproj", "wuk", "wuv", "wo_t")]

    def twin(c, seq, at):
        return dl.mla_decode_plain(
            x, lw["attn_norm"][1], lw["ckv_norm"][1], cos_t[at], sin_t[at],
            *w, c, seq, softmax_scale=cfg.softmax_scale, split=dl.MLA_SPLIT,
            **dims)[0]

    k12 = (lambda: dl.deepseek_decoder_stack_layer(
        x, lw["wproj"], lw["wuk"], lw["wuv"], lw["wo_t"], cache, 600, 1,
        lw["attn_norm"], lw["ckv_norm"], cos_t[600], sin_t[600],
        softmax_scale=cfg.softmax_scale, **dims)[0],
        lambda: twin(cache[1], 600, 600))
    k11 = (lambda: dl.deepseek_decoder_layer_fused(
        x, *w, c576, 4096, lw["attn_norm"][1], lw["ckv_norm"][1],
        cos_t[4095], sin_t[4095], softmax_scale=cfg.softmax_scale,
        **dims)[0], lambda: twin(c576, 4096, 4095))
    return {"k12_pos600": k12, "k11_4096": k11}


def sequence(fn, reps: int = 8):
    """The kernels of one call of ``fn`` in launch order (the median call
    of ``reps`` under ``torch.profiler``, ``profiling.profile_calls``):
    name, start after the call's first kernel started, own duration, and
    the time charged to it (from the end of the kernels before it to its
    own end), all in µs."""
    kern, _ = profiling.profile_calls(fn, reps)
    per = len(kern) // reps
    calls = [kern[i * per:(i + 1) * per] for i in range(reps)]
    calls.sort(key=lambda c: c[-1][1] - c[0][0])
    call = calls[reps // 2]
    out = []
    for start, stop, name, charged in profiling.charged(call):
        short = name.split("(")[0].split("::")[-1].split("<")[0][:24]
        out.append(f"{short}@{start - call[0][0]:.1f}+{stop - start:.1f}"
                   f"/{charged:.1f}")
    return f"{per} kernels per call: " + " ".join(out)


def run(cases, setter, values):
    for v in list(values) + list(reversed(values)):
        setter(v)
        for label, (kernel, twin) in cases.items():
            got, want = kernel(), twin()
            got = got[0] if isinstance(got, tuple) else got
            want = want[0] if isinstance(want, tuple) else want
            torch.testing.assert_close(got.float(), want.float(),
                                       **cs.LIMITS_TOL)
            ms, _ = cs.busy_ms(kernel)
            print(f"[tune] {label} split={v} busy_ms={ms:.4f} "
                  f"kernels(name@start+own/charged us)={sequence(kernel)}",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    default = pd.SPLIT
    run(paged_cases(dev), lambda v: setattr(pd, "SPLIT", v), PAGED_SPLITS)
    pd.SPLIT = default
    default = dl.MLA_SPLIT
    run(mla_cases(dev), lambda v: setattr(dl, "MLA_SPLIT", v), MLA_SPLITS)
    dl.MLA_SPLIT = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
