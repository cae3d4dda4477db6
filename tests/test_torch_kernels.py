"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and skips without one.  On the card:

    python -m pytest tests/test_torch_kernels.py -q

Tolerances: the kernels and their twins share inputs and arithmetic but
sum in another order (the decode GEMVs split their sums across blocks, in
a fixed order, so every kernel repeats its bits), and round to bf16 at the
same places; outputs are held at atol 2e-2 / rtol 2e-2, logits at 2e-2 of the
largest logit, appended K/V rows at atol 0.05 (the JAX suite's bf16
tolerance).
"""

import importlib

import numpy as np
import pytest
import torch

from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as model
from clusterfusion_tpu_torch.ops import flash_prefill as fp
from clusterfusion_tpu_torch.ops import stack_kernel as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dev, seed, scale=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16).to(dev)


@pytest.mark.parametrize("kv,T,g,hd,q_offset,extra,rows,view", [
    (2, 1, 1, 128, 0, 0, 64, False),
    (2, 37, 1, 128, 0, 0, 64, False),
    (2, 64, 4, 128, 0, 0, 64, False),
    (1, 130, 2, 64, 0, 0, 64, False),
    (2, 33, 2, 64, 93, 30, 64, False),
    (4, 200, 1, 128, 256, 7, 64, False),
    # long prompts, both head dims and row tiles
    (2, 1024, 1, 128, 0, 0, 128, False),
    (1, 2048, 1, 128, 0, 0, 128, False),
    (2, 1024, 1, 64, 0, 0, 64, False),
    (1, 2048, 1, 64, 0, 0, 128, False),
    # groups 1, 4 and 8 at both head dims
    (2, 300, 4, 128, 0, 0, 128, False),
    (2, 129, 8, 128, 0, 0, 64, False),
    (1, 1024, 8, 64, 0, 0, 128, False),
    (4, 77, 4, 64, 0, 0, 64, False),
    # T = 1, with and without an offset
    (2, 1, 1, 128, 0, 0, 128, False),
    (2, 1, 8, 64, 500, 3, 128, False),
    (3, 1, 4, 128, 63, 0, 64, False),
    # T*group and q_offset + T off the row and key tiles
    (3, 45, 3, 128, 17, 5, 128, False),
    (2, 63, 1, 64, 65, 1, 64, False),
    (2, 129, 1, 128, 127, 0, 128, False),
    # a layer of a cache read in place, NaN in every row past the chunk
    (4, 200, 1, 128, 256, 7, 128, True),
    (2, 45, 8, 64, 19, 60, 64, True),
    (2, 1, 1, 128, 300, 1, 128, True),
])
def test_flash_prefill_kernel_matches_plain(dev, kv, T, g, hd, q_offset,
                                            extra, rows, view):
    S = q_offset + T + extra
    q = _randn((kv, T, g, hd), dev, 0)
    if view:
        # [layers, kv, capacity, hd]; the kernel reads layer 1's first S
        # rows where they lie, and must never touch the NaN rows past the
        # chunk (positions q_offset + T ..)
        kbuf = torch.full((2, kv, S + 64, hd), float("nan"),
                          dtype=torch.bfloat16, device=dev)
        vbuf = kbuf.clone()
        kbuf[1, :, :q_offset + T] = _randn((kv, q_offset + T, hd), dev, 1)
        vbuf[1, :, :q_offset + T] = _randn((kv, q_offset + T, hd), dev, 2)
        k, v = kbuf[1, :, :S], vbuf[1, :, :S]
        assert not k.is_contiguous()
    else:
        k = _randn((kv, S, hd), dev, 1)
        v = _randn((kv, S, hd), dev, 2)
    before = fp.launches
    out = fp.flash_prefill_attention(q, k, v, q_offset=q_offset,
                                     kcfg=KernelConfig(prefill_block_rows=rows))
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    assert bool(torch.isfinite(out).all())
    ref = fp.flash_prefill_attention_plain(q, k, v, q_offset=q_offset)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_chunked_prefill_matches_whole_on_card(dev):
    """prefill_chunk over two chunks (the second through kernel 4 at
    q_offset 40, reading the cache in place) gives the logits and caches
    of one whole prefill, at LlamaConfig.tiny() with GQA.  Tolerances as
    the JAX suite's test: the projections run at other M, so bf16 roundings
    may differ."""
    cfg = LlamaConfig.tiny(n_kv_heads=2)
    p = model.init_params(cfg, seed=3, device=dev)
    toks = (np.arange(101) * 11) % cfg.vocab_size
    k1, v1 = model.init_cache(cfg, device=dev)
    before = fp.launches
    l1, _, _ = model.prefill(p, k1, v1, toks, cfg)
    kc, vc = model.init_cache(cfg, device=dev)
    model.prefill_chunk(p, kc, vc, toks[:40], cfg, pos0=0)
    l2, _, _ = model.prefill_chunk(p, kc, vc, toks[40:], cfg, pos0=40)
    torch.cuda.synchronize()
    assert fp.launches == before + 3 * cfg.n_layers
    scale = max(l1.abs().max().item(), 1.0)
    assert (l2 - l1[40:]).abs().max().item() < 0.05 * scale
    torch.testing.assert_close(kc.float(), k1.float(), atol=0.05, rtol=0)
    torch.testing.assert_close(vc.float(), v1.float(), atol=0.05, rtol=0)


HIDDEN, L, HD, F_PAD, VOCAB, CAP = 512, 2, 128, 1024, 384, 640


def _stack_args(dev, n_heads, kv_heads, hg, pos, seed=0, hidden=HIDDEN,
                hd=HD):
    HD = hd
    g, G = n_heads // kv_heads, kv_heads // hg
    a = dict(
        x=_randn((1, hidden), dev, seed),
        attn_norm=1 + _randn((L, hidden), dev, seed + 1, 0.1),
        ffn_norm=1 + _randn((L, hidden), dev, seed + 2, 0.1),
        wqkv_f=_randn((L, G, hidden, hg * (g + 2) * HD), dev, seed + 3,
                      hidden ** -0.5),
        wo_f=_randn((L, G, hg * g * HD, hidden), dev, seed + 4,
                    (g * HD) ** -0.5),
        w13=_randn((L, 2, hidden, F_PAD), dev, seed + 5, hidden ** -0.5),
        w2=_randn((L, F_PAD, hidden), dev, seed + 6, F_PAD ** -0.5),
    )
    kc = torch.zeros((L, kv_heads, CAP, HD), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :, :pos] = _randn((L, kv_heads, pos, HD), dev, seed + 7)
    vc[:, :, :pos] = _randn((L, kv_heads, pos, HD), dev, seed + 8)
    lm = dict(final_norm=1 + _randn((hidden,), dev, seed + 9, 0.1),
              lm_head=_randn((hidden, VOCAB), dev, seed + 10, hidden ** -0.5))
    return g, a, kc, vc, lm


def _same_bits(a, b):
    """Bit equality of two bf16 tensors (NaN rows compare equal)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int16),
                                              b.view(torch.int16))


# the default kv_split and two others of the candidates
KV_SPLIT_DEFAULT = KernelConfig().kv_split
KV_SPLITS = [KV_SPLIT_DEFAULT] + [k for k in (32, 64, 128)
                                  if k != KV_SPLIT_DEFAULT][:2]
# positions around the split boundaries ("ks" is the case's kv_split)
STACK_POS = ["0", "1", "37", "300", "ks-1", "ks", "ks+1", "cap-1"]


def _stack_pos(name, kv_split):
    if name == "cap-1":
        return CAP - 1
    if name.startswith("ks"):
        return kv_split + int(name[2:] or 0)
    return int(name)


@pytest.mark.parametrize("kv_split", KV_SPLITS,
                         ids=[f"ks{k}" for k in KV_SPLITS])
@pytest.mark.parametrize("pos_name", STACK_POS)
@pytest.mark.parametrize("with_lm", [True, False], ids=["lm", "no_lm"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", [(4, 4, 2), (8, 2, 1)],
                         ids=["mha", "gqa"])
@pytest.mark.parametrize("rope_style", ["gptj", "neox"])
def test_stack_kernel_matches_plain(dev, rope_style, n_heads, kv_heads, hg,
                                    with_lm, pos_name, kv_split):
    """Kernel 7 against its plain twin at the same kv_split, every cache row
    above pos NaN: the kernel reads rows < pos only and writes row pos."""
    pos = _stack_pos(pos_name, kv_split)
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos)
    kc[:, :, pos + 1:] = float("nan")
    vc[:, :, pos + 1:] = float("nan")
    cfg = LlamaConfig.tiny(rope_style=rope_style)
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style=rope_style, eps=1e-5,
              **(lm if with_lm else {}))
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, a["wqkv_f"],
            a["wo_f"], a["w13"], a["w2"]]
    kp, vp = kc.clone(), vc.clone()
    before = sk.launches
    out = sk.fused_decoder_stack(*args, kc, vc, pos,
                                 kcfg=KernelConfig(kv_split=kv_split), **kw)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert sk.last_step_kernels == 8 * L - (pos == 0) * L + 1 + with_lm
    ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos, kv_split=kv_split,
                                       **kw)
    assert torch.isfinite(out[0].float()).all()
    if with_lm:
        err = (out[0] - ref[0]).abs().max().item()
        assert err <= 2e-2 * ref[0].abs().max().item(), err
    else:
        torch.testing.assert_close(out[0].float(), ref[0].float(),
                                   atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out[1].float(), ref[1].float(), atol=2e-2,
                               rtol=2e-2)
    for got, want in ((kc, kp), (vc, vp)):
        torch.testing.assert_close(got[:, :, pos].float(),
                                   want[:, :, pos].float(), atol=0.05, rtol=0)
    others = torch.ones(CAP, dtype=torch.bool, device=dev)
    others[pos] = False
    assert _same_bits(kc[:, :, others], kp[:, :, others])
    assert _same_bits(vc[:, :, others], vp[:, :, others])


@pytest.mark.parametrize("with_lm", [True, False], ids=["lm", "no_lm"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", [(4, 4, 2), (8, 2, 1)],
                         ids=["mha", "gqa"])
def test_stack_kernel_is_bit_reproducible(dev, n_heads, kv_heads, hg, with_lm):
    """Kernel 7's GEMVs sum their K chunks in a fixed order, so one step on
    the same inputs gives the same bits every time, the appended rows too."""
    pos = 300
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style=cfg.rope_style, eps=1e-5,
              **(lm if with_lm else {}))
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, a["wqkv_f"],
            a["wo_f"], a["w13"], a["w2"]]
    outs = [sk.fused_decoder_stack(*args, kc.clone(), vc.clone(), pos, **kw)
            for _ in range(4)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            assert torch.equal(got, want)


def _int8_stack(a, lm, lm_kind):
    """The stack's four projections quantized to int8 (per output column),
    and the LM head as ``lm_kind`` says: None (no head), "bf16" or
    "int8"."""
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    q = quantize_llama_params(
        {"layers": {k: a[k] for k in ("wqkv_f", "wo_f", "w13", "w2")},
         "lm_head": lm["lm_head"]}, "int8", lm_head=lm_kind == "int8")
    head = {} if lm_kind is None else dict(final_norm=lm["final_norm"],
                                           lm_head=q["lm_head"])
    return q["layers"], head


# (n_heads, kv_heads, hg): hg 4 and 8, the quantized engines' grouping, with
# G = 2 head groups (the O projection's scales differ per group) and G = 1
INT8_SHAPES = [(16, 8, 4), (16, 16, 8), (32, 8, 8)]


@pytest.mark.parametrize("pos", [0, 37, 300, CAP - 1])
@pytest.mark.parametrize("lm_kind", [None, "bf16", "int8"],
                         ids=["no_lm", "lm_bf16", "lm_int8"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", INT8_SHAPES,
                         ids=["hg4_G2", "hg8_G2", "hg8_G1"])
def test_stack_int8_kernel_matches_plain(dev, n_heads, kv_heads, hg, lm_kind,
                                         pos):
    """Kernel 7's int8 mode against its plain twin at the same kv_split,
    every cache row above pos NaN, at phase 4's limits."""
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos, seed=20)
    kc[:, :, pos + 1:] = float("nan")
    vc[:, :, pos + 1:] = float("nan")
    w, head = _int8_stack(a, lm, lm_kind)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style=cfg.rope_style, eps=1e-5,
              **head)
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, w["wqkv_f"],
            w["wo_f"], w["w13"], w["w2"]]
    kp, vp = kc.clone(), vc.clone()
    before = (sk.launches, sk.int8_launches)
    out = sk.fused_decoder_stack(*args, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    assert (sk.launches, sk.int8_launches) == (before[0] + 1, before[1] + 1)
    assert sk.last_step_kernels == 8 * L - (pos == 0) * L + 1 + bool(head)
    ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos, **kw)
    assert torch.isfinite(out[0].float()).all()
    if head:
        err = (out[0] - ref[0]).abs().max().item()
        assert err <= 2e-2 * ref[0].abs().max().item(), err
    else:
        torch.testing.assert_close(out[0].float(), ref[0].float(),
                                   atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out[1].float(), ref[1].float(), atol=2e-2,
                               rtol=2e-2)
    for got, want in ((kc, kp), (vc, vp)):
        torch.testing.assert_close(got[:, :, pos].float(),
                                   want[:, :, pos].float(), atol=0.05, rtol=0)
    others = torch.ones(CAP, dtype=torch.bool, device=dev)
    others[pos] = False
    assert _same_bits(kc[:, :, others], kp[:, :, others])
    assert _same_bits(vc[:, :, others], vp[:, :, others])


@pytest.mark.parametrize("lm_kind", [None, "int8"], ids=["no_lm", "lm_int8"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", INT8_SHAPES[:2],
                         ids=["hg4_G2", "hg8_G2"])
def test_stack_int8_kernel_is_bit_reproducible(dev, n_heads, kv_heads, hg,
                                               lm_kind):
    """Kernel 7's int8 mode sums in a fixed order too: the same bits on
    every call, the appended rows too."""
    pos = 300
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos, seed=30)
    w, head = _int8_stack(a, lm, lm_kind)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style=cfg.rope_style, eps=1e-5,
              **head)
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, w["wqkv_f"],
            w["wo_f"], w["w13"], w["w2"]]
    runs = []
    for _ in range(4):
        k, v = kc.clone(), vc.clone()
        out = sk.fused_decoder_stack(*args, k, v, pos, **kw)
        runs.append((out[0], out[1], k, v))
    torch.cuda.synchronize()
    for run in runs[1:]:
        for got, want in zip(run, runs[0]):
            assert torch.equal(got, want)


def test_int8_engine_runs_kernel7_int8(dev):
    """``Llama.synthetic(quant="int8")`` streams through kernel 7's int8
    mode, one launch a step, its tokens the eager int8 path's (teacher-
    forced) wherever that path's top-2 gap exceeds 0.1."""
    from clusterfusion_tpu_torch.models.generation import Llama
    cfg = LlamaConfig.tiny(max_seq_len=128)
    eng = Llama.synthetic(cfg, quant="int8", device=dev)
    prompt = list(range(1, 30))
    before = sk.int8_launches
    toks = list(eng.stream_generate(prompt, 6, temperature=0.0))
    assert sk.int8_launches - before == len(toks)   # a step after each token
    kc, vc = model.init_cache(cfg, device=dev)
    lg, kc, vc = model.prefill(eng.params, kc, vc, prompt, cfg, flash=False)
    lg = lg[-1]
    for i, t in enumerate(toks):
        top = torch.topk(lg, 2).values
        if (top[0] - top[1]).item() > 0.1:
            assert int(torch.argmax(lg)) == t, i
        lg, kc, vc = model.decode_step(eng.params, kc, vc, t, len(prompt) + i,
                                       cfg, fused=False)


@pytest.mark.parametrize("n,pos", [(1, 37), (2, 0), (5, 37), (8, 300),
                                   (9, CAP - 9), (17, 100)])
@pytest.mark.parametrize("with_lm", [True, False], ids=["lm", "no_lm"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", [(4, 4, 2), (8, 2, 1)],
                         ids=["mha", "gqa4"])
@pytest.mark.parametrize("rope_style", ["gptj", "neox"])
def test_verify_kernel_matches_plain(dev, rope_style, n_heads, kv_heads, hg,
                                     with_lm, n, pos):
    """Kernel 8 against its plain twin.  Rows at and above pos hold large
    garbage (stale rows of rejected drafts): the kernel must read none of
    them, overwrite rows pos..pos+n-1 and leave the rest as they were."""
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos)
    kc[:, :, pos:] = _randn(kc[:, :, pos:].shape, dev, 40, 8.0)
    vc[:, :, pos:] = _randn(vc[:, :, pos:].shape, dev, 41, 8.0)
    x = _randn((n, HIDDEN), dev, 42)
    cos, sin = model.rope_rows(LlamaConfig.tiny(rope_style=rope_style), pos,
                               n, dev)
    kw = dict(group=g, head_dim=HD, rope_style=rope_style, eps=1e-5,
              **(lm if with_lm else {}))
    args = [x, a["attn_norm"], a["ffn_norm"], cos, sin, a["wqkv_f"],
            a["wo_f"], a["w13"], a["w2"]]
    k0, v0 = kc.clone(), vc.clone()
    kp, vp = kc.clone(), vc.clone()
    before = sv.launches
    out = sv.fused_verify_stack(*args, kc, vc, pos,
                                kcfg=KernelConfig(kv_split=128), **kw)
    torch.cuda.synchronize()
    assert sv.launches == before + 1
    assert sv.last_step_kernels == 8 * L - (pos == 0) * L + 1 + with_lm
    ref = sv.fused_verify_stack_plain(*args, kp, vp, pos, kv_split=128, **kw)
    if with_lm:
        assert out[0].shape == (n, VOCAB)
        err = (out[0] - ref[0]).abs().max().item()
        assert err <= 2e-2 * ref[0].abs().max().item(), err
    else:
        torch.testing.assert_close(out[0].float(), ref[0].float(),
                                   atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out[1].float(), ref[1].float(), atol=2e-2,
                               rtol=2e-2)
    new = slice(pos, pos + n)
    for got, want in ((kc, kp), (vc, vp)):
        torch.testing.assert_close(got[:, :, new].float(),
                                   want[:, :, new].float(), atol=0.05, rtol=0)
    others = torch.ones(CAP, dtype=torch.bool, device=dev)
    others[new] = False
    assert torch.equal(kc[:, :, others], k0[:, :, others])
    assert torch.equal(vc[:, :, others], v0[:, :, others])


@pytest.mark.parametrize("n", [5, 9])
@pytest.mark.parametrize("with_lm", [True, False], ids=["lm", "no_lm"])
def test_verify_kernel_is_bit_reproducible(dev, with_lm, n):
    """Kernel 8's GEMVs sum their K chunks in a fixed order (the batched
    GEMV's cluster mode), so one call on the same inputs gives the same
    bits every time, the appended rows too."""
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    pos = 300
    g, a, kc, vc, lm = _stack_args(dev, 8, 2, 1, pos)
    x = _randn((n, HIDDEN), dev, 42)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_rows(cfg, pos, n, dev)
    kw = dict(group=g, head_dim=HD, rope_style=cfg.rope_style, eps=1e-5,
              **(lm if with_lm else {}))
    args = [x, a["attn_norm"], a["ffn_norm"], cos, sin, a["wqkv_f"],
            a["wo_f"], a["w13"], a["w2"]]
    outs = [sv.fused_verify_stack(*args, kc.clone(), vc.clone(), pos, **kw)
            for _ in range(4)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            assert torch.equal(got, want)


def test_verify_step_launches_kernel(dev):
    """verify_step(fused=True) on the card goes through kernel 8 once and
    agrees with the eager verify (the JAX suite's limit for this op)."""
    from clusterfusion_tpu_torch.models import speculative as spec
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    cfg = LlamaConfig.tiny(n_kv_heads=2)
    p = model.init_params(cfg, seed=3, device=dev)
    kc, vc = model.init_cache(cfg, device=dev)
    model.prefill(p, kc, vc, list(range(1, 40)), cfg)
    ke, ve = kc.clone(), vc.clone()
    before = sv.launches
    lf, _, _ = spec.verify_step(p, kc, vc, [5, 9, 2, 7], 39, cfg)
    torch.cuda.synchronize()
    assert sv.launches == before + 1
    le, _, _ = spec.verify_step(p, ke, ve, [5, 9, 2, 7], 39, cfg, fused=False)
    scale = max(le.abs().max().item(), 1.0)
    assert (lf - le).abs().max().item() < 0.06 * scale
    torch.testing.assert_close(kc.float(), ke.float(), atol=0.08, rtol=0)


def test_model_paths_agree_on_card(dev):
    """Fused decode vs eager decode and flash vs eager prefill, all on the
    card, at LlamaConfig.tiny() with GQA."""
    cfg = LlamaConfig.tiny(n_kv_heads=2)
    p = model.init_params(cfg, seed=2, device=dev)
    toks = (np.arange(70) * 13) % cfg.vocab_size
    kf, vf = model.init_cache(cfg, device=dev)
    ke, ve = model.init_cache(cfg, device=dev)
    lf, _, _ = model.prefill(p, kf, vf, toks, cfg, flash=True)
    le, _, _ = model.prefill(p, ke, ve, toks, cfg, flash=False)
    scale = max(le.abs().max().item(), 1.0)
    assert (lf - le).abs().max().item() < 0.05 * scale
    torch.testing.assert_close(kf.float(), ke.float(), atol=0.05, rtol=0)
    d_f, _, _ = model.decode_step(p, kf, vf, 7, len(toks), cfg, fused=True)
    d_e, _, _ = model.decode_step(p, ke, ve, 7, len(toks), cfg, fused=False)
    assert (d_f - d_e).abs().max().item() < 0.1 * max(d_e.abs().max().item(),
                                                      1.0)


# -- paged kernels: paged_attention (kernel 10), llama_decoder_layer_paged (9)


def _paged_pools(dev, L, kv, page, hd, lens, seed, n_spare=3):
    """Pools of random rows and a block table over shuffled pages: request
    b owns lens[b] // page + 1 pages; page 0 stays unowned."""
    need = [n // page + 1 for n in lens]
    n_pages = 1 + sum(need) + n_spare
    perm = np.random.RandomState(seed).permutation(np.arange(1, n_pages))
    width = max(need)
    table = np.zeros((len(lens), width), np.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at:at + n]
        at += n
    kp = _randn((L, n_pages, kv, page, hd), dev, seed + 1)
    vp = _randn((L, n_pages, kv, page, hd), dev, seed + 2)
    return (kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _appended_mask(kp, table, lens, layer):
    """True at every (layer, page, :, row) slot the appends write."""
    page = kp.shape[3]
    mask = torch.zeros(kp.shape[:2] + (page,), dtype=torch.bool,
                       device=kp.device)
    for b, n in enumerate(lens.tolist()):
        mask[layer, int(table[b, n // page]), n % page] = True
    return mask[:, :, None, :, None].expand(kp.shape)


@pytest.mark.parametrize("B,kv,g,hd,page,lens", [
    (4, 2, 1, 128, 16, [0, 1, 17, 64]),
    (3, 2, 4, 64, 8, [5, 64, 130]),
    (3, 4, 1, 128, 1, [0, 7, 70]),
    (2, 2, 7, 128, 16, [33, 100]),
    (8, 32, 1, 128, 16, [0, 1, 15, 16, 255, 511, 1000, 2047]),
    (8, 8, 4, 128, 16, [0, 1, 15, 16, 255, 511, 1000, 2047]),
])
def test_paged_attention_kernel_matches_plain(dev, B, kv, g, hd, page, lens):
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    L, layer = 2, 1
    kp, vp, table, lens_t = _paged_pools(dev, L, kv, page, hd, lens, 3)
    q = _randn((B, kv, g, hd), dev, 10)
    k_new = _randn((B, kv, hd), dev, 11)
    v_new = _randn((B, kv, hd), dev, 12)
    kr, vr = kp.clone(), vp.clone()
    before = pd.launches["paged_attention"]
    o, kp2, vp2 = pd.paged_attention(q, k_new, v_new, kp, vp, table, lens_t,
                                     layer)
    torch.cuda.synchronize()
    assert pd.launches["paged_attention"] == before + 1
    assert kp2 is kp and vp2 is vp
    want, _, _ = pd.paged_attention_plain(q, k_new, v_new, kr, vr, table,
                                          lens_t, layer)
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)
    # the twin rounds where the kernel rounds: each head's row agrees to
    # about two bf16 ulps of its own largest value
    got, ref = o.float().reshape(-1, hd), want.float().reshape(-1, hd)
    rel = (got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-6)
    assert rel.max().item() <= 2e-2
    assert torch.equal(kp, kr) and torch.equal(vp, vr)   # appends exact
    app = _appended_mask(kp, table, lens_t, layer)
    rows = torch.arange(B, device=dev)
    pg = table[rows, lens_t.long() // page].long()
    assert torch.equal(kp[layer][pg, :, lens_t.long() % page], k_new)
    assert torch.equal(vp[layer][pg, :, lens_t.long() % page], v_new)
    k0, _, _, _ = _paged_pools(dev, L, kv, page, hd, lens, 3)
    assert torch.equal(kp[~app], k0[~app])               # the rest untouched


def _split_lens():
    """Lengths around the split pass's edges: SPLIT - 1, SPLIT, SPLIT + 1,
    a multiple of 16 (a full last page at page 16) and 0."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    return [pd.SPLIT - 1, pd.SPLIT, pd.SPLIT + 1, 48, 0]


def _nan_unowned(kp, vp, table, lens):
    """NaN in every pool row no request owns (the rows at and past
    lens[b] of its pages too): the kernels must never read them."""
    page = kp.shape[3]
    owned = torch.zeros(kp.shape[1:2] + (page,), dtype=torch.bool,
                        device=kp.device)
    for b, n in enumerate(lens.tolist()):
        j = torch.arange(n, device=kp.device)
        owned[table[b, j // page].long(), j % page] = True
    free = ~owned[None, :, None, :, None].expand(kp.shape)
    kp[free] = float("nan")
    vp[free] = float("nan")


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("page", [1, 16])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_attention_split_edges(dev, g, page):
    """Kernel 10 at lens around a split's edges, NaN in the unowned rows:
    against its twin, the appends exact, the other rows untouched, and a
    repeat bit-identical."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    lens = _split_lens()
    B, kv, hd, L, layer = len(lens), 2, 128, 2, 1
    kp, vp, table, lens_t = _paged_pools(dev, L, kv, page, hd, lens, 7)
    _nan_unowned(kp, vp, table, lens_t)
    q = _randn((B, kv, g, hd), dev, 13)
    k_new = _randn((B, kv, hd), dev, 14)
    v_new = _randn((B, kv, hd), dev, 15)
    k0, kr, vr = kp.clone(), kp.clone(), vp.clone()
    o, _, _ = pd.paged_attention(q, k_new, v_new, kp, vp, table, lens_t, layer)
    o2, _, _ = pd.paged_attention(q, k_new, v_new, kp, vp, table, lens_t,
                                  layer)
    want, _, _ = pd.paged_attention_plain(q, k_new, v_new, kr, vr, table,
                                          lens_t, layer)
    torch.cuda.synchronize()
    assert torch.equal(_bits(o), _bits(o2))
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(_bits(kp), _bits(kr)) and torch.equal(_bits(vp),
                                                             _bits(vr))
    app = _appended_mask(kp, table, lens_t, layer)
    assert torch.equal(_bits(kp[~app]), _bits(k0[~app]))


def test_paged_attention_groups_in_turn(dev):
    """Kernel 10 at group 4, then 1, then 4 again: the launchers of the
    two groups share the merge kernel, whose shared-memory allowance one
    must not lower under the other."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    lens = [300, 7]
    for g in (4, 1, 4):
        kp, vp, table, lens_t = _paged_pools(dev, 2, 2, 16, 128, lens, 9)
        q = _randn((2, 2, g, 128), dev, 16)
        kn = _randn((2, 2, 128), dev, 17)
        kr, vr = kp.clone(), vp.clone()
        o, _, _ = pd.paged_attention(q, kn, kn, kp, vp, table, lens_t, 1)
        want, _, _ = pd.paged_attention_plain(q, kn, kn, kr, vr, table,
                                              lens_t, 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(o.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("page", [1, 16])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_layer_split_edges(dev, g, page):
    """Kernel 9 at the same lens and NaN rows: against its twin, and a
    repeat bit-identical (its GEMVs sum in a fixed order)."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    lens = _split_lens()
    B, kv, hd, hg, L, layer, hidden = len(lens), 2, 128, 1, 2, 1, 512
    cfg = LlamaConfig.tiny(rope_style="neox", head_dim=hd)
    cos_t, sin_t = model.rope_table(cfg, device=dev)
    kp, vp, table, lens_t = _paged_pools(dev, L, kv, page, hd, lens, 8)
    _nan_unowned(kp, vp, table, lens_t)
    wqkv, wo = _layer_weights(dev, L, hidden, kv, g, hd, hg, 21)
    x = _randn((B, hidden), dev, 33)
    res = _randn((B, hidden), dev, 34)
    rms = 1 + _randn((hidden,), dev, 35, 0.1)
    pos = torch.zeros_like(lens_t)          # any position inside the table
    kr, vr = kp.clone(), vp.clone()
    args = (wqkv, wo, table, lens_t, pos)
    kw = dict(group=g, rope_style="neox")
    out = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, layer, rms,
                                       1e-5, cos_t, sin_t, **kw)
    again = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, layer, rms,
                                         1e-5, cos_t, sin_t, **kw)
    want = pd.llama_decoder_layer_paged_plain(x, res, *args, kr, vr, layer,
                                              rms, 1e-5, cos_t, sin_t, **kw)
    torch.cuda.synchronize()
    for i in (0, 1):
        assert torch.equal(_bits(out[i]), _bits(again[i]))
        torch.testing.assert_close(out[i].float(), want[i].float(),
                                   atol=2e-2, rtol=2e-2)
    app = _appended_mask(kp, table, lens_t, layer)
    torch.testing.assert_close(kp[app].float(), kr[app].float(), atol=0.05,
                               rtol=0)
    assert torch.equal(_bits(kp[~app]), _bits(kr[~app]))


def _layer_weights(dev, L, hidden, kv, g, hd, hg, seed):
    G = kv // hg
    return (_randn((L, G, hidden, hg * (g + 2) * hd), dev, seed,
                   hidden ** -0.5),
            _randn((L, G, hg * g * hd, hidden), dev, seed + 1,
                   (kv * g * hd) ** -0.5))


@pytest.mark.parametrize("B,kv,g,hd,hg,page,lens,style", [
    (1, 4, 1, 128, 2, 16, [37], "gptj"),
    (3, 2, 4, 64, 1, 8, [0, 9, 70], "neox"),
    (3, 4, 1, 128, 4, 1, [5, 0, 40], "neox"),
    (4, 4, 1, 128, 2, 16, [40, 0, 0, 0], "neox"),
    (8, 2, 2, 128, 2, 16, [0, 1, 15, 16, 63, 64, 100, 200], "gptj"),
])
def test_paged_layer_kernel_matches_plain(dev, B, kv, g, hd, hg, page, lens,
                                          style):
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    L, layer, hidden = 2, 1, 512
    cfg = LlamaConfig.tiny(rope_style=style, head_dim=hd)
    cos_t, sin_t = model.rope_table(cfg, device=dev)
    kp, vp, table, lens_t = _paged_pools(dev, L, kv, page, hd, lens, 5)
    wqkv, wo = _layer_weights(dev, L, hidden, kv, g, hd, hg, 20)
    x = _randn((B, hidden), dev, 30)
    res = _randn((B, hidden), dev, 31)
    rms = 1 + _randn((hidden,), dev, 32, 0.1)
    kr, vr = kp.clone(), vp.clone()
    args = (wqkv, wo, table, lens_t, lens_t)
    kw = dict(group=g, rope_style=style)
    before = pd.launches["llama_decoder_layer_paged"]
    out = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, layer, rms,
                                       1e-5, cos_t, sin_t, **kw)
    torch.cuda.synchronize()
    assert pd.launches["llama_decoder_layer_paged"] == before + 1
    want = pd.llama_decoder_layer_paged_plain(x, res, *args, kr, vr, layer,
                                              rms, 1e-5, cos_t, sin_t, **kw)
    torch.testing.assert_close(out[0].float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(out[1].float(), want[1].float(), atol=2e-2,
                               rtol=2e-2)
    app = _appended_mask(kp, table, lens_t, layer)
    torch.testing.assert_close(kp[app].float(), kr[app].float(), atol=0.05,
                               rtol=0)
    torch.testing.assert_close(vp[app].float(), vr[app].float(), atol=0.05,
                               rtol=0)
    assert torch.equal(kp[~app], kr[~app]) and torch.equal(vp[~app], vr[~app])


def _e4m3_one_code(a, b):
    """(every byte of two e4m3 tensors equal or one code apart, as adjacent
    values of one sign are, or both zero or the least denormal; the share
    of equal bytes)."""
    x, y = a.view(torch.uint8).int(), b.view(torch.uint8).int()
    near = (((x ^ y) & 0x80) == 0) & ((x - y).abs() <= 1)
    near |= ((x & 0x7F) <= 1) & ((y & 0x7F) <= 1)
    return bool(near.all()), (x == y).float().mean().item()


def _fp8_pools(dev, L, kv, page, hd, lens, seed):
    """``_paged_pools`` in e4m3, NaN (0x7f) in every unowned row."""
    kp, vp, table, lens_t = _paged_pools(dev, L, kv, page, hd, lens, seed)
    _nan_unowned(kp, vp, table, lens_t)
    return (kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn), table,
            lens_t)


@pytest.mark.parametrize("B,kv,g,hd,page,lens", [
    (4, 2, 1, 128, 16, [0, 1, 17, 64]),
    (3, 2, 4, 64, 8, [5, 64, 130]),
    (3, 4, 1, 128, 1, [0, 7, 70]),
    (2, 2, 7, 128, 16, [33, 100]),
    (5, 2, 4, 128, 16, [127, 128, 129, 48, 0]),
])
def test_paged_attention_fp8_pool_matches_plain(dev, B, kv, g, hd, page,
                                                lens):
    """Kernel 10 on e4m3 pools: against its twin (outputs at atol 2e-2 /
    rtol 2e-2, each head's row within 2 % of its largest value), the
    appended codes equal to the twin's (both store e4m3 of the same bf16
    row), every other byte untouched, a repeat bit-identical, each call
    counted as fp8."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    L, layer = 2, 1
    kp, vp, table, lens_t = _fp8_pools(dev, L, kv, page, hd, lens, 3)
    q = _randn((B, kv, g, hd), dev, 10)
    k_new = _randn((B, kv, hd), dev, 11)
    v_new = _randn((B, kv, hd), dev, 12)
    k0, k2, v2, kr, vr = kp.clone(), kp.clone(), vp.clone(), kp.clone(), \
        vp.clone()
    before = pd.launches["paged_attention_fp8"]
    o, _, _ = pd.paged_attention(q, k_new, v_new, kp, vp, table, lens_t, layer)
    o2, _, _ = pd.paged_attention(q, k_new, v_new, k2, v2, table, lens_t,
                                  layer)
    want, _, _ = pd.paged_attention_plain(q, k_new, v_new, kr, vr, table,
                                          lens_t, layer)
    torch.cuda.synchronize()
    assert pd.launches["paged_attention_fp8"] == before + 2
    assert torch.equal(_bits(o), _bits(o2))
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)
    got, ref = o.float().reshape(-1, hd), want.float().reshape(-1, hd)
    rel = (got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-6)
    assert rel.max().item() <= 2e-2
    for a, b in ((kp, kr), (vp, vr), (kp, k2), (vp, v2)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    app = _appended_mask(kp, table, lens_t, layer)
    assert torch.equal(kp.view(torch.uint8)[~app], k0.view(torch.uint8)[~app])


@pytest.mark.parametrize("weights", ["bf16", "int8"])
@pytest.mark.parametrize("kv,g,hd,hg,page,lens", [
    (2, 1, 128, 2, 16, [0, 1, 17, 200]),       # e4m3 of the float32 row
    (2, 4, 128, 1, 8, [5, 64, 130]),           # e4m3 of the float32 row
    (2, 2, 128, 2, 4, [5, 64, 130]),           # page % 8: of the bf16 row
    (2, 4, 64, 1, 8, [0, 9, 70]),              # hd 64: of the bf16 row
    (4, 1, 128, 4, 1, [5, 0, 40]),             # page 1: of the bf16 row
])
def test_paged_layer_fp8_pool_matches_plain(dev, kv, g, hd, hg, page, lens,
                                            weights):
    """Kernel 9 on e4m3 pools with bf16 and int8 weights: against its twin
    (outputs at atol 2e-2 / rtol 2e-2), the appended codes within one code
    of the twin's and at least 99 % equal (the twin and the kernel round
    float32 rows that differ by a sum order; storing by the other append
    rule would move about one code in 30), every other byte untouched, a
    repeat bit-identical, each call counted as fp8."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.ops import quant as tq
    L, layer, hidden, B = 2, 1, 512, len(lens)
    cfg = LlamaConfig.tiny(rope_style="neox", head_dim=hd)
    cos_t, sin_t = model.rope_table(cfg, device=dev)
    kp, vp, table, lens_t = _fp8_pools(dev, L, kv, page, hd, lens, 5)
    wqkv, wo = _layer_weights(dev, L, hidden, kv, g, hd, hg, 20)
    if weights == "int8":
        lw = tq.quantize_llama_params(
            {"layers": {"wqkv_f": wqkv, "wo_f": wo}}, "int8",
            targets=("wqkv_f", "wo_f"))["layers"]
        wqkv, wo = lw["wqkv_f"], lw["wo_f"]
    x = _randn((B, hidden), dev, 30)
    res = _randn((B, hidden), dev, 31)
    rms = 1 + _randn((hidden,), dev, 32, 0.1)
    k0, k2, v2, kr, vr = kp.clone(), kp.clone(), vp.clone(), kp.clone(), \
        vp.clone()
    args = (wqkv, wo, table, lens_t, lens_t)
    tail = (layer, rms, 1e-5, cos_t, sin_t)
    kw = dict(group=g, rope_style="neox")
    before = pd.launches["llama_decoder_layer_paged_fp8"]
    out = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, *tail, **kw)
    again = pd.llama_decoder_layer_paged(x, res, *args, k2, v2, *tail, **kw)
    want = pd.llama_decoder_layer_paged_plain(x, res, *args, kr, vr, *tail,
                                              **kw)
    torch.cuda.synchronize()
    assert pd.launches["llama_decoder_layer_paged_fp8"] == before + 2
    for i in (0, 1):
        assert torch.equal(_bits(out[i]), _bits(again[i]))
        torch.testing.assert_close(out[i].float(), want[i].float(),
                                   atol=2e-2, rtol=2e-2)
    app = _appended_mask(kp, table, lens_t, layer)
    for a, b, a2 in ((kp, kr, k2), (vp, vr, v2)):
        assert torch.equal(a.view(torch.uint8), a2.view(torch.uint8))
        near, equal = _e4m3_one_code(a[app], b[app])
        assert near and equal >= 0.99, equal
        assert torch.equal(a.view(torch.uint8)[~app],
                           b.view(torch.uint8)[~app])
    assert torch.equal(kp.view(torch.uint8)[~app], k0.view(torch.uint8)[~app])


def test_sglang_entry_kernel_matches_plain(dev):
    """The page-1 sglang entry on the card against the same call on CPU
    tensors (the plain twin)."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    heads, hd, hidden, L, layer = 4, 128, 512, 2, 1
    lens = [5, 17, 1]
    total = sum(lens) + len(lens)
    num_pages = total + 7
    perm = np.random.RandomState(0).permutation(num_pages)[:total]
    indptr = torch.tensor(np.cumsum([0] + [n + 1 for n in lens]),
                          dtype=torch.int32)
    indices = torch.tensor(perm, dtype=torch.int32)
    a = dict(x=_randn((3, hidden), dev, 1), res=_randn((3, hidden), dev, 2),
             wqkv=_randn((3 * hidden, hidden), dev, 3, 0.05),
             wo=_randn((hidden, hidden), dev, 4, 0.05),
             kc=_randn((L, num_pages, hidden), dev, 5),
             vc=_randn((L, num_pages, hidden), dev, 6),
             rms=1 + _randn((hidden,), dev, 7, 0.1))
    angle = np.outer(np.arange(64), 0.3 * np.arange(hd // 2) + 0.1)
    cos_sin = torch.tensor(np.concatenate([np.cos(angle), np.sin(angle)], -1),
                           dtype=torch.float32)
    pos = torch.tensor(lens, dtype=torch.int32)
    outs = []
    for d in (dev, torch.device("cpu")):
        t = {k: v.to(d).clone() for k, v in a.items()}
        o = pd.llama_decoder_layer_batch_decode_sglang(
            t["x"], t["res"], t["wqkv"], t["wo"], indptr.to(d),
            indices.to(d), t["kc"], t["vc"], layer, t["rms"], 1e-5,
            pos.to(d), cos_sin.to(d), n_heads=heads, head_dim=hd)
        outs.append([x.cpu().float() for x in o])
    torch.cuda.synchronize()
    for got, want in zip(outs[0][:2], outs[1][:2]):
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    for got, want in zip(outs[0][2:], outs[1][2:]):
        torch.testing.assert_close(got, want, atol=0.05, rtol=0)


# -- DeepSeek: the MLA layers (kernels 11, 12) and the fused FFN (kernel 5) --

MLA_CAP, NOPE, ROPE = 320, 128, 64


def _mla_args(dev, heads, lora, seed=60, hidden=HIDDEN, layers=2,
              cap=MLA_CAP):
    n_proj = heads * (NOPE + ROPE) + lora + ROPE
    a = dict(
        x=_randn((1, hidden), dev, seed),
        wproj=_randn((layers, hidden, n_proj), dev, seed + 1, hidden ** -0.5),
        wuk=_randn((layers, heads, NOPE, lora), dev, seed + 2, NOPE ** -0.5),
        wuv=_randn((layers, heads, lora, NOPE), dev, seed + 3, lora ** -0.5),
        wo=_randn((layers, heads * NOPE, hidden), dev, seed + 4,
                  (heads * NOPE) ** -0.5),
        rms_in=1 + _randn((layers, hidden), dev, seed + 5, 0.1),
        rms_ckv=1 + _randn((layers, lora), dev, seed + 6, 0.1))
    width = -(-(lora + ROPE) // 128) * 128
    cache = _randn((layers, cap, width), dev, seed + 7)
    return a, cache


def _mla_rope(dev, pos, cap=MLA_CAP):
    from clusterfusion_tpu_torch.config import DeepSeekConfig
    from clusterfusion_tpu_torch.models import deepseek as ds
    c, s = ds.rope_table(DeepSeekConfig.tiny(max_seq_len=cap), device=dev)
    return c[pos], s[pos]


@pytest.mark.parametrize("pos", [0, 37, 300, MLA_CAP - 1])
@pytest.mark.parametrize("heads,lora", [(4, 128), (16, 512)])
@pytest.mark.parametrize("op", ["stack", "layer"])
def test_mla_kernels_match_plain(dev, op, heads, lora, pos):
    """Kernels 12 (the stack entry, layer 1, append at pos) and 11 (one
    layer, a 576-column cache, rows < pos) against their plain twin.  Rows
    at and above pos hold large garbage: the kernels read none of them."""
    from clusterfusion_tpu_torch.ops import deepseek_layer as dl
    a, cache = _mla_args(dev, heads, lora)
    cache[:, pos:] = _randn(cache[:, pos:].shape, dev, 70, 8.0)
    cos, sin = _mla_rope(dev, pos)
    mla = lora + ROPE
    dims = dict(n_heads=heads, nope_dim=NOPE, rope_dim=ROPE, lora_rank=lora)
    want, cur = dl.mla_decode_plain(
        a["x"], a["rms_in"][1], a["rms_ckv"][1], cos, sin, a["wproj"][1],
        a["wuk"][1], a["wuv"][1], a["wo"][1], cache[1], pos, eps=1e-6,
        softmax_scale=(NOPE + ROPE) ** -0.5,
        split=dl.MLA_SPLIT, **dims)
    key = {"stack": "deepseek_decoder_stack_layer",
           "layer": "deepseek_decoder_layer_fused"}[op]
    before = dl.launches[key]
    if op == "stack":
        ref = cache.clone()
        out, c2 = dl.deepseek_decoder_stack_layer(
            a["x"], a["wproj"], a["wuk"], a["wuv"], a["wo"], cache, pos, 1,
            a["rms_in"], a["rms_ckv"], cos, sin, **dims)
        torch.cuda.synchronize()
        assert c2 is cache
        torch.testing.assert_close(cache[1, pos, :mla].float(), cur,
                                   atol=0.05, rtol=0)
        assert not cache[1, pos, mla:].any()
        others = torch.ones(cache.shape[:2], dtype=torch.bool, device=dev)
        others[1, pos] = False
        assert torch.equal(cache[others], ref[others])
    else:
        c576 = cache[1, :, :mla].contiguous()
        out, ckv_new = dl.deepseek_decoder_layer_fused(
            a["x"], a["wproj"][1], a["wuk"][1], a["wuv"][1], a["wo"][1],
            c576, pos, a["rms_in"][1], a["rms_ckv"][1], cos, sin, **dims)
        torch.cuda.synchronize()
        torch.testing.assert_close(ckv_new[0].float(), cur, atol=0.05, rtol=0)
    assert dl.launches[key] == before + 1
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("pos", [0, 31, 32, 600, 4095])
def test_mla_stack_kernel_positions(dev, pos):
    """Kernel 12 at DeepSeek-V2-Lite's attention widths (16 heads, lora
    512) in a 4096-row cache, pos around the 32-row splits' edges and at
    both ends: against its twin, the appended row, the other rows
    untouched, 5 kernels a call (4 at pos 0), a repeat bit-identical."""
    from clusterfusion_tpu_torch.ops import deepseek_layer as dl
    a, cache = _mla_args(dev, 16, 512, seed=61, cap=4096)
    cos, sin = _mla_rope(dev, pos, cap=4096)
    cache[:, pos:] = _randn(cache[:, pos:].shape, dev, 71, 8.0)
    mla = 512 + ROPE
    dims = dict(n_heads=16, nope_dim=NOPE, rope_dim=ROPE, lora_rank=512)
    before = cache.clone()
    want, cur = dl.mla_decode_plain(
        a["x"], a["rms_in"][1], a["rms_ckv"][1], cos, sin, a["wproj"][1],
        a["wuk"][1], a["wuv"][1], a["wo"][1], before[1], pos, eps=1e-6,
        softmax_scale=(NOPE + ROPE) ** -0.5, split=dl.MLA_SPLIT, **dims)
    call = (a["x"], a["wproj"], a["wuk"], a["wuv"], a["wo"], cache, pos, 1,
            a["rms_in"], a["rms_ckv"], cos, sin)
    out, _ = dl.deepseek_decoder_stack_layer(*call, **dims)
    kernels = dl.last_kernels["deepseek_decoder_stack_layer"]
    again, _ = dl.deepseek_decoder_stack_layer(*call, **dims)
    torch.cuda.synchronize()
    assert kernels == (4 if pos == 0 else 5)
    assert torch.equal(_bits(out), _bits(again))
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(cache[1, pos, :mla].float(), cur, atol=0.05,
                               rtol=0)
    assert not cache[1, pos, mla:].any()
    others = torch.ones(cache.shape[:2], dtype=torch.bool, device=dev)
    others[1, pos] = False
    assert torch.equal(cache[others], before[others])


def test_mla_public_op_matches_oracle(dev):
    """The public op (kernel 11, every row attended) against the float32
    oracle at the JAX suite's limits (``tests/test_deepseek.py``)."""
    from clusterfusion_tpu_torch.ops import deepseek_layer as dl
    from clusterfusion_tpu_torch.ops.reference import \
        deepseek_decoder_layer_ref
    heads, lora, seq, hidden = 16, 512, 300, 1024
    g = torch.Generator().manual_seed(80)

    def r(*shape, s=0.1):
        return (torch.randn(shape, generator=g) * s).bfloat16().to(dev)

    angle = torch.rand(ROPE // 2, generator=g) * 3.0
    args = dict(input=r(1, hidden, s=1.0),
                weight_q_nope=r(heads * NOPE, hidden),
                weight_q_pe=r(heads * ROPE, hidden),
                weight_uk=r(heads, NOPE, lora), weight_kv_nope=r(lora, hidden),
                weight_k_pe=r(ROPE, hidden), weight_uv=r(heads, lora, NOPE),
                weight_o=r(hidden, heads * NOPE),
                ckv_cache=r(seq, lora + ROPE, s=1.0),
                rms_input_weight=r(hidden), rms_ckv_weight=r(lora),
                cos=angle.cos().to(dev), sin=angle.sin().to(dev))
    dims = dict(n_heads=heads, nope_dim=NOPE, rope_dim=ROPE, lora_rank=lora)
    out, ckv = dl.deepseek_decoder_layer(**args, **dims)
    want_out, want_ckv = deepseek_decoder_layer_ref(**args, **dims)
    torch.cuda.synchronize()
    assert (ckv.float() - want_ckv.float()).abs().max().item() < 5e-2
    err = (out.float() - want_out.float()).abs()
    assert err.max().item() < 1e-1 and err.mean().item() < 1e-2


@pytest.mark.parametrize("stacked,fuse_residual,f_pad", [
    (True, True, 1024), (True, False, 1024), (False, True, 1408),
    (True, True, 11264), (True, True, 1408), (True, False, 1400)])
def test_fused_ffn_kernel_matches_plain(dev, stacked, fuse_residual, f_pad):
    """Kernel 5 against its plain twin, one launch a call, the same bits on
    a repeat.  f_pad 1400 leaves the last column slice short (the slice
    width is a multiple of 8 near f_pad / SMs)."""
    from clusterfusion_tpu_torch.ops import ffn
    L, hidden = 2, 2048 if f_pad == 11264 else HIDDEN
    x = _randn((1, hidden), dev, 90)
    res = _randn((1, hidden), dev, 91)
    nw = 1 + _randn((L, hidden), dev, 92, 0.1)
    w13 = _randn((L, 2, hidden, f_pad), dev, 93, hidden ** -0.5)
    w2 = _randn((L, f_pad, hidden), dev, 94, f_pad ** -0.5)
    layer = 1
    if not stacked:
        nw, w13, w2, layer = nw[1:2], w13[1], w2[1], 0
    before = ffn.launches
    out, h = ffn.fused_ffn(x, res, nw, w13, w2, eps=1e-6,
                           fuse_residual=fuse_residual, layer_id=layer)
    torch.cuda.synchronize()
    assert ffn.launches == before + 1
    assert ffn.last_call_kernels == 1
    want, want_h = ffn.fused_ffn_plain(x, res, nw, w13, w2, eps=1e-6,
                                       fuse_residual=fuse_residual,
                                       layer_id=layer)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.equal(h, want_h)
    for _ in range(3):
        again, h2 = ffn.fused_ffn(x, res, nw, w13, w2, eps=1e-6,
                                  fuse_residual=fuse_residual, layer_id=layer)
        assert _same_bits(again, out) and _same_bits(h2, h)


@pytest.mark.parametrize("experts", [0, 4])
def test_deepseek_decode_step_launches_kernels(dev, experts):
    """decode_step(fused=True) on the card launches kernel 12 once per
    layer, and kernel 5 once per layer for a dense FFN; it agrees with the
    eager step (the JAX suite's limits)."""
    from clusterfusion_tpu_torch.config import DeepSeekConfig
    from clusterfusion_tpu_torch.models import deepseek as ds
    from clusterfusion_tpu_torch.ops import deepseek_layer as dl
    from clusterfusion_tpu_torch.ops import ffn
    cfg = DeepSeekConfig.tiny(n_experts=experts, moe_ffn_dim=256)
    p = ds.init_params(cfg, seed=3, device=dev)
    cache = ds.init_cache(cfg, device=dev)
    ds.prefill(p, cache, list(range(1, 40)), cfg)
    ce = cache.clone()
    n12, n5 = dl.launches["deepseek_decoder_stack_layer"], ffn.launches
    lf, _ = ds.decode_step(p, cache, 5, 39, cfg, fused=True)
    torch.cuda.synchronize()
    assert dl.launches["deepseek_decoder_stack_layer"] == n12 + cfg.n_layers
    assert ffn.launches == n5 + (0 if experts else cfg.n_layers)
    le, _ = ds.decode_step(p, ce, 5, 39, cfg, fused=False)
    scale = max(le.abs().max().item(), 1.0)
    assert (lf - le).abs().max().item() < 0.05 * scale
    mla = cfg.mla_head_dim
    torch.testing.assert_close(cache[:, 39, :mla].float(),
                               ce[:, 39, :mla].float(), atol=0.05, rtol=0)


@pytest.mark.parametrize("rows,hidden", [(1, 4096), (7, 512), (64, 128),
                                         (64, 8192), (1, 8192), (3, 12288),
                                         (2, 20480)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_norm_kernels_match_plain(dev, rows, hidden, dtype):
    """Kernels 1 and 2 against their plain twins (the float32 oracles):
    every output is rounded once, so they agree to one rounding of the
    output type (bf16: 2e-2; float32: 1e-5).  A thread holds one or two
    16-byte chunks of a row of up to 2048 chunks; 12288 runs the two-pass
    loop in float32 and 20480 in both types."""
    from clusterfusion_tpu_torch.ops import reference as ref
    rn = importlib.import_module("clusterfusion_tpu_torch.ops.rmsnorm")
    x = _randn((rows, hidden), dev, 50).to(dtype)
    r = _randn((rows, hidden), dev, 51).to(dtype)
    w = (1 + _randn((hidden,), dev, 52, 0.1)).to(dtype)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 \
        else dict(atol=1e-5, rtol=1e-5)
    before = dict(rn.launches)
    y = rn.rmsnorm(x, w)
    yf, hf = rn.fused_add_rmsnorm(x, r, w, 1e-5)
    torch.cuda.synchronize()
    assert rn.launches["rmsnorm"] == before["rmsnorm"] + 1
    assert rn.launches["fused_add_rmsnorm"] == before["fused_add_rmsnorm"] + 1
    torch.testing.assert_close(y.float(), ref.rmsnorm_ref(x, w).float(), **tol)
    want_y, want_h = ref.fused_add_rmsnorm_ref(x, r, w, 1e-5)
    torch.testing.assert_close(yf.float(), want_y.float(), **tol)
    torch.testing.assert_close(hf.float(), want_h.float(), **tol)
    assert y.dtype == yf.dtype == hf.dtype == dtype


@pytest.mark.parametrize("K,N", [(512, 384), (4096, 32000), (11264, 4096),
                                 (4096, 4224), (512, 8)])
def test_gemv_kernel_matches_plain(dev, K, N):
    """Kernel 3 against its plain twin; the products are exact in float32
    and only the order of the sums differs.  N 384 and 4224 end in a
    128-column tile; N 8 (one 8-column tile) goes to the C entry, since the
    wrapper takes multiples of 128 only.  Repeated calls give the same
    bits (the K chunks meet in a fixed order)."""
    gv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    from clusterfusion_tpu_torch.ops import _build
    x = _randn((1, K), dev, 53)
    w = _randn((K, N), dev, 54, K ** -0.5)

    def call():
        if N % 128 == 0:
            return gv.gemv(x, w)
        y = torch.full((1, N), float("nan"), device=dev)
        _build.check(_build.lib().cf_gemv(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, K, N,
            KernelConfig().gemv_threads,
            torch.cuda.current_stream(dev).cuda_stream), "cf_gemv")
        return y
    before = gv.launches
    y = call()
    torch.cuda.synchronize()
    assert gv.launches == before + (N % 128 == 0)
    torch.testing.assert_close(y, gv.gemv_plain(x, w), atol=1e-3, rtol=1e-3)
    for _ in range(3):
        assert torch.equal(call(), y)


# (M, K, N, mode, out): mode "plain" (y = x @ w) or "swiglu" (w is gate
# and up [2, K, N]; y = bf16(silu(x @ gate) * (x @ up)), the verify
# stack's gate/up product, whose output is the down product's x); out
# "f32" or "bf16"
ROWS_GEMV_CASES = [
    (2, 512, 384, "plain", "f32"), (5, 4096, 4224, "plain", "f32"),
    (8, 1000, 264, "plain", "f32"), (9, 4096, 12288, "plain", "f32"),
    (16, 11008, 4096, "plain", "f32"), (17, 512, 384, "plain", "f32"),
    (32, 777, 136, "plain", "f32"),
    # SwiGLU: the 7B gate/up at M 4 and 5, K off a box, N off a tile
    (5, 4096, 11264, "swiglu", "bf16"), (4, 4096, 11264, "swiglu", "bf16"),
    (9, 1000, 264, "swiglu", "bf16"), (3, 777, 136, "swiglu", "bf16"),
    # bf16 output (kernel 9's O-projection)
    (4, 4096, 4096, "plain", "bf16"), (8, 520, 136, "plain", "bf16"),
    # K ending inside a box and a stage of 32 rows, N in an 8-column tile
    (5, 4100, 392, "plain", "f32"), (4, 40, 8, "plain", "f32"),
    # the Llama-2-7B products at M 4 and 5: QKV, O, down, LM head
    (4, 4096, 12288, "plain", "f32"), (5, 4096, 12288, "plain", "f32"),
    (5, 4096, 4096, "plain", "f32"), (4, 11264, 4096, "plain", "f32"),
    (5, 11264, 4096, "plain", "f32"), (5, 4096, 32000, "plain", "f32"),
]


@pytest.mark.parametrize("M,K,N,mode,out", ROWS_GEMV_CASES,
                         ids=["-".join(map(str, c)) for c in ROWS_GEMV_CASES])
def test_ring_gemv_rows_match_plain(dev, M, K, N, mode, out):
    """The rows GEMV (kernels 8 and 9's products, M > 1; weights and x as
    TMA boxes, mma.sync, K chunks summed in a cluster) through its C entry:
    every row of y written (it starts NaN), against the float32 product of
    the same bf16 x, and the same bits on every call.  K off the 16-row mma
    step, the 32-row stage and a box, N ending in an 8-column tile, M past
    16 (two row chunks), the SwiGLU pair (gate and up in one product, act
    out) and a bf16 output are among the cases.  x rows sit a multiple of
    8 elements apart (TMA's 16-byte row pitch), garbage past K."""
    from clusterfusion_tpu_torch.ops import _build
    pair = mode == "swiglu"
    x_row = -(-K // 8) * 8
    xp = _randn((M, x_row), dev, 55)
    xp[:, K:] = float("nan")
    x = xp[:, :K]
    w = _randn((2, K, N) if pair else (K, N), dev, 56, K ** -0.5)

    def call():
        y = torch.full((M, N), float("nan"), device=dev)
        yb = torch.full((M, N), float("nan"), device=dev,
                        dtype=torch.bfloat16) if out == "bf16" else None
        _build.check(_build.lib().cf_gemv_rows(
            xp.data_ptr(), x_row, int(pair), w.data_ptr(), y.data_ptr(),
            None if yb is None else yb.data_ptr(), M, K, N,
            torch.cuda.current_stream(dev).cuda_stream), "cf_gemv_rows")
        return y if yb is None else yb
    y = call()
    torch.cuda.synchronize()
    if pair:
        g, u = x.float() @ w[0].float(), x.float() @ w[1].float()
        ref = g / (1 + torch.exp(-g)) * u
    else:
        ref = x.float() @ w.float()
    if out == "bf16":
        assert y.dtype == torch.bfloat16
        torch.testing.assert_close(y.float(), ref, atol=1e-2, rtol=1e-2)
    else:
        torch.testing.assert_close(y, ref, atol=1e-3, rtol=1e-3)
    for _ in range(3):
        assert torch.equal(call(), y)


# (n tokens, kv heads, group, seq, split): query rows group*n of 5 and 8
# (the 8-row instance), 9 and 17 (two tiles of up to 16)
SPLIT_ROWS_CASES = [(5, 2, 1, 600, 64), (9, 2, 1, 300, 128),
                    (17, 1, 1, 129, 64), (3, 2, 3, 64, 64), (8, 2, 1, 200, 32)]


@pytest.mark.parametrize("n,kv,g,seq,split", SPLIT_ROWS_CASES,
                         ids=["-".join(map(str, c)) for c in SPLIT_ROWS_CASES])
def test_verify_split_pass_matches_plain(dev, n, kv, g, seq, split):
    """Kernel 8's split pass (attn_split_kernel over the query rows of n
    tokens, row i*n + t being q head i at token t, roped with row t)
    against ``split_attention_plain``'s rounding (q rounded to bf16, p to
    bf16 against each split's own max): the partials merged in float32
    agree to 2e-3; rows at and above seq hold NaN and are never read."""
    from clusterfusion_tpu_torch.ops import _build
    from clusterfusion_tpu_torch.ops.stack_kernel import (
        _LOG2E, _rope, split_attention_plain)
    hd, cap, style = 128, 1024, "neox"
    rows = g * n
    qkv = _randn((n, kv * (g + 2) * hd), dev, 60).float()
    kc = _randn((kv, cap, hd), dev, 61)
    vc = _randn((kv, cap, hd), dev, 62)
    kc[:, seq:] = float("nan")
    vc[:, seq:] = float("nan")
    cos, sin = model.rope_rows(LlamaConfig.tiny(rope_style=style), 700, n, dev)
    ns = -(-seq // split)
    ml = torch.full((kv, ns, rows, 2), float("nan"), device=dev)
    acc = torch.full((kv, ns, rows, hd), float("nan"), device=dev)
    _build.check(_build.lib().cf_verify_split(
        qkv.data_ptr(), kc.data_ptr(), vc.data_ptr(), cos.contiguous().data_ptr(),
        sin.contiguous().data_ptr(), ml.data_ptr(), acc.data_ptr(), n, kv, g,
        hd, cap, seq, split, 1, 0, torch.cuda.current_stream(dev).cuda_stream),
        "cf_verify_split")
    torch.cuda.synchronize()
    m_all = ml[..., 0].amax(dim=1)                              # [kv, rows]
    e = torch.exp2(ml[..., 0] - m_all[:, None])
    l_k = (ml[..., 1] * e).sum(dim=1)
    o_k = (acc * e[..., None]).sum(dim=1) / l_k[..., None]
    # the twin: q [kv, rows, hd] in the kernel's row order, nothing folded
    raw = qkv.reshape(n, kv, g + 2, hd)[:, :, :g]               # [n, kv, g, hd]
    q = _rope(raw, cos[:, None, None], sin[:, None, None], style)
    q = (q * (_LOG2E / hd ** 0.5)).permute(1, 2, 0, 3).reshape(kv, rows, hd)
    zero = torch.zeros((kv, hd), device=dev)
    acc_p, _, l_p = split_attention_plain(q, zero, zero, kc, vc, seq, split,
                                          fold=False)
    torch.testing.assert_close(o_k, acc_p / l_p[..., None], atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("entry", ["cf_decoder_stack", "cf_verify_stack"])
def test_stack_c_entries_refuse_head_dim_256(dev, entry):
    """Kernel 8 takes hd 128 only and kernel 7 hd 128 and 64: called
    directly at hd 256 (Gemma-2's), each C entry returns
    cudaErrorInvalidValue (1) before it launches anything."""
    from clusterfusion_tpu_torch.ops import _build
    import ctypes
    lib = _build.lib()
    buf = torch.zeros(1 << 20, device=dev)
    p = [buf.data_ptr()] * 17
    n_launch = ctypes.c_int(-1)
    st = torch.cuda.current_stream(dev).cuda_stream
    # L, hidden, kv, hg, group, hd, cap, f_pad, vocab, pos, neox
    dims = [1, 512, 2, 1, 2, 256, 64, 512, 0, 8, 1]
    if entry == "cf_decoder_stack":
        err = lib.cf_decoder_stack(*p, *dims, 1e-5, 64, 256,
                                   ctypes.byref(n_launch), None, 0, st,
                                   *[None] * 5, 0, 0, 0, None, None, 0, 0)
    else:
        err = lib.cf_verify_stack(*p, 2, *dims, 1e-5, 64, 256,
                                  ctypes.byref(n_launch), st, *[None] * 5,
                                  0, 0, 0, None, None, 0, 0)
    torch.cuda.synchronize()
    assert err == 1
    assert n_launch.value == 0


LAYER_MODES = {
    # name: (seq, rope, fuse_residual, append_kv, emit_partials, fold)
    "full_append": (37, "gptj", True, True, False, 1),
    "full_neox": (300, "neox", True, False, False, 1),
    "no_residual": (37, "gptj", False, False, False, 1),
    "seq0_append": (0, "neox", True, True, False, 1),
    "partials_fold1": (300, "neox", True, False, True, 1),
    "partials_fold0": (37, "neox", True, False, True, 0),
    "partials_empty": (0, "neox", True, False, True, 0),
    # NaN in every row above seq (the appended row seq is written)
    "nan_full_append": (300, "gptj", True, True, False, 1),
    "nan_partials": (300, "neox", True, False, True, 1),
}


@pytest.mark.parametrize("mode", list(LAYER_MODES))
@pytest.mark.parametrize("n_heads,kv_heads,hg", [(4, 4, 2), (8, 2, 1)],
                         ids=["mha", "gqa"])
def test_decoder_layer_kernel_matches_plain(dev, n_heads, kv_heads, hg, mode):
    """Kernel 6 against its plain twin in each mode, stacked weights at
    layer 1, one launch a call and the same bits on a repeat.  Rows at and
    above seq hold large garbage (NaN in the nan_ modes): the kernel reads
    none of them and, with append_kv, overwrites row seq only."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    seq, style, fuse, append, partials, fold = LAYER_MODES[mode]
    g, a, kc, vc, _ = _stack_args(dev, n_heads, kv_heads, hg, seq)
    if mode.startswith("nan_"):
        kc[:, :, seq:] = float("nan")
        vc[:, :, seq:] = float("nan")
    else:
        kc[:, :, seq:] = _randn(kc[:, :, seq:].shape, dev, 60, 8.0)
        vc[:, :, seq:] = _randn(vc[:, :, seq:].shape, dev, 61, 8.0)
    res = _randn((1, HIDDEN), dev, 62)
    cos, sin = model.rope_row(LlamaConfig.tiny(rope_style=style), seq, dev)
    kw = dict(group=g, head_dim=HD, rope_style=style, fuse_residual=fuse,
              eps=1e-5, emit_partials=partials, fold_current=fold,
              append_kv=append)
    args = [a["x"], res, a["attn_norm"], cos, sin, a["wqkv_f"], a["wo_f"]]
    kp, vp = kc.clone(), vc.clone()
    before = dl.launches
    out = dl._fused_decoder_layer(*args, kc, vc, seq, 1, **kw)
    torch.cuda.synchronize()
    assert dl.launches == before + 1
    assert dl.last_call_kernels == 1
    again = dl._fused_decoder_layer(*args, kc.clone(), vc.clone(), seq, 1,
                                    **kw)
    for a, b in zip(out, again):
        assert (a is None and b is None) or _bits_equal(a, b)
    ref = dl._fused_decoder_layer_plain(*args, kp, vp, seq, 1, **kw)
    tol = dict(atol=2e-2, rtol=2e-2)
    if partials:
        torch.testing.assert_close(out[1], ref[1], **tol)        # m, l
        torch.testing.assert_close(out[0], ref[0], atol=5e-2, rtol=2e-2)
        if seq == 0 and not fold:
            assert torch.all(out[1][0] == -1e30) and torch.all(out[1][1] == 0)
            assert torch.all(out[0] == 0)
        res_i = 2
    else:
        torch.testing.assert_close(out[0].float(), ref[0].float(), **tol)
        res_i = 1
    if fuse:
        torch.testing.assert_close(out[res_i].float(), ref[res_i].float(),
                                   **tol)
    else:
        assert out[res_i] is None
    for i in (res_i + 1, res_i + 2):                              # k/v rows
        torch.testing.assert_close(out[i].float(), ref[i].float(), atol=0.05,
                                   rtol=0)
    torch.testing.assert_close(kc.float(), kp.float(), atol=0.05, rtol=0,
                               equal_nan=True)
    others = torch.ones(CAP, dtype=torch.bool, device=dev)
    if append:
        others[seq] = False
    assert _same_bits(kc[:, :, others], kp[:, :, others])
    assert _same_bits(vc[:, :, others], vp[:, :, others])


def _bits_equal(a, b):
    """Bit equality of two tensors of any type (NaN compares equal)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _layer_case(dev, hidden, n_heads, kv_heads, hg, hd, cap, seq, seed):
    """One layer's weights, a cache with large garbage at and above seq,
    and the token's inputs, for kernel 6 at any width."""
    g, G = n_heads // kv_heads, kv_heads // hg
    wqkv = _randn((G, hidden, hg * (g + 2) * hd), dev, seed, hidden ** -0.5)
    wo = _randn((G, hg * g * hd, hidden), dev, seed + 1, (g * hd) ** -0.5)
    kc = _randn((1, kv_heads, cap, hd), dev, seed + 2)
    vc = _randn((1, kv_heads, cap, hd), dev, seed + 3)
    kc[:, :, seq:] *= 8
    vc[:, :, seq:] *= 8
    x, res = _randn((1, hidden), dev, seed + 4), _randn((1, hidden), dev,
                                                        seed + 5)
    norm = 1 + _randn((hidden,), dev, seed + 6, 0.1)
    cfg = LlamaConfig.tiny(hidden_dim=hidden, n_heads=n_heads,
                           n_kv_heads=kv_heads, head_dim=hd,
                           rope_style="neox")
    cos, sin = model.rope_row(cfg, seq, dev)
    return g, (x, res, norm, cos, sin, wqkv, wo), kc, vc


@pytest.mark.parametrize("hidden,n_heads,kv_heads,hg,hd,cap,seq", [
    # Llama-2-7B's width: one cluster per kv head, 32 of them
    (4096, 32, 32, 4, 128, 1024, 0), (4096, 32, 32, 4, 128, 1024, 1),
    (4096, 32, 32, 4, 128, 1024, 600), (4096, 32, 32, 4, 128, 1024, 1023),
    # GQA at hd 64 (TinyLlama's heads: 32 query heads on 4 kv heads)
    (2048, 32, 4, 2, 64, 512, 0), (2048, 32, 4, 2, 64, 512, 37),
    (2048, 32, 4, 2, 64, 512, 511)],
    ids=["7b-0", "7b-1", "7b-600", "7b-cap-1", "gqa64-0", "gqa64-37",
         "gqa64-cap-1"])
def test_decoder_layer_kernel_widths(dev, hidden, n_heads, kv_heads, hg, hd,
                                     cap, seq):
    """Kernel 6 at full width, full mode with the append and partials mode
    folding the current token, against its plain twin (the modes test's
    tolerances), one launch a call and the same bits on a repeat."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    g, args, kc, vc = _layer_case(dev, hidden, n_heads, kv_heads, hg, hd,
                                  cap, seq, seed=100)
    kw = dict(group=g, head_dim=hd, rope_style="neox", fuse_residual=True,
              eps=1e-5)
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out = dl._fused_decoder_layer(*args, kk, vk, seq, 0, append_kv=True,
                                  **kw)
    assert dl.last_call_kernels == 1
    again = dl._fused_decoder_layer(*args, kk, vk, seq, 0, append_kv=True,
                                    **kw)
    ref = dl._fused_decoder_layer_plain(*args, kp, vp, seq, 0,
                                        append_kv=True, **kw)
    torch.cuda.synchronize()
    for i in range(4):
        assert _bits_equal(out[i], again[i])
    for i in (0, 1):
        torch.testing.assert_close(out[i].float(), ref[i].float(), atol=2e-2,
                                   rtol=2e-2)
    for i in (2, 3):
        torch.testing.assert_close(out[i].float(), ref[i].float(), atol=0.05,
                                   rtol=0)
    torch.testing.assert_close(kk.float(), kp.float(), atol=0.05, rtol=0)
    others = torch.ones(cap, dtype=torch.bool, device=dev)
    others[seq] = False
    assert _same_bits(kk[:, :, others], kc[:, :, others])
    assert _same_bits(vk[:, :, others], vc[:, :, others])
    pkw = dict(kw, emit_partials=True, fold_current=1)
    part = dl._fused_decoder_layer(*args, kc, vc, seq, 0, **pkw)
    part2 = dl._fused_decoder_layer(*args, kc, vc, seq, 0, **pkw)
    pref = dl._fused_decoder_layer_plain(*args, kc.clone(), vc.clone(), seq,
                                         0, **pkw)
    torch.cuda.synchronize()
    assert _bits_equal(part[0], part2[0]) and _bits_equal(part[1], part2[1])
    torch.testing.assert_close(part[1], pref[1], atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(part[0], pref[0], atol=5e-2, rtol=2e-2)


def test_decoder_layer_on_two_streams(dev):
    """Kernel 6 on two streams at once (each stream has its own fold
    counters and rows) gives the bits of the same calls made one after
    the other."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    g, args, kc, vc = _layer_case(dev, 2048, 16, 16, 4, 128, 512, 300, 110)
    kw = dict(group=g, head_dim=128, rope_style="neox", fuse_residual=True,
              eps=1e-5)
    xs = [_randn((1, 2048), dev, 120 + i) for i in range(2)]

    def call(x):
        return dl._fused_decoder_layer(x, *args[1:], kc, vc, 300, 0, **kw)
    serial = [call(x)[0] for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(8):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(call(xs[i])[0])
    torch.cuda.synchronize()
    for i in range(2):
        for o in outs[i]:
            assert _same_bits(o, serial[i])


@pytest.mark.parametrize("op", ["sglang", "meta"])
def test_decoder_layer_public_ops_match_plain(dev, op):
    """Both public ops over kernel 6 against the same ops on the CPU (their
    plain twins) at 32 heads of 128 over 37 rows."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    hidden, heads, hd, seq = 4096, 32, 128, 37
    t = dict(x=_randn((1, hidden), dev, 70), res=_randn((1, hidden), dev, 71),
             wqkv=_randn((3 * hidden, hidden), dev, 72, hidden ** -0.5),
             wo=_randn((hidden, hidden), dev, 73, hidden ** -0.5),
             k=_randn((seq, hidden), dev, 74), v=_randn((seq, hidden), dev, 75),
             rms=1 + _randn((hidden,), dev, 76, 0.1))
    ang = torch.linspace(0.1, 1.0, hd // 2, device=dev)
    before = dl.launches
    if op == "sglang":
        def call(d):
            return dl.llama_decoder_layer_sglang(
                d["x"], d["res"], d["wqkv"], d["wo"], d["k"], d["v"],
                d["rms"], 1e-5, d["cos"], d["sin"])
        t.update(cos=ang.cos(), sin=ang.sin())
    else:
        def call(d):
            return dl.llama_decoder_layer(d["x"], d["wqkv"], d["wo"], d["k"],
                                          d["v"], d["rms"], d["cos"],
                                          d["sin"])
        t.update(cos=ang.repeat_interleave(2).cos()[None],
                 sin=ang.repeat_interleave(2).sin()[None])
    got = call(t)
    torch.cuda.synchronize()
    assert dl.launches == before + 1
    want = call({k: v.cpu() for k, v in t.items()})
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float().cpu(), b.float(), atol=5e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("op", ["sglang", "meta", "paged_sglang"])
def test_public_layer_ops_match_the_oracles(dev, op):
    """The public ops over kernels 6 and 9 on the card against the float32
    layer oracles of ``ops/reference.py`` on the same inputs (kernel 6 at
    32 heads of 128 over 37 rows, kernel 9's sglang entry at B 3 over
    shuffled pool rows): outputs within 1e-1 and a mean error under 1e-2,
    residual at 2e-2, new rows at 5e-2 (``tests/test_torch_layer.py``'s
    tolerances against the JAX ops; the kernels round to bf16 where the
    oracles do not)."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.ops import reference as ref
    hidden, heads, hd, seq = 4096, 32, 128, 37
    ang = torch.linspace(0.1, 1.0, hd // 2, device=dev)
    t = dict(x=_randn((1, hidden), dev, 170), res=_randn((1, hidden), dev, 171),
             wqkv=_randn((3 * hidden, hidden), dev, 172, hidden ** -0.5),
             wo=_randn((hidden, hidden), dev, 173, hidden ** -0.5),
             k=_randn((seq, hidden), dev, 174), v=_randn((seq, hidden), dev, 175),
             rms=1 + _randn((hidden,), dev, 176, 0.1))
    if op == "sglang":
        args = (t["x"], t["res"], t["wqkv"], t["wo"], t["k"], t["v"],
                t["rms"], 1e-5, ang.cos(), ang.sin())
        got = dl.llama_decoder_layer_sglang(*args)
        want = ref.llama_decoder_layer_sglang_ref(*args, n_heads=heads,
                                                  head_dim=hd)
        checks = ((1, 2e-2), (2, 5e-2), (3, 5e-2))
    elif op == "meta":
        cos = ang.repeat_interleave(2).cos()[None]
        sin = ang.repeat_interleave(2).sin()[None]
        args = (t["x"], t["wqkv"], t["wo"], t["k"], t["v"], t["rms"], cos,
                sin)
        got = dl.llama_decoder_layer(*args)
        want = ref.llama_decoder_layer_ref(*args, n_heads=heads, head_dim=hd)
        checks = ((1, 5e-2), (2, 5e-2))
    else:
        hidden, heads = 512, 4
        lens = [5, 140, 1]
        total = sum(lens) + len(lens)
        g = torch.Generator().manual_seed(177)
        indices = torch.randperm(total + 7, generator=g)[:total].int().to(dev)
        indptr = torch.tensor(np.cumsum([0] + [n + 1 for n in lens]),
                              dtype=torch.int32, device=dev)
        pos = torch.tensor(lens, dtype=torch.int32, device=dev)
        kc = _randn((2, total + 7, hidden), dev, 178)
        vc = _randn((2, total + 7, hidden), dev, 179)
        angle = torch.outer(torch.arange(160, device=dev).float(),
                            0.3 * torch.arange(hd // 2, device=dev) + 0.1)
        cos_sin = torch.cat([angle.cos(), angle.sin()], -1)
        x, res = _randn((3, hidden), dev, 180), _randn((3, hidden), dev, 181)
        wq = _randn((3 * hidden, hidden), dev, 182, 0.05)
        wo = _randn((hidden, hidden), dev, 183, 0.05)
        rms = 1 + _randn((hidden,), dev, 184, 0.1)
        want = ref.llama_decoder_layer_batch_paged_ref(
            x, res, wq, wo, indptr, indices, kc[1], vc[1], rms, 1e-5, pos,
            cos_sin, n_heads=heads, head_dim=hd)
        got = pd.llama_decoder_layer_batch_decode_sglang(
            x, res, wq, wo, indptr, indices, kc, vc, 1, rms, 1e-5, pos,
            cos_sin, n_heads=heads, head_dim=hd)
        new = indices[indptr[1:].long() - 1].long()
        got = (got[0], got[1], kc[1, new], vc[1, new])
        want = (want[0], want[1], want[2][new], want[3][new])
        checks = ((1, 2e-2), (2, 5e-2), (3, 5e-2))
    torch.cuda.synchronize()
    for i, tol in checks:
        err = (got[i].float() - want[i].float()).abs().max().item()
        assert err < tol, (i, err)
    err = (got[0].float() - want[0].float()).abs()
    assert err.max().item() < 1e-1 and err.mean().item() < 1e-2


@pytest.mark.parametrize("which", ["tp", "sp"])
def test_sharded_steps_on_card_one_rank(dev, tmp_path, which):
    """The tp and sp steps in a one-process group on the card against
    decode_step(fused=True): kernel 6 once per layer, kernel 2 once per
    layer in the tp step (the sp step normalises plain, as in JAX)."""
    import torch.distributed as dist

    from clusterfusion_tpu_torch.config import MeshConfig
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    rn = importlib.import_module("clusterfusion_tpu_torch.ops.rmsnorm")
    from clusterfusion_tpu_torch import parallel as par
    cfg = LlamaConfig.tiny(n_kv_heads=2, max_seq_len=64)
    p = model.init_params(cfg, seed=5, device=dev)
    kc, vc = model.init_cache(cfg, device=dev)
    model.prefill(p, kc, vc, list(range(1, 21)), cfg)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = par.build_mesh(MeshConfig())
        make = par.make_sharded_decode_step if which == "tp" \
            else par.make_sp_sharded_decode_step
        step = make(cfg, mesh)
        kr, vr = kc.clone(), vc.clone()
        k6, k2 = dl.launches, rn.launches["fused_add_rmsnorm"]
        lg, kc, vc = step(par.shard_params(p, cfg, mesh), kc, vc, 9, 20)
        torch.cuda.synchronize()
        assert dl.launches - k6 == cfg.n_layers
        assert rn.launches["fused_add_rmsnorm"] - k2 == \
            (cfg.n_layers if which == "tp" else 0)
    finally:
        dist.destroy_process_group()
    ref, kr, vr = model.decode_step(p, kr, vr, 9, 20, cfg, fused=True)
    scale = max(ref.abs().max().item(), 1.0)
    assert (lg - ref).abs().max().item() < 0.05 * scale
    torch.testing.assert_close(kc.float(), kr.float(), atol=0.05, rtol=0)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_loopback_collectives_match_plain(dev, n):
    """Kernels 13 and 14 for n virtual ranks on one card, 64 calls with
    fresh inputs (a stale bank would show): every rank's sum has the bits
    of the plain twin's rank-order adds, the gather equals the plain
    concatenation, and the error word stays 0."""
    from clusterfusion_tpu_torch.parallel import collective as col
    lb = col.LoopbackComm(n, dev)
    try:
        gen = torch.Generator(device=dev).manual_seed(n)
        r0, g0 = col.launches["all_reduce"], col.launches["all_gather"]
        for call in range(64):
            relu = call % 2 == 1
            xs = [torch.randn((1, 4096), generator=gen, device=dev) * 1e3
                  for _ in range(n)]
            got = lb.all_reduce(xs, relu=relu)
            want = col.all_reduce_loopback_plain(xs, relu)[0]
            for g in got:
                assert torch.equal(g.view(torch.int32), want.view(torch.int32))
            shards = [torch.randn(32000 // n, generator=gen, device=dev)
                      for _ in range(n)]
            want = col.all_gather_loopback_plain(shards)[0]
            for g in lb.all_gather(shards):
                assert torch.equal(g, want)
        lb.check()
        assert lb.ranks[0].error() == 0
        assert col.launches["all_reduce"] == r0 + 64
        assert col.launches["all_gather"] == g0 + 64
    finally:
        lb.close()


@pytest.mark.parametrize("n", [2, 4])
def test_per_rank_collectives_on_streams(dev, n):
    """Each virtual rank launches its own part on its own stream (as a
    rank's step does); the parts meet on the card.  The first round runs
    through the one-launch loopback entry, so that the wrappers' padding
    kernels are loaded before any rank spins (see ``LoopbackComm``)."""
    from clusterfusion_tpu_torch.parallel import collective as col
    lb = col.LoopbackComm(n, dev)
    try:
        gen = torch.Generator(device=dev).manual_seed(10 + n)
        streams = [torch.cuda.Stream(dev) for _ in range(n)]
        lb.all_reduce([torch.randn(4096 + 3, device=dev) for _ in range(n)])
        lb.all_gather([torch.randn((5, 7), device=dev).bfloat16()
                       for _ in range(n)])
        for call in range(8):
            xs = [torch.randn(4096 + 3, generator=gen, device=dev)
                  for _ in range(n)]
            shards = [torch.randn((5, 7), generator=gen, device=dev)
                      .bfloat16() for _ in range(n)]
            sums, gathers = [], []
            for r in range(n):
                streams[r].wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(streams[r]):
                    sums.append(lb.ranks[r].all_reduce(xs[r]))
                    gathers.append(lb.ranks[r].all_gather(shards[r]))
            torch.cuda.synchronize(dev)
            want = col.all_reduce_loopback_plain(xs)[0]
            for s, g in zip(sums, gathers):
                assert torch.equal(s.view(torch.int32), want.view(torch.int32))
                assert torch.equal(g, torch.cat(shards))
        lb.check()
    finally:
        lb.close()


def test_collective_wait_is_bounded(dev):
    """A rank whose peer never comes gives up after about 2 s and the
    error word names both; the call raises instead of hanging."""
    from clusterfusion_tpu_torch.parallel import collective as col
    lb = col.LoopbackComm(2, dev)
    try:
        lb.ranks[0].all_reduce(torch.ones(64, device=dev))
        with pytest.raises(RuntimeError, match="rank 0 waited"):
            lb.check()
        assert lb.ranks[0].error() == 0x10000 | 1
    finally:
        lb.close()


MODE5_SPECS = dict(wqkv_f=(None, "tp", None, None),
                   wo_f=(None, "tp", None, None),
                   w13=(None, None, None, "tp"), w2=(None, "tp", None))


def _mode5_shards(a, kc, vc, meshes):
    from clusterfusion_tpu_torch.parallel.sharding import shard_tensor
    shards = [{k: shard_tensor(a[k], s, m) for k, s in MODE5_SPECS.items()}
              for m in meshes]
    caches = [(shard_tensor(kc, (None, "tp", None, None), m),
               shard_tensor(vc, (None, "tp", None, None), m))
              for m in meshes]
    return shards, caches


def _mode5_step(a, shards, caches, meshes, streams, cos, sin, pos, kw,
                ranks=None, head=None, gather=False):
    """Each virtual rank's mode-5 step on its own stream; the kernels each
    step launched.  ``head``: (final_norm, [each rank's LM-head shard]);
    ``gather``: the logits gathered inside the stack (the tp step's form,
    ``_fused_decoder_stack_gathered``)."""
    dev = a["x"].device
    fn = sk._fused_decoder_stack_gathered if gather else sk.fused_decoder_stack
    outs, kernels = [], []
    for r in (range(len(meshes)) if ranks is None else ranks):
        streams[r].wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(streams[r]):
            sh = shards[r]
            extra = {} if head is None else dict(final_norm=head[0],
                                                 lm_head=head[1][r])
            outs.append(fn(
                a["x"], a["attn_norm"], a["ffn_norm"], cos, sin,
                sh["wqkv_f"], sh["wo_f"], sh["w13"], sh["w2"], *caches[r], pos,
                reduce_axis="tp", mesh=meshes[r], **kw, **extra))
            kernels.append(sk.last_step_kernels)
    for s in streams:
        torch.cuda.current_stream(dev).wait_stream(s)
    return outs, kernels


def _mode5_against_unsharded(dev, n_heads, kv_heads, hg, hidden=HIDDEN):
    """Mode 5 at tp 2 on one card against kernel 7's unsharded step, called
    twice (the second call must repeat the first's bits)."""
    from clusterfusion_tpu_torch.parallel import collective as col
    pos, tp = 37, 2
    g, a, kc, vc, _ = _stack_args(dev, n_heads, kv_heads, hg, pos,
                                  hidden=hidden)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5)
    kr, vr = kc.clone(), vc.clone()
    ref = sk.fused_decoder_stack(a["x"], a["attn_norm"], a["ffn_norm"], cos,
                                 sin, a["wqkv_f"], a["wo_f"], a["w13"],
                                 a["w2"], kr, vr, pos, **kw)
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards, caches = _mode5_shards(a, kc, vc, meshes)
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        r0 = col.launches["all_reduce"]
        outs, kernels = _mode5_step(a, shards, caches, meshes, streams, cos,
                                    sin, pos, kw)
        again, _ = _mode5_step(a, shards, caches, meshes, streams, cos, sin,
                               pos, kw)
        torch.cuda.synchronize(dev)
        lb.check()
        # 8 kernels a layer and the final norm, as at tp 1: no reduce has a
        # launch of its own
        assert kernels == [8 * L + 1] * tp
        assert col.launches["all_reduce"] == r0 + 2 * 2 * L * tp
    finally:
        lb.close()
    for first, second in zip(outs, again):
        assert torch.equal(first[0], second[0])
        assert torch.equal(first[1], second[1])
    for r, (xo, ro, k, v) in enumerate(outs):
        assert torch.equal(xo, outs[0][0]) and torch.equal(ro, outs[0][1])
        torch.testing.assert_close(xo.float(), ref[0].float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(ro.float(), ref[1].float(), atol=2e-2,
                                   rtol=2e-2)
        heads = slice(r * kv_heads // tp, (r + 1) * kv_heads // tp)
        for got, full, before in ((k, kr, kc), (v, vr, vc)):
            torch.testing.assert_close(got[:, :, pos].float(),
                                       full[:, heads, pos].float(), atol=0.05,
                                       rtol=0)
            others = torch.ones(CAP, dtype=torch.bool, device=dev)
            others[pos] = False
            assert torch.equal(got[:, :, others], before[:, heads][:, :, others])


@pytest.mark.parametrize("n_heads,kv_heads,hg", [(4, 4, 2), (8, 2, 1)],
                         ids=["mha", "gqa"])
def test_stack_mode5_loopback_matches_unsharded(dev, n_heads, kv_heads, hg):
    """Mode 5 (reduce_axis) at tp 2 on one card: two virtual ranks, each on
    its own stream with its shards of the weights and caches, against
    kernel 7's unsharded step.  Both ranks' x_out and residual have the
    same bits, a second call repeats them, each rank's appended rows are
    its heads' rows, and the step has 8L+1 kernels (the reduces run inside
    the products and the norms)."""
    _mode5_against_unsharded(dev, n_heads, kv_heads, hg)


@pytest.mark.parametrize("hidden", [8192, 8448], ids=["32_tiles", "33_tiles"])
def test_stack_mode5_flag_columns(dev, hidden):
    """Mode 5's reduces take a row of at most 8192 (its norm holds the row
    in registers, one flag column per 256-column tile): hidden 8192
    (llama2_70b's) runs and matches the unsharded step; 8448 is refused
    before any launch."""
    if hidden <= 8192:
        _mode5_against_unsharded(dev, 4, 4, 2, hidden=hidden)
        return
    from clusterfusion_tpu_torch.parallel import collective as col
    pos = 37
    g, a, kc, vc, _ = _stack_args(dev, 4, 4, 2, pos, hidden=hidden)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5)
    lb = col.LoopbackComm(2, dev)
    try:
        meshes = [lb.mesh(r) for r in range(2)]
        shards, caches = _mode5_shards(a, kc, vc, meshes)
        streams = [torch.cuda.Stream(dev) for _ in range(2)]
        with pytest.raises(RuntimeError, match="invalid argument"):
            _mode5_step(a, shards, caches, meshes, streams, cos, sin, pos, kw,
                        ranks=[0])
        torch.cuda.synchronize(dev)
        assert lb.ranks[0].error() == 0
    finally:
        lb.close()


# the gathered test's vocab: shards of 576 columns at tp 2 (three tiles of
# 256, the last a quarter full; not a multiple of 128), 1152 in all (a
# 128-aligned block of 384, so kernel 7 takes it unsharded)
GATHER_VOCAB = 1152


def _gather_setup(dev, pos, shard):
    """Mode-5 inputs at tp 2 and an LM head of 2 * ``shard`` columns: (g,
    a, kc, vc, final_norm, lm_head, kw, cos, sin)."""
    g, a, kc, vc, lm = _stack_args(dev, 4, 4, 2, pos)
    lm_head = _randn((HIDDEN, 2 * shard), dev, 11, HIDDEN ** -0.5)
    cos, sin = model.rope_row(LlamaConfig.tiny(), pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5)
    return a, kc, vc, lm["final_norm"], lm_head, kw, cos, sin


def test_stack_mode5_gathered_logits(dev):
    """The tp step's tail inside the stack at tp 2 on one card (mode 5
    with each rank's LM-head shard, ``_fused_decoder_stack_gathered``):
    8L+3 kernels a rank, one in-stack gather a rank and no standalone
    launch; both ranks' logits bit-identical and repeated bit for bit by a
    second call; within 1e-2 of the largest logit of the old tail (each
    rank's plain final norm over its bf16 x_out + residual, ``torch.mm``
    of its shard, kernel 14 standalone) and of kernel 7's unsharded LM
    head.  The old tail normalises the bf16-rounded pair, the stack the
    float32 pair, so the bits differ."""
    from clusterfusion_tpu_torch.ops.reference import fused_add_rmsnorm_ref
    from clusterfusion_tpu_torch.parallel import collective as col
    pos, tp, shard = 37, 2, GATHER_VOCAB // 2
    a, kc, vc, fnorm, lm_head, kw, cos, sin = _gather_setup(dev, pos, shard)
    ref, _, _, _ = sk.fused_decoder_stack(
        a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, a["wqkv_f"],
        a["wo_f"], a["w13"], a["w2"], kc.clone(), vc.clone(), pos,
        final_norm=fnorm, lm_head=lm_head, **kw)
    heads = [lm_head[:, r * shard:(r + 1) * shard].contiguous()
             for r in range(tp)]
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards, caches = _mode5_shards(a, kc, vc, meshes)
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        outs, _ = _mode5_step(a, shards, caches, meshes, streams, cos, sin,
                              pos, kw)
        torch.cuda.synchronize(dev)
        parts = []
        for r, (xo, ro, _, _) in enumerate(outs):
            xn, _ = fused_add_rmsnorm_ref(xo, ro, fnorm, 1e-5)
            parts.append(model._lm_logits(xn[0], heads[r]))
        old = lb.all_gather(parts)[0]
        g0, s0 = col.launches["all_gather"], col.standalone["all_gather"]
        first, kernels = _mode5_step(a, shards, caches, meshes, streams, cos,
                                     sin, pos, kw, head=(fnorm, heads),
                                     gather=True)
        second, _ = _mode5_step(a, shards, caches, meshes, streams, cos, sin,
                                pos, kw, head=(fnorm, heads), gather=True)
        torch.cuda.synchronize(dev)
        lb.check()
        assert kernels == [8 * L + 3] * tp
        assert col.launches["all_gather"] == g0 + 2 * tp
        assert col.standalone["all_gather"] == s0
    finally:
        lb.close()
    got = [o[0] for o in first]
    assert got[0].shape == (1, GATHER_VOCAB)
    for r in range(tp):
        assert torch.equal(got[r].view(torch.int32), got[0].view(torch.int32))
        assert torch.equal(second[r][0].view(torch.int32),
                           got[0].view(torch.int32))
    scale = ref.abs().max().item()
    assert (got[0][0] - old).abs().max().item() <= 1e-2 * scale
    assert (got[0] - ref).abs().max().item() <= 1e-2 * scale


@pytest.mark.parametrize("shard", [65536, 65544],
                         ids=["256_tiles", "257_tiles"])
def test_stack_mode5_gather_flag_columns(dev, shard):
    """The gather publishes one flag column per 256-column tile of the
    vocab shard, and a rank's buffer has 256: a shard of 65536 columns
    runs, both ranks' logits bit-identical and each rank's part within
    1e-3 of the largest logit of its own shard's product (the public
    mode-5 call with the LM head, whose K chunks may be cut otherwise);
    65544 needs 257 and is refused before any launch."""
    from clusterfusion_tpu_torch.parallel import collective as col
    pos, tp = 37, 2
    a, kc, vc, fnorm, lm_head, kw, cos, sin = _gather_setup(dev, pos, shard)
    heads = [lm_head[:, r * shard:(r + 1) * shard].contiguous()
             for r in range(tp)]
    del lm_head
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards, caches = _mode5_shards(a, kc, vc, meshes)
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        if shard > 65536:
            with pytest.raises(RuntimeError, match="invalid argument"):
                _mode5_step(a, shards, caches, meshes, streams, cos, sin,
                            pos, kw, ranks=[0], head=(fnorm, heads),
                            gather=True)
            torch.cuda.synchronize(dev)
            assert lb.ranks[0].error() == 0
            return
        local, _ = _mode5_step(a, shards, caches, meshes, streams, cos, sin,
                               pos, kw, head=(fnorm, heads))
        got, kernels = _mode5_step(a, shards, caches, meshes, streams, cos,
                                   sin, pos, kw, head=(fnorm, heads),
                                   gather=True)
        torch.cuda.synchronize(dev)
        lb.check()
    finally:
        lb.close()
    assert kernels == [8 * L + 3] * tp
    assert torch.equal(got[1][0].view(torch.int32), got[0][0].view(torch.int32))
    want = torch.cat([o[0] for o in local], dim=1)
    scale = want.abs().max().item()
    assert (got[0][0] - want).abs().max().item() <= 1e-3 * scale


def test_stack_mode5_wait_is_bounded(dev):
    """A mode-5 step on virtual rank 0 whose peer never runs: its first
    reduce gives up after about 2 s with both ranks in the error word, the
    later ones give up at once, and the step raises instead of hanging."""
    import time

    from clusterfusion_tpu_torch.parallel import collective as col
    pos = 37
    g, a, kc, vc, _ = _stack_args(dev, 4, 4, 2, pos)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5)
    lb = col.LoopbackComm(2, dev)
    try:
        meshes = [lb.mesh(r) for r in range(2)]
        shards, caches = _mode5_shards(a, kc, vc, meshes)
        streams = [torch.cuda.Stream(dev) for _ in range(2)]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError,
                           match="rank 0 waited more than 2 s for the flag "
                                 "of rank 1"):
            _mode5_step(a, shards, caches, meshes, streams, cos, sin, pos, kw,
                        ranks=[0])
            lb.check()
        waited = time.perf_counter() - t0
        assert lb.ranks[0].error() == 0x10000 | 1
        assert 1.9 < waited < 4.0
    finally:
        lb.close()


# -- int8 weights on the rows GEMV (kernels 8 and 9, int8 serving) ------------


def _int8_codes(dev, nmat, K, N, seed):
    """Random int8 codes over the whole range and positive scales."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randint(-128, 128, (nmat, K, N), generator=g, dtype=torch.int8)
    s = torch.rand((nmat, N), generator=g) * 1e-2 + 1e-3
    return q.to(dev), s.to(dev)


@pytest.mark.parametrize("M", [1, 2, 5, 8, 9, 16, 20])
@pytest.mark.parametrize("K,N,nmat,kg", [(512, 256, 1, 0), (1024, 272, 3, 0),
                                         (4096, 512, 1, 1024),
                                         (2048, 4096, 1, 0)],
                         ids=["one", "three_ragged", "groups", "wide"])
@pytest.mark.parametrize("bf16_out", [False, True], ids=["f32", "bf16"])
def test_rows_gemv8_matches_plain(dev, M, K, N, nmat, kg, bf16_out):
    """The GEMVs' int8 instances (the rows GEMV's from 2 rows, the one-row
    GEMV's at 1) against their plain twin: x_bf16 @ bf16(code) in float32,
    the per-column scale after the sum (kg 0) or each group's scale on its
    partial (kg > 0), the same bits on a repeat.  The codes take every
    value of int8, -128 included."""
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    q, s = _int8_codes(dev, nmat, K, N, 70 + M)
    if kg:
        s = s.new_empty((K // kg, N)).uniform_(1e-3, 1e-2)
    x = _randn((M, K), dev, 71)
    before = gemv.int8_launches
    y = gemv._gemv_int8(x, q, s, kg=kg, bf16_out=bf16_out)
    again = gemv._gemv_int8(x, q, s, kg=kg, bf16_out=bf16_out)
    torch.cuda.synchronize()
    assert gemv.int8_launches == before + 2
    ref = gemv._gemv_int8_plain(x.cpu(), q.cpu(), s.cpu(), kg)
    assert y.shape == (M, nmat * N) and torch.equal(y, again)
    if bf16_out:
        ref = ref.to(torch.bfloat16)
    torch.testing.assert_close(y.float().cpu(), ref.float(),
                               atol=1e-3 * ref.abs().max().item(), rtol=1e-2)


def test_rows_gemv8_scales_each_column_and_group(dev):
    """Scale placement: a one-hot x row picks one k row of the codes, so
    each output is code * scale exactly, column by column and (kg > 0) from
    the scale row of that k row's group."""
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    K, N, kg = 512, 512, 128
    q, _ = _int8_codes(dev, 1, K, N, 80)
    s = torch.arange(1, K // kg * N + 1, dtype=torch.float32,
                     device=dev).reshape(K // kg, N) * 1e-3
    rows = [3, 130, 300, 511]
    x = torch.zeros((len(rows), K), dtype=torch.bfloat16, device=dev)
    x[torch.arange(len(rows)), rows] = 1
    y = gemv._gemv_int8(x, q, s, kg=kg)
    want = q[0, rows].float() * s[[r // kg for r in rows]]
    assert torch.equal(y, want)
    y1 = gemv._gemv_int8(x, q, s[:1])
    assert torch.equal(y1, q[0, rows].float() * s[0])


@pytest.mark.parametrize("M", [1, 4, 9])
def test_ffn8_matches_plain(dev, M):
    """The int8 FFN (the rows GEMV's pair form, gate and up each scaled
    before the SwiGLU, then the down product scaled after its sum; at one
    row the one-row GEMV's int8 instances) against its plain twin."""
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    from clusterfusion_tpu_torch.ops.quant import quantize_int8
    hidden, f = 512, 1024
    w13 = quantize_int8(_randn((2, hidden, f), dev, 90, hidden ** -0.5), -2)
    w2 = quantize_int8(_randn((f, hidden), dev, 91, f ** -0.5), -2)
    x = _randn((M, hidden), dev, 92)
    before = gemv.ffn8_launches
    out = gemv._ffn_int8(x, w13.q, w13.s, w2.q, w2.s)
    again = gemv._ffn_int8(x, w13.q, w13.s, w2.q, w2.s)
    torch.cuda.synchronize()
    assert gemv.ffn8_launches == before + 2
    ref = gemv._ffn_int8_plain(x.cpu(), w13.q.cpu(), w13.s.cpu().reshape(2, f),
                               w2.q.cpu(), w2.s.cpu().reshape(hidden))
    assert torch.equal(_bits(out), _bits(again))
    torch.testing.assert_close(out.float().cpu(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("n,pos", [(1, 37), (2, 0), (5, 37), (9, 300),
                                   (17, 100)])
@pytest.mark.parametrize("lm_kind", [None, "bf16", "int8"],
                         ids=["no_lm", "lm_bf16", "lm_int8"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", INT8_SHAPES,
                         ids=["hg4_G2", "hg8_G2", "hg8_G1"])
def test_verify_int8_kernel_matches_plain(dev, n_heads, kv_heads, hg,
                                          lm_kind, n, pos):
    """Kernel 8's int8 mode against its plain twin at phase 9's limits,
    rows at and above pos holding large garbage, the other rows untouched,
    and the same bits on a repeat."""
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos, seed=50)
    kc[:, :, pos:] = _randn(kc[:, :, pos:].shape, dev, 51, 8.0)
    vc[:, :, pos:] = _randn(vc[:, :, pos:].shape, dev, 52, 8.0)
    w, head = _int8_stack(a, lm, lm_kind)
    x = _randn((n, HIDDEN), dev, 53)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_rows(cfg, pos, n, dev)
    kw = dict(group=g, head_dim=HD, rope_style=cfg.rope_style, eps=1e-5,
              **head)
    args = [x, a["attn_norm"], a["ffn_norm"], cos, sin, w["wqkv_f"],
            w["wo_f"], w["w13"], w["w2"]]
    k0, v0 = kc.clone(), vc.clone()
    kp, vp = kc.clone(), vc.clone()
    k2, v2 = kc.clone(), vc.clone()
    before = (sv.launches, sv.int8_launches)
    out = sv.fused_verify_stack(*args, kc, vc, pos, **kw)
    again = sv.fused_verify_stack(*args, k2, v2, pos, **kw)
    torch.cuda.synchronize()
    assert (sv.launches, sv.int8_launches) == (before[0] + 2, before[1] + 2)
    assert sv.last_step_kernels == 8 * L - (pos == 0) * L + 1 + bool(head)
    for got, want in zip((*again[:2], k2, v2), (*out[:2], kc, vc)):
        assert torch.equal(got, want)
    ref = sv.fused_verify_stack_plain(*args, kp, vp, pos, **kw)
    if head:
        err = (out[0] - ref[0]).abs().max().item()
        assert err <= 2e-2 * ref[0].abs().max().item(), err
    else:
        torch.testing.assert_close(out[0].float(), ref[0].float(),
                                   atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out[1].float(), ref[1].float(), atol=2e-2,
                               rtol=2e-2)
    new = slice(pos, pos + n)
    for got, want in ((kc, kp), (vc, vp)):
        torch.testing.assert_close(got[:, :, new].float(),
                                   want[:, :, new].float(), atol=0.05, rtol=0)
    others = torch.ones(CAP, dtype=torch.bool, device=dev)
    others[new] = False
    assert torch.equal(kc[:, :, others], k0[:, :, others])
    assert torch.equal(vc[:, :, others], v0[:, :, others])


@pytest.mark.parametrize("B,lens", [(1, [37]), (4, [40, 0, 0, 0]),
                                    (8, [0, 1, 15, 16, 63, 64, 100, 200])])
@pytest.mark.parametrize("kv,hg", [(8, 4), (8, 8)], ids=["hg4_G2", "hg8_G1"])
def test_paged_layer_int8_kernel_matches_plain(dev, B, lens, kv, hg):
    """Kernel 9's int8 mode against its plain twin, NaN in every pool row
    no request owns, the same bits on a repeat (into fresh pools)."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.ops.quant import quantize_int8
    L, layer, hidden, g, hd, page = 2, 1, 512, 2, 128, 16
    cfg = LlamaConfig.tiny()
    cos_t, sin_t = model.rope_table(cfg, device=dev)
    kp, vp, table, lens_t = _paged_pools(dev, L, kv, page, hd, lens, 60)
    _nan_unowned(kp, vp, table, lens_t)
    wqkv, wo = (quantize_int8(w, -2)
                for w in _layer_weights(dev, L, hidden, kv, g, hd, hg, 61))
    x = _randn((B, hidden), dev, 62)
    res = _randn((B, hidden), dev, 63)
    rms = 1 + _randn((hidden,), dev, 64, 0.1)
    kr, vr = kp.clone(), vp.clone()
    k2, v2 = kp.clone(), vp.clone()
    args = (wqkv, wo, table, lens_t, lens_t)
    kw = dict(group=g, rope_style=cfg.rope_style)
    before = pd.launches["llama_decoder_layer_paged_int8"]
    out = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, layer, rms,
                                       1e-5, cos_t, sin_t, **kw)
    again = pd.llama_decoder_layer_paged(x, res, *args, k2, v2, layer, rms,
                                         1e-5, cos_t, sin_t, **kw)
    torch.cuda.synchronize()
    assert pd.launches["llama_decoder_layer_paged_int8"] == before + 2
    assert torch.equal(_bits(out[0]), _bits(again[0]))
    assert torch.equal(_bits(kp), _bits(k2)) and torch.equal(_bits(vp),
                                                             _bits(v2))
    assert torch.isfinite(out[0].float()).all()
    want = pd.llama_decoder_layer_paged_plain(x, res, *args, kr, vr, layer,
                                              rms, 1e-5, cos_t, sin_t, **kw)
    for i in (0, 1):
        torch.testing.assert_close(out[i].float(), want[i].float(), atol=2e-2,
                                   rtol=2e-2)
    app = _appended_mask(kp, table, lens_t, layer)
    torch.testing.assert_close(kp[app].float(), kr[app].float(), atol=0.05,
                               rtol=0)
    assert torch.equal(_bits(kp[~app]), _bits(kr[~app]))


def test_int8_entries_refuse(dev):
    """On the card kernel 6 takes int4 weights (mode 1.4: one W4A8 call is
    its two kernels, counted as int4) and refuses them, before any launch,
    in a group size the kernels do not take, as kernel 9 does (mode 1.5);
    the C entries refuse what the int8 instances do not take: a width that
    is not a multiple of 16, a scale group that does not divide K, the pair
    form at one row."""
    from clusterfusion_tpu_torch.ops import _build
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    pos = 37
    g, a, kc, vc, lm = _stack_args(dev, 16, 8, 4, pos, seed=65)
    q4 = quantize_llama_params(
        {"layers": {k: a[k] for k in ("wqkv_f", "wo_f", "w13", "w2")},
         "lm_head": lm["lm_head"]}, "int4")["layers"]
    cos, sin = model.rope_row(LlamaConfig.tiny(), pos, dev)
    before = (dl.launches, dl.int4_launches)
    out = dl._fused_decoder_layer(
        a["x"], _randn((1, HIDDEN), dev, 66), a["attn_norm"], cos, sin,
        q4["wqkv_f"], q4["wo_f"], kc, vc, pos, 1, group=g, head_dim=HD,
        rope_style="gptj", fuse_residual=True, eps=1e-5)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0].float()).all()
    assert (dl.launches, dl.int4_launches) == (before[0] + 1, before[1] + 1)
    assert dl.last_call_kernels == 2
    q64 = quantize_llama_params(
        {"layers": {k: a[k] for k in ("wqkv_f", "wo_f")}}, "int4", 64,
        targets=("wqkv_f", "wo_f"))["layers"]
    before = dl.launches
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        dl._fused_decoder_layer(
            a["x"], _randn((1, HIDDEN), dev, 66), a["attn_norm"], cos, sin,
            q64["wqkv_f"], q64["wo_f"], kc, vc, pos, 1, group=g, head_dim=HD,
            rope_style="gptj", fuse_residual=True, eps=1e-5)
    assert dl.launches == before
    cos_t, sin_t = model.rope_table(LlamaConfig.tiny(), device=dev)
    kp, vp, table, lens_t = _paged_pools(dev, 2, 8, 16, HD, [5, 9], 67)
    before = pd.launches["llama_decoder_layer_paged"]
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        pd.llama_decoder_layer_paged(
            _randn((2, HIDDEN), dev, 68), _randn((2, HIDDEN), dev, 69),
            q64["wqkv_f"], q64["wo_f"], table, lens_t, lens_t, kp, vp, 1,
            a["attn_norm"][1], 1e-5, cos_t, sin_t, group=g)
    assert pd.launches["llama_decoder_layer_paged"] == before
    lib = _build.lib()
    x = _randn((4, 512), dev, 70)
    q = torch.zeros((2, 512, 512), dtype=torch.int8, device=dev)
    s = torch.ones((2, 512), device=dev)
    y = torch.empty((4, 1024), device=dev)
    yb = torch.empty((4, 512), dtype=torch.bfloat16, device=dev)
    st = torch.cuda.current_stream(dev).cuda_stream
    good = lib.cf_gemv_rows8(x.data_ptr(), 512, 0, q.data_ptr(), s.data_ptr(),
                             0, y.data_ptr(), None, 4, 512, 512, 2, st)
    assert good == 0
    for args in ((0, 0, 4, 512, 504, 2), (0, 300, 4, 512, 512, 1),
                 (1, 0, 1, 512, 512, 2)):
        pair, kg, M, K, N, nmat = args
        err = lib.cf_gemv_rows8(x.data_ptr(), 512, pair, q.data_ptr(),
                                s.data_ptr(), kg, y.data_ptr(), yb.data_ptr(),
                                M, K, N, nmat, st)
        assert err != 0, args
    torch.cuda.synchronize()


def test_int8_engine_spec_and_serving_on_card(dev):
    """The int8 engine on the card: ``spec_generate`` (self-draft and a bf16
    draft) runs kernel 8's int8 mode once a round and emits the engine's
    own greedy stream; ``generate`` and both serving steps run the int8
    products and give each request the tokens it gets alone."""
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    from clusterfusion_tpu_torch.runtime import ServingEngine
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    cfg = LlamaConfig.tiny(max_seq_len=256)
    eng = Llama.synthetic(cfg, quant="int8", device=dev)
    prompt = list(range(1, 30))
    ref = list(eng.stream_generate(prompt, 12, temperature=0.0))
    for draft in (eng, Llama.synthetic(cfg, seed=1, device=dev)):
        before = sv.int8_launches
        toks = eng.spec_generate(prompt, 12, draft, n_draft=4)
        assert sv.int8_launches - before == eng.spec_stats["rounds"]
        assert toks == ref
    prompts = [list(range(1, 9)), list(range(3, 40)), list(range(5, 21))]
    for impl in ("batched", "fused"):
        outs = []
        for batch in (prompts, *([p] for p in prompts)):
            srv = ServingEngine(eng.params, cfg, page_size=16, num_pages=32,
                                max_batch=4, step_impl=impl)
            for i, p in enumerate(batch):
                srv.submit(i, p, 6, temperature=0.0)
            before = (gemv.int8_launches, gemv.ffn8_launches,
                      pd.launches["llama_decoder_layer_paged_int8"])
            outs.append(srv.run())
            assert (gemv.int8_launches > before[0]) == (impl == "batched")
            assert gemv.ffn8_launches > before[1]
            assert (pd.launches["llama_decoder_layer_paged_int8"] > before[2]) \
                == (impl == "fused")
        for i in range(len(prompts)):
            assert outs[0][i] == outs[1 + i][0], (impl, i)
    toks, _ = eng.generate([prompts[0]], 6, temperature=0.0)
    assert toks[0] == outs[1][0]


# -- int4 weights on the ring and rows GEMVs (kernels 7, 8, 9, serving) -------


def _int4_codes(dev, nmat, K, N, seed):
    """Packed int4 codes [nmat, K/2, N] over every byte value (code -8
    included) and float32 group scales [nmat, K/128, N] that are bf16
    values."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randint(-128, 128, (nmat, K // 2, N), generator=g,
                      dtype=torch.int8)
    s = (torch.rand((nmat, K // 128, N), generator=g) * 0.05 + 0.01)
    return q.to(dev), s.bfloat16().float().to(dev)


@pytest.mark.parametrize("M", [1, 2, 5, 9, 16, 20])
@pytest.mark.parametrize("K,N,nmat,kg", [(128, 256, 1, 0), (384, 272, 3, 0),
                                         (4096, 512, 1, 1024),
                                         (2048, 4096, 1, 0)],
                         ids=["one_group", "three_groups_ragged", "blocks",
                              "wide"])
@pytest.mark.parametrize("a8", [False, True], ids=["exact", "w4a8"])
def test_gemv4_matches_plain(dev, M, K, N, nmat, kg, a8):
    """The GEMVs' int4 instances (the rows GEMV's from 2 rows, the one-row
    GEMV's at 1) in both modes against their plain twin: K of one and of
    three scale groups, x whose halves differ 10x in absmax (W4A8
    quantizes per activation block: kg rows, or the row), the same bits on
    a repeat."""
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    q, s = _int4_codes(dev, nmat, K, N, 170 + M)
    x = _randn((M, K), dev, 171)
    x[:, : K // 2] *= 10
    before = gemv.int4_launches
    y = gemv._gemv_int4(x, q, s, kg=kg, a8=a8)
    again = gemv._gemv_int4(x, q, s, kg=kg, a8=a8)
    torch.cuda.synchronize()
    assert gemv.int4_launches == before + 2
    assert y.shape == (M, nmat * N) and torch.equal(y, again)
    ref = gemv._gemv_int4_plain(x.cpu(), q.cpu(), s.cpu(), kg, a8)
    torch.testing.assert_close(y.cpu(), ref, atol=1e-3 * ref.abs().max().item(),
                               rtol=1e-2)


@pytest.mark.parametrize("M", [2, 9])
@pytest.mark.parametrize("a8", [False, True], ids=["exact", "w4a8"])
def test_gemv4_pair_matches_plain(dev, M, a8):
    """The rows GEMV's int4 pair form (the verify's gate/up product):
    bf16(silu(gate) * up) against the plain products."""
    import ctypes

    import torch.nn.functional as F

    from clusterfusion_tpu_torch.ops import _build
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    K, N = 512, 384
    q, s = _int4_codes(dev, 2, K, N, 180 + M)
    x = _randn((M, K), dev, 181)
    yb = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    x8 = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    xs = torch.empty((M, 1), device=dev)
    err = _build.lib().cf_gemv_rows4(
        x.data_ptr(), K, 1, q.data_ptr(), s.data_ptr(), 0, None, yb.data_ptr(),
        M, K, N, 2, int(a8), x8.data_ptr(), xs.data_ptr(), ctypes.c_void_p(
            torch.cuda.current_stream(dev).cuda_stream))
    torch.cuda.synchronize()
    assert err == 0
    ref = gemv._gemv_int4_plain(x.cpu(), q.cpu(), s.cpu(), 0, a8)
    want = (F.silu(ref[:, :N]) * ref[:, N:]).to(torch.bfloat16)
    torch.testing.assert_close(yb.float().cpu(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("M", [1, 16])
def test_gemv4_unpacks_every_byte_and_rounds_once(dev, M):
    """One-hot x rows pick single k rows of codes that take every byte
    value in each column sweep: the exact mode's outputs are bf16(code * s)
    bit for bit, the nibbles read as ``unpack_int4`` reads them (code -8
    too), and s makes the product need 11 bits (trap 3: a kernel that
    skipped the bf16 rounding would differ)."""
    from clusterfusion_tpu_torch.ops.quant import unpack_int4
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    K, N = 256, 256
    b = (torch.arange(K // 2)[:, None] + torch.arange(N)[None]) % 256
    q = b.to(torch.uint8).view(torch.int8)
    s = torch.full((K // 128, N), 255 / 128)          # bf16 1.9921875
    codes = unpack_int4(q, 0).float()                 # [K, N]
    ks = [(3 + 37 * i) % K for i in range(M)]
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    x[torch.arange(M), ks] = 1
    y = gemv._gemv_int4(x.to(dev), q.to(dev), s.to(dev))
    torch.cuda.synchronize()
    unrounded = codes[ks] * s[0]
    want = unrounded.to(torch.bfloat16).float()
    assert torch.equal(y.cpu(), want)
    assert not torch.equal(want, unrounded)
    assert set(codes[ks].flatten().tolist()) == set(range(-8, 8))


@pytest.mark.parametrize("M", [1, 4, 9])
def test_ffn4_matches_plain(dev, M):
    """The int4 FFN (exact: the rows GEMV's int4 pair form, then the down
    product; at one row the one-row GEMV's int4 instances) against its
    plain twin."""
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    from clusterfusion_tpu_torch.ops.quant import quantize_int4
    hidden, f = 512, 1024
    w13 = quantize_int4(_randn((2, hidden, f), dev, 190, hidden ** -0.5), -2)
    w2 = quantize_int4(_randn((f, hidden), dev, 191, f ** -0.5), -2)
    x = _randn((M, hidden), dev, 192)
    before = gemv.ffn4_launches
    out = gemv._ffn_int4(x, w13.q, w13.s, w2.q, w2.s)
    again = gemv._ffn_int4(x, w13.q, w13.s, w2.q, w2.s)
    torch.cuda.synchronize()
    assert gemv.ffn4_launches == before + 2
    ref = gemv._ffn_int4_plain(x.cpu(), w13.q.cpu(), w13.s.cpu(), w2.q.cpu(),
                               w2.s.cpu())
    assert torch.equal(_bits(out), _bits(again))
    torch.testing.assert_close(out.float().cpu(), ref.float(), atol=2e-2,
                               rtol=2e-2)


def test_gemv4_entries_refuse(dev):
    """The int4 C entry refuses what the int4 instances do not take: K not
    a multiple of 128, a width not a multiple of 16, the pair form at one
    row, an activation block that does not divide K, W4A8 from 2 rows
    without its x8 scratch."""
    import ctypes

    from clusterfusion_tpu_torch.ops import _build
    lib = _build.lib()
    x = _randn((4, 512), dev, 193)
    q = torch.zeros((2, 256, 512), dtype=torch.int8, device=dev)
    s = torch.ones((2, 4, 512), device=dev)
    y = torch.empty((4, 1024), device=dev)
    yb = torch.empty((4, 512), dtype=torch.bfloat16, device=dev)
    x8 = torch.empty((4, 512), dtype=torch.bfloat16, device=dev)
    xs = torch.empty((4, 4), device=dev)
    st = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    good = lib.cf_gemv_rows4(x.data_ptr(), 512, 0, q.data_ptr(), s.data_ptr(),
                             0, y.data_ptr(), None, 4, 512, 512, 2, 1,
                             x8.data_ptr(), xs.data_ptr(), st)
    assert good == 0
    for pair, kg, M, K, N, nmat, q8 in ((0, 0, 4, 448, 512, 1, x8),
                                        (0, 0, 4, 512, 504, 2, x8),
                                        (1, 0, 1, 512, 512, 2, x8),
                                        (0, 384, 4, 512, 512, 1, x8),
                                        (0, 0, 4, 512, 512, 1, None)):
        err = lib.cf_gemv_rows4(x.data_ptr(), 512, pair, q.data_ptr(),
                                s.data_ptr(), kg, y.data_ptr(), yb.data_ptr(),
                                M, K, N, nmat, 1,
                                None if q8 is None else q8.data_ptr(),
                                xs.data_ptr(), st)
        assert err != 0, (pair, kg, M, K, N, nmat)
    torch.cuda.synchronize()


def _int4_stack(a, lm, lm_kind):
    """The stack's four projections quantized to int4 (groups of 128), and
    the LM head as ``lm_kind`` says: None, "bf16" or "int8"."""
    from clusterfusion_tpu_torch.ops.quant import (quantize_int8,
                                                   quantize_llama_params)
    q = quantize_llama_params(
        {"layers": {k: a[k] for k in ("wqkv_f", "wo_f", "w13", "w2")},
         "lm_head": lm["lm_head"]}, "int4")
    head = {} if lm_kind is None else dict(
        final_norm=lm["final_norm"],
        lm_head=quantize_int8(lm["lm_head"], -2) if lm_kind == "int8"
        else lm["lm_head"])
    return q["layers"], head


INT4_SHAPES = INT8_SHAPES[:2]


def _w4a8_by_layer(kernel, plain, args, kc, vc, pos, kcfg, kw, held):
    """W4A8 held layer by layer, teacher-forced: layer l of the kernel and
    of its plain twin, both from the kernel's own state after its first l
    layers (x_out + residual_out), at phase 4's limits (``held(out, ref,
    kk, vk, kp, vp)``: each output within 2e-2 of its largest value).  A
    bf16 rounding that the two take apart can move an activation across a
    step of its int8 quantization, which moves every output of that
    product a little, and over free-running layers that compounds; one
    layer from one input must still agree."""
    x, norms, rope, proj = args[0], args[1:3], args[3:5], args[5:]
    bare = {k: v for k, v in kw.items() if k not in ("final_norm", "lm_head")}
    for l in range(L):
        xl = x
        if l:
            h, r, _, _ = kernel(x, *(t[:l] for t in norms), *rope,
                                *(t[:l] for t in proj), kc[:l].clone(),
                                vc[:l].clone(), pos, kcfg=kcfg, **bare)
            xl = (h.float() + r.float()).bfloat16()
        one = (xl, *(t[l:l + 1] for t in norms), *rope,
               *(t[l:l + 1] for t in proj))
        kk, vk = kc[l:l + 1].clone(), vc[l:l + 1].clone()
        kp, vp = kk.clone(), vk.clone()
        out = kernel(*one, kk, vk, pos, kcfg=kcfg, **kw)
        ref = plain(*one, kp, vp, pos, int4_w4a8=True, **kw)
        held(out, ref, kk, vk, kp, vp)


@pytest.mark.parametrize("pos", [0, 37, CAP - 1])
@pytest.mark.parametrize("lm_kind", [None, "bf16", "int8"],
                         ids=["no_lm", "lm_bf16", "lm_int8"])
@pytest.mark.parametrize("a8", [True, False], ids=["w4a8", "exact"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", INT4_SHAPES,
                         ids=["hg4_G2", "hg8_G2"])
def test_stack_int4_kernel_matches_plain(dev, n_heads, kv_heads, hg, a8,
                                         lm_kind, pos):
    """Kernel 7's int4 modes against their plain twin at phase 4's limits
    (W4A8 layer by layer, teacher-forced), every cache row above pos NaN,
    the same launches as the int8 mode and the same bits on a repeat."""
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos, seed=120)
    kc[:, :, pos + 1:] = float("nan")
    vc[:, :, pos + 1:] = float("nan")
    w, head = _int4_stack(a, lm, lm_kind)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style=cfg.rope_style, eps=1e-5,
              **head)
    kcfg = KernelConfig(int4_w4a8=a8)
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, w["wqkv_f"],
            w["wo_f"], w["w13"], w["w2"]]
    kp, vp = kc.clone(), vc.clone()
    k2, v2 = kc.clone(), vc.clone()
    before = (sk.launches, sk.int4_launches)
    out = sk.fused_decoder_stack(*args, kc, vc, pos, kcfg=kcfg, **kw)
    again = sk.fused_decoder_stack(*args, k2, v2, pos, kcfg=kcfg, **kw)
    torch.cuda.synchronize()
    assert (sk.launches, sk.int4_launches) == (before[0] + 2, before[1] + 2)
    assert sk.last_step_kernels == 8 * L - (pos == 0) * L + 1 + bool(head)
    for got, want in zip((*again[:2], k2, v2), (*out[:2], kc, vc)):
        assert _same_bits(got, want) if got.dtype == torch.bfloat16 else \
            torch.equal(got, want)
    assert torch.isfinite(out[0].float()).all()

    def held(out, ref, kc, vc, kp, vp):
        tol = 2e-2
        for i, (got, want) in enumerate(zip(out[:2], ref[:2])):
            if a8 or head and i == 0:   # within 2e-2 of the largest value
                err = (got.float() - want.float()).abs().max().item()
                assert err <= tol * want.float().abs().max().item(), (i, err)
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=2e-2)
        for got, want in ((kc, kp), (vc, vp)):
            torch.testing.assert_close(got[:, :, pos].float(),
                                       want[:, :, pos].float(), atol=0.05,
                                       rtol=0)
        others = torch.ones(CAP, dtype=torch.bool, device=dev)
        others[pos] = False
        assert _same_bits(kc[:, :, others], kp[:, :, others])
        assert _same_bits(vc[:, :, others], vp[:, :, others])

    if a8:
        _w4a8_by_layer(sk.fused_decoder_stack, sk.fused_decoder_stack_plain,
                       args, kp, vp, pos, kcfg, kw, held)
    else:
        ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos,
                                           int4_w4a8=False, **kw)
        held(out, ref, kc, vc, kp, vp)


@pytest.mark.parametrize("n,pos", [(1, 37), (2, 0), (5, 37), (9, 300),
                                   (17, 100)])
@pytest.mark.parametrize("lm_kind", [None, "int8"], ids=["no_lm", "lm_int8"])
@pytest.mark.parametrize("a8", [True, False], ids=["w4a8", "exact"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", INT4_SHAPES,
                         ids=["hg4_G2", "hg8_G2"])
def test_verify_int4_kernel_matches_plain(dev, n_heads, kv_heads, hg, a8,
                                          lm_kind, n, pos):
    """Kernel 8's int4 modes against their plain twin at phase 9's limits
    (W4A8 layer by layer, teacher-forced), rows at and above pos holding
    large garbage, the other rows untouched, and the same bits on a
    repeat."""
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos, seed=150)
    kc[:, :, pos:] = _randn(kc[:, :, pos:].shape, dev, 151, 8.0)
    vc[:, :, pos:] = _randn(vc[:, :, pos:].shape, dev, 152, 8.0)
    w, head = _int4_stack(a, lm, lm_kind)
    x = _randn((n, HIDDEN), dev, 153)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_rows(cfg, pos, n, dev)
    kw = dict(group=g, head_dim=HD, rope_style=cfg.rope_style, eps=1e-5,
              **head)
    args = [x, a["attn_norm"], a["ffn_norm"], cos, sin, w["wqkv_f"],
            w["wo_f"], w["w13"], w["w2"]]
    kcfg = KernelConfig(int4_w4a8=a8)
    k0, v0 = kc.clone(), vc.clone()
    kp, vp = kc.clone(), vc.clone()
    k2, v2 = kc.clone(), vc.clone()
    before = (sv.launches, sv.int4_launches)
    out = sv.fused_verify_stack(*args, kc, vc, pos, kcfg=kcfg, **kw)
    again = sv.fused_verify_stack(*args, k2, v2, pos, kcfg=kcfg, **kw)
    torch.cuda.synchronize()
    assert (sv.launches, sv.int4_launches) == (before[0] + 2, before[1] + 2)
    # from 2 rows W4A8 quantizes the x of each of a layer's four products
    # in a launch of its own
    assert sv.last_step_kernels == 8 * L - (pos == 0) * L + 1 + bool(head) \
        + 4 * L * (a8 and n > 1)
    for got, want in zip((*again[:2], k2, v2), (*out[:2], kc, vc)):
        assert torch.equal(got, want)
    new = slice(pos, pos + n)
    others = torch.ones(CAP, dtype=torch.bool, device=dev)
    others[new] = False
    assert torch.equal(kc[:, :, others], k0[:, :, others])
    assert torch.equal(vc[:, :, others], v0[:, :, others])

    def held(out, ref, kc, vc, kp, vp):
        tol = 2e-2
        for i, (got, want) in enumerate(zip(out[:2], ref[:2])):
            if a8 or head and i == 0:   # within 2e-2 of the largest value
                err = (got.float() - want.float()).abs().max().item()
                assert err <= tol * want.float().abs().max().item(), (i, err)
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=2e-2)
        for got, want in ((kc, kp), (vc, vp)):
            torch.testing.assert_close(got[:, :, new].float(),
                                       want[:, :, new].float(), atol=0.05,
                                       rtol=0)
        assert torch.equal(kc[:, :, others], kp[:, :, others])
        assert torch.equal(vc[:, :, others], vp[:, :, others])

    if a8:
        _w4a8_by_layer(sv.fused_verify_stack, sv.fused_verify_stack_plain,
                       args, kp, vp, pos, kcfg, kw, held)
    else:
        ref = sv.fused_verify_stack_plain(*args, kp, vp, pos, int4_w4a8=False,
                                          **kw)
        held(out, ref, kc, vc, kp, vp)


@pytest.mark.parametrize("B,lens", [(1, [37]), (4, [40, 0, 0, 0]),
                                    (8, [0, 1, 15, 16, 63, 64, 100, 200])])
@pytest.mark.parametrize("kv,hg", [(8, 4), (8, 8)], ids=["hg4_G2", "hg8_G1"])
def test_paged_layer_int4_kernel_matches_plain(dev, B, lens, kv, hg):
    """Kernel 9's int4 mode (exact) against its plain twin, NaN in every
    pool row no request owns, the same bits on a repeat."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.ops.quant import quantize_int4
    L, layer, hidden, g, hd, page = 2, 1, 512, 2, 128, 16
    cfg = LlamaConfig.tiny()
    cos_t, sin_t = model.rope_table(cfg, device=dev)
    kp, vp, table, lens_t = _paged_pools(dev, L, kv, page, hd, lens, 160)
    _nan_unowned(kp, vp, table, lens_t)
    wqkv, wo = (quantize_int4(w, -2)
                for w in _layer_weights(dev, L, hidden, kv, g, hd, hg, 161))
    x = _randn((B, hidden), dev, 162)
    res = _randn((B, hidden), dev, 163)
    rms = 1 + _randn((hidden,), dev, 164, 0.1)
    kr, vr = kp.clone(), vp.clone()
    k2, v2 = kp.clone(), vp.clone()
    args = (wqkv, wo, table, lens_t, lens_t)
    kw = dict(group=g, rope_style=cfg.rope_style)
    before = pd.launches["llama_decoder_layer_paged_int4"]
    out = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, layer, rms,
                                       1e-5, cos_t, sin_t, **kw)
    again = pd.llama_decoder_layer_paged(x, res, *args, k2, v2, layer, rms,
                                         1e-5, cos_t, sin_t, **kw)
    torch.cuda.synchronize()
    assert pd.launches["llama_decoder_layer_paged_int4"] == before + 2
    assert torch.equal(_bits(out[0]), _bits(again[0]))
    assert torch.equal(_bits(kp), _bits(k2)) and torch.equal(_bits(vp),
                                                             _bits(v2))
    assert torch.isfinite(out[0].float()).all()
    want = pd.llama_decoder_layer_paged_plain(x, res, *args, kr, vr, layer,
                                              rms, 1e-5, cos_t, sin_t, **kw)
    for i in (0, 1):
        torch.testing.assert_close(out[i].float(), want[i].float(), atol=2e-2,
                                   rtol=2e-2)
    app = _appended_mask(kp, table, lens_t, layer)
    torch.testing.assert_close(kp[app].float(), kr[app].float(), atol=0.05,
                               rtol=0)
    assert torch.equal(_bits(kp[~app]), _bits(kr[~app]))


def test_int4_engine_spec_and_serving_on_card(dev):
    """The int4 engine on the card: the stream runs kernel 7's int4 mode;
    ``spec_generate`` (self-draft and a bf16 draft) runs kernel 8's int4
    mode once a round and emits the engine's own greedy stream; both
    serving steps run the int4 products (the fused one by default) and give
    each request the tokens it gets alone; ``generate`` agrees."""
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    from clusterfusion_tpu_torch.runtime import ServingEngine
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    cfg = LlamaConfig.tiny(max_seq_len=256)
    eng = Llama.synthetic(cfg, quant="int4", device=dev)
    prompt = list(range(1, 30))
    before = sk.int4_launches
    ref = list(eng.stream_generate(prompt, 12, temperature=0.0))
    assert sk.int4_launches - before == len(ref)   # a step after each token
    for draft in (eng, Llama.synthetic(cfg, seed=1, device=dev)):
        before = sv.int4_launches
        toks = eng.spec_generate(prompt, 12, draft, n_draft=4)
        assert sv.int4_launches - before == eng.spec_stats["rounds"]
        assert toks == ref
    assert ServingEngine(eng.params, cfg).step_impl == "fused"
    prompts = [list(range(1, 9)), list(range(3, 40)), list(range(5, 21))]
    for impl in ("batched", "fused"):
        outs = []
        for batch in (prompts, *([p] for p in prompts)):
            srv = ServingEngine(eng.params, cfg, page_size=16, num_pages=32,
                                max_batch=4, step_impl=impl)
            for i, p in enumerate(batch):
                srv.submit(i, p, 6, temperature=0.0)
            before = (gemv.int4_launches, gemv.ffn4_launches,
                      pd.launches["llama_decoder_layer_paged_int4"])
            outs.append(srv.run())
            assert (gemv.int4_launches > before[0]) == (impl == "batched")
            assert gemv.ffn4_launches > before[1]
            assert (pd.launches["llama_decoder_layer_paged_int4"] > before[2]) \
                == (impl == "fused")
        for i in range(len(prompts)):
            assert outs[0][i] == outs[1 + i][0], (impl, i)
    toks, _ = eng.generate([prompts[0]], 6, temperature=0.0)
    assert toks[0] == outs[1][0]


# -- int8 weights in kernel 6 and in kernel 7's mode 5 ------------------------


def _qt_slice(t, dim, n, i):
    """Slice ``i`` of ``n`` of an int8 QuantizedTensor along ``dim`` (its
    codes and scales alike), contiguous."""
    import dataclasses
    q = t.q.chunk(n, dim)[i].contiguous()
    s = t.s.chunk(n, dim)[i].contiguous()
    return dataclasses.replace(t, q=q, s=s)


INT8_LAYER_MODES = ("full_append", "partials_fold1", "partials_fold0",
                    "nan_full_append")


@pytest.mark.parametrize("mode", INT8_LAYER_MODES)
@pytest.mark.parametrize("n_heads,kv_heads,hg,shard", [
    (8, 4, 1, False), (8, 4, 2, False), (16, 8, 4, True)],
    ids=["hg1_G4", "hg2_G2", "hg4_tp2_shard"])
def test_decoder_layer_int8_kernel_matches_plain(dev, n_heads, kv_heads, hg,
                                                 shard, mode):
    """Kernel 6's int8 mode against its plain twin: the layer's QKV and O
    quantized per output column (stacked, layer 1 read), at head groups 1,
    2 and (the first tp-2 shard's slices, G 2 -> 1 and half the kv heads)
    4; one launch a call, counted as int8, the same bits on a repeat.  Rows
    at and above seq hold garbage (NaN in the nan_ mode) that the kernel
    never reads."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops.quant import quantize_int8
    seq, style, fuse, append, partials, fold = LAYER_MODES[mode]
    g, a, kc, vc, _ = _stack_args(dev, n_heads, kv_heads, hg, seq, seed=80)
    w = {k: quantize_int8(a[k], -2) for k in ("wqkv_f", "wo_f")}
    if shard:
        w = {k: _qt_slice(t, 1, 2, 0) for k, t in w.items()}
        kc = kc[:, :kv_heads // 2].contiguous()
        vc = vc[:, :kv_heads // 2].contiguous()
    if mode.startswith("nan_"):
        kc[:, :, seq:] = float("nan")
        vc[:, :, seq:] = float("nan")
    else:
        kc[:, :, seq:] = _randn(kc[:, :, seq:].shape, dev, 81, 8.0)
        vc[:, :, seq:] = _randn(vc[:, :, seq:].shape, dev, 82, 8.0)
    res = _randn((1, HIDDEN), dev, 83)
    cos, sin = model.rope_row(LlamaConfig.tiny(rope_style=style), seq, dev)
    kw = dict(group=g, head_dim=HD, rope_style=style, fuse_residual=fuse,
              eps=1e-5, emit_partials=partials, fold_current=fold,
              append_kv=append)
    args = [a["x"], res, a["attn_norm"], cos, sin, w["wqkv_f"], w["wo_f"]]
    kp, vp = kc.clone(), vc.clone()
    before = (dl.launches, dl.int8_launches)
    out = dl._fused_decoder_layer(*args, kc, vc, seq, 1, **kw)
    torch.cuda.synchronize()
    assert (dl.launches, dl.int8_launches) == (before[0] + 1, before[1] + 1)
    assert dl.last_call_kernels == 1
    again = dl._fused_decoder_layer(*args, kc.clone(), vc.clone(), seq, 1,
                                    **kw)
    for x, y in zip(out, again):
        assert (x is None and y is None) or _bits_equal(x, y)
    ref = dl._fused_decoder_layer_plain(*args, kp, vp, seq, 1, **kw)
    tol = dict(atol=2e-2, rtol=2e-2)
    if partials:
        torch.testing.assert_close(out[1], ref[1], **tol)
        torch.testing.assert_close(out[0], ref[0], atol=5e-2, rtol=2e-2)
        res_i = 2
    else:
        assert torch.isfinite(out[0].float()).all()
        torch.testing.assert_close(out[0].float(), ref[0].float(), **tol)
        res_i = 1
    torch.testing.assert_close(out[res_i].float(), ref[res_i].float(), **tol)
    for i in (res_i + 1, res_i + 2):
        torch.testing.assert_close(out[i].float(), ref[i].float(), atol=0.05,
                                   rtol=0)
    others = torch.ones(CAP, dtype=torch.bool, device=dev)
    if append:
        others[seq] = False
        torch.testing.assert_close(kc[1, :, seq].float(),
                                   kp[1, :, seq].float(), atol=0.05, rtol=0)
        assert _same_bits(kc[0, :, seq], kp[0, :, seq])
    assert _same_bits(kc[:, :, others], kp[:, :, others])
    assert _same_bits(vc[:, :, others], vp[:, :, others])


@pytest.mark.parametrize("what", ["raw_int8", "int4", "int4_stack_mode5"])
def test_int8_layer_entries_refuse(dev, what):
    """Kernel 6 refuses a raw int8 tensor (not a QuantizedTensor) before
    any launch (ROADMAP.md queue 2, mode 1); since mode 1.4 it takes an
    int4 pair, and kernel 7 with reduce_axis (on an axis of one rank) int4
    weights, each launching its kernels once, counted as int4, and
    refuses int4 beside an int8 wo, or an int8 KV cache (mode 2), before
    any launch."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops.quant import quantize_int4, quantize_int8
    from clusterfusion_tpu_torch.parallel.mesh import AXES, Mesh
    seq = 37
    g, a, kc, vc, _ = _stack_args(dev, 8, 4, 2, seq, seed=84)
    cos, sin = model.rope_row(LlamaConfig.tiny(), seq, dev)
    before = (dl.launches, sk.launches, dl.int4_launches, sk.int4_launches)
    if what == "int4_stack_mode5":
        q4 = {k: quantize_int4(a[k], -2) for k in ("wqkv_f", "wo_f", "w13",
                                                     "w2")}
        one = Mesh(shape=dict.fromkeys(AXES, 1),
                   coords=dict.fromkeys(AXES, 0), groups=dict.fromkeys(AXES))
        out = sk.fused_decoder_stack(
            a["x"], a["attn_norm"], a["ffn_norm"], cos, sin,
            q4["wqkv_f"], q4["wo_f"], q4["w13"], q4["w2"], kc, vc, seq,
            group=g, head_dim=HD, rope_style="gptj", eps=1e-5,
            reduce_axis="tp", mesh=one)
        torch.cuda.synchronize()
        assert torch.isfinite(out[0].float()).all()
        assert (sk.launches, sk.int4_launches) == (before[1] + 1,
                                                   before[3] + 1)
        return
    if what == "raw_int8":
        wq, wo = a["wqkv_f"].to(torch.int8), a["wo_f"].to(torch.int8)
        with pytest.raises(NotImplementedError, match="only bf16, int8"):
            dl._fused_decoder_layer(
                a["x"], _randn((1, HIDDEN), dev, 85), a["attn_norm"], cos,
                sin, wq, wo, kc, vc, seq, 1, group=g, head_dim=HD,
                rope_style="gptj", fuse_residual=True, eps=1e-5)
        torch.cuda.synchronize()
        assert (dl.launches, sk.launches) == before[:2]
        return
    wq, wo = quantize_int4(a["wqkv_f"], -2), quantize_int4(a["wo_f"], -2)
    for bad, cache, err in ((quantize_int8(a["wo_f"], -2), kc, ValueError),
                            (wo, kc.to(torch.int8), NotImplementedError)):
        with pytest.raises(err):
            dl._fused_decoder_layer(
                a["x"], _randn((1, HIDDEN), dev, 85), a["attn_norm"], cos,
                sin, wq, bad, cache, cache, seq, 1, group=g, head_dim=HD,
                rope_style="gptj", fuse_residual=True, eps=1e-5)
    assert dl.launches == before[0]
    out = dl._fused_decoder_layer(
        a["x"], _randn((1, HIDDEN), dev, 85), a["attn_norm"], cos, sin, wq,
        wo, kc, vc, seq, 1, group=g, head_dim=HD, rope_style="gptj",
        fuse_residual=True, eps=1e-5)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0].float()).all()
    assert (dl.launches, dl.int4_launches) == (before[0] + 1, before[2] + 1)


def _int8_mode5_shards(w, lm_head, kc, vc, meshes):
    """Each virtual rank's int8 shards (codes and scales cut as
    ``shard_params`` cuts them), LM-head shard (int8 or bf16) and
    caches."""
    import dataclasses

    from clusterfusion_tpu_torch.ops.quant import QuantizedTensor
    from clusterfusion_tpu_torch.parallel.sharding import (_qt_spec,
                                                           shard_tensor)

    def cut(t, spec, m):
        if not isinstance(t, QuantizedTensor):
            return shard_tensor(t, spec, m)
        sp = _qt_spec(spec, t)
        return dataclasses.replace(t, q=shard_tensor(t.q, sp.q, m),
                                   s=shard_tensor(t.s, sp.s, m))

    shards = [{k: cut(w[k], s, m) for k, s in MODE5_SPECS.items()}
              for m in meshes]
    heads = [cut(lm_head, (None, "tp"), m) for m in meshes]
    caches = [(shard_tensor(kc, (None, "tp", None, None), m),
               shard_tensor(vc, (None, "tp", None, None), m))
              for m in meshes]
    return shards, heads, caches


@pytest.mark.parametrize("lm_kind", ["int8", "bf16"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", INT8_SHAPES[:2],
                         ids=["hg4_G2", "hg8_G2"])
def test_stack_int8_mode5_loopback_matches_unsharded(dev, n_heads, kv_heads,
                                                     hg, lm_kind):
    """Kernel 7's int8 mode 5 at tp 2 on one card: the O and down products
    run ring_gemv8_kernel's G1_PUSH_SUM instance and the LM head's shard
    (int8 or bf16) its G1_PUSH_GATHER instance, over a loopback
    communicator.  Without the head, both ranks' x_out and residual are
    bit-identical, repeat bit for bit, and agree with the unsharded int8
    step (the G1_Y instance's sums) at atol 2e-2 / rtol 2e-2, with 8L+1
    kernels a rank; each rank appends its heads' rows.  With the head
    gathered (8L+3 kernels, one gather a rank, none standalone), the
    ranks' logits are bit-identical and within 1e-3 of the largest logit
    of the ranks' own shards from the public call with the LM head (the
    G1_Y instance; the pushing product may cut its K chunks otherwise),
    and within 2e-2 of kernel 7's unsharded logits."""
    from clusterfusion_tpu_torch.ops.quant import quantize_int8
    from clusterfusion_tpu_torch.parallel import collective as col
    pos, tp = 37, 2
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos, seed=86)
    w, _ = _int8_stack(a, lm, None)
    lm_head = quantize_int8(lm["lm_head"], -2) if lm_kind == "int8" \
        else lm["lm_head"]
    cos, sin = model.rope_row(LlamaConfig.tiny(), pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5)
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, w["wqkv_f"],
            w["wo_f"], w["w13"], w["w2"]]
    kr, vr = kc.clone(), vc.clone()
    ref = sk.fused_decoder_stack(*args, kr, vr, pos, **kw)
    ref_lg = sk.fused_decoder_stack(*args, kc.clone(), vc.clone(), pos,
                                    final_norm=lm["final_norm"],
                                    lm_head=lm_head, **kw)[0]
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards, heads, caches = _int8_mode5_shards(w, lm_head, kc, vc, meshes)
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        i8 = sk.int8_launches
        outs, kernels = _mode5_step(a, shards, caches, meshes, streams, cos,
                                    sin, pos, kw)
        again, _ = _mode5_step(a, shards, caches, meshes, streams, cos, sin,
                               pos, kw)
        local, _ = _mode5_step(a, shards, caches, meshes, streams, cos, sin,
                               pos, kw, head=(lm["final_norm"], heads))
        g0, s0 = col.launches["all_gather"], col.standalone["all_gather"]
        first, gk = _mode5_step(a, shards, caches, meshes, streams, cos, sin,
                                pos, kw, head=(lm["final_norm"], heads),
                                gather=True)
        torch.cuda.synchronize(dev)
        lb.check()
        assert kernels == [8 * L + 1] * tp and gk == [8 * L + 3] * tp
        assert sk.int8_launches == i8 + 4 * tp
        assert col.launches["all_gather"] == g0 + tp
        assert col.standalone["all_gather"] == s0
    finally:
        lb.close()
    for r, (xo, ro, k, v) in enumerate(outs):
        assert torch.equal(xo, outs[0][0]) and torch.equal(ro, outs[0][1])
        assert torch.equal(xo, again[r][0]) and torch.equal(ro, again[r][1])
        torch.testing.assert_close(xo.float(), ref[0].float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(ro.float(), ref[1].float(), atol=2e-2,
                                   rtol=2e-2)
        heads_r = slice(r * kv_heads // tp, (r + 1) * kv_heads // tp)
        for got, full in ((k, kr), (v, vr)):
            torch.testing.assert_close(got[:, :, pos].float(),
                                       full[:, heads_r, pos].float(),
                                       atol=0.05, rtol=0)
    got = [o[0] for o in first]
    assert got[0].shape == (1, VOCAB)
    for r in range(tp):
        assert torch.equal(got[r].view(torch.int32), got[0].view(torch.int32))
    want = torch.cat([o[0] for o in local], dim=-1)
    scale = want.abs().max().item()
    assert (got[0] - want).abs().max().item() <= 1e-3 * scale
    assert (got[0] - ref_lg).abs().max().item() <= \
        2e-2 * ref_lg.abs().max().item()


@pytest.mark.parametrize("which", ["tp", "sp", "fused"])
def test_int8_sharded_steps_on_card_one_rank(dev, tmp_path, which):
    """The int8 tp, sp and fused tp steps in a one-process group on the
    card against ``decode_step(fused=True)`` on the same int8 tree (int8
    LM head): kernel 6's int8 mode once a layer, the FFN on ``_ffn_int8``
    once a layer, ``_gemv_int8`` for the sp step's O products and the LM
    head; the fused step one call of kernel 7's int8 mode."""
    import torch.distributed as dist

    from clusterfusion_tpu_torch.config import MeshConfig
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    gm = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    from clusterfusion_tpu_torch import parallel as par
    cfg = LlamaConfig.tiny(n_kv_heads=2, max_seq_len=64)
    p = quantize_llama_params(model.init_params(cfg, seed=5, device=dev),
                              "int8", lm_head=True)
    kc, vc = model.init_cache(cfg, device=dev)
    model.prefill(p, kc, vc, list(range(1, 21)), cfg)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = par.build_mesh(MeshConfig())
        step = (par.make_sp_sharded_decode_step(cfg, mesh) if which == "sp"
                else par.make_sharded_decode_step(
                    cfg, mesh, fused_collectives=which == "fused"))
        kr, vr = kc.clone(), vc.clone()
        n = (dl.int8_launches, gm.ffn8_launches, gm.int8_launches,
             sk.int8_launches)
        lg, kc, vc = step(par.shard_params(p, cfg, mesh), kc, vc, 9, 20)
        torch.cuda.synchronize()
        got = (dl.int8_launches - n[0], gm.ffn8_launches - n[1],
               gm.int8_launches - n[2], sk.int8_launches - n[3])
    finally:
        dist.destroy_process_group()
    L_ = cfg.n_layers
    assert got == {"tp": (L_, L_, 1, 0), "sp": (L_, L_, L_ + 1, 0),
                   "fused": (0, 0, 0, 1)}[which]
    ref, kr, vr = model.decode_step(p, kr, vr, 9, 20, cfg, fused=True)
    scale = max(ref.abs().max().item(), 1.0)
    assert (lg - ref).abs().max().item() < 0.05 * scale
    torch.testing.assert_close(kc.float(), kr.float(), atol=0.05, rtol=0)


INT4_LAYER_CASES = {
    # name: (hidden, n_heads, kv_heads, hg, hd)
    "g1_hg1": (512, 8, 8, 1, 128),
    "g1_hg8": (1024, 8, 8, 8, 128),
    "g8_hg1": (512, 16, 2, 1, 128),
    "g8_hg2": (512, 32, 4, 2, 128),
    "hd64_g1_hg2": (512, 8, 8, 2, 64),
    "hd64_g8_hg2": (512, 32, 4, 2, 64),
    "7b_hg8": (4096, 32, 32, 8, 128),
}


def _near_largest(got, want, tol=2e-2):
    """W4A8's rule (phase 4's): every value within tol of the largest."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.parametrize("mode", INT8_LAYER_MODES)
@pytest.mark.parametrize("a8", [True, False], ids=["w4a8", "exact"])
@pytest.mark.parametrize("case", list(INT4_LAYER_CASES))
def test_decoder_layer_int4_kernel_matches_plain(dev, case, a8, mode):
    """Kernel 6's int4 modes against their plain twin (groups 1 and 8,
    head groups 1, 2 and 8, hd 128 and 64 where a head group's o is whole
    scale groups, and the 7B layer): counted as int4, two kernels a W4A8
    full-mode call (the layer, then the ring GEMV's W4A8 O projection over
    the head groups' o), one otherwise, the same bits on a repeat.  Exact
    at atol 2e-2 / rtol 2e-2; W4A8, which a bf16 rounding taken apart can
    move by a step of its int8 activations, within 2e-2 of each output's
    largest value.  Rows at and above seq hold garbage (NaN in the nan_
    mode) that the kernel never reads."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops.quant import quantize_int4
    hidden, n_heads, kv_heads, hg, hd = INT4_LAYER_CASES[case]
    seq, style, fuse, append, partials, fold = LAYER_MODES[mode]
    g, args, kc, vc = _layer_case(dev, hidden, n_heads, kv_heads, hg, hd,
                                  CAP, seq, seed=130)
    if mode.startswith("nan_"):
        kc[:, :, seq:] = float("nan")
        vc[:, :, seq:] = float("nan")
    args = list(args)
    args[5], args[6] = quantize_int4(args[5], -2), quantize_int4(args[6], -2)
    cfg = LlamaConfig.tiny(hidden_dim=hidden, n_heads=n_heads,
                           n_kv_heads=kv_heads, head_dim=hd, rope_style=style)
    args[3], args[4] = model.rope_row(cfg, seq, dev)
    kw = dict(group=g, head_dim=hd, rope_style=style, fuse_residual=fuse,
              eps=1e-5, emit_partials=partials, fold_current=fold,
              append_kv=append, kcfg=KernelConfig(int4_w4a8=a8))
    kp, vp = kc.clone(), vc.clone()
    before = (dl.launches, dl.int4_launches)
    out = dl._fused_decoder_layer(*args, kc, vc, seq, 0, **kw)
    torch.cuda.synchronize()
    assert (dl.launches, dl.int4_launches) == (before[0] + 1, before[1] + 1)
    assert dl.last_call_kernels == (2 if a8 and not partials else 1)
    again = dl._fused_decoder_layer(*args, kc.clone(), vc.clone(), seq, 0,
                                    **kw)
    for x, y in zip(out, again):
        assert (x is None and y is None) or _bits_equal(x, y)
    ref = dl._fused_decoder_layer_plain(*args, kp, vp, seq, 0, **kw)
    tol = dict(atol=2e-2, rtol=2e-2)
    outs = (1, 0) if partials else (0,)
    for i in outs:
        assert torch.isfinite(out[i].float()).all()
        if a8:
            _near_largest(out[i], ref[i])
        else:
            torch.testing.assert_close(out[i].float(), ref[i].float(),
                                       **(tol if i or not partials else
                                          dict(atol=5e-2, rtol=2e-2)))
    res_i = 2 if partials else 1
    torch.testing.assert_close(out[res_i].float(), ref[res_i].float(), **tol)
    for i in (res_i + 1, res_i + 2):
        torch.testing.assert_close(out[i].float(), ref[i].float(), atol=0.05,
                                   rtol=0)
    others = torch.ones(CAP, dtype=torch.bool, device=dev)
    if append:
        others[seq] = False
        torch.testing.assert_close(kc[0, :, seq].float(),
                                   kp[0, :, seq].float(), atol=0.05, rtol=0)
    assert _same_bits(kc[:, :, others], kp[:, :, others])
    assert _same_bits(vc[:, :, others], vp[:, :, others])


def _int4_mode5_pair(dev, a, shards, caches, meshes, streams, cos, sin, pos,
                     kw, layers):
    """One mode-5 pair step over ``layers`` (a slice) of every rank's int4
    shards from x = a["x"]: (outs, kernels)."""
    sub = dict(a, attn_norm=a["attn_norm"][layers],
               ffn_norm=a["ffn_norm"][layers])
    sh = [{k: v[layers] for k, v in s.items()} for s in shards]
    cs = [(k[layers].clone(), v[layers].clone()) for k, v in caches]
    outs, kernels = _mode5_step(sub, sh, cs, meshes, streams, cos, sin, pos,
                                kw)
    return outs, kernels, cs


@pytest.mark.parametrize("a8", [False, True], ids=["exact", "w4a8"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", INT4_SHAPES,
                         ids=["hg4_G2", "hg8_G2"])
def test_stack_int4_mode5_loopback(dev, n_heads, kv_heads, hg, a8):
    """Kernel 7's int4 mode 5 at tp 2 on one card: the O and down products
    run ring_gemv4_kernel's G1_PUSH_SUM instances over a loopback
    communicator, 8L+1 kernels a rank, counted as int4; both ranks' x_out
    and residual are bit-identical and repeat bit for bit.  Exact: the same
    function as the unsharded step, held against its G1_Y sums at atol
    2e-2 / rtol 2e-2, each rank's appended rows at 0.05.  W4A8: the down
    product's activation blocks are the shard's f-blocks, so it is held
    against its own twin over the ranks
    (``fused_decoder_stack_plain_ranks``) layer by layer, teacher-forced
    (``_w4a8_by_layer``'s rule: each output within 2e-2 of its largest)."""
    from clusterfusion_tpu_torch.parallel import collective as col
    from clusterfusion_tpu_torch.parallel.sharding import _qt_spec, shard_tensor
    import dataclasses
    pos, tp = 37, 2
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos, seed=140)
    w, _ = _int4_stack(a, lm, None)
    cos, sin = model.rope_row(LlamaConfig.tiny(), pos, dev)
    kcfg = KernelConfig(int4_w4a8=a8)
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5, kcfg=kcfg)
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, w["wqkv_f"],
            w["wo_f"], w["w13"], w["w2"]]
    kr, vr = kc.clone(), vc.clone()
    ref = sk.fused_decoder_stack(*args, kr, vr, pos, **kw)
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]

        def cut(t, spec, m):
            sp = _qt_spec(spec, t)
            return dataclasses.replace(t, q=shard_tensor(t.q, sp.q, m),
                                       s=shard_tensor(t.s, sp.s, m))

        shards = [{k: cut(w[k], s, m) for k, s in MODE5_SPECS.items()}
                  for m in meshes]
        caches = [(shard_tensor(kc, (None, "tp", None, None), m),
                   shard_tensor(vc, (None, "tp", None, None), m))
                  for m in meshes]
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        n4 = sk.int4_launches
        outs, kernels, cs = _int4_mode5_pair(dev, a, shards, caches, meshes,
                                             streams, cos, sin, pos, kw,
                                             slice(0, L))
        again, _, _ = _int4_mode5_pair(dev, a, shards, caches, meshes,
                                       streams, cos, sin, pos, kw,
                                       slice(0, L))
        torch.cuda.synchronize(dev)
        lb.check()
        assert kernels == [8 * L + 1] * tp
        assert sk.int4_launches == n4 + 2 * tp
        for r, (xo, ro, _, _) in enumerate(outs):
            assert torch.equal(xo, outs[0][0]) and torch.equal(ro, outs[0][1])
            assert torch.equal(xo, again[r][0]) and torch.equal(ro, again[r][1])
            assert torch.isfinite(xo.float()).all()
        if not a8:
            for r, (xo, ro, k, v) in enumerate(outs):
                torch.testing.assert_close(xo.float(), ref[0].float(),
                                           atol=2e-2, rtol=2e-2)
                torch.testing.assert_close(ro.float(), ref[1].float(),
                                           atol=2e-2, rtol=2e-2)
                heads_r = slice(r * kv_heads // tp, (r + 1) * kv_heads // tp)
                for got, full in ((k, kr), (v, vr)):
                    torch.testing.assert_close(got[:, :, pos].float(),
                                               full[:, heads_r, pos].float(),
                                               atol=0.05, rtol=0)
            return
        pkw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5,
                   int4_w4a8=True, kv_split=kcfg.kv_split)
        x = a["x"]
        for l in range(L):
            xl = x
            if l:
                prev, _, _ = _int4_mode5_pair(dev, a, shards, caches, meshes,
                                              streams, cos, sin, pos, kw,
                                              slice(0, l))
                torch.cuda.synchronize(dev)
                xl = (prev[0][0].float() + prev[0][1].float()).bfloat16()
            one = slice(l, l + 1)
            got, _, cs = _int4_mode5_pair(dev, dict(a, x=xl), shards, caches,
                                          meshes, streams, cos, sin, pos, kw,
                                          one)
            torch.cuda.synchronize(dev)
            lb.check()
            want = sk.fused_decoder_stack_plain_ranks(
                [(xl, a["attn_norm"][one], a["ffn_norm"][one], cos, sin,
                  *(shards[r][k][one] for k in ("wqkv_f", "wo_f", "w13",
                                                "w2")),
                  caches[r][0][one].clone(), caches[r][1][one].clone(), pos)
                 for r in range(tp)], **pkw)
            for r in range(tp):
                for i in (0, 1):
                    _near_largest(got[r][i], want[r][i])
                for i in (2, 3):
                    torch.testing.assert_close(
                        got[r][i][:, :, pos].float(),
                        want[r][i][:, :, pos].float(), atol=0.05, rtol=0)
    finally:
        lb.close()


@pytest.mark.parametrize("a8", [True, False], ids=["w4a8", "exact"])
@pytest.mark.parametrize("which", ["tp", "sp", "fused"])
def test_int4_sharded_steps_on_card_one_rank(dev, tmp_path, which, a8):
    """The int4 tp, sp and fused tp steps in a one-process group on the
    card: kernel 6's int4 mode once a layer, the FFN on ``_ffn_int4`` once
    a layer, ``_gemv_int4`` for the sp step's O products, the int8 LM head
    on ``_gemv_int8``; the fused step one call of kernel 7's int4 mode.
    Held against the same step on the CPU (the plain twins) from the same
    tree and caches: logits within 5 % of the largest, caches at 0.05; the
    exact steps also against ``decode_step(fused=True)``, the same
    function, at the same limits."""
    import torch.distributed as dist

    from clusterfusion_tpu_torch.config import MeshConfig
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    gm = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    from clusterfusion_tpu_torch import parallel as par
    cfg = LlamaConfig.tiny(n_kv_heads=2, max_seq_len=64)
    kcfg = KernelConfig(int4_w4a8=a8)
    p = quantize_llama_params(model.init_params(cfg, seed=6, device="cpu"),
                              "int4", lm_head=True)
    kc, vc = model.init_cache(cfg, device="cpu")
    model.prefill(p, kc, vc, list(range(1, 21)), cfg)
    pd_ = {k: ({n: t.to(dev) for n, t in v.items()} if k == "layers"
               else v.to(dev)) for k, v in p.items()}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = par.build_mesh(MeshConfig())
        step = (par.make_sp_sharded_decode_step(cfg, mesh, kcfg)
                if which == "sp" else par.make_sharded_decode_step(
                    cfg, mesh, kcfg, fused_collectives=which == "fused"))
        kd, vd = kc.to(dev), vc.to(dev)
        n = (dl.int4_launches, gm.ffn4_launches, gm.int4_launches,
             gm.int8_launches, sk.int4_launches)
        lg, kd, vd = step(par.shard_params(pd_, cfg, mesh), kd, vd, 9, 20)
        torch.cuda.synchronize()
        got = (dl.int4_launches - n[0], gm.ffn4_launches - n[1],
               gm.int4_launches - n[2], gm.int8_launches - n[3],
               sk.int4_launches - n[4])
        lc, kc2, vc2 = step(par.shard_params(p, cfg, mesh), kc.clone(),
                            vc.clone(), 9, 20)
    finally:
        dist.destroy_process_group()
    L_ = cfg.n_layers
    assert got == {"tp": (L_, L_, 0, 1, 0), "sp": (L_, L_, L_, 1, 0),
                   "fused": (0, 0, 0, 0, 1)}[which]
    wants = [(lc, kc2)]
    if not a8:
        ref, kr, _ = model.decode_step(pd_, kc.to(dev), vc.to(dev), 9, 20,
                                       cfg, kcfg, fused=True)
        wants.append((ref, kr))
    for want, kw_ in wants:
        want = want.to(dev)
        scale = max(want.abs().max().item(), 1.0)
        assert (lg - want).abs().max().item() < 0.05 * scale
        torch.testing.assert_close(kd.float(), kw_.to(dev).float(), atol=0.05,
                                   rtol=0)


# -- 8-bit KV caches in kernels 7 and 8 (Int8KV, fp8 e4m3)

KV8_FORMATS = ("int8", "fp8")


def _kv8(kc, vc, fmt, pos):
    """bf16 caches as an 8-bit pair: rows < pos quantized as the kernels
    store rows (int8: ``quantize_kv_rows``, fp8: a cast), rows at and above
    pos NaN scales (int8) or NaN bytes 0x7F (fp8), which the kernels never
    read."""
    from clusterfusion_tpu_torch.ops import quant as tq
    out = []
    for c in (kc, vc):
        L_, H, cap, hd = c.shape
        if fmt == "int8":
            pair = tq.init_kv_int8(L_, H, cap, hd, device=c.device)
            tq.cache_fill_rows(pair, c[:, :, :pos].float(), 0)
            pair.s.view(L_, H, -1)[:, :, pos:] = float("nan")
        else:
            pair = c.float().to(torch.float8_e4m3fn)
            pair.view(torch.uint8)[:, :, pos:] = 0x7F
        out.append(pair)
    return out


def _kv8_clone(c):
    from clusterfusion_tpu_torch.ops import quant as tq
    return tq.Int8KV(c.q.clone(), c.s.clone()) if isinstance(c, tq.Int8KV) \
        else c.clone()


def _kv8_rows_held(got, want, rows, first_layer_tight):
    """Appended rows of an 8-bit cache against the twin's: int8 codes within
    1 and scales at rtol 1e-5 at layer 0 (the same f32 row up to a sum
    order), dequantized rows at atol 0.05 + scales at rtol 1e-2 in every
    layer; fp8 rows within one e4m3 step (rtol 0.125) + 0.05.  Every other
    row keeps its bits (codes, scales, bytes)."""
    from clusterfusion_tpu_torch.ops import quant as tq
    if isinstance(got, tq.Int8KV):
        L_, H = got.q.shape[:2]
        gs = got.s.view(L_, H, -1)
        ws = want.s.view(L_, H, -1)
        if first_layer_tight:
            dq = (got.q[0][:, rows].int() - want.q[0][:, rows].int()).abs()
            assert dq.max().item() <= 1
            torch.testing.assert_close(gs[0][:, rows], ws[0][:, rows],
                                       rtol=1e-5, atol=0)
        torch.testing.assert_close(gs[:, :, rows], ws[:, :, rows], rtol=1e-2,
                                   atol=0)
        torch.testing.assert_close(
            got.q[:, :, rows].float() * gs[:, :, rows, None],
            want.q[:, :, rows].float() * ws[:, :, rows, None], atol=0.05,
            rtol=0)
        others = torch.ones(got.q.shape[2], dtype=torch.bool,
                            device=got.q.device)
        others[rows] = False
        assert torch.equal(got.q[:, :, others], want.q[:, :, others])
        so = torch.ones(gs.shape[2], dtype=torch.bool, device=gs.device)
        so[rows] = False
        assert torch.equal(gs[:, :, so].view(torch.int32),
                           ws[:, :, so].view(torch.int32))
    else:
        torch.testing.assert_close(got[:, :, rows].float(),
                                   want[:, :, rows].float(), atol=0.05,
                                   rtol=0.125)
        others = torch.ones(got.shape[2], dtype=torch.bool, device=got.device)
        others[rows] = False
        assert torch.equal(got.view(torch.uint8)[:, :, others],
                           want.view(torch.uint8)[:, :, others])


def _kv8_weights(a, lm, weights):
    if weights == "int8":
        return _int8_stack(a, lm, "bf16")
    if weights == "int4":
        return _int4_stack(a, lm, "bf16")
    return a, dict(final_norm=lm["final_norm"], lm_head=lm["lm_head"])


@pytest.mark.parametrize("kv_split", [KV_SPLIT_DEFAULT, 32],
                         ids=["ks_default", "ks32"])
@pytest.mark.parametrize("pos", [0, 37, 127, 128, 300, CAP - 1])
@pytest.mark.parametrize("weights", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("fmt", KV8_FORMATS)
def test_stack_kv8_kernel_matches_plain(dev, fmt, weights, pos, kv_split):
    """Kernel 7 on an Int8KV and an fp8 cache against its plain twin at the
    same kv_split, with bf16, int8 and int4 (exact) weights, the appends at
    and around a plane row's boundary, NaN above pos."""
    shape = (4, 4, 2) if weights == "bf16" else INT8_SHAPES[0]
    g, a, kc, vc, lm = _stack_args(dev, *shape, pos, seed=90)
    k8, v8 = _kv8(kc, vc, fmt, pos)
    w, head = _kv8_weights(a, lm, weights)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_row(cfg, pos, dev)
    kcfg = KernelConfig(kv_split=kv_split, int4_w4a8=False)
    kw = dict(group=g, head_dim=HD, rope_style=cfg.rope_style, eps=1e-5,
              **head)
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, w["wqkv_f"],
            w["wo_f"], w["w13"], w["w2"]]
    kp, vp = _kv8_clone(k8), _kv8_clone(v8)
    kind = sk.KV_INT8 if fmt == "int8" else sk.KV_FP8
    before = (sk.launches, sk.kv8_launches[kind])
    out = sk.fused_decoder_stack(*args, k8, v8, pos, kcfg=kcfg, **kw)
    torch.cuda.synchronize()
    assert (sk.launches, sk.kv8_launches[kind]) == (before[0] + 1,
                                                    before[1] + 1)
    assert sk.last_step_kernels == 8 * L - (pos == 0) * L + 2
    ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos, kv_split=kv_split,
                                       int4_w4a8=False, **kw)
    assert torch.isfinite(out[0]).all()
    err = (out[0] - ref[0]).abs().max().item()
    assert err <= 2e-2 * ref[0].abs().max().item(), err
    torch.testing.assert_close(out[1].float(), ref[1].float(), atol=2e-2,
                               rtol=2e-2)
    for got, want in ((k8, kp), (v8, vp)):
        _kv8_rows_held(got, want, [pos], True)


@pytest.mark.parametrize("n,pos", [(1, 37), (2, 0), (5, 126), (9, 300),
                                   (17, 120)])
@pytest.mark.parametrize("weights", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("fmt", KV8_FORMATS)
def test_verify_kv8_kernel_matches_plain(dev, fmt, weights, n, pos):
    """Kernel 8 on an Int8KV and an fp8 cache against its plain twin, the
    fresh rows straddling a plane row (5 from 126, 17 from 120), NaN above
    pos."""
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    shape = (4, 4, 2) if weights == "bf16" else INT8_SHAPES[0]
    g, a, kc, vc, lm = _stack_args(dev, *shape, pos, seed=91)
    k8, v8 = _kv8(kc, vc, fmt, pos)
    w, head = _kv8_weights(a, lm, weights)
    x = _randn((n, HIDDEN), dev, 92)
    cos, sin = model.rope_rows(LlamaConfig.tiny(), pos, n, dev)
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5, **head)
    args = [x, a["attn_norm"], a["ffn_norm"], cos, sin, w["wqkv_f"],
            w["wo_f"], w["w13"], w["w2"]]
    kp, vp = _kv8_clone(k8), _kv8_clone(v8)
    kind = sk.KV_INT8 if fmt == "int8" else sk.KV_FP8
    before = sv.kv8_launches[kind]
    kcfg = KernelConfig(kv_split=128, int4_w4a8=False)
    out = sv.fused_verify_stack(*args, k8, v8, pos, kcfg=kcfg, **kw)
    torch.cuda.synchronize()
    assert sv.kv8_launches[kind] == before + 1
    ref = sv.fused_verify_stack_plain(*args, kp, vp, pos, kv_split=128,
                                      int4_w4a8=False, **kw)
    assert torch.isfinite(out[0]).all()
    err = (out[0] - ref[0]).abs().max().item()
    assert err <= 2e-2 * ref[0].abs().max().item(), err
    for got, want in ((k8, kp), (v8, vp)):
        _kv8_rows_held(got, want, list(range(pos, pos + n)), True)


@pytest.mark.parametrize("fmt", KV8_FORMATS)
def test_kv8_kernels_are_bit_reproducible(dev, fmt):
    """Kernels 7 and 8 on an 8-bit cache give the same bits on every call,
    the appended codes, scales and bytes too."""
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    pos = 300
    g, a, kc, vc, lm = _stack_args(dev, 4, 4, 2, pos, seed=93)
    k8, v8 = _kv8(kc, vc, fmt, pos)
    cfg = LlamaConfig.tiny()
    kw = dict(group=g, head_dim=HD, rope_style=cfg.rope_style, eps=1e-5,
              **lm)
    w = [a[k] for k in ("wqkv_f", "wo_f", "w13", "w2")]
    for n in (1, 5):
        cos, sin = model.rope_rows(cfg, pos, n, dev)
        x = _randn((n, HIDDEN), dev, 94)
        fn = sk.fused_decoder_stack if n == 1 else sv.fused_verify_stack
        runs = []
        for _ in range(3):
            k, v = _kv8_clone(k8), _kv8_clone(v8)
            out = fn(x, a["attn_norm"], a["ffn_norm"], cos, sin, *w, k, v,
                     pos, **kw)
            runs.append((out[0], out[1], k.q, k.s.view(torch.int32), v.q,
                         v.s.view(torch.int32)) if fmt == "int8"
                        else (out[0], out[1], k.view(torch.uint8),
                              v.view(torch.uint8)))
        torch.cuda.synchronize()
        for run in runs[1:]:
            for got, want in zip(run, runs[0]):
                assert torch.equal(got, want)


@pytest.mark.parametrize("fmt", KV8_FORMATS)
def test_stack_kv8_kernel_at_7b(dev, fmt):
    """Kernel 7 and kernel 8 (n 5) on an 8-bit cache at Llama-2-7B widths
    (two layers, cap 4096) against their twins, at pos 600 and 4000 (n 5
    from 1022: the fresh rows straddle plane row 8)."""
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    cfg = LlamaConfig.llama2_7b()
    hidden, kvh, g = cfg.hidden_dim, cfg.kv_heads, cfg.n_heads // cfg.kv_heads
    hg, G, f_pad, cap = 4, cfg.kv_heads // 4, 11264, 4096
    a = dict(attn_norm=1 + _randn((L, hidden), dev, 95, 0.1),
             ffn_norm=1 + _randn((L, hidden), dev, 96, 0.1),
             wqkv_f=_randn((L, G, hidden, hg * (g + 2) * HD), dev, 97,
                           hidden ** -0.5),
             wo_f=_randn((L, G, hg * g * HD, hidden), dev, 98,
                         (g * HD) ** -0.5),
             w13=_randn((L, 2, hidden, f_pad), dev, 99, hidden ** -0.5),
             w2=_randn((L, f_pad, hidden), dev, 100, f_pad ** -0.5))
    lm = dict(final_norm=1 + _randn((hidden,), dev, 101, 0.1),
              lm_head=_randn((hidden, cfg.vocab_size), dev, 102,
                             hidden ** -0.5))
    kc = _randn((L, kvh, cap, HD), dev, 103)
    vc = _randn((L, kvh, cap, HD), dev, 104)
    kw = dict(group=g, head_dim=HD, rope_style=cfg.rope_style, eps=1e-5,
              **lm)
    w = [a[k] for k in ("wqkv_f", "wo_f", "w13", "w2")]
    for fn, plain, n, pos in ((sk.fused_decoder_stack,
                               sk.fused_decoder_stack_plain, 1, 600),
                              (sk.fused_decoder_stack,
                               sk.fused_decoder_stack_plain, 1, 4000),
                              (sv.fused_verify_stack,
                               sv.fused_verify_stack_plain, 5, 1022)):
        k8, v8 = _kv8(kc, vc, fmt, pos)
        kp, vp = _kv8_clone(k8), _kv8_clone(v8)
        cos, sin = model.rope_rows(cfg, pos, n, dev)
        x = _randn((n, hidden), dev, 105)
        out = fn(x, a["attn_norm"], a["ffn_norm"], cos, sin, *w, k8, v8, pos,
                 **kw)
        ref = plain(x, a["attn_norm"], a["ffn_norm"], cos, sin, *w, kp, vp,
                    pos, **kw)
        torch.cuda.synchronize()
        err = (out[0] - ref[0]).abs().max().item()
        assert err <= 2e-2 * ref[0].abs().max().item(), (pos, err)
        for got, want in ((k8, kp), (v8, vp)):
            _kv8_rows_held(got, want, list(range(pos, pos + n)), True)


@pytest.mark.parametrize("fmt", KV8_FORMATS)
def test_kv8_engine_streams_on_card(dev, fmt):
    """An engine with an 8-bit cache on the card: ``stream_generate`` runs
    kernel 7's 8-bit mode once a token and ``spec_generate`` (self-draft)
    kernel 8's once a round; the stream agrees with the eager step's
    wherever its top-2 gap clears 0.1, and spec with the stream where the
    stream's gap does."""
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    kv_dtype = "int8" if fmt == "int8" else torch.float8_e4m3fn
    kind = sk.KV_INT8 if fmt == "int8" else sk.KV_FP8
    cfg = LlamaConfig.tiny(n_kv_heads=2, max_seq_len=256)
    eng = Llama.synthetic(cfg, seed=5, device=dev, kv_dtype=kv_dtype)
    prompt = list(range(1, 121))
    b7, b8 = sk.kv8_launches[kind], sv.kv8_launches[kind]
    stream = list(eng.stream_generate(prompt, 12, temperature=0.0))
    assert sk.kv8_launches[kind] - b7 == 12
    spec = eng.spec_generate(prompt, 12, eng, n_draft=3)
    assert sv.kv8_launches[kind] - b8 == eng.spec_stats["rounds"] >= 1
    kc, vc = model.init_cache(cfg, device=dev, dtype=kv_dtype)
    lg, kc, vc = model.prefill(eng.params, kc, vc, prompt, cfg)
    for i, t in enumerate(stream):
        top = torch.topk(lg.reshape(-1, lg.shape[-1])[-1], 2).values
        if (top[0] - top[1]).item() > 0.1:
            assert int(torch.argmax(lg.reshape(-1, lg.shape[-1])[-1])) == t
            assert spec[i] == t
        else:
            break
        lg, kc, vc = model.decode_step(eng.params, kc, vc, t, len(prompt) + i,
                                       cfg, fused=False)


# -- 8-bit KV caches on the multi-card paths (kernel 6's fp8 mode, kernel 7's
# mode 5 on Int8KV and fp8, the tp, sp and fused tp steps)


def _fp8_pair(kc, vc, seq):
    """bf16 caches as an fp8 e4m3 pair, NaN bytes 0x7F at and above seq
    (rows kernel 6 never reads)."""
    out = []
    for c in (kc, vc):
        f = c.float().to(torch.float8_e4m3fn)
        f.view(torch.uint8)[:, :, seq:] = 0x7F
        out.append(f)
    return out


def _e4m3_one_step(got, want):
    """Two e4m3 rows whose float32 sources differ by a sum order: every
    byte equal or one code apart (adjacent values of one sign; both zero
    or the least denormal); returns the share of equal bytes."""
    a = got.view(torch.uint8).int()
    b = want.view(torch.uint8).int()
    near = ((a ^ b) & 0x80 == 0) & ((a - b).abs() <= 1)
    near |= ((a & 0x7F) <= 1) & ((b & 0x7F) <= 1)
    assert near.all(), int((~near).sum())
    return (a == b).float().mean().item()


FP8_LAYER_MODES = ("full_append", "partials_fold1", "partials_fold0",
                   "seq0_append", "nan_full_append")
FP8_LAYER_CASES = ("g1_hg1", "g8_hg2", "hd64_g8_hg2", "7b_hg8")


@pytest.mark.parametrize("mode", FP8_LAYER_MODES)
@pytest.mark.parametrize("weights", ["bf16", "int8", "exact", "w4a8"])
@pytest.mark.parametrize("case", FP8_LAYER_CASES)
def test_decoder_layer_fp8_kv_matches_plain(dev, case, weights, mode):
    """Kernel 6's fp8 mode against its plain twin in every weight kind
    (bf16, int8, int4 exact and W4A8) at groups 1 and 8, head groups 1, 2
    and 8, hd 128 and 64, and the 7B layer: counted as fp8 (and as its
    weight kind), the same bits on a repeat, at the weight kinds' limits
    (W4A8 within 2e-2 of each output's largest value, else atol 2e-2 /
    rtol 2e-2, partials' acc 5e-2).  The appended e4m3 row is within one
    code of the twin's (e4m3 of float32 rows that differ by a sum order),
    and every other byte, the NaN bytes above seq too, keeps its bits."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops.quant import quantize_int4, quantize_int8
    hidden, n_heads, kv_heads, hg, hd = INT4_LAYER_CASES[case]
    seq, style, fuse, append, partials, fold = LAYER_MODES[mode]
    g, args, kc, vc = _layer_case(dev, hidden, n_heads, kv_heads, hg, hd,
                                  CAP, seq, seed=150)
    kc, vc = _fp8_pair(kc, vc, seq)
    args = list(args)
    if weights == "int8":
        args[5], args[6] = (quantize_int8(args[5], -2),
                            quantize_int8(args[6], -2))
    elif weights != "bf16":
        args[5], args[6] = (quantize_int4(args[5], -2),
                            quantize_int4(args[6], -2))
    cfg = LlamaConfig.tiny(hidden_dim=hidden, n_heads=n_heads,
                           n_kv_heads=kv_heads, head_dim=hd, rope_style=style)
    args[3], args[4] = model.rope_row(cfg, seq, dev)
    a8 = weights == "w4a8"
    kw = dict(group=g, head_dim=hd, rope_style=style, fuse_residual=fuse,
              eps=1e-5, emit_partials=partials, fold_current=fold,
              append_kv=append, kcfg=KernelConfig(int4_w4a8=a8))
    kp, vp = kc.clone(), vc.clone()
    before = (dl.launches, dl.fp8_launches)
    out = dl._fused_decoder_layer(*args, kc, vc, seq, 0, **kw)
    torch.cuda.synchronize()
    assert (dl.launches, dl.fp8_launches) == (before[0] + 1, before[1] + 1)
    assert dl.last_call_kernels == (2 if a8 and not partials else 1)
    k2, v2 = kp.clone(), vp.clone()
    again = dl._fused_decoder_layer(*args, k2, v2, seq, 0, **kw)
    for x, y in zip(out, again):
        assert (x is None and y is None) or _bits_equal(x, y)
    ref = dl._fused_decoder_layer_plain(*args, kp, vp, seq, 0, **kw)
    tol = dict(atol=2e-2, rtol=2e-2)
    for i in ((1, 0) if partials else (0,)):
        assert torch.isfinite(out[i].float()).all()
        if a8:
            _near_largest(out[i], ref[i])
        else:
            torch.testing.assert_close(out[i].float(), ref[i].float(),
                                       **(tol if i or not partials else
                                          dict(atol=5e-2, rtol=2e-2)))
    res_i = 2 if partials else 1
    torch.testing.assert_close(out[res_i].float(), ref[res_i].float(), **tol)
    for i in (res_i + 1, res_i + 2):
        torch.testing.assert_close(out[i].float(), ref[i].float(), atol=0.05,
                                   rtol=0)
    others = torch.ones(CAP, dtype=torch.bool, device=dev)
    if append:
        others[seq] = False
        for c, c2, p in ((kc, k2, kp), (vc, v2, vp)):
            _e4m3_one_step(c[0, :, seq], p[0, :, seq])
            assert _bits_equal(c[0, :, seq], c2[0, :, seq])
    for c, p in ((kc, kp), (vc, vp)):
        assert _bits_equal(c[:, :, others], p[:, :, others])


def test_decoder_layer_refuses_int8kv_on_card(dev):
    """Kernel 6 on the card refuses an ``Int8KV`` pair (the JAX package's
    kernel 6 takes none) and a pair of two kinds before any launch."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops import quant as tq
    g, args, kc, vc = _layer_case(dev, 512, 8, 8, 1, 128, CAP, 37, seed=151)
    k8 = tq.init_kv_int8(1, 8, CAP, 128, device=dev)
    f8, _ = _fp8_pair(kc, vc, 37)
    kw = dict(group=g, head_dim=128, rope_style="neox", fuse_residual=True,
              eps=1e-5)
    n = dl.launches
    with pytest.raises(NotImplementedError, match="take none"):
        dl._fused_decoder_layer(*args, k8, k8, 37, 0, **kw)
    for a, b in ((f8, vc), (kc, k8)):
        with pytest.raises(ValueError, match="one kind"):
            dl._fused_decoder_layer(*args, a, b, 37, 0, **kw)
    assert dl.launches == n


@pytest.mark.parametrize("weights", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", KV8_FORMATS)
def test_stack_kv8_mode5_loopback_matches_unsharded(dev, fmt, weights):
    """Kernel 7's mode 5 on an 8-bit cache at tp 2 on one card (two
    virtual ranks on their own streams over a loopback communicator, each
    with its ``shard_cache`` slice of the pair): 8L+1 kernels a rank,
    counted as 8-bit; both ranks' x_out and residual bit-identical, a
    repeat the same bits, within 2e-2 of kernel 7's unsharded step on the
    same cache; each rank's appended rows as the unsharded step's of its
    heads (``_kv8_rows_held``: every other row keeps its bits).  With the
    LM head gathered (8L+3 kernels) the ranks' logits are bit-identical
    and within 2e-2 of the unsharded logits."""
    from clusterfusion_tpu_torch.ops.quant import Int8KV
    from clusterfusion_tpu_torch.parallel import collective as col
    from clusterfusion_tpu_torch.parallel.sharding import shard_cache
    pos, tp = 130, 2
    g, a, kc, vc, lm = _stack_args(dev, 16, 8, 4, pos, seed=152)
    head = dict(final_norm=lm["final_norm"], lm_head=lm["lm_head"])
    if weights == "int8":
        w, head = _int8_stack(a, lm, "bf16")
        a = dict(a, **w)
    k8, v8 = _kv8(kc, vc, fmt, pos)
    cos, sin = model.rope_row(LlamaConfig.tiny(), pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5)
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, a["wqkv_f"],
            a["wo_f"], a["w13"], a["w2"]]
    kr, vr = _kv8_clone(k8), _kv8_clone(v8)
    ref = sk.fused_decoder_stack(*args, kr, vr, pos, **kw)
    ref_lg = sk.fused_decoder_stack(*args, _kv8_clone(k8), _kv8_clone(v8),
                                    pos, **head, **kw)[0]
    kind = sk.KV_INT8 if fmt == "int8" else sk.KV_FP8
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards, heads, _ = _int8_mode5_shards(a, head["lm_head"], kc, vc,
                                              meshes)
        caches = [(shard_cache(_kv8_clone(k8), m),
                   shard_cache(_kv8_clone(v8), m)) for m in meshes]
        assert all(isinstance(c[0], Int8KV) == (fmt == "int8")
                   for c in caches)
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        n8 = sk.kv8_launches[kind]
        outs, kernels = _mode5_step(a, shards, caches, meshes, streams, cos,
                                    sin, pos, kw)
        again, _ = _mode5_step(a, shards, [(_kv8_clone(k), _kv8_clone(v))
                                           for k, v in caches],
                               meshes, streams, cos, sin, pos, kw)
        first, gk = _mode5_step(a, shards, [(_kv8_clone(k), _kv8_clone(v))
                                            for k, v in caches],
                                meshes, streams, cos, sin, pos, kw,
                                head=(head["final_norm"], heads), gather=True)
        torch.cuda.synchronize(dev)
        lb.check()
        assert kernels == [8 * L + 1] * tp and gk == [8 * L + 3] * tp
        assert sk.kv8_launches[kind] == n8 + 3 * tp
    finally:
        lb.close()
    for r, (xo, ro, k, v) in enumerate(outs):
        assert torch.equal(xo, outs[0][0]) and torch.equal(ro, outs[0][1])
        assert torch.equal(xo, again[r][0]) and torch.equal(ro, again[r][1])
        torch.testing.assert_close(xo.float(), ref[0].float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(ro.float(), ref[1].float(), atol=2e-2,
                                   rtol=2e-2)
        heads_r = slice(r * 8 // tp, (r + 1) * 8 // tp)
        for got, full in ((k, kr), (v, vr)):
            want = Int8KV(full.q[:, heads_r], full.s[:, heads_r]) \
                if fmt == "int8" else full[:, heads_r]
            _kv8_rows_held(got, want, [pos], True)
    lg = [o[0] for o in first]
    for r in range(tp):
        assert torch.equal(lg[r].view(torch.int32), lg[0].view(torch.int32))
    assert (lg[0] - ref_lg).abs().max().item() <= \
        2e-2 * ref_lg.abs().max().item()


@pytest.mark.parametrize("which", ["tp_fp8", "sp_fp8", "fused_fp8",
                                   "fused_int8"])
def test_kv8_sharded_steps_on_card_one_rank(dev, tmp_path, which):
    """The tp, sp and fused tp steps on an 8-bit cache in a one-process
    group on the card, after a 130-token prefill: kernel 6's fp8 mode once
    a layer (tp, sp), or one call of kernel 7's 8-bit mode 5 (fused, fp8
    and ``Int8KV``); against ``decode_step(fused=True)`` on the same cache
    (kernel 7's single-card 8-bit step): logits within 5 % of the largest,
    the appended rows as ``_kv8_rows_held`` holds them beside the twin's
    (the sp step stores e4m3 of the bf16 row, one step at most apart)."""
    import torch.distributed as dist

    from clusterfusion_tpu_torch.config import MeshConfig
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch import parallel as par
    step_kind, fmt = which.split("_")
    kv_dtype = "int8" if fmt == "int8" else torch.float8_e4m3fn
    kind = sk.KV_INT8 if fmt == "int8" else sk.KV_FP8
    cfg = LlamaConfig.tiny(n_kv_heads=2, max_seq_len=256)
    p = model.init_params(cfg, seed=7, device=dev)
    kc, vc = model.init_cache(cfg, device=dev, dtype=kv_dtype)
    pos = 130
    model.prefill(p, kc, vc, list(range(1, pos + 1)), cfg)
    kr, vr = _kv8_clone(kc), _kv8_clone(vc)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = par.build_mesh(MeshConfig())
        step = (par.make_sp_sharded_decode_step(cfg, mesh)
                if step_kind == "sp" else par.make_sharded_decode_step(
                    cfg, mesh, fused_collectives=step_kind == "fused"))
        n = (dl.fp8_launches, sk.kv8_launches[kind])
        lg, kc2, vc2 = step(par.shard_params(p, cfg, mesh), kc, vc, 9, pos)
        torch.cuda.synchronize()
        got = (dl.fp8_launches - n[0], sk.kv8_launches[kind] - n[1])
    finally:
        dist.destroy_process_group()
    assert kc2 is kc and vc2 is vc
    L_ = cfg.n_layers
    assert got == ((0, 1) if step_kind == "fused" else (L_, 0))
    ref, kr, vr = model.decode_step(p, kr, vr, 9, pos, cfg, fused=True)
    scale = max(ref.abs().max().item(), 1.0)
    assert (lg - ref).abs().max().item() < 0.05 * scale
    for got_c, want_c in ((kc, kr), (vc, vr)):
        _kv8_rows_held(got_c, want_c, [pos], step_kind == "fused")


# -- head dim 64 in kernel 7 (the TPU kernel's defer_append variant)

# (n_heads, kv_heads, hg) at hd 64: TinyLlama's group 8 on 4 kv heads in one
# head group of 4 (its bf16 and quantized grouping), and group 2 over 2
# head groups (the O projection's groups summed)
HD64_SHAPES = [(32, 4, 4), (8, 4, 2)]
# weight kind: (stack weights, KernelConfig.int4_w4a8)
HD64_WEIGHTS = {"bf16": ("bf16", True), "int8": ("int8", True),
                "int4_w4a8": ("int4", True), "int4_exact": ("int4", False)}


def _kv_layers(c, lo, hi):
    """A copy of layers lo..hi-1 of a bf16, fp8 or Int8KV cache."""
    from clusterfusion_tpu_torch.ops import quant as tq
    if isinstance(c, tq.Int8KV):
        return tq.Int8KV(c.q[lo:hi].clone(), c.s[lo:hi].clone())
    return c[lo:hi].clone()


def _hd64_case(dev, shape, weights, kv, pos, seed):
    """Kernel 7's inputs at hd 64: (kw, args, k cache, v cache, kcfg), the
    caches bf16 with NaN above pos, or 8-bit as ``_kv8`` makes them."""
    g, a, kc, vc, lm = _stack_args(dev, *shape, pos, seed=seed, hd=64)
    kind, a8 = HD64_WEIGHTS[weights]
    w, head = _kv8_weights(a, lm, kind)
    if kv == "bf16":
        kc[:, :, pos + 1:] = float("nan")
        vc[:, :, pos + 1:] = float("nan")
    else:
        kc, vc = _kv8(kc, vc, kv, pos)
    cfg = LlamaConfig.tiny(head_dim=64, rope_style="neox")
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=64, rope_style="neox", eps=1e-5, **head)
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, w["wqkv_f"],
            w["wo_f"], w["w13"], w["w2"]]
    return kw, args, kc, vc, KernelConfig(int4_w4a8=a8)


def _hd64_rows_held(got, want, pos, kv, tight):
    """Appended rows at hd 64 against the twin's: bf16 at atol 0.05; 8-bit
    as ``_kv8_rows_held`` holds every layer, and at layer 0 (``tight``)
    int8 codes within 1 and scales within one bf16 step of the row's
    absmax (2^-8: both store the bf16-rounded row, whose absmax a bf16
    rounding may move), fp8 bytes within one code and 99 % equal."""
    if kv == "bf16":
        torch.testing.assert_close(got[:, :, pos].float(),
                                   want[:, :, pos].float(), atol=0.05, rtol=0)
        others = torch.ones(got.shape[2], dtype=torch.bool, device=got.device)
        others[pos] = False
        assert _same_bits(got[:, :, others], want[:, :, others])
        return
    _kv8_rows_held(got, want, [pos], False)
    if not tight:
        return
    if kv == "int8":
        dq = (got.q[0, :, pos].int() - want.q[0, :, pos].int()).abs()
        assert dq.max().item() <= 1
        L_, H = got.q.shape[:2]
        torch.testing.assert_close(got.s.view(L_, H, -1)[0, :, pos],
                                   want.s.view(L_, H, -1)[0, :, pos],
                                   rtol=2.0 ** -8, atol=0)
    else:
        gb = got.view(torch.uint8)[0, :, pos].int()
        wb = want.view(torch.uint8)[0, :, pos].int()
        assert (gb - wb).abs().max().item() <= 1
        assert (gb == wb).float().mean().item() >= 0.99


@pytest.mark.parametrize("pos", [0, 37, 300, CAP - 1])
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("weights", list(HD64_WEIGHTS))
@pytest.mark.parametrize("shape", HD64_SHAPES, ids=["g8_hg4", "g2_hg2"])
def test_hd64_stack_kernel_matches_plain(dev, shape, weights, kv, pos):
    """Kernel 7 at hd 64 against its plain twin, with bf16, int8, int4
    W4A8 and int4 exact weights on a bf16, an Int8KV and an fp8 cache, NaN
    above pos: one launch counted (and one 8-bit launch), 8L+1 kernels and
    the LM head's; logits within 2e-2 of the largest and the residual at
    atol/rtol 2e-2 (W4A8: each layer from one input, teacher-forced, as
    ``_w4a8_by_layer`` holds it); the appended rows (the bf16-row rule of
    hd 64 on an 8-bit cache) as ``_hd64_rows_held`` holds them."""
    kw, args, kc, vc, kcfg = _hd64_case(dev, shape, weights, kv, pos, 160)
    kind = {"int8": sk.KV_INT8, "fp8": sk.KV_FP8}.get(kv)
    kp, vp = _kv8_clone(kc), _kv8_clone(vc)
    before = (sk.launches, sk.kv8_launches.get(kind, 0))
    out = sk.fused_decoder_stack(*args, kc, vc, pos, kcfg=kcfg, **kw)
    torch.cuda.synchronize()
    assert sk.launches == before[0] + 1
    assert kind is None or sk.kv8_launches[kind] == before[1] + 1
    assert sk.last_step_kernels == 8 * L - (pos == 0) * L + 2
    assert torch.isfinite(out[0]).all()
    if weights != "int4_w4a8":
        ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos,
                                           int4_w4a8=kcfg.int4_w4a8, **kw)
        err = (out[0] - ref[0]).abs().max().item()
        assert err <= 2e-2 * ref[0].abs().max().item(), err
        torch.testing.assert_close(out[1].float(), ref[1].float(), atol=2e-2,
                                   rtol=2e-2)
        for got, want in ((kc, kp), (vc, vp)):
            _hd64_rows_held(got, want, pos, kv, True)
        return
    # W4A8: layer l of the kernel and of its twin from one input, the
    # kernel's own state after its first l layers
    x, norms, rope, proj = args[0], args[1:3], args[3:5], args[5:]
    bare = {k: v for k, v in kw.items() if k not in ("final_norm", "lm_head")}
    for l in range(L):
        xl = x
        if l:
            h, r, _, _ = sk.fused_decoder_stack(
                x, *(t[:l] for t in norms), *rope, *(t[:l] for t in proj),
                _kv_layers(kp, 0, l), _kv_layers(vp, 0, l), pos, kcfg=kcfg,
                **bare)
            xl = (h.float() + r.float()).bfloat16()
        one = (xl, *(t[l:l + 1] for t in norms), *rope,
               *(t[l:l + 1] for t in proj))
        kk, vk = _kv_layers(kp, l, l + 1), _kv_layers(vp, l, l + 1)
        kt, vt = _kv_layers(kp, l, l + 1), _kv_layers(vp, l, l + 1)
        got = sk.fused_decoder_stack(*one, kk, vk, pos, kcfg=kcfg, **kw)
        ref = sk.fused_decoder_stack_plain(*one, kt, vt, pos, int4_w4a8=True,
                                           **kw)
        for a_, b_ in zip(got[:2], ref[:2]):
            err = (a_.float() - b_.float()).abs().max().item()
            assert err <= 2e-2 * b_.float().abs().max().item(), (l, err)
        for g_, w_ in ((kk, kt), (vk, vt)):
            _hd64_rows_held(g_, w_, pos, kv, True)


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("weights", ["bf16", "int4_w4a8"])
def test_hd64_stack_kernel_is_bit_reproducible(dev, weights, kv):
    """Kernel 7 at hd 64 gives the same bits on every call: logits,
    residual and the appended rows (codes, scales, bytes)."""
    runs = []
    for _ in range(3):
        kw, args, kc, vc, kcfg = _hd64_case(dev, HD64_SHAPES[0], weights, kv,
                                            300, 161)
        out = sk.fused_decoder_stack(*args, kc, vc, 300, kcfg=kcfg, **kw)
        caches = [c.q for c in (kc, vc)] + [c.s.view(torch.int32)
                                            for c in (kc, vc)] \
            if kv == "int8" else [c.view(torch.uint8) for c in (kc, vc)]
        runs.append((out[0], out[1].view(torch.int16), *caches))
    torch.cuda.synchronize()
    for run in runs[1:]:
        for got, want in zip(run, runs[0]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["bf16-bf16", "int4_w4a8-int8"])
def test_hd64_stack_mode5_loopback_matches_twin(dev, case):
    """Kernel 7's mode 5 at hd 64 as a tp-2 pair on one card (two virtual
    ranks on their own streams over a loopback communicator, each with its
    ``shard_params`` / ``shard_cache`` slices of a tree of 16 heads on 4 kv
    heads in head groups of 2): 8L+1 kernels a rank, both ranks' x_out and
    residual bit-identical and repeated bit for bit; each layer, from the
    pair's own state (teacher-forced), within 2e-2 of the largest value of
    its twin over the ranks (``fused_decoder_stack_plain_ranks``), the
    appended rows as ``_hd64_rows_held``.  Runs bf16 weights on a bf16
    cache, and int4 W4A8 weights on an Int8KV cache."""
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    from clusterfusion_tpu_torch.parallel import collective as col
    weights, kv = case.split("-")
    pos, tp = 130, 2
    cfg = LlamaConfig.tiny(n_heads=16, n_kv_heads=4, head_dim=64,
                           rope_style="neox", max_seq_len=CAP)
    p = model.init_params(cfg, seed=162, head_group=2, device=dev)
    if weights != "bf16":
        p = quantize_llama_params(p, "int4")
    kc, vc = model.init_cache(cfg, device=dev)
    kc[:, :, :pos] = _randn(kc[:, :, :pos].shape, dev, 163)
    vc[:, :, :pos] = _randn(vc[:, :, :pos].shape, dev, 164)
    if kv != "bf16":
        kc, vc = _kv8(kc, vc, kv, pos)
    cos, sin = model.rope_row(cfg, pos, dev)
    kcfg = KernelConfig(int4_w4a8=True)
    kw = dict(group=4, head_dim=64, rope_style="neox", eps=cfg.norm_eps)
    names = ("attn_norm", "ffn_norm", "wqkv_f", "wo_f", "w13", "w2")
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards = [par.shard_params(p, cfg, m)["layers"] for m in meshes]
        caches = [(par.shard_cache(kc, m), par.shard_cache(vc, m))
                  for m in meshes]
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]

        def pair(x, ly):
            cs = [(_kv_layers(k, ly.start, ly.stop),
                   _kv_layers(v, ly.start, ly.stop)) for k, v in caches]
            outs, n = [], []
            for r in range(tp):
                streams[r].wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(streams[r]):
                    sl = shards[r]
                    outs.append(sk.fused_decoder_stack(
                        x, *(sl[k][ly] for k in names[:2]), cos, sin,
                        *(sl[k][ly] for k in names[2:]), *cs[r], pos,
                        kcfg=kcfg, reduce_axis="tp", mesh=meshes[r], **kw))
                    n.append(sk.last_step_kernels)
            for st in streams:
                torch.cuda.current_stream(dev).wait_stream(st)
            return outs, n

        x0 = p["embed"][torch.tensor([5], device=dev)]
        outs, n = pair(x0, slice(0, L))
        again, _ = pair(x0, slice(0, L))
        torch.cuda.synchronize(dev)
        lb.check()
        assert n == [8 * L + 1] * tp
        for o, a_ in zip(outs, again):
            for j in (0, 1):
                assert _same_bits(o[j], outs[0][j])
                assert _same_bits(o[j], a_[j])
        x = x0
        for l in range(L):
            one = slice(l, l + 1)
            got, _ = pair(x, one)
            want = sk.fused_decoder_stack_plain_ranks(
                [(x, *(shards[r][k][one] for k in names[:2]), cos, sin,
                  *(shards[r][k][one] for k in names[2:]),
                  _kv_layers(caches[r][0], l, l + 1),
                  _kv_layers(caches[r][1], l, l + 1), pos)
                 for r in range(tp)], int4_w4a8=True, **kw)
            torch.cuda.synchronize(dev)
            lb.check()
            for g_, w_ in zip(got, want):
                for j in (0, 1):
                    err = (g_[j].float() - w_[j].float()).abs().max().item()
                    assert err <= 2e-2 * w_[j].float().abs().max().item()
                for j in (2, 3):
                    _hd64_rows_held(g_[j], w_[j], pos, kv, True)
            x = (got[0][0].float() + got[0][1].float()).bfloat16()
    finally:
        lb.close()


@pytest.mark.parametrize("hd", [32, 96])
def test_stack_c_entry_refuses_other_head_dims(dev, hd):
    """Kernel 7's C entry takes hd 64 and 128 (the only widths a card test
    covers): at 32 and 96 it returns cudaErrorInvalidValue (1) before it
    launches anything."""
    from clusterfusion_tpu_torch.ops import _build
    import ctypes
    lib = _build.lib()
    buf = torch.zeros(1 << 20, device=dev)
    p = [buf.data_ptr()] * 17
    n_launch = ctypes.c_int(-1)
    st = torch.cuda.current_stream(dev).cuda_stream
    dims = [1, 512, 2, 1, 2, hd, 64, 512, 0, 8, 1]
    err = lib.cf_decoder_stack(*p, *dims, 1e-5, 64, 256,
                               ctypes.byref(n_launch), None, 0, st,
                               *[None] * 5, 0, 0, 0, None, None, 0, 0)
    torch.cuda.synchronize()
    assert err == 1
    assert n_launch.value == 0


@pytest.mark.parametrize("quant,kv", [(None, "bf16"), ("int4", "int8")])
def test_hd64_engine_streams_on_card(dev, quant, kv):
    """``Llama.stream_generate`` at the JAX package's hd-64 test geometry
    on the card (fused: one kernel-7 launch a token), bf16 and at the
    operating point int4 W4A8 + Int8KV: 12 greedy tokens after a 20-token
    prompt, teacher-forced into the plain twin's step (the same cache
    kind) wherever its top-2 gap exceeds 0.1."""
    from clusterfusion_tpu_torch.models.generation import Llama
    cfg = LlamaConfig.tiny(head_dim=64, n_kv_heads=2, n_layers=2,
                           max_seq_len=256, rope_style="neox")
    eng = Llama.synthetic(cfg, seed=11, fused=True, quant=quant, device=dev,
                          kv_dtype="int8" if kv == "int8" else torch.bfloat16)
    prompt = [1 + (7 * i) % 300 for i in range(20)]
    before = sk.launches
    toks = list(eng.stream_generate(prompt, 12, temperature=0.0))
    torch.cuda.synchronize()
    assert len(toks) == 12 and sk.launches - before == 12
    kc, vc = model.init_cache(cfg, device=dev, dtype=eng.kv_dtype)
    lg, kc, vc = model.prefill(eng.params, kc, vc, prompt, cfg)
    lg = lg[-1]
    lw = eng.params["layers"]
    for i, t in enumerate(toks):
        top = torch.topk(lg, 2).values
        if (top[0] - top[1]).item() > 0.1:
            assert int(torch.argmax(lg)) == t, i
        pos = len(prompt) + i
        cos, sin = model.rope_row(cfg, pos, dev)
        x = eng.params["embed"][torch.tensor([t], device=dev)]
        lg, _, kc, vc = sk.fused_decoder_stack_plain(
            x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"], kc, vc, pos, group=2,
            head_dim=64, rope_style="neox", eps=cfg.norm_eps,
            final_norm=eng.params["final_norm"],
            lm_head=eng.params["lm_head"])
        lg = lg[0]


# -- sliding window (Mistral's) in kernels 4, 7 and 8

# kv, T, group, hd, q_offset, window, block rows: windows inside a key
# tile, across tiles, of 1, chunked (q_offset > 0), at both head dims
WINDOW_FLASH_CASES = [(2, 300, 1, 128, 0, 64, 64), (2, 300, 4, 128, 0, 100, 128),
                      (2, 200, 2, 64, 130, 77, 128), (1, 1024, 1, 128, 0, 1, 128),
                      (2, 513, 8, 64, 0, 200, 64), (2, 45, 3, 128, 17, 5, 128),
                      (1, 2048, 1, 128, 0, 700, 128)]


@pytest.mark.parametrize("kv,T,g,hd,q_offset,window,rows", WINDOW_FLASH_CASES,
                         ids=["-".join(map(str, c)) for c in WINDOW_FLASH_CASES])
def test_flash_prefill_window_matches_plain(dev, kv, T, g, hd, q_offset,
                                            window, rows):
    """Kernel 4 with a window against its plain twin (atol 2e-2, the
    causal case's), finite; a window that reaches key 0 for every query
    (>= q_offset + T) gives window 0's bits."""
    S = q_offset + T
    q = _randn((kv, T, g, hd), dev, 70)
    k = _randn((kv, S, hd), dev, 71)
    v = _randn((kv, S, hd), dev, 72)
    kcfg = KernelConfig(prefill_block_rows=rows)
    out = fp.flash_prefill_attention(q, k, v, q_offset=q_offset,
                                     window=window, kcfg=kcfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    ref = fp.flash_prefill_attention_plain(q, k, v, q_offset=q_offset,
                                           window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    full = fp.flash_prefill_attention(q, k, v, q_offset=q_offset, kcfg=kcfg)
    wide = fp.flash_prefill_attention(q, k, v, q_offset=q_offset, window=S,
                                      kcfg=kcfg)
    assert _same_bits(full, wide)


@pytest.mark.parametrize("window", [1, 2, 64, 100, 236, 300, 301, 4096])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
def test_stack_window_matches_plain(dev, fmt, window):
    """Kernel 7 with a window at pos 300 (kv_split 64: 100 starts inside the
    split of rows 192-255; 236 at its first row; 1 reads no cached row and
    launches no split pass) against its plain twin on each cache kind, NaN
    above pos; a window that reaches row 0 (>= pos + 1) gives window 0's
    bits; a repeat gives the same bits."""
    pos, kv_split = 300, 64
    g, a, kc, vc, lm = _stack_args(dev, 8, 2, 1, pos, seed=93)
    kc[:, :, pos + 1:] = float("nan")
    vc[:, :, pos + 1:] = float("nan")
    if fmt != "bf16":
        kc, vc = _kv8(kc, vc, fmt, pos)
    cfg = LlamaConfig.tiny(rope_style="neox")
    cos, sin = model.rope_row(cfg, pos, dev)
    kcfg = KernelConfig(kv_split=kv_split)
    kw = dict(group=g, head_dim=HD, rope_style="neox", eps=1e-5, **lm)
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, a["wqkv_f"],
            a["wo_f"], a["w13"], a["w2"]]
    clone = _kv8_clone if fmt != "bf16" else torch.clone
    kk, vk = clone(kc), clone(vc)
    out = sk.fused_decoder_stack(*args, kk, vk, pos, kcfg=kcfg, window=window,
                                 **kw)
    torch.cuda.synchronize()
    assert sk.last_step_kernels == 8 * L + 2 - (window == 1) * L
    kp, vp = clone(kc), clone(vc)
    ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos, kv_split=kv_split,
                                       window=window, **kw)
    assert torch.isfinite(out[0]).all()
    err = (out[0] - ref[0]).abs().max().item()
    assert err <= 2e-2 * ref[0].abs().max().item(), err
    torch.testing.assert_close(out[1].float(), ref[1].float(), atol=2e-2,
                               rtol=2e-2)
    if fmt == "bf16":
        torch.testing.assert_close(kk[:, :, pos].float(), kp[:, :, pos].float(),
                                   atol=0.05, rtol=0)
    else:
        for got, want in ((kk, kp), (vk, vp)):
            _kv8_rows_held(got, want, [pos], True)
    again = sk.fused_decoder_stack(*args, clone(kc), clone(vc), pos,
                                   kcfg=kcfg, window=window, **kw)
    assert torch.equal(again[0], out[0])
    if window >= pos + 1:
        none = sk.fused_decoder_stack(*args, clone(kc), clone(vc), pos,
                                      kcfg=kcfg, **kw)
        assert torch.equal(none[0], out[0])


# window, n, pos, kv_split: inside a split; a first live split (320-335)
# dead for tokens 3 and 4; windows shorter than n (fresh rows masked too);
# one that reaches row 0 for every token (>= pos + n)
WINDOW_VERIFY_CASES = [(100, 5, 300, 64), (8, 5, 340, 16), (3, 5, 300, 64),
                       (1, 5, 300, 64), (305, 5, 300, 64), (4096, 9, 300, 128)]


@pytest.mark.parametrize("window,n,pos,kv_split", WINDOW_VERIFY_CASES,
                         ids=["-".join(map(str, c)) for c in WINDOW_VERIFY_CASES])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_verify_window_matches_plain(dev, fmt, window, n, pos, kv_split):
    """Kernel 8 with a window against its plain twin, large garbage at and
    above pos; a window >= pos + n gives window 0's bits."""
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    g, a, kc, vc, lm = _stack_args(dev, 8, 2, 1, pos, seed=94)
    kc[:, :, pos:] = _randn(kc[:, :, pos:].shape, dev, 95, 8.0)
    vc[:, :, pos:] = _randn(vc[:, :, pos:].shape, dev, 96, 8.0)
    if fmt != "bf16":
        kc, vc = _kv8(kc, vc, fmt, pos)
    clone = _kv8_clone if fmt != "bf16" else torch.clone
    x = _randn((n, HIDDEN), dev, 97)
    cos, sin = model.rope_rows(LlamaConfig.tiny(rope_style="neox"), pos, n,
                               dev)
    kcfg = KernelConfig(kv_split=kv_split)
    kw = dict(group=g, head_dim=HD, rope_style="neox", eps=1e-5, **lm)
    args = [x, a["attn_norm"], a["ffn_norm"], cos, sin, a["wqkv_f"],
            a["wo_f"], a["w13"], a["w2"]]
    kk, vk = clone(kc), clone(vc)
    out = sv.fused_verify_stack(*args, kk, vk, pos, kcfg=kcfg, window=window,
                                **kw)
    torch.cuda.synchronize()
    assert sv.last_step_kernels == 8 * L + 2 - (window == 1) * L
    kp, vp = clone(kc), clone(vc)
    ref = sv.fused_verify_stack_plain(*args, kp, vp, pos, kv_split=kv_split,
                                      window=window, **kw)
    assert torch.isfinite(out[0]).all()
    err = (out[0] - ref[0]).abs().max().item()
    assert err <= 2e-2 * ref[0].abs().max().item(), err
    if fmt != "bf16":
        for got, want in ((kk, kp), (vk, vp)):
            _kv8_rows_held(got, want, list(range(pos, pos + n)), True)
    if window >= pos + n:
        none = sv.fused_verify_stack(*args, clone(kc), clone(vc), pos,
                                     kcfg=kcfg, **kw)
        assert torch.equal(none[0], out[0])


@pytest.mark.parametrize("window", [8, 100, 4096])
def test_verify_split_pass_window_matches_plain(dev, window):
    """Kernel 8's split pass under a window alone (cf_verify_split), n 5 at
    seq 340, splits of 16: the grid holds the splits from the one with
    token 0's bound; token t's rows merged against ``split_attention_plain``
    at window - t (the same bound, the same split boundaries, so the same
    roundings).  At window 8 the first live split holds no live row for
    tokens 3 and 4: their partials are (-1e30, 0, 0)."""
    from clusterfusion_tpu_torch.ops import _build
    from clusterfusion_tpu_torch.ops.stack_kernel import (
        _LOG2E, _rope, first_live_row, split_attention_plain)
    n, kv, g, hd, cap, seq, split, style = 5, 2, 2, 128, 512, 340, 16, "neox"
    rows = g * n
    qkv = _randn((n, kv * (g + 2) * hd), dev, 80).float()
    kc = _randn((kv, cap, hd), dev, 81)
    vc = _randn((kv, cap, hd), dev, 82)
    kc[:, seq:] = float("nan")
    vc[:, seq:] = float("nan")
    cos, sin = model.rope_rows(LlamaConfig.tiny(rope_style=style), seq, n, dev)
    ns = -(-(seq - first_live_row(seq, split, window)) // split)
    ml = torch.full((kv, ns, rows, 2), float("nan"), device=dev)
    acc = torch.full((kv, ns, rows, hd), float("nan"), device=dev)
    _build.check(_build.lib().cf_verify_split(
        qkv.data_ptr(), kc.data_ptr(), vc.data_ptr(), cos.contiguous().data_ptr(),
        sin.contiguous().data_ptr(), ml.data_ptr(), acc.data_ptr(), n, kv, g,
        hd, cap, seq, split, 1, window,
        torch.cuda.current_stream(dev).cuda_stream), "cf_verify_split")
    torch.cuda.synchronize()
    assert torch.isfinite(ml).all() and torch.isfinite(acc).all()
    m_all = ml[..., 0].amax(dim=1)                              # [kv, rows]
    e = torch.exp2(ml[..., 0] - m_all[:, None])
    o_k = (acc * e[..., None]).sum(dim=1) / \
        (ml[..., 1] * e).sum(dim=1)[..., None]
    raw = qkv.reshape(n, kv, g + 2, hd)[:, :, :g]               # [n, kv, g, hd]
    q = _rope(raw, cos[:, None, None], sin[:, None, None], style)
    q = q * (_LOG2E / hd ** 0.5)
    zero = torch.zeros((kv, hd), device=dev)
    for t in range(n):
        acc_p, _, l_p = split_attention_plain(q[t], zero, zero, kc, vc, seq,
                                              split, fold=False,
                                              window=window - t)
        # row i*n + t of each kv head is q head i at token t
        torch.testing.assert_close(o_k[:, t::n], acc_p / l_p[..., None],
                                   atol=2e-3, rtol=2e-3)
    if window == 8:      # tokens 3 and 4 have no live row in split 320-335
        dead = ml[:, 0, 3::n]
        assert (dead[..., 0] == -1e30).all() and (dead[..., 1] == 0).all()
        assert (acc[:, 0, 3::n] == 0).all()


def test_windowed_engine_runs_kernels_4_7_8(dev):
    """A windowed tiny Mistral-shaped engine on the card: stream_generate
    (kernel 4 once a layer, kernel 7 once a step, one after each token,
    every step past the window) teacher-forced into the eager step wherever the top-2 gap
    exceeds 0.1, and a self-draft spec_generate (one kernel-8 launch a
    round) whose stream equals stream_generate's there too."""
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    cfg = LlamaConfig.tiny(sliding_window=24, n_kv_heads=2, rope_style="neox",
                           max_seq_len=256)
    eng = Llama.synthetic(cfg, seed=12, fused=True, device=dev)
    prompt = [1 + (5 * i) % 300 for i in range(40)]
    before = (fp.launches, sk.launches)
    toks = list(eng.stream_generate(prompt, 16, temperature=0.0))
    torch.cuda.synchronize()
    assert (fp.launches - before[0], sk.launches - before[1]) == \
        (cfg.n_layers, 16)
    kc, vc = model.init_cache(cfg, device=dev)
    lg, kc, vc = model.prefill(eng.params, kc, vc, prompt, cfg, flash=False)
    lg = lg[-1]
    gaps = []
    for i, t in enumerate(toks):
        top = torch.topk(lg, 2).values
        gaps.append((top[0] - top[1]).item())
        if gaps[-1] > 0.1:
            assert int(torch.argmax(lg)) == t, i
        lg, kc, vc = model.decode_step(eng.params, kc, vc, t, len(prompt) + i,
                                       cfg, fused=False)
    draft = Llama(eng.params, cfg, eng.tokenizer, fused=True)
    v0 = sv.launches
    spec = eng.spec_generate(prompt, 16, draft, n_draft=4)
    assert sv.launches - v0 == eng.spec_stats["rounds"]
    # the streams may part only where the target's top-2 gap is <= 0.1
    div = next((i for i, (a, b) in enumerate(zip(spec, toks)) if a != b),
               None)
    assert div is None or gaps[div] <= 0.1, (div, spec, toks)


# -- sliding window (Mistral's) in the serving kernels 9 and 10


def _window_view(kp, vp, table, lens, window, dtype=torch.bfloat16):
    """The rolling page buffer's view of bf16 pools: (a table whose slots
    wholly below each request's bound hold the NULL page 0, copies of the
    pools in ``dtype`` with NaN in page 0 and in every row below each
    bound)."""
    page = kp.shape[3]
    t, kw, vw = table.clone(), kp.clone(), vp.clone()
    kw[:, 0] = vw[:, 0] = float("nan")
    for b, n in enumerate(lens.tolist()):
        lo = max(0, n + 1 - window)
        j = torch.arange(lo, device=kp.device)
        kw[:, table[b, j // page].long(), :, j % page] = float("nan")
        vw[:, table[b, j // page].long(), :, j % page] = float("nan")
        t[b, :lo // page] = 0
    return t, kw.to(dtype), vw.to(dtype)


def _raw(t):
    """A bf16 or e4m3 tensor's bits, one integer an element."""
    return t.view(torch.uint8 if t.dtype == torch.float8_e4m3fn
                  else torch.int16)


# windows: one row, inside a page and a split, a split's edge, and one past
# row 0 for every request (window 0's bits)
WINDOW_PAGED_WINDOWS = [1, 12, 100, 128, 1001]
WINDOW_PAGED_LENS = [0, 37, 129, 300, 1000]


@pytest.mark.parametrize("window", WINDOW_PAGED_WINDOWS)
@pytest.mark.parametrize("kv,g,hd,page,pool", [
    (2, 4, 128, 16, "bf16"), (2, 1, 64, 8, "bf16"), (4, 2, 128, 1, "bf16"),
    (2, 4, 128, 16, "fp8")])
def test_paged_attention_window_matches_plain(dev, kv, g, hd, page, pool,
                                              window):
    """Kernel 10 with a window over the rolling buffer's table, NaN in page
    0, below every bound and in every unowned row: against its twin (atol
    2e-2 / rtol 2e-2, each head's row within 2 % of its largest value),
    finite, the pools byte-equal to the twin's, a repeat bit-identical, the
    call counted as windowed; a window past row 0 gives window 0's bits."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    lens = WINDOW_PAGED_LENS
    B, L, layer = len(lens), 2, 1
    kp, vp, table, lens_t = _paged_pools(dev, L, kv, page, hd, lens, 61)
    table[0] = 0                                   # a padding row
    _nan_unowned(kp, vp, table, lens_t)
    dtype = torch.float8_e4m3fn if pool == "fp8" else torch.bfloat16
    q = _randn((B, kv, g, hd), dev, 62)
    k_new = _randn((B, kv, hd), dev, 63)
    v_new = _randn((B, kv, hd), dev, 64)
    tw, kw, vw = _window_view(kp, vp, table, lens_t, window, dtype)
    kp, vp = kp.to(dtype), vp.to(dtype)
    k2, v2, kr, vr = kw.clone(), vw.clone(), kw.clone(), vw.clone()
    before = pd.launches["paged_attention_window"]
    o, _, _ = pd.paged_attention(q, k_new, v_new, kw, vw, tw, lens_t, layer,
                                 window=window)
    o2, _, _ = pd.paged_attention(q, k_new, v_new, k2, v2, tw, lens_t, layer,
                                  window=window)
    want, _, _ = pd.paged_attention_plain(q, k_new, v_new, kr, vr, tw, lens_t,
                                          layer, window=window)
    torch.cuda.synchronize()
    assert pd.launches["paged_attention_window"] == before + 2
    assert torch.isfinite(o.float()).all()
    assert torch.equal(_bits(o), _bits(o2))
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)
    got, ref = o.float().reshape(-1, hd), want.float().reshape(-1, hd)
    rel = (got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-6)
    assert rel.max().item() <= 2e-2
    for a, b in ((kw, kr), (vw, vr), (kw, k2), (vw, v2)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    if window > max(lens):
        none, k0, v0 = pd.paged_attention(q, k_new, v_new, kp.clone(),
                                          vp.clone(), table, lens_t, layer)
        wide, k1, v1 = pd.paged_attention(q, k_new, v_new, kp.clone(),
                                          vp.clone(), table, lens_t, layer,
                                          window=window)
        assert torch.equal(_bits(none), _bits(wide))
        assert torch.equal(k0.view(torch.uint8), k1.view(torch.uint8))


@pytest.mark.parametrize("window", WINDOW_PAGED_WINDOWS)
@pytest.mark.parametrize("weights,hd,page,pool", [
    ("bf16", 128, 16, "bf16"), ("int8", 128, 16, "bf16"),
    ("int4", 128, 16, "bf16"), ("bf16", 64, 8, "bf16"),
    ("bf16", 128, 16, "fp8")])
def test_paged_layer_window_matches_plain(dev, weights, hd, page, pool,
                                          window):
    """Kernel 9 with a window, the same pools and NaN rows: against its
    twin (atol 2e-2 / rtol 2e-2), finite, the appended rows within 0.05
    (bf16) or one e4m3 code, every other byte untouched, a repeat
    bit-identical; a window past row 0 gives window 0's bits."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.ops import quant as tq
    lens = WINDOW_PAGED_LENS[1:]
    B, kv, g, hg, L, layer, hidden = len(lens), 2, 4, 1, 2, 1, 512
    cfg = LlamaConfig.tiny(rope_style="neox", head_dim=hd, max_seq_len=2048)
    cos_t, sin_t = model.rope_table(cfg, device=dev)
    kp, vp, table, lens_t = _paged_pools(dev, L, kv, page, hd, lens, 65)
    _nan_unowned(kp, vp, table, lens_t)
    dtype = torch.float8_e4m3fn if pool == "fp8" else torch.bfloat16
    wqkv, wo = _layer_weights(dev, L, hidden, kv, g, hd, hg, 66)
    if weights != "bf16":
        lw = tq.quantize_llama_params(
            {"layers": {"wqkv_f": wqkv, "wo_f": wo}}, weights,
            targets=("wqkv_f", "wo_f"))["layers"]
        wqkv, wo = lw["wqkv_f"], lw["wo_f"]
    x = _randn((B, hidden), dev, 67)
    res = _randn((B, hidden), dev, 68)
    rms = 1 + _randn((hidden,), dev, 69, 0.1)
    tw, kw, vw = _window_view(kp, vp, table, lens_t, window, dtype)
    kp, vp = kp.to(dtype), vp.to(dtype)
    k0, k2, v2, kr, vr = kw.clone(), kw.clone(), vw.clone(), kw.clone(), \
        vw.clone()
    tail = (layer, rms, 1e-5, cos_t, sin_t)
    kwargs = dict(group=g, rope_style="neox", window=window)
    before = pd.launches["llama_decoder_layer_paged_window"]
    out = pd.llama_decoder_layer_paged(x, res, wqkv, wo, tw, lens_t, lens_t,
                                       kw, vw, *tail, **kwargs)
    again = pd.llama_decoder_layer_paged(x, res, wqkv, wo, tw, lens_t, lens_t,
                                         k2, v2, *tail, **kwargs)
    want = pd.llama_decoder_layer_paged_plain(x, res, wqkv, wo, tw, lens_t,
                                              lens_t, kr, vr, *tail, **kwargs)
    torch.cuda.synchronize()
    assert pd.launches["llama_decoder_layer_paged_window"] == before + 2
    assert torch.isfinite(out[0].float()).all()
    for i in (0, 1):
        assert torch.equal(_bits(out[i]), _bits(again[i]))
        torch.testing.assert_close(out[i].float(), want[i].float(),
                                   atol=2e-2, rtol=2e-2)
    app = _appended_mask(kw, tw, lens_t, layer)
    for a, b, a2 in ((kw, kr, k2), (vw, vr, v2)):
        assert torch.equal(a.view(torch.uint8), a2.view(torch.uint8))
        if pool == "fp8":
            assert _e4m3_one_code(a[app], b[app])[0]
        else:
            torch.testing.assert_close(a[app].float(), b[app].float(),
                                       atol=0.05, rtol=0)
        assert torch.equal(_raw(a)[~app], _raw(b)[~app])
    assert torch.equal(_raw(kw)[~app], _raw(k0)[~app])
    if window > max(lens):
        kw0 = dict(kwargs, window=0)
        none = pd.llama_decoder_layer_paged(x, res, wqkv, wo, table, lens_t,
                                            lens_t, kp.clone(), vp.clone(),
                                            *tail, **kw0)
        wide = pd.llama_decoder_layer_paged(x, res, wqkv, wo, table, lens_t,
                                            lens_t, kp.clone(), vp.clone(),
                                            *tail, **kwargs)
        for a, b in zip(none, wide):
            assert torch.equal(_raw(a), _raw(b))


@pytest.mark.parametrize("impl,kv", [("batched", "bf16"), ("fused", "bf16"),
                                     ("fused", "fp8")])
def test_windowed_serving_engine_on_card(dev, impl, kv):
    """A windowed tiny Mistral-shaped engine on the card with its rolling
    page buffer (window 24, page 8: 4 real pages a request at most), a pool
    smaller than full context needs: three requests past the window, all
    admitted at once, each token within 0.02 x the largest |logit| of the
    plain path's argmax fed the same prefix, kernel 10 or 9 launched once a
    layer and step with the window."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.runtime import ServingEngine
    fp8 = torch.float8_e4m3fn
    cfg = LlamaConfig.tiny(sliding_window=24, n_kv_heads=2, rope_style="neox",
                           max_seq_len=256)
    params = model.init_params(cfg, 12, device=dev)
    prompts = [[1 + (7 * i + r) % 300 for i in range(n)]
               for r, n in enumerate((40, 57, 90))]
    n_new = 12
    eng = ServingEngine(params, cfg, page_size=8, num_pages=3 * 4 + 1,
                        max_batch=4, step_impl=impl,
                        kv_dtype=fp8 if kv == "fp8" else torch.bfloat16)
    for i, p in enumerate(prompts):
        eng.submit(i, p, n_new, temperature=0.0)
    key = "paged_attention" if impl == "batched" else \
        "llama_decoder_layer_paged"
    before = pd.launches[key + "_window"]
    out = eng.run()
    torch.cuda.synchronize()
    assert pd.launches[key + "_window"] - before == cfg.n_layers * (n_new - 1)
    for i, p in enumerate(prompts):
        assert eng.last_results[i].error is None and len(out[i]) == n_new
        kc, vc = model.init_cache(cfg, device=dev,
                                  dtype=fp8 if kv == "fp8" else torch.bfloat16)
        lg, kc, vc = model.prefill(params, kc, vc, p, cfg, flash=False)
        lg = lg[-1].float()
        for j, t in enumerate(out[i]):
            scale = max(lg.abs().max().item(), 1.0)
            assert (lg.max() - lg[t]).item() < 0.02 * scale, (i, j)
            lg, kc, vc = model.decode_step(params, kc, vc, t, len(p) + j, cfg,
                                           fused=False)
            lg = lg.float()


# -- sliding window (Mistral's) in kernel 6 and kernel 7's mode 5

# window_lo in the cache's own rows at seq 300 (kv_split 64): below row 0,
# row 0, inside a split, on a split boundary, the last cached row, at seq
# and above it (the sp step's shard bounds; the tp step's is seq+1-window)
LAYER_WINDOW_BOUNDS = [-5, 0, 100, 128, 299, 300, 400]
LAYER_WINDOW_MODES = {
    # name: (append_kv, emit_partials, fold)
    "append": (True, False, 1),
    "partials_fold1": (False, True, 1),
    "partials_fold0": (False, True, 0),
}


def _nan_rows(c, rows):
    """NaN in cache rows ``rows`` (fp8: the NaN byte 0x7F)."""
    if c.dtype == torch.float8_e4m3fn:
        c.view(torch.uint8)[:, :, rows] = 0x7F
    else:
        c[:, :, rows] = float("nan")


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("mode", list(LAYER_WINDOW_MODES))
@pytest.mark.parametrize("bound", LAYER_WINDOW_BOUNDS)
def test_decoder_layer_window_matches_plain(dev, kv, mode, bound):
    """Kernel 6 with a window from the bound ``window_lo`` (GQA, layer 1 of
    stacked weights, seq 300), NaN in every row below the bound and at and
    above seq, against its plain twin at the modes test's tolerances:
    finite, one launch, the same bits on a repeat, no row but seq moved; a
    bound at or below row 0 gives the bits of no window; nothing in the
    window and nothing folded gives the empty state exactly."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    seq = 300
    append, partials, fold = LAYER_WINDOW_MODES[mode]
    g, a, kc, vc, _ = _stack_args(dev, 8, 2, 1, seq, seed=250)
    if kv == "fp8":
        kc, vc = kc.to(torch.float8_e4m3fn), vc.to(torch.float8_e4m3fn)
    for c in (kc, vc):
        _nan_rows(c, slice(0, max(bound, 0)))
        _nan_rows(c, slice(seq, None))
    res = _randn((1, HIDDEN), dev, 262)
    cos, sin = model.rope_row(LlamaConfig.tiny(rope_style="neox"), seq, dev)
    kw = dict(group=g, head_dim=HD, rope_style="neox", fuse_residual=True,
              eps=1e-5, emit_partials=partials, fold_current=fold,
              append_kv=append)
    args = [a["x"], res, a["attn_norm"], cos, sin, a["wqkv_f"], a["wo_f"]]
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    n0, w0 = dl.launches, dl.window_launches
    out = dl._fused_decoder_layer(*args, kk, vk, seq, 1, window=24,
                                  window_lo=bound, **kw)
    again = dl._fused_decoder_layer(*args, kc.clone(), vc.clone(), seq, 1,
                                    window=24, window_lo=bound, **kw)
    ref = dl._fused_decoder_layer_plain(*args, kp, vp, seq, 1, window=24,
                                        window_lo=bound, **kw)
    torch.cuda.synchronize()
    assert dl.launches == n0 + 2 and dl.window_launches == w0 + 2
    assert dl.last_call_kernels == 1
    n_out = 5 if partials else 4
    for x, y in zip(out[:n_out], again[:n_out]):
        assert _bits_equal(x, y)
    assert all(bool(torch.isfinite(t.float()).all()) for t in out[:n_out])
    tol = dict(atol=2e-2, rtol=2e-2)
    if partials:
        torch.testing.assert_close(out[1], ref[1], **tol)
        torch.testing.assert_close(out[0], ref[0], atol=5e-2, rtol=2e-2)
        if bound >= seq and not fold:
            assert torch.all(out[1][0] == -1e30) and torch.all(out[1][1] == 0)
            assert torch.all(out[0] == 0)
    else:
        torch.testing.assert_close(out[0].float(), ref[0].float(), **tol)
    for i in range(n_out - 3, n_out):           # residual, k_new, v_new
        torch.testing.assert_close(out[i].float(), ref[i].float(), atol=0.05,
                                   rtol=0)
    others = torch.ones(CAP, dtype=torch.bool, device=dev)
    if append:
        others[seq] = False
    for got, before in ((kk, kc), (vk, vc)):
        assert _bits_equal(got[:, :, others], before[:, :, others])
    if bound <= 0:
        none = dl._fused_decoder_layer(*args, kc.clone(), vc.clone(), seq, 1,
                                       **kw)
        for x, y in zip(out[:n_out], none[:n_out]):
            assert _bits_equal(x, y)


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("seq,window,bound", [
    (5000, 4096, None), (8000, 4096, None), (4600, 4096, 4600 + 1 - 4096),
    (4600, 4096, 4600 + 1 - 4096 - 2048), (4600, 4096, 4600 + 1 - 4096 - 4096),
    (6500, 4096, 6500 + 1 - 4096), (300, 1, None)],
    ids=["5000", "8000", "shard0", "shard1", "shard2", "6500", "window1"])
def test_decoder_layer_window_at_mistral_width(dev, kv, seq, window, bound):
    """Kernel 6 at Mistral-7B's layer width (hidden 4096, 32 heads on 8 kv
    heads of 128) over an 8192-row cache, NaN below the bound and above
    seq: full mode with the append (its default bound seq + 1 - window)
    and partials mode with the sp step's shard bounds (``bound``, fold 0),
    against the plain twin at the modes test's tolerances, finite."""
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    g, args, kc, vc = _layer_case(dev, 4096, 32, 8, 1, 128, 8192, seq, 270)
    if kv == "fp8":
        kc, vc = kc.to(torch.float8_e4m3fn), vc.to(torch.float8_e4m3fn)
    lo = seq + 1 - window if bound is None else bound
    for c in (kc, vc):
        _nan_rows(c, slice(0, min(max(lo, 0), seq)))
        _nan_rows(c, slice(seq, None))
    kw = dict(group=g, head_dim=128, rope_style="neox", fuse_residual=True,
              eps=1e-5, window=window, window_lo=bound)
    if bound is None:
        kw["append_kv"] = True
    else:
        kw.update(emit_partials=True, fold_current=0)
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out = dl._fused_decoder_layer(*args, kk, vk, seq, 0, **kw)
    ref = dl._fused_decoder_layer_plain(*args, kp, vp, seq, 0, **kw)
    torch.cuda.synchronize()
    n_out = 4 if bound is None else 5
    assert all(bool(torch.isfinite(t.float()).all()) for t in out[:n_out])
    if bound is None:
        torch.testing.assert_close(out[0].float(), ref[0].float(), atol=2e-2,
                                   rtol=2e-2)
    else:
        torch.testing.assert_close(out[1], ref[1], atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(out[0], ref[0], atol=5e-2, rtol=2e-2)
    for i in range(n_out - 2, n_out):
        torch.testing.assert_close(out[i].float(), ref[i].float(), atol=0.05,
                                   rtol=0)


@pytest.mark.parametrize("window", [1, 16, 100, 301])
def test_stack_mode5_window_loopback(dev, window):
    """Kernel 7's mode 5 with a window at tp 2 on one card (two virtual
    ranks on their own streams over a loopback communicator, pos 300,
    kv_split 64) against kernel 7's one-card window step on the same cache:
    8L+1 kernels a rank (7L+1 at window 1, no split pass), both ranks' bits
    equal and repeated, within 2e-2 of the one-card step, each rank's
    appended rows its heads'; with the logits gathered (8L+3, 7L+3 at
    window 1) the ranks' logits bit-identical and within 2e-2 of the
    largest one-card logit; window pos + 1 gives window 0's bits."""
    from clusterfusion_tpu_torch.parallel import collective as col
    pos, tp = 300, 2
    g, a, kc, vc, lm = _stack_args(dev, 16, 8, 4, pos, seed=280)
    cos, sin = model.rope_row(LlamaConfig.tiny(), pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5,
              kcfg=KernelConfig(kv_split=64))
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, a["wqkv_f"],
            a["wo_f"], a["w13"], a["w2"]]
    kr, vr = kc.clone(), vc.clone()
    ref = sk.fused_decoder_stack(*args, kr, vr, pos, window=window, **kw)
    ref_lg = sk.fused_decoder_stack(*args, kc.clone(), vc.clone(), pos,
                                    window=window, **lm, **kw)[0]
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards, caches = _mode5_shards(a, kc, vc, meshes)
        heads = [h.contiguous() for h in lm["lm_head"].chunk(tp, dim=-1)]
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        wkw = dict(kw, window=window)

        def fresh():
            return [(k.clone(), v.clone()) for k, v in caches]

        outs, kernels = _mode5_step(a, shards, caches, meshes, streams, cos,
                                    sin, pos, wkw)
        again, _ = _mode5_step(a, shards, fresh(), meshes, streams, cos, sin,
                               pos, wkw)
        gathered, gk = _mode5_step(a, shards, fresh(), meshes, streams, cos,
                                   sin, pos, wkw,
                                   head=(lm["final_norm"], heads),
                                   gather=True)
        full = []
        if window == pos + 1:
            full, _ = _mode5_step(a, shards, fresh(), meshes, streams, cos,
                                  sin, pos, kw)
        torch.cuda.synchronize(dev)
        lb.check()
    finally:
        lb.close()
    drop = L * (window == 1)
    assert kernels == [8 * L + 1 - drop] * tp
    assert gk == [8 * L + 3 - drop] * tp
    for r, (xo, ro, k, v) in enumerate(outs):
        assert torch.equal(xo, outs[0][0]) and torch.equal(ro, outs[0][1])
        assert torch.equal(xo, again[r][0]) and torch.equal(ro, again[r][1])
        torch.testing.assert_close(xo.float(), ref[0].float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(ro.float(), ref[1].float(), atol=2e-2,
                                   rtol=2e-2)
        hs = slice(r * 8 // tp, (r + 1) * 8 // tp)
        for got, want, before in ((k, kr, kc), (v, vr, vc)):
            torch.testing.assert_close(got[:, :, pos].float(),
                                       want[:, hs, pos].float(), atol=0.05,
                                       rtol=0)
            others = torch.ones(CAP, dtype=torch.bool, device=dev)
            others[pos] = False
            assert torch.equal(got[:, :, others], before[:, hs][:, :, others])
        if full:
            assert torch.equal(xo, full[r][0]) and torch.equal(ro, full[r][1])
    lg = [o[0] for o in gathered]
    for r in range(tp):
        assert torch.equal(lg[r].view(torch.int32), lg[0].view(torch.int32))
    assert (lg[0] - ref_lg).abs().max().item() <= \
        2e-2 * ref_lg.abs().max().item()
