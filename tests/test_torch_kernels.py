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


def _stack_args(dev, n_heads, kv_heads, hg, pos, seed=0):
    g, G = n_heads // kv_heads, kv_heads // hg
    a = dict(
        x=_randn((1, HIDDEN), dev, seed),
        attn_norm=1 + _randn((L, HIDDEN), dev, seed + 1, 0.1),
        ffn_norm=1 + _randn((L, HIDDEN), dev, seed + 2, 0.1),
        wqkv_f=_randn((L, G, HIDDEN, hg * (g + 2) * HD), dev, seed + 3,
                      HIDDEN ** -0.5),
        wo_f=_randn((L, G, hg * g * HD, HIDDEN), dev, seed + 4,
                    (g * HD) ** -0.5),
        w13=_randn((L, 2, HIDDEN, F_PAD), dev, seed + 5, HIDDEN ** -0.5),
        w2=_randn((L, F_PAD, HIDDEN), dev, seed + 6, F_PAD ** -0.5),
    )
    kc = torch.zeros((L, kv_heads, CAP, HD), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :, :pos] = _randn((L, kv_heads, pos, HD), dev, seed + 7)
    vc[:, :, :pos] = _randn((L, kv_heads, pos, HD), dev, seed + 8)
    lm = dict(final_norm=1 + _randn((HIDDEN,), dev, seed + 9, 0.1),
              lm_head=_randn((HIDDEN, VOCAB), dev, seed + 10, HIDDEN ** -0.5))
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
                                         (64, 8192)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_norm_kernels_match_plain(dev, rows, hidden, dtype):
    """Kernels 1 and 2 against their plain twins (the float32 oracles):
    every output is rounded once, so they agree to one rounding of the
    output type (bf16: 2e-2; float32: 1e-5)."""
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


@pytest.mark.parametrize("M,K,N", [(2, 512, 384), (5, 4096, 4224),
                                   (8, 1000, 264), (9, 4096, 12288),
                                   (16, 11008, 4096), (17, 512, 384),
                                   (32, 777, 136)])
def test_ring_gemv_rows_match_plain(dev, M, K, N):
    """The ring GEMV's tensor-core form (the verify stack's GEMVs, M > 1)
    through kernel 3's C entry: every row of y written (it starts NaN),
    against the float32 product, and the same bits on every call.  K off
    the 16-row mma step and the 32-row stage, N ending in an 8-column
    tile, and M past 16 (two row chunks) are among the cases."""
    from clusterfusion_tpu_torch.ops import _build
    x = _randn((M, K), dev, 55)
    w = _randn((K, N), dev, 56, K ** -0.5)

    def call():
        y = torch.full((M, N), float("nan"), device=dev)
        _build.check(_build.lib().cf_gemv(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), M, K, N,
            KernelConfig().gemv_threads,
            torch.cuda.current_stream(dev).cuda_stream), "cf_gemv")
        return y
    y = call()
    torch.cuda.synchronize()
    torch.testing.assert_close(y, x.float() @ w.float(), atol=1e-3, rtol=1e-3)
    for _ in range(3):
        assert torch.equal(call(), y)


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


@pytest.mark.parametrize("n_heads,kv_heads,hg", [(4, 4, 2), (8, 2, 1)],
                         ids=["mha", "gqa"])
def test_stack_mode5_loopback_matches_unsharded(dev, n_heads, kv_heads, hg):
    """Mode 5 (reduce_axis) at tp 2 on one card: two virtual ranks, each on
    its own stream with its shards of the weights and caches, against
    kernel 7's unsharded step.  Both ranks' x_out and residual have the
    same bits; each rank's appended rows are its heads' rows."""
    from clusterfusion_tpu_torch.parallel import collective as col
    from clusterfusion_tpu_torch.parallel.sharding import shard_tensor
    pos, tp = 37, 2
    g, a, kc, vc, _ = _stack_args(dev, n_heads, kv_heads, hg, pos)
    cfg = LlamaConfig.tiny()
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=1e-5)
    kr, vr = kc.clone(), vc.clone()
    ref = sk.fused_decoder_stack(a["x"], a["attn_norm"], a["ffn_norm"], cos,
                                 sin, a["wqkv_f"], a["wo_f"], a["w13"],
                                 a["w2"], kr, vr, pos, **kw)
    specs = dict(wqkv_f=(None, "tp", None, None), wo_f=(None, "tp", None, None),
                 w13=(None, None, None, "tp"), w2=(None, "tp", None))
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards = [{k: shard_tensor(a[k], s, m) for k, s in specs.items()}
                  for m in meshes]
        caches = [(shard_tensor(kc, (None, "tp", None, None), m),
                   shard_tensor(vc, (None, "tp", None, None), m))
                  for m in meshes]
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        r0 = col.launches["all_reduce"]
        outs = []
        for r in range(tp):
            streams[r].wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(streams[r]):
                sh = shards[r]
                outs.append(sk.fused_decoder_stack(
                    a["x"], a["attn_norm"], a["ffn_norm"], cos, sin,
                    sh["wqkv_f"], sh["wo_f"], sh["w13"], sh["w2"],
                    *caches[r], pos, reduce_axis="tp", mesh=meshes[r], **kw))
                assert sk.last_step_kernels == 10 * L + 1
        torch.cuda.synchronize(dev)
        lb.check()
        assert col.launches["all_reduce"] == r0 + 2 * L * tp
    finally:
        lb.close()
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
