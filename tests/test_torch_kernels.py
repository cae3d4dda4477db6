"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and skips without one.  On the card:

    python -m pytest tests/test_torch_kernels.py -q

Tolerances: the kernels and their twins share inputs and arithmetic but
sum in another order (and the decode GEMVs split their sums across blocks
with atomics), and round to bf16 at the same places; outputs are held at
atol 2e-2 / rtol 2e-2, logits at 2e-2 of the largest logit, appended K/V
rows at atol 0.05 (the JAX suite's bf16 tolerance).
"""

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


@pytest.mark.parametrize("kv,T,g,hd,q_offset,extra,rows", [
    (2, 1, 1, 128, 0, 0, 64),
    (2, 37, 1, 128, 0, 0, 64),
    (2, 64, 4, 128, 0, 0, 32),
    (1, 130, 2, 64, 0, 0, 64),
    (2, 33, 2, 64, 93, 30, 32),
    (4, 200, 1, 128, 256, 7, 64),
])
def test_flash_prefill_kernel_matches_plain(dev, kv, T, g, hd, q_offset,
                                            extra, rows):
    S = q_offset + T + extra
    q = _randn((kv, T, g, hd), dev, 0)
    k = _randn((kv, S, hd), dev, 1)
    v = _randn((kv, S, hd), dev, 2)
    before = fp.launches
    out = fp.flash_prefill_attention(q, k, v, q_offset=q_offset,
                                     kcfg=KernelConfig(prefill_block_rows=rows))
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    ref = fp.flash_prefill_attention_plain(q, k, v, q_offset=q_offset)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


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


@pytest.mark.parametrize("pos", [0, 37, 300])
@pytest.mark.parametrize("with_lm", [True, False], ids=["lm", "no_lm"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", [(4, 4, 2), (8, 2, 1)],
                         ids=["mha", "gqa"])
@pytest.mark.parametrize("rope_style", ["gptj", "neox"])
def test_stack_kernel_matches_plain(dev, rope_style, n_heads, kv_heads, hg,
                                    with_lm, pos):
    g, a, kc, vc, lm = _stack_args(dev, n_heads, kv_heads, hg, pos)
    cfg = LlamaConfig.tiny(rope_style=rope_style)
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=HD, rope_style=rope_style, eps=1e-5,
              **(lm if with_lm else {}))
    args = [a["x"], a["attn_norm"], a["ffn_norm"], cos, sin, a["wqkv_f"],
            a["wo_f"], a["w13"], a["w2"]]
    kp, vp = kc.clone(), vc.clone()
    before = sk.launches
    out = sk.fused_decoder_stack(*args, kc, vc, pos,
                                 kcfg=KernelConfig(kv_split=128), **kw)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert sk.last_step_kernels == 8 * L - (pos == 0) * L + 1 + with_lm
    ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos, **kw)
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
    assert torch.equal(kc[:, :, others], kp[:, :, others])
    assert torch.equal(vc[:, :, others], vp[:, :, others])


@pytest.mark.parametrize("n,pos", [(1, 37), (2, 0), (5, 37), (8, 300),
                                   (9, CAP - 9)])
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


def _mla_args(dev, heads, lora, seed=60, hidden=HIDDEN, layers=2):
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
    cache = _randn((layers, MLA_CAP, width), dev, seed + 7)
    return a, cache


def _mla_rope(dev, pos):
    from clusterfusion_tpu_torch.config import DeepSeekConfig
    from clusterfusion_tpu_torch.models import deepseek as ds
    c, s = ds.rope_table(DeepSeekConfig.tiny(max_seq_len=MLA_CAP), device=dev)
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
    (True, True, 11264)])
def test_fused_ffn_kernel_matches_plain(dev, stacked, fuse_residual, f_pad):
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
    want, want_h = ffn.fused_ffn_plain(x, res, nw, w13, w2, eps=1e-6,
                                       fuse_residual=fuse_residual,
                                       layer_id=layer)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.equal(h, want_h)


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
