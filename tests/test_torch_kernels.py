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
