"""The port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernels run as the JAX suite runs them here: Pallas in interpret mode.
The port's wrappers run their plain PyTorch twins, since every tensor lies
on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.ops import reference as jref
from clusterfusion_tpu.ops import rope as jrope
from clusterfusion_tpu.ops.flash_prefill import \
    flash_prefill_attention as j_flash
from clusterfusion_tpu.ops.stack_kernel import \
    fused_decoder_stack as j_stack
from clusterfusion_tpu_torch.models.convert import tensor_from_numpy
from clusterfusion_tpu_torch.ops import reference as tref
from clusterfusion_tpu_torch.ops import rope as trope
from clusterfusion_tpu_torch.ops.flash_prefill import (
    flash_prefill_attention, flash_prefill_attention_plain)
from clusterfusion_tpu_torch.ops.stack_kernel import (
    _vocab_block, fused_decoder_stack, fused_decoder_stack_plain)


def _bf16(a):
    """numpy float -> (jax bf16 array, torch bf16 tensor), the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, tensor_from_numpy(np.asarray(j))


def _np(t):
    return t.float().numpy()


# ---- rope and the reference norms: float32, rtol 1e-5 -----------------------

@pytest.mark.parametrize("style,l3", [("neox", None), ("gptj", None),
                                      ("gptj", (8.0, 1.0, 4.0, 8192))])
def test_rope_tables_match_jax(style, l3):
    jf = jrope.rope_tables_neox if style == "neox" else jrope.rope_tables_gptj
    tf = trope.rope_tables_neox if style == "neox" else trope.rope_tables_gptj
    jc, js = jf(128, 300, 10000.0, l3)
    tc, ts = tf(128, 300, 10000.0, l3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("style", ["neox", "gptj"])
def test_apply_rope_matches_jax(style):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 128).astype(np.float32)
    if style == "neox":
        c, s = jrope.rope_tables_neox(128, 5)
        jo = jrope.apply_rope_neox(x, c, s)
        to = trope.apply_rope_neox(torch.from_numpy(x),
                                   *trope.rope_tables_neox(128, 5))
    else:
        c, s = jrope.rope_tables_gptj(128, 5)
        jo = jrope.apply_rope_gptj(x, c, s)
        to = trope.apply_rope_gptj(torch.from_numpy(x),
                                   *trope.rope_tables_gptj(128, 5))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)


def test_reference_norms_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 256).astype(np.float32)
    r = rng.randn(4, 256).astype(np.float32)
    w = (1 + 0.1 * rng.randn(256)).astype(np.float32)
    tx, tr, tw = map(torch.from_numpy, (x, r, w))
    np.testing.assert_allclose(tref.rmsnorm_ref(tx, tw, 1e-5).numpy(),
                               np.asarray(jref.rmsnorm_ref(x, w, 1e-5)),
                               rtol=1e-5, atol=1e-6)
    jy, jh = jref.fused_add_rmsnorm_ref(x, r, w, 1e-5)
    ty, th = tref.fused_add_rmsnorm_ref(tx, tr, tw, 1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)


# ---- flash prefill: atol 3e-2, rtol 5e-2 (bf16 output, as the JAX suite) ----

def test_flash_prefill_plain_matches_jax():
    kv, T, g, hd, q_offset = 2, 40, 2, 128, 24
    rng = np.random.RandomState(2)
    S = q_offset + T + 5                       # keys past the chunk: unread
    jq, tq = _bf16(rng.randn(kv, T, g, hd))
    jk, tk = _bf16(rng.randn(kv, S, hd))
    jv, tv = _bf16(rng.randn(kv, S, hd))
    jo = j_flash(jq, jk, jv, q_offset=q_offset, block_q=16, block_k=32)
    to = flash_prefill_attention_plain(tq, tk, tv, q_offset=q_offset)
    assert to.dtype == torch.bfloat16 and to.shape == (kv, T, g, hd)
    np.testing.assert_allclose(_np(to), np.asarray(jo, np.float32),
                               atol=3e-2, rtol=5e-2)
    # on CPU tensors the wrapper is the plain twin, bit for bit
    assert torch.equal(flash_prefill_attention(tq, tk, tv, q_offset=q_offset),
                       to)


def test_flash_prefill_refuses_unported_variants():
    q = torch.zeros(1, 4, 1, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 128, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        flash_prefill_attention(q, k, k, window=2)
    with pytest.raises(NotImplementedError):
        flash_prefill_attention(q, k, k, softcap=30.0)


# ---- whole-stack decode step ------------------------------------------------

HIDDEN, L, HD, F_PAD, VOCAB, CAP, POS, EPS = 512, 2, 128, 1024, 384, 256, 37, 1e-5


def _stack_inputs(n_heads, kv_heads, hg, rope_style, seed=3):
    g = n_heads // kv_heads
    G = kv_heads // hg
    rng = np.random.RandomState(seed)

    def w(shape, fan_in):
        return rng.randn(*shape) / np.sqrt(fan_in)

    a = {
        "x": w((1, HIDDEN), 1),
        "attn_norm": 1 + 0.1 * rng.randn(L, HIDDEN),
        "ffn_norm": 1 + 0.1 * rng.randn(L, HIDDEN),
        "wqkv_f": w((L, G, HIDDEN, hg * (g + 2) * HD), HIDDEN),
        "wo_f": w((L, G, hg * g * HD, HIDDEN), g * HD),
        "w13": w((L, 2, HIDDEN, F_PAD), HIDDEN),
        "w2": w((L, F_PAD, HIDDEN), F_PAD),
        "final_norm": 1 + 0.1 * rng.randn(HIDDEN),
        "lm_head": w((HIDDEN, VOCAB), HIDDEN),
    }
    cache = np.zeros((2, L, kv_heads, CAP, HD))
    cache[:, :, :, :POS] = rng.randn(2, L, kv_heads, POS, HD)
    a["k_cache"], a["v_cache"] = cache
    j = {k: _bf16(v)[0] for k, v in a.items()}
    t = {k: tensor_from_numpy(np.asarray(v)) for k, v in j.items()}
    tabs = (jrope.rope_tables_neox if rope_style == "neox"
            else jrope.rope_tables_gptj)(HD, CAP)
    if rope_style == "neox":
        tabs = [jnp.concatenate([c, c], axis=-1) for c in tabs]
    cos, sin = (c[POS:POS + 1] for c in tabs)
    j["cos"], j["sin"] = cos, sin
    t["cos"], t["sin"] = (tensor_from_numpy(np.asarray(c)) for c in (cos, sin))
    return g, j, t


_ARGS = ("x", "attn_norm", "ffn_norm", "cos", "sin", "wqkv_f", "wo_f", "w13",
         "w2", "k_cache", "v_cache")


@pytest.mark.parametrize("with_lm", [True, False], ids=["lm", "no_lm"])
@pytest.mark.parametrize("n_heads,kv_heads,hg", [(4, 4, 2), (4, 2, 2)],
                         ids=["mha", "gqa"])
@pytest.mark.parametrize("rope_style", ["gptj", "neox"])
def test_stack_plain_matches_jax(rope_style, n_heads, kv_heads, hg, with_lm):
    """fused_decoder_stack_plain vs the JAX stack kernel (interpret mode):
    outputs at atol/rtol 0.05, the appended K/V rows at atol 0.05 (the JAX
    suite's bf16 tolerance), every other cache row unchanged."""
    g, j, t = _stack_inputs(n_heads, kv_heads, hg, rope_style)
    lm = dict(final_norm="final_norm", lm_head="lm_head") if with_lm else {}
    kw = dict(group=g, head_dim=HD, rope_style=rope_style, eps=EPS)
    jfn = jax.jit(functools.partial(j_stack, **kw))
    jout = jfn(*(j[k] for k in _ARGS), jnp.asarray(POS, jnp.int32),
               **{k: j[v] for k, v in lm.items()})
    k_before = t["k_cache"].clone()
    v_before = t["v_cache"].clone()
    tout = fused_decoder_stack_plain(*(t[k] for k in _ARGS), POS,
                                     **{k: t[v] for k, v in lm.items()}, **kw)
    assert tout[2] is t["k_cache"] and tout[3] is t["v_cache"]   # in place
    for jo, to in zip(jout[:2], tout[:2]):
        assert tuple(to.shape) == tuple(jo.shape)
        np.testing.assert_allclose(_np(to), np.asarray(jo, np.float32),
                                   atol=0.05, rtol=0.05)
    for jc, tc, before in ((jout[2], tout[2], k_before),
                           (jout[3], tout[3], v_before)):
        np.testing.assert_allclose(_np(tc[:, :, POS]),
                                   np.asarray(jc, np.float32)[:, :, POS],
                                   atol=0.05)
        others = torch.ones(CAP, dtype=torch.bool)
        others[POS] = False
        assert torch.equal(tc[:, :, others], before[:, :, others])


def test_stack_wrapper_on_cpu_is_plain_and_refuses_variants():
    g, _, t = _stack_inputs(4, 2, 2, "gptj")
    kw = dict(group=g, head_dim=HD, rope_style="gptj", eps=EPS)
    args = [t[k] for k in _ARGS]
    want = fused_decoder_stack_plain(*[a.clone() for a in args], POS, **kw)
    got = fused_decoder_stack(*args, POS, **kw)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    for bad in (dict(window=8), dict(softcap=50.0), dict(reduce_axis="tp"),
                dict(ffn_act="gelu_tanh"),
                dict(bias_qkv=torch.zeros(L, 1, 8 * HD))):
        with pytest.raises(NotImplementedError):
            fused_decoder_stack(*args, POS, **kw, **bad)


@pytest.mark.parametrize("V", [32000, 384, 128256, 32001, 100])
def test_vocab_block_matches_jax(V):
    from clusterfusion_tpu.ops.stack_kernel import _vocab_block as j_vb
    assert _vocab_block(V) == j_vb(V)
