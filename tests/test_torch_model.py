"""The port's Llama against the JAX package's, on the CPU, at
``LlamaConfig.tiny()`` (MHA) and a GQA variant (``n_kv_heads=2``).

One JAX parameter tree crosses to the port through ``params_from_numpy``,
so both packages run the same weights.  JAX's kernels run in interpret
mode, the port's wrappers run their plain twins.

Greedy tokens are compared under one rule: at every step where JAX's top-2
logit gap exceeds 0.05, the port must pick JAX's token (with random
weights the logits are near-flat, and a smaller gap can flip on rounding
that both packages are entitled to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import LlamaConfig as JConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu_torch.config import LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models.convert import params_from_numpy

GAP = 0.05


def _setup(kv_heads=None, seed=0):
    jcfg = JConfig.tiny(n_kv_heads=kv_heads)
    tcfg = LlamaConfig.tiny(n_kv_heads=kv_heads)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def mha():
    return _setup()


@pytest.fixture(scope="module")
def gqa():
    return _setup(kv_heads=2, seed=1)


def _close(t, j, atol=0.05, rtol=0.05, scale=False):
    tn = t.float().numpy()
    jn = np.asarray(j, np.float32)
    if scale:      # logits: max abs diff within 5 % of the largest logit
        s = max(float(np.max(np.abs(jn))), 1.0)
        assert float(np.max(np.abs(tn - jn))) < 0.05 * s
    else:
        np.testing.assert_allclose(tn, jn, atol=atol, rtol=rtol)


def test_params_round_trip_bit_exact(mha):
    _, _, jp, tp = mha
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert leaves
    for path, leaf in leaves:
        node = tp
        for key in path:
            node = node[key.key]
        a = np.asarray(leaf)
        assert node.dtype == torch.bfloat16 and tuple(node.shape) == a.shape
        assert np.array_equal(node.view(torch.int16).numpy(),
                              a.view(np.int16)), path


def test_init_params_layout_matches_jax(mha):
    _, tcfg, _, tp = mha
    mine = tmodel.init_params(tcfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tp)
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine) == shapes


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "eager"])
def test_prefill_matches_jax(mha, flash):
    jcfg, tcfg, jp, tp = mha
    toks = (np.arange(37) * 13) % tcfg.vocab_size
    jl, jk, jv = jmodel.prefill(jp, *jmodel.init_cache(jcfg),
                                jnp.asarray(toks, jnp.int32), jcfg,
                                flash=flash)
    kc, vc = tmodel.init_cache(tcfg, device="cpu")
    tl, tk, tv = tmodel.prefill(tp, kc, vc, toks, tcfg, flash=flash)
    assert tk is kc and tv is vc                          # in place
    _close(tl, jl, scale=True)
    _close(tk, jk, atol=0.05, rtol=0)
    _close(tv, jv, atol=0.05, rtol=0)


def test_chunked_prefill_matches_whole(mha):
    _, tcfg, _, tp = mha
    toks = (np.arange(29) * 7) % tcfg.vocab_size
    l1, k1, v1 = tmodel.prefill(tp, *tmodel.init_cache(tcfg, device="cpu"),
                                toks, tcfg)
    kc, vc = tmodel.init_cache(tcfg, device="cpu")
    tmodel.prefill_chunk(tp, kc, vc, toks[:16], tcfg, pos0=0)
    l2, kc, vc = tmodel.prefill_chunk(tp, kc, vc, toks[16:], tcfg, pos0=16)
    scale = max(float(l1.abs().max()), 1.0)
    assert float((l2[-1] - l1[-1]).abs().max()) < 0.05 * scale
    np.testing.assert_allclose(kc.float().numpy(), k1.float().numpy(),
                               atol=0.05)


@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_decode_step_matches_jax(which, request):
    """decode_step fused and eager against JAX decode_step fused=True and
    fused=False, after the same prefill."""
    jcfg, tcfg, jp, tp = request.getfixturevalue(which)
    toks = np.asarray([5, 17, 42, 9, 100, 3], np.int32)
    _, jk, jv = jmodel.prefill(jp, *jmodel.init_cache(jcfg),
                               jnp.asarray(toks), jcfg)
    kc0, vc0 = tmodel.init_cache(tcfg, device="cpu")
    tmodel.prefill(tp, kc0, vc0, toks, tcfg)
    pos = len(toks)
    for fused in (True, False):
        jl, jk2, jv2 = jmodel.decode_step(jp, jk, jv, jnp.asarray(7, jnp.int32),
                                          jnp.asarray(pos, jnp.int32), jcfg,
                                          fused=fused)
        kc, vc = kc0.clone(), vc0.clone()
        tl, kc, vc = tmodel.decode_step(tp, kc, vc, 7, pos, tcfg,
                                        fused=fused)
        assert tl.shape == (tcfg.vocab_size,) and tl.dtype == torch.float32
        _close(tl, jl, scale=True)
        _close(kc[:, :, pos], np.asarray(jk2, np.float32)[:, :, pos],
               atol=0.05, rtol=0)
        _close(vc[:, :, pos], np.asarray(jv2, np.float32)[:, :, pos],
               atol=0.05, rtol=0)
        assert torch.equal(kc[:, :, :pos], kc0[:, :, :pos])


def _top2_gap(logits):
    s = np.sort(np.asarray(logits, np.float32))
    return float(s[-1] - s[-2])


def test_decode_loop_matches_jax(mha):
    """8 greedy steps: tokens equal wherever JAX's top-2 gap exceeds 0.05
    (JAX's per-step logits are recomputed teacher-forced on JAX's tokens)."""
    jcfg, tcfg, jp, tp = mha
    toks = np.asarray([1, 2, 3, 4], np.int32)
    jl, jk, jv = jmodel.prefill(jp, *jmodel.init_cache(jcfg),
                                jnp.asarray(toks), jcfg)
    first = int(jnp.argmax(jl[-1]))
    # gaps of JAX's logits at each step, teacher-forced on JAX's tokens
    jt, _, _ = jmodel.decode_loop(jp, jk.copy(), jv.copy(),
                                  jnp.asarray(first, jnp.int32),
                                  jnp.asarray(len(toks), jnp.int32), jcfg,
                                  fused=True, n_steps=8)
    jt = [int(x) for x in np.asarray(jt)]
    kc, vc = tmodel.init_cache(tcfg, device="cpu")
    tmodel.prefill(tp, kc, vc, toks, tcfg)
    tt, _, _ = tmodel.decode_loop(tp, kc, vc, first, len(toks), tcfg,
                                  fused=True, n_steps=8)
    tt = tt.tolist()
    gaps = []
    k2, v2 = jk, jv
    tok = first
    for i in range(8):
        lg, k2, v2 = jmodel.decode_step(jp, k2, v2, jnp.asarray(tok, jnp.int32),
                                        jnp.asarray(len(toks) + i, jnp.int32),
                                        jcfg, fused=True)
        gaps.append(_top2_gap(lg))
        tok = jt[i]
    for i in range(8):
        if gaps[i] > GAP:
            assert tt[i] == jt[i], (i, tt, jt, gaps)
        if tt[i] != jt[i]:
            break          # past a legitimate divergence the streams differ
    assert sum(g > GAP for g in gaps) >= 4   # the rule is not vacuous


def test_entry_points_refuse_unported_configs():
    """Gemma-2's interleaved window pattern and QKV bias stay refused (a
    window in Mistral's pattern runs: tests/test_torch_window.py)."""
    p = tmodel.init_params(LlamaConfig.tiny(), device="cpu")
    for cfg in (LlamaConfig.tiny(sliding_window=16, window_pattern="even"),
                LlamaConfig.tiny(qkv_bias=True)):
        kc, vc = tmodel.init_cache(cfg, device="cpu")
        with pytest.raises(NotImplementedError):
            tmodel.prefill(p, kc, vc, [1, 2], cfg)


@pytest.mark.parametrize("kv_heads,hg", [(None, 2), (2, None)])
def test_fuse_attention_weights_matches_jax(kv_heads, hg):
    """torch.nn.Linear-layout projections -> the fused kernel layout, the
    same permutation as the JAX package (bit-exact)."""
    jcfg, tcfg = JConfig.tiny(n_kv_heads=kv_heads), \
        LlamaConfig.tiny(n_kv_heads=kv_heads)
    hd, h = tcfg.head_dim_, tcfg.hidden_dim
    rng = np.random.RandomState(5)
    wq = rng.randn(tcfg.n_heads * hd, h).astype(np.float32)
    wk = rng.randn(tcfg.kv_heads * hd, h).astype(np.float32)
    wv = rng.randn(tcfg.kv_heads * hd, h).astype(np.float32)
    wo = rng.randn(h, tcfg.n_heads * hd).astype(np.float32)
    jq, jo = jmodel.fuse_attention_weights(wq, wk, wv, wo, jcfg,
                                           head_group=hg)
    tq, to = tmodel.fuse_attention_weights(
        *map(torch.from_numpy, (wq, wk, wv, wo)), tcfg, head_group=hg)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("style", ["gptj", "neox"])
def test_rope_row_is_a_row_of_the_table(style):
    cfg = LlamaConfig.tiny(rope_style=style)
    jc, js = jmodel.rope_table(JConfig.tiny(rope_style=style))
    tc, ts = tmodel.rope_table(cfg)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    for pos in (0, 1, 137, cfg.max_seq_len - 1):
        c, s = tmodel.rope_row(cfg, pos)
        assert torch.equal(c[0], tc[pos]) and torch.equal(s[0], ts[pos])
