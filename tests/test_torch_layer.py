"""The port's per-layer ops against the JAX package's, on the CPU: the norms
(kernels 1 and 2), ``gemv`` (kernel 3), the fused attention half
``_fused_decoder_layer`` (kernel 6) in each of its modes, and the public
ops ``llama_decoder_layer`` / ``llama_decoder_layer_sglang``.

Inputs are made with numpy from a seed and handed to both packages with
the same bits.  The JAX kernels run as the JAX suite runs them here
(Pallas in interpret mode); the port's wrappers run their plain twins,
since every tensor lies on the CPU.  Tolerances are the JAX suite's for
the same ops: the norms as ``tests/test_rmsnorm.py`` (mean abs error 2e-2
in bf16, 1e-5 in float32), the layers as ``tests/test_decoder_layer.py``
(output max 1e-1 and mean 1e-2, residual 2e-2, k/v rows 5e-2); gemv's
products are exact in float32 on both sides, so only the order of the sums
differs (1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import KernelConfig as JKernelConfig
from clusterfusion_tpu.config import LlamaConfig as JConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu.ops import decoder_layer as jdl
from clusterfusion_tpu.ops import fused_add_rmsnorm as j_fadd
from clusterfusion_tpu.ops import gemv as j_gemv
from clusterfusion_tpu.ops import rmsnorm as j_rmsnorm
from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models.convert import tensor_from_numpy
from clusterfusion_tpu_torch.ops import decoder_layer as tdl
from clusterfusion_tpu_torch.ops import fused_add_rmsnorm, gemv, rmsnorm

def _arr(a, dtype):
    """numpy float -> (jax array, torch tensor) of ``dtype``, the same bits."""
    j = jnp.asarray(a, dtype)
    return j, tensor_from_numpy(np.asarray(j), device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _mae(a, b):
    return float(np.mean(np.abs(_np(a) - _np(b))))


def _max_err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


# --------------------------------------------------------------------------
# Kernels 1, 2 and 3
# --------------------------------------------------------------------------

_NORM_SHAPES = [(7, 512), (64, 128)]
_DTYPES = [(jnp.bfloat16, 2e-2), (jnp.float32, 1e-5)]


@pytest.mark.parametrize("batch,hidden", _NORM_SHAPES)
@pytest.mark.parametrize("dtype,tol", _DTYPES, ids=["bf16", "f32"])
def test_rmsnorm_matches_jax(batch, hidden, dtype, tol):
    rng = np.random.default_rng(batch * 1000 + hidden)
    jx, tx = _arr(rng.standard_normal((batch, hidden)), dtype)
    jw, tw = _arr(rng.standard_normal(hidden) * 0.1, dtype)
    got = rmsnorm(tx, tw)
    want = j_rmsnorm(jx, jw)
    assert got.dtype == tx.dtype and tuple(got.shape) == (batch, hidden)
    assert _mae(got, want) < tol


@pytest.mark.parametrize("batch,hidden", _NORM_SHAPES)
@pytest.mark.parametrize("dtype,tol", _DTYPES, ids=["bf16", "f32"])
def test_fused_add_rmsnorm_matches_jax(batch, hidden, dtype, tol):
    rng = np.random.default_rng(batch * 1000 + hidden + 1)
    jx, tx = _arr(rng.standard_normal((batch, hidden)), dtype)
    jr, tr = _arr(rng.standard_normal((batch, hidden)), dtype)
    jw, tw = _arr(rng.standard_normal(hidden) * 0.1, dtype)
    got_y, got_h = fused_add_rmsnorm(tx, tr, tw, 1e-5)
    want_y, want_h = j_fadd(jx, jr, jw, 1e-5)
    assert got_y.dtype == got_h.dtype == tx.dtype
    assert _mae(got_y, want_y) < tol
    assert _mae(got_h, want_h) < tol


@pytest.mark.parametrize("K,N", [(512, 384), (128, 1024)])
def test_gemv_matches_jax(K, N):
    rng = np.random.default_rng(K + N)
    jx, tx = _arr(rng.standard_normal((1, K)), jnp.bfloat16)
    jw, tw = _arr(rng.standard_normal((K, N)) / np.sqrt(K), jnp.bfloat16)
    got = gemv(tx, tw)
    want = j_gemv(jx, jw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, N)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3, rtol=1e-3)


def test_gemv_refuses_unaligned_n():
    with pytest.raises(ValueError):
        gemv(torch.zeros((1, 64), dtype=torch.bfloat16),
             torch.zeros((64, 200), dtype=torch.bfloat16))


# --------------------------------------------------------------------------
# Kernel 6: _fused_decoder_layer in each mode
# --------------------------------------------------------------------------

CAP = 64
LAYER = 1
GARBAGE = 1e3       # rows at and above seq: never read, never changed


@pytest.fixture(scope="module")
def layer_setup():
    """LlamaConfig.tiny(n_kv_heads=2) (GQA, group 2, hd 128): the JAX
    parameter tree's stacked fused weights, a [L, kv, 64, hd] cache and the
    layer's inputs, each as (jax, torch) with the same bits."""
    jcfg = JConfig.tiny(n_kv_heads=2)
    cfg = LlamaConfig.tiny(n_kv_heads=2)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    lw = jp["layers"]
    rng = np.random.default_rng(11)
    L, kv, hd, h = cfg.n_layers, cfg.kv_heads, cfg.head_dim_, cfg.hidden_dim
    w = {k: (lw[k], tensor_from_numpy(np.asarray(lw[k]), device="cpu"))
         for k in ("wqkv_f", "wo_f")}
    norm = rng.standard_normal((L, 1, h)) * 0.1 + 1.0
    w["rms_w"] = _arr(norm, jnp.bfloat16)
    w["x"] = _arr(rng.standard_normal((1, h)), jnp.bfloat16)
    w["res"] = _arr(rng.standard_normal((1, h)), jnp.bfloat16)
    cache = rng.standard_normal((2, L, kv, CAP, hd))
    return cfg, w, cache


def _caches(cache, seq):
    """(jax, torch) k and v caches: random rows < seq, garbage above."""
    c = cache.copy()
    c[:, :, :, seq:] = GARBAGE
    return _arr(c[0], jnp.bfloat16), _arr(c[1], jnp.bfloat16)


def _rope_row(pos, style):
    """Full-dim (cos, sin) [1, hd] at ``pos``, as (jax, torch)."""
    c, s = tmodel.rope_row(LlamaConfig.tiny(rope_style=style), pos)
    return (jnp.asarray(c.numpy()), c), (jnp.asarray(s.numpy()), s)


_MODES = {
    # name: (seq, rope, fuse_residual, append_kv, emit_partials, fold)
    "full_append": (37, "gptj", True, True, False, 1),
    "full_neox": (37, "neox", True, False, False, 1),
    "no_residual": (37, "gptj", False, False, False, 1),
    "partials_fold1": (37, "neox", True, False, True, 1),
    "partials_fold0": (37, "neox", True, False, True, 0),
    "partials_empty": (0, "neox", True, False, True, 0),
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_fused_decoder_layer_matches_jax(layer_setup, mode):
    cfg, w, cache = layer_setup
    seq, style, fuse, append, partials, fold = _MODES[mode]
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    (jk, tk), (jv, tv) = _caches(cache, seq)
    tk0, tv0 = tk.clone(), tv.clone()
    (jc, tc), (js, ts) = _rope_row(seq, style)
    kw = dict(group=g, head_dim=hd, rope_style=style, fuse_residual=fuse,
              eps=cfg.norm_eps, emit_partials=partials, fold_current=fold,
              append_kv=append)
    jargs = [w[k][0] for k in ("x", "res", "rms_w")] + [jc, js] + \
        [w[k][0] for k in ("wqkv_f", "wo_f")] + [jk, jv, seq, LAYER]
    targs = [w[k][1] for k in ("x", "res", "rms_w")] + [tc, ts] + \
        [w[k][1] for k in ("wqkv_f", "wo_f")] + [tk, tv, seq, LAYER]
    want = jdl._fused_decoder_layer(*jargs, kcfg=JKernelConfig(),
                                    interpret=True, **kw)
    got = tdl._fused_decoder_layer(*targs, kcfg=KernelConfig(), **kw)
    rows = cfg.kv_heads * g
    if partials:
        acc, ml, res_out, k_new, v_new = got
        assert tuple(acc.shape) == (rows, hd) and tuple(ml.shape) == (2, rows)
        np.testing.assert_allclose(_np(ml[0]), _np(want[1][0]), rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(_np(ml[1]), _np(want[1][1]), rtol=1e-2,
                                   atol=1e-3)
        np.testing.assert_allclose(_np(acc), _np(want[0]), rtol=2e-2,
                                   atol=5e-2)
        if seq == 0 and not fold:
            # the empty state: exp2(m - m*) of an empty shard must stay finite
            assert torch.all(ml[0] == -1e30) and torch.all(ml[1] == 0)
            assert torch.all(acc == 0)
        want_res, want_k, want_v = want[2], want[3], want[4]
    else:
        out, res_out, k_new, v_new = got[:4]
        assert _max_err(out, want[0]) < 1e-1
        assert _mae(out, want[0]) < 1e-2
        want_res, want_k, want_v = want[1], want[2], want[3]
    if fuse:
        assert _max_err(res_out, want_res) < 2e-2
    else:
        assert res_out is None
    assert _max_err(k_new, want_k) < 5e-2
    assert _max_err(v_new, want_v) < 5e-2
    if append:
        jk2, jv2 = want[4], want[5]
        assert got[4] is tk and got[5] is tv
        assert _max_err(tk[LAYER, :, seq], jk2[LAYER, :, seq]) < 5e-2
        assert _max_err(tv[LAYER, :, seq], jv2[LAYER, :, seq]) < 5e-2
        others = torch.ones(CAP, dtype=torch.bool)
        others[seq] = False
        assert torch.equal(tk[:, :, others], tk0[:, :, others])
        assert torch.equal(tv[:, :, others], tv0[:, :, others])
        assert torch.equal(tk[0], tk0[0]) and torch.equal(tv[0], tv0[0])
    else:
        assert torch.equal(tk, tk0) and torch.equal(tv, tv0)


def test_partials_merge_equals_full_layer(layer_setup):
    """The sequence-parallel algebra on one process: two shards' partials
    ([0, 20) without the current token, [20, 37) with it) merged in the
    log2 domain, normalised and O-projected, equal the full mode's output
    (the same twin, rounded to bf16 at the same places)."""
    cfg, w, cache = layer_setup
    g, hd, seq = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, 37
    (_, tk), (_, tv) = _caches(cache, seq)
    (_, tc), (_, ts) = _rope_row(seq, "neox")
    base = [w[k][1] for k in ("x", "res", "rms_w")] + [tc, ts] + \
        [w[k][1] for k in ("wqkv_f", "wo_f")]
    kw = dict(group=g, head_dim=hd, rope_style="neox", fuse_residual=True,
              eps=cfg.norm_eps)
    full = tdl._fused_decoder_layer(*base, tk, tv, seq, LAYER, **kw)
    shards = [(tk[:, :, :20].contiguous(), tv[:, :, :20].contiguous(), 20, 0),
              (tk[:, :, 20:].contiguous(), tv[:, :, 20:].contiguous(), 17, 1)]
    parts = [tdl._fused_decoder_layer(*base, k, v, n, LAYER,
                                      emit_partials=True, fold_current=f,
                                      **kw)
             for k, v, n, f in shards]
    m = torch.stack([p[1][0] for p in parts])
    m_g = m.amax(dim=0)
    alpha = torch.exp2(m - m_g)
    l_g = sum(p[1][1] * a for p, a in zip(parts, alpha))
    acc_g = sum(p[0] * a[:, None] for p, a in zip(parts, alpha))
    o = (acc_g / l_g[:, None]).to(torch.bfloat16)
    wo = w["wo_f"][1][LAYER]
    out = (o.reshape(wo.shape[0], -1).float()[:, :, None]
           * wo.float()).sum(dim=(0, 1)).to(torch.bfloat16)
    assert _max_err(out, full[0][0]) < 2e-2


# --------------------------------------------------------------------------
# Public ops at hidden 512, 4 heads of 128
# --------------------------------------------------------------------------

HIDDEN, HEADS, HD = 512, 4, 128


def _public_inputs(seqlen, seed):
    rng = np.random.default_rng(seed)
    shapes = dict(input=((1, HIDDEN), 1.0), residual=((1, HIDDEN), 1.0),
                  w_qkv=((3 * HIDDEN, HIDDEN), 0.1),
                  w_o=((HIDDEN, HIDDEN), 0.1),
                  k_cache=((seqlen, HIDDEN), 1.0),
                  v_cache=((seqlen, HIDDEN), 1.0), rms_w=((HIDDEN,), 0.1))
    return {k: _arr(rng.standard_normal(s) * sc, jnp.bfloat16)
            for k, (s, sc) in shapes.items()}


@pytest.mark.parametrize("seqlen", [1, 37])
def test_llama_decoder_layer_sglang_matches_jax(seqlen):
    d = _public_inputs(seqlen, seqlen)
    angle = np.random.default_rng(99).uniform(size=HD // 2) * np.pi
    (jc, tc), (js, ts) = (_arr(np.cos(angle), jnp.float32),
                          _arr(np.sin(angle), jnp.float32))
    names = ("input", "residual", "w_qkv", "w_o", "k_cache", "v_cache",
             "rms_w")
    want = jdl.llama_decoder_layer_sglang(*[d[k][0] for k in names], 1e-5,
                                          jc, js)
    got = tdl.llama_decoder_layer_sglang(*[d[k][1] for k in names], 1e-5,
                                         tc, ts)
    assert _max_err(got[1], want[1]) < 2e-2, "residual"
    assert _max_err(got[2], want[2]) < 5e-2, "k_new"
    assert _max_err(got[3], want[3]) < 5e-2, "v_new"
    assert _max_err(got[0], want[0]) < 1e-1, "output"
    assert _mae(got[0], want[0]) < 1e-2, "output mae"


@pytest.mark.parametrize("seqlen", [1, 37])
def test_llama_decoder_layer_matches_jax(seqlen):
    d = _public_inputs(seqlen, seqlen + 1000)
    pos = seqlen
    inv = 1.0 / (10000.0 ** (np.arange(0, HD, 2) / HD))
    ang = np.repeat(pos * inv, 2)[None]
    (jc, tc), (js, ts) = (_arr(np.cos(ang), jnp.float32),
                          _arr(np.sin(ang), jnp.float32))
    names = ("input", "w_qkv", "w_o", "k_cache", "v_cache", "rms_w")
    want = jdl.llama_decoder_layer(*[d[k][0] for k in names], jc, js)
    got = tdl.llama_decoder_layer(*[d[k][1] for k in names], tc, ts)
    assert _max_err(got[1], want[1]) < 5e-2, "k_new"
    assert _max_err(got[2], want[2]) < 5e-2, "v_new"
    assert _max_err(got[0], want[0]) < 1e-1, "output"
    assert _mae(got[0], want[0]) < 1e-2, "output mae"


# --------------------------------------------------------------------------
# The float32 layer oracles (ops/reference.py) against JAX's, and the
# public ops against them
# --------------------------------------------------------------------------


def _sglang_ref_inputs(seqlen):
    d = _public_inputs(seqlen, seqlen + 2000)
    angle = np.random.default_rng(98).uniform(size=HD // 2) * np.pi
    return d, (_arr(np.cos(angle), jnp.float32),
               _arr(np.sin(angle), jnp.float32))


def _meta_ref_inputs(seqlen):
    d = _public_inputs(seqlen, seqlen + 3000)
    inv = 1.0 / (10000.0 ** (np.arange(0, HD, 2) / HD))
    ang = np.repeat(seqlen * inv, 2)[None]
    return d, (_arr(np.cos(ang), jnp.float32), _arr(np.sin(ang), jnp.float32))


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("seqlen", [1, 37])
def test_sglang_layer_oracle_matches_jax(seqlen, window):
    """``llama_decoder_layer_sglang_ref`` (and ``_attend_single`` inside it,
    with and without a window) against JAX's: both float32 from the same
    bf16 inputs, so within a bf16 rounding of each output."""
    from clusterfusion_tpu.ops import reference as jref
    from clusterfusion_tpu_torch.ops import reference as tref
    d, ((jc, tc), (js, ts)) = _sglang_ref_inputs(seqlen)
    names = ("input", "residual", "w_qkv", "w_o", "k_cache", "v_cache",
             "rms_w")
    kw = dict(n_heads=HEADS, head_dim=HD, window=window)
    want = jref.llama_decoder_layer_sglang_ref(*[d[k][0] for k in names],
                                               1e-5, jc, js, **kw)
    got = tref.llama_decoder_layer_sglang_ref(*[d[k][1] for k in names],
                                              1e-5, tc, ts, **kw)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.bfloat16 and g_.shape == (1, HIDDEN)
        np.testing.assert_allclose(_np(g_), np.asarray(w_, np.float32),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("seqlen", [1, 37])
def test_meta_layer_oracle_matches_jax(seqlen):
    """``llama_decoder_layer_ref`` against JAX's (float32, within a bf16
    rounding of each output)."""
    from clusterfusion_tpu.ops import reference as jref
    from clusterfusion_tpu_torch.ops import reference as tref
    d, ((jc, tc), (js, ts)) = _meta_ref_inputs(seqlen)
    names = ("input", "w_qkv", "w_o", "k_cache", "v_cache", "rms_w")
    kw = dict(n_heads=HEADS, head_dim=HD)
    want = jref.llama_decoder_layer_ref(*[d[k][0] for k in names], jc, js,
                                        **kw)
    got = tref.llama_decoder_layer_ref(*[d[k][1] for k in names], tc, ts,
                                       **kw)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g_), np.asarray(w_, np.float32),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("seqlen", [1, 37])
def test_public_layer_ops_match_the_oracles(seqlen):
    """Kernel 6's public ops (their plain twin here) against the float32
    oracles at the tolerances of the JAX ops' tests above: the twin rounds
    the normed row, q, p and o to bf16 where the kernel does, the oracle
    does not."""
    from clusterfusion_tpu_torch.ops import reference as tref
    d, ((_, tc), (_, ts)) = _sglang_ref_inputs(seqlen)
    names = ("input", "residual", "w_qkv", "w_o", "k_cache", "v_cache",
             "rms_w")
    args = [d[k][1] for k in names]
    got = tdl.llama_decoder_layer_sglang(*args, 1e-5, tc, ts)
    want = tref.llama_decoder_layer_sglang_ref(*args, 1e-5, tc, ts,
                                               n_heads=HEADS, head_dim=HD)
    for i, tol in ((1, 2e-2), (2, 5e-2), (3, 5e-2), (0, 1e-1)):
        assert _max_err(got[i], _np(want[i])) < tol, i
    assert _mae(got[0], _np(want[0])) < 1e-2
    d, ((_, tc), (_, ts)) = _meta_ref_inputs(seqlen)
    names = ("input", "w_qkv", "w_o", "k_cache", "v_cache", "rms_w")
    args = [d[k][1] for k in names]
    got = tdl.llama_decoder_layer(*args, tc, ts)
    want = tref.llama_decoder_layer_ref(*args, tc, ts, n_heads=HEADS,
                                        head_dim=HD)
    for i, tol in ((1, 5e-2), (2, 5e-2), (0, 1e-1)):
        assert _max_err(got[i], _np(want[i])) < tol, i
    assert _mae(got[0], _np(want[0])) < 1e-2


# --------------------------------------------------------------------------
# Refusals: what the kernels do not take raises, never falls back
# --------------------------------------------------------------------------


def _one_layer_args(layer_setup, **over):
    cfg, w, cache = layer_setup
    (_, tk), (_, tv) = _caches(cache, 5)
    (_, tc), (_, ts) = _rope_row(5, "neox")
    args = dict(x=w["x"][1], residual=w["res"][1], rms_w=w["rms_w"][1],
                cos_f=tc, sin_f=ts, wqkv_f=w["wqkv_f"][1],
                wo_f=w["wo_f"][1], k_cache=tk, v_cache=tv, seq_len=5)
    args.update(over)
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style="neox", fuse_residual=True, eps=cfg.norm_eps)
    return args, kw


@pytest.mark.parametrize("what", ["int8_weights", "int4_weights", "window",
                                  "softcap", "bias", "fp8_cache"])
def test_fused_decoder_layer_refuses_unported(layer_setup, what):
    """A raw int8 tensor (not a QuantizedTensor) and an int4 pair in a
    group size the kernels do not take (64; mode 1.5: groups of 128 run
    since mode 1.4) are refused, as are the modes not ported yet (a window
    in Gemma-2's "even" pattern: Mistral's runs since mode 3.1), and an
    fp8 k cache beside a bf16 v cache (since item 2.2 an fp8 pair runs;
    a pair of two kinds raises ValueError)."""
    args, kw = _one_layer_args(layer_setup)
    if what == "int8_weights":
        args["wqkv_f"] = args["wqkv_f"].to(torch.int8)
    elif what == "int4_weights":
        from clusterfusion_tpu_torch.ops.quant import quantize_int4
        args["wqkv_f"] = quantize_int4(args["wqkv_f"], -2, 64)
        args["wo_f"] = quantize_int4(args["wo_f"], -2, 64)
    elif what == "window":      # Mistral's pattern runs; Gemma-2's is refused
        kw.update(window=16, window_pattern="even")
    elif what == "softcap":
        kw["softcap"] = 50.0
    elif what == "bias":
        kw["bias_qkv"] = torch.zeros(8)
    else:
        args["k_cache"] = args["k_cache"].to(torch.float8_e4m3fn)
    with pytest.raises(ValueError if what == "fp8_cache"
                       else NotImplementedError,
                       match="queue 2, mode 1.5" if what == "int4_weights"
                       else "one kind" if what == "fp8_cache" else ""):
        tdl._fused_decoder_layer(**args, **kw)


def test_fused_decoder_layer_partials_do_not_append(layer_setup):
    args, kw = _one_layer_args(layer_setup)
    with pytest.raises(ValueError):
        tdl._fused_decoder_layer(**args, **kw, emit_partials=True,
                                 append_kv=True)


# JAX packages whose exports the port mirrors: the name list of each (its
# ``__all__``, or its public non-module names where it has none)
EXPORTING = ("clusterfusion_tpu", "clusterfusion_tpu.ops",
             "clusterfusion_tpu.models")


@pytest.mark.parametrize("pkg", EXPORTING)
def test_exports_match_jax(pkg):
    """Every name a JAX package exports resolves in the port's twin
    wherever the module that defines it is ported (the quantization names
    wait for ``ops/quant.py``)."""
    import importlib
    import importlib.util
    import types
    jmod = importlib.import_module(pkg)
    tmod = importlib.import_module(pkg.replace("clusterfusion_tpu",
                                               "clusterfusion_tpu_torch", 1))
    names = getattr(jmod, "__all__", None) or [
        k for k, v in vars(jmod).items()
        if not k.startswith("_") and not isinstance(v, types.ModuleType)]
    checked = []
    for name in names:
        home = getattr(jmod, name).__module__
        if importlib.util.find_spec(home.replace(
                "clusterfusion_tpu", "clusterfusion_tpu_torch", 1)) is None:
            continue
        assert hasattr(tmod, name), f"{tmod.__name__} lacks {name}"
        checked.append(name)
    assert checked
    if pkg == "clusterfusion_tpu":
        assert tmod.__version__ == jmod.__version__
