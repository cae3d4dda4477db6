"""The port's DeepSeek-V2 MLA path against the JAX package, on the CPU.

The same inputs, made from a seed, go through the JAX function and its
counterpart in the port: the config, the YaRN rope tables, the MLA layer
ops (kernels 11 and 12), the fused FFN (kernel 5), the MoE and the model at
``DeepSeekConfig.tiny()``, tiny with experts and tiny with YaRN.  JAX's
Pallas kernels run in interpret mode, the port's wrappers run their plain
twins.  JAX parameter trees cross through ``params_from_numpy``.

Tolerances are the JAX suite's own for these ops: the MLA layer as in
``tests/test_deepseek.py`` (ckv_new 5e-2, output max 1e-1 and mean 1e-2),
logits within 5 % of the largest logit and compressed rows within 0.05 as
in ``tests/test_deepseek_model.py``.  Greedy tokens must agree wherever
JAX's top-2 logit gap exceeds 0.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import DeepSeekConfig as JConfig
from clusterfusion_tpu.models import deepseek as jmodel
from clusterfusion_tpu.ops import deepseek_layer as jdl
from clusterfusion_tpu.ops import ffn as jffn
from clusterfusion_tpu.ops import moe as jmoe
from clusterfusion_tpu.ops import rope as jrope
from clusterfusion_tpu.ops.reference import deepseek_decoder_layer_ref as jref
from clusterfusion_tpu_torch.config import DeepSeekConfig
from clusterfusion_tpu_torch.models import deepseek as tmodel
from clusterfusion_tpu_torch.models.convert import (params_from_numpy,
                                                    tensor_from_numpy)
from clusterfusion_tpu_torch.ops import deepseek_layer as tdl
from clusterfusion_tpu_torch.ops import ffn as tffn
from clusterfusion_tpu_torch.ops import moe as tmoe
from clusterfusion_tpu_torch.ops import rope as trope
from clusterfusion_tpu_torch.ops.reference import \
    deepseek_decoder_layer_ref as tref

GAP = 0.05
# DeepSeek-V2-Lite's published YaRN settings (config.json rope_scaling)
YARN = dict(yarn_factor=40.0, yarn_orig_max=4096, yarn_beta_fast=32.0,
            yarn_beta_slow=1.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707)


def _bf16(a):
    """numpy f32 -> (the JAX bf16 array, the bit-equal torch CPU tensor)."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, tensor_from_numpy(np.asarray(j), device="cpu")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float32)


def _max_err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _logits_close(t, j, frac=0.05):
    scale = max(float(np.max(np.abs(_np(j)))), 1.0)
    err = _max_err(t, j)
    assert err < frac * scale, (err, scale)


# -- config and rope ---------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"tiny": True}, {"n_experts": 64,
                                                     "moe_top_k": 6,
                                                     **YARN}],
                         ids=["v2lite", "tiny", "moe_yarn"])
def test_config_matches_jax(kw):
    kw = dict(kw)
    if kw.pop("tiny", False):
        j, t = JConfig.tiny(), DeepSeekConfig.tiny()
    else:
        j, t = JConfig(**kw), DeepSeekConfig(**kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("head_dim", "mla_head_dim", "n_proj"):
        assert getattr(j, prop) == getattr(t, prop), prop
    assert t.softmax_scale == pytest.approx(j.softmax_scale, rel=1e-12)


def test_rope_tables_yarn_matches_jax():
    """V2-Lite's YaRN tables over its 4096 positions, atol 1e-5."""
    kw = dict(factor=40.0, orig_max=4096, beta_fast=32.0, beta_slow=1.0,
              mscale=0.707, mscale_all_dim=0.707)
    jc, js = jrope.rope_tables_yarn(64, 4096, 10000.0, **kw)
    tc, ts = trope.rope_tables_yarn(64, 4096, 10000.0, **kw)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    assert trope.yarn_softmax_scale_mult(40.0, 0.707) == pytest.approx(
        jrope.yarn_softmax_scale_mult(40.0, 0.707), rel=1e-12)
    cfg = DeepSeekConfig.tiny(**YARN)
    jc, _ = jmodel.rope_table(JConfig.tiny(**YARN))
    tc, _ = tmodel.rope_table(cfg)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)


# -- the MLA layer ops: kernels 11 and 12 -------------------------------------

LAYER = DeepSeekConfig(hidden_dim=1024, n_heads=4)   # the JAX test's geometry
DIMS = dict(n_heads=LAYER.n_heads, nope_dim=LAYER.nope_head_dim,
            rope_dim=LAYER.rope_head_dim, lora_rank=LAYER.kv_lora_rank)
_jref = jax.jit(jref, static_argnames=tuple(DIMS) + ("eps",))


def _layer_inputs(seq, seed):
    """The inputs of ``tests/test_deepseek.py``'s layer test, from numpy."""
    h, nope, rope, lora = (LAYER.n_heads, LAYER.nope_head_dim,
                           LAYER.rope_head_dim, LAYER.kv_lora_rank)
    hid = LAYER.hidden_dim
    rng = np.random.RandomState(seed)

    def r(shape, s=0.1):
        return rng.randn(*shape).astype(np.float32) * s

    angle = rng.uniform(0, 3.0, rope // 2).astype(np.float32)
    raw = dict(input=r((1, hid), 1.0), weight_q_nope=r((h * nope, hid)),
               weight_q_pe=r((h * rope, hid)), weight_uk=r((h, nope, lora)),
               weight_kv_nope=r((lora, hid)), weight_k_pe=r((rope, hid)),
               weight_uv=r((h, lora, nope)), weight_o=r((hid, h * nope)),
               ckv_cache=r((seq, lora + rope), 1.0),
               rms_input_weight=r((hid,)), rms_ckv_weight=r((lora,)))
    j, t = {}, {}
    for k, v in raw.items():
        j[k], t[k] = _bf16(v)
    for k, v in (("cos", np.cos(angle)), ("sin", np.sin(angle))):
        j[k], t[k] = jnp.asarray(v), torch.from_numpy(v)
    return j, t


@pytest.mark.parametrize("seq", [1, 37, 300])
def test_mla_layer_matches_jax_and_oracle(seq):
    """Kernel 11's twin, through the public op, against the JAX op
    (interpret mode) and both oracles."""
    j, t = _layer_inputs(seq, seq)
    got_out, got_ckv = tdl.deepseek_decoder_layer(**t, **DIMS)
    assert got_out.shape == (1, LAYER.hidden_dim)
    assert got_ckv.shape == (1, LAYER.mla_head_dim)
    want = jdl.deepseek_decoder_layer(**j, **DIMS)
    oracle = tref(**t, **DIMS)
    joracle = _jref(**j, **DIMS)
    assert _max_err(oracle[0], joracle[0]) < 1e-2
    assert _max_err(oracle[1], joracle[1]) < 1e-2
    for ref_out, ref_ckv in (want, oracle):
        assert _max_err(got_ckv, ref_ckv) < 5e-2, "ckv_new"
        assert _max_err(got_out, ref_out) < 1e-1, "output"
        assert float(np.mean(np.abs(_np(got_out) - _np(ref_out)))) < 1e-2


@pytest.mark.parametrize("seq", [33, 300])
def test_mla_split_twin_matches_one_split(seq):
    """The twin in MLA_SPLIT-row splits against one split over every row.
    p is rounded to bf16 against each split's own max, so a p may differ by
    one bf16 rounding and the output by about one bf16 ulp: atol 2e-2 /
    rtol 2e-2, the suite's bf16 limit; the current row does not depend on
    the split."""
    _, t = _layer_inputs(seq, seq)
    wproj = torch.cat([t["weight_q_nope"].T, t["weight_q_pe"].T,
                       t["weight_kv_nope"].T, t["weight_k_pe"].T], -1)
    args = (t["input"], t["rms_input_weight"], t["rms_ckv_weight"], t["cos"],
            t["sin"], wproj, t["weight_uk"], t["weight_uv"],
            t["weight_o"].T, t["ckv_cache"], seq)
    kw = dict(n_heads=DIMS["n_heads"], nope_dim=DIMS["nope_dim"],
              rope_dim=DIMS["rope_dim"], lora_rank=DIMS["lora_rank"],
              eps=1e-6, softmax_scale=(DIMS["nope_dim"]
                                       + DIMS["rope_dim"]) ** -0.5)
    out, cur = tdl.mla_decode_plain(*args, split=tdl.MLA_SPLIT, **kw)
    one, cur1 = tdl.mla_decode_plain(*args, split=seq, **kw)
    assert seq > tdl.MLA_SPLIT
    np.testing.assert_allclose(_np(out), _np(one), atol=2e-2, rtol=2e-2)
    assert torch.equal(cur, cur1)


def test_mla_layer_takes_padded_cache():
    """A 640-wide cache (the model's layout) gives the 576-wide result."""
    _, t = _layer_inputs(37, 3)
    wproj = torch.cat([t["weight_q_nope"].T, t["weight_q_pe"].T,
                       t["weight_kv_nope"].T, t["weight_k_pe"].T], -1)
    args = (t["input"], wproj, t["weight_uk"], t["weight_uv"],
            t["weight_o"].T)
    tail = (t["rms_input_weight"], t["rms_ckv_weight"], t["cos"], t["sin"])
    cache = t["ckv_cache"]
    padded = torch.nn.functional.pad(cache, (0, 64), value=1e4)
    a = tdl.deepseek_decoder_layer_fused(*args, cache, 30, *tail, **DIMS)
    b = tdl.deepseek_decoder_layer_fused(*args, padded, 30, *tail, **DIMS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


STACK = DeepSeekConfig.tiny()
STACK_CAP = 64


def _stack_inputs(seed=11):
    cfg = STACK
    h, nope, rope, lora = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                           cfg.kv_lora_rank)
    hid, L = cfg.hidden_dim, cfg.n_layers
    rng = np.random.RandomState(seed)

    def r(shape, fan_in):
        return rng.randn(*shape).astype(np.float32) / np.sqrt(fan_in)

    raw = dict(input=r((1, hid), 1.0), wproj_s=r((L, hid, cfg.n_proj), hid),
               wuk_s=r((L, h, nope, lora), nope),
               wuv_s=r((L, h, lora, nope), lora),
               wo_s=r((L, h * nope, hid), h * nope),
               rms_in_s=1 + 0.1 * r((L, hid), 1.0),
               rms_ckv_s=1 + 0.1 * r((L, lora), 1.0))
    cache = rng.randn(L, STACK_CAP, 256).astype(np.float32)
    j, t = {}, {}
    for k, v in raw.items():
        j[k], t[k] = _bf16(v)
    j["ckv_cache"], t["ckv_cache"] = _bf16(cache)
    cos, sin = tmodel.rope_table(cfg)
    return j, t, cos, sin


@pytest.mark.parametrize("pos", [0, 5, 37])
def test_mla_stack_layer_matches_jax(pos):
    """Kernel 12's twin against the JAX op at layer 1: pos 0, 5, and 37,
    across the boundary of the 32-row splits.  Rows at and above pos hold
    large garbage; the op reads none of them, writes row pos (zero in the
    pad columns) and leaves every other row as it was."""
    j, t, cos, sin = _stack_inputs()
    garbage = np.random.RandomState(pos).randn(STACK.n_layers,
                                               STACK_CAP - pos, 256) * 8
    jg, tg = _bf16(garbage)
    j["ckv_cache"] = j["ckv_cache"].at[:, pos:].set(jg)
    t["ckv_cache"][:, pos:] = tg
    before = t["ckv_cache"].clone()
    dims = dict(n_heads=STACK.n_heads, nope_dim=STACK.nope_head_dim,
                rope_dim=STACK.rope_head_dim, lora_rank=STACK.kv_lora_rank,
                eps=STACK.norm_eps)
    order = ("input", "wproj_s", "wuk_s", "wuv_s", "wo_s", "ckv_cache")
    out, cache = tdl.deepseek_decoder_stack_layer(
        *[t[k] for k in order], pos, 1, t["rms_in_s"], t["rms_ckv_s"],
        cos[pos], sin[pos], **dims)
    assert cache is t["ckv_cache"]
    jout, jcache = jdl.deepseek_decoder_stack_layer(
        *[j[k] for k in order], jnp.asarray(pos, jnp.int32),
        jnp.asarray(1, jnp.int32), j["rms_in_s"], j["rms_ckv_s"],
        jnp.asarray(cos[pos].numpy()), jnp.asarray(sin[pos].numpy()), **dims)
    assert _max_err(out, jout) < 1e-1
    assert float(np.mean(np.abs(_np(out) - _np(jout)))) < 1e-2
    mla = STACK.mla_head_dim
    jc = np.asarray(jcache, np.float32)
    assert _max_err(cache[1, pos], jc[1, pos]) < 5e-2
    assert not cache[1, pos, mla:].any() and not jc[1, pos, mla:].any()
    others = torch.ones(STACK.n_layers, STACK_CAP, dtype=torch.bool)
    others[1, pos] = False
    assert torch.equal(cache[others], before[others])


# -- kernel 5: the fused FFN ---------------------------------------------------


def test_ffn_helpers_match_jax():
    for f in (1024, 1408, 11264, 3 * 128):
        assert tffn.ffn_block_size(f) == jffn.ffn_block_size(f)
    rng = np.random.RandomState(0)
    w13 = rng.randn(2, 8, 1000).astype(np.float32)
    w2 = rng.randn(1000, 8).astype(np.float32)
    j13, j2 = jffn.pad_ffn_weights(jnp.asarray(w13), jnp.asarray(w2), 128)
    t13, t2 = tffn.pad_ffn_weights(torch.from_numpy(w13),
                                   torch.from_numpy(w2), 128)
    assert np.array_equal(t13.numpy(), np.asarray(j13))
    assert np.array_equal(t2.numpy(), np.asarray(j2))


@pytest.mark.parametrize("fuse_residual", [True, False])
def test_fused_ffn_matches_jax(fuse_residual):
    """Kernel 5's twin, stacked, at layer 1, against the JAX kernel."""
    L, hid, f = 2, 512, 1024
    rng = np.random.RandomState(7)
    x, tx = _bf16(rng.randn(1, hid))
    res, tres = _bf16(rng.randn(1, hid))
    nw, tnw = _bf16(1 + 0.1 * rng.randn(L, 1, hid))
    w13, t13 = _bf16(rng.randn(L, 2, hid, f) / np.sqrt(hid))
    w2, t2 = _bf16(rng.randn(L, f, hid) / np.sqrt(f))
    out, h = tffn.fused_ffn(tx, tres, tnw, t13, t2, eps=1e-6,
                            fuse_residual=fuse_residual, layer_id=1)
    jout, jh = jffn.fused_ffn(x, res, nw, w13, w2, eps=1e-6,
                              fuse_residual=fuse_residual, layer_id=1,
                              interpret=True)
    np.testing.assert_allclose(_np(out), _np(jout), atol=2e-2, rtol=2e-2)
    if fuse_residual:
        assert np.array_equal(_np(h), _np(jh))


# -- MoE -----------------------------------------------------------------------

E, H, F_E = 8, 256, 128


@pytest.mark.parametrize("norm,scaling", [(True, 1.0), (False, 16.0)],
                         ids=["norm_topk", "scaled_16"])
def test_moe_matches_jax(norm, scaling):
    rng = np.random.RandomState(3)
    router, trouter = _bf16(rng.randn(H, E) / np.sqrt(H))
    w13, t13 = _bf16(rng.randn(E, 2, H, F_E) / np.sqrt(H))
    w2, t2 = _bf16(rng.randn(E, F_E, H) / np.sqrt(F_E))
    kw = dict(norm_topk_prob=norm, routed_scaling_factor=scaling)
    xt, txt = _bf16(rng.randn(5, H))
    g, sel = tmoe.route_top_k(txt, trouter, 2, **kw)
    jg, jsel = jax.jit(lambda a, b: jmoe.route_top_k(a, b, 2, **kw))(xt, router)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    assert np.array_equal(sel.numpy(), np.asarray(jsel))
    assert (np.count_nonzero(g.numpy(), axis=-1) == 2).all()
    x1, tx1 = _bf16(rng.randn(1, H))
    dec = tmoe.moe_ffn_decode(tx1, trouter, t13, t2, 2, **kw)
    jdec = jax.jit(lambda *a: jmoe.moe_ffn_decode(*a, 2, **kw))(
        x1, router, w13, w2)
    np.testing.assert_allclose(_np(dec), _np(jdec), atol=0.02 * scaling,
                               rtol=2e-2)
    dense = tmoe.moe_ffn_dense(txt, trouter, t13, t2, 2, **kw)
    jdense = jax.jit(lambda *a: jmoe.moe_ffn_dense(*a, 2, **kw))(
        xt, router, w13, w2)
    np.testing.assert_allclose(_np(dense), _np(jdense), atol=0.02 * scaling,
                               rtol=2e-2)


# -- the model -------------------------------------------------------------------

MODELS = {
    "dense": dict(),
    "moe": dict(n_experts=4, moe_top_k=2, moe_ffn_dim=256),
    "yarn": dict(YARN),
}
PROMPT = [5, 17, 42, 9, 100, 3]


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    kw = MODELS[request.param]
    jcfg, tcfg = JConfig.tiny(**kw), DeepSeekConfig.tiny(**kw)
    jp = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(len(request.param)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jl, jc = jmodel.prefill(jp, jmodel.init_cache(jcfg),
                            jnp.asarray(PROMPT, jnp.int32), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jl=jl, jc=jc)


def _jstep(m, cache, tok, pos, fused):
    return jmodel.decode_step(m["jp"], cache, jnp.asarray(tok, jnp.int32),
                              jnp.asarray(pos, jnp.int32), m["jcfg"],
                              fused=fused)


def _prefilled(m):
    cache = tmodel.init_cache(m["tcfg"], device="cpu")
    logits, cache = tmodel.prefill(m["tp"], cache, PROMPT, m["tcfg"])
    return logits, cache


def test_params_round_trip_bit_exact(model):
    leaves = jax.tree_util.tree_leaves_with_path(model["jp"])
    assert len(leaves) == 12 + 3 * bool(model["tcfg"].n_experts)
    for path, leaf in leaves:
        node = model["tp"]
        for key in path:
            node = node[key.key]
        a = np.asarray(leaf)
        assert node.dtype == torch.bfloat16 and tuple(node.shape) == a.shape
        assert np.array_equal(node.view(torch.int16).numpy(),
                              a.view(np.int16)), path
    mine = tmodel.init_params(model["tcfg"], device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), model["tp"])


def test_prefill_matches_jax(model):
    logits, cache = _prefilled(model)
    assert logits.shape == (len(PROMPT), model["tcfg"].vocab_size)
    _logits_close(logits, model["jl"])
    np.testing.assert_allclose(_np(cache), _np(model["jc"]), atol=0.05,
                               rtol=0)


def test_decode_step_matches_jax(model):
    """decode_step fused and eager after the same prefill, against JAX's
    fused and eager steps: logits, the appended row, the other rows."""
    _, cache0 = _prefilled(model)
    pos = len(PROMPT)
    for fused in (True, False):
        jl, jc = _jstep(model, model["jc"], 7, pos, fused)
        cache = cache0.clone()
        tl, cache = tmodel.decode_step(model["tp"], cache, 7, pos,
                                       model["tcfg"], fused=fused)
        assert tl.shape == (model["tcfg"].vocab_size,)
        assert tl.dtype == torch.float32
        _logits_close(tl, jl)
        mla = model["tcfg"].mla_head_dim
        np.testing.assert_allclose(_np(cache[:, pos, :mla]),
                                   _np(jc)[:, pos, :mla], atol=0.05, rtol=0)
        assert torch.equal(cache[:, :pos], cache0[:, :pos])


def test_teacher_forced_decode_matches_jax(model):
    """Three steps, fed JAX's eager tokens: fused and eager track JAX."""
    jl0, cache = _prefilled(model)
    tf, te = cache, cache.clone()
    jf = je = model["jc"]
    tok = int(np.argmax(np.asarray(model["jl"])[-1]))
    for step in range(3):
        pos = len(PROMPT) + step
        jlf, jf = _jstep(model, jf, tok, pos, True)
        jle, je = _jstep(model, je, tok, pos, False)
        lf, tf = tmodel.decode_step(model["tp"], tf, tok, pos, model["tcfg"],
                                    fused=True)
        le, te = tmodel.decode_step(model["tp"], te, tok, pos, model["tcfg"],
                                    fused=False)
        _logits_close(lf, jlf)
        _logits_close(le, jle)
        tok = int(np.argmax(np.asarray(jle)))


def _top2_gap(logits):
    s = np.sort(_np(logits))
    return float(s[-1] - s[-2])


def test_generate_greedy_matches_jax(model):
    """generate_greedy's tokens: wherever JAX's top-2 gap (its fused step,
    teacher-forced on the port's tokens) exceeds 0.05, JAX's argmax."""
    toks = tmodel.generate_greedy(model["tp"], model["tcfg"], PROMPT, 5)
    assert len(toks) == 5
    assert toks == tmodel.generate_greedy(model["tp"], model["tcfg"], PROMPT,
                                          5)
    lg, cache = model["jl"][-1], model["jc"]
    gaps = []
    for i, tok in enumerate(toks):
        gaps.append(_top2_gap(lg))
        if gaps[-1] > GAP:
            assert tok == int(np.argmax(np.asarray(lg))), (i, toks, gaps)
        lg, cache = _jstep(model, cache, tok, len(PROMPT) + i, True)
    assert sum(g > GAP for g in gaps) >= 2     # the rule is not vacuous


# -- what the port refuses ---------------------------------------------------------


def test_unported_variants_raise():
    cfg = DeepSeekConfig.tiny()
    p = tmodel.init_params(cfg, device="cpu")
    lw = p["layers"]
    x = p["embed"][:1]
    with pytest.raises(NotImplementedError):
        tffn.fused_ffn(x, x, lw["ffn_norm"], lw["w13"].to(torch.int8),
                       lw["w2"].to(torch.int8), eps=1e-6, layer_id=0)
    with pytest.raises(NotImplementedError):
        tffn.fused_ffn(x, x, lw["ffn_norm"], lw["w13"], lw["w2"], eps=1e-6,
                       ffn_act="gelu_tanh")
    cos, sin = tmodel.rope_table(cfg)
    dims = dict(n_heads=cfg.n_heads, nope_dim=cfg.nope_head_dim,
                rope_dim=cfg.rope_head_dim, lora_rank=cfg.kv_lora_rank)
    cache = tmodel.init_cache(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        tdl.deepseek_decoder_stack_layer(
            x, lw["wproj"].to(torch.int8), lw["wuk"], lw["wuv"], lw["wo_t"],
            cache, 0, 0, lw["attn_norm"], lw["ckv_norm"], cos[0], sin[0],
            **dims)
    fp8 = tmodel.init_cache(cfg, dtype=torch.float8_e4m3fn, device="cpu")
    with pytest.raises(NotImplementedError):
        tmodel.decode_step(p, fp8, 3, 0, cfg, fused=True)
    with pytest.raises(NotImplementedError):
        tmoe.moe_ffn_decode(x, torch.zeros(cfg.hidden_dim, 4),
                            torch.zeros(4, 2, cfg.hidden_dim, 128,
                                        dtype=torch.int8),
                            torch.zeros(4, 128, cfg.hidden_dim,
                                        dtype=torch.int8), 2)


def test_default_device_entries_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    cfg = DeepSeekConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_cache(cfg)
