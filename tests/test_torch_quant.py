"""The port's ``ops/quant.py`` and its int8 weight-only decode path against
the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  Codes,
scales and the KV formats must come out bit-equal (both divide in float32
and round half to even).  The int8 model paths use the JAX suite's own
tolerances for them (``tests/test_quant.py``): logits atol 0.12 / rtol
0.05 and K/V atol 0.06 for a decode step, and ``tests/test_torch_model.py``'s
rule for the prefill (logits within 5 % of the largest, K/V atol 0.05).
JAX's decode and prefill run their Pallas kernels in interpret mode; the
port's fused step runs kernel 7's plain twin.  The JAX calls are few and
shape-stable (one model geometry), as jaxlib's CPU backend allows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import LlamaConfig as JConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu.ops import quant as jq
from clusterfusion_tpu_torch.config import LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.models.generation import Llama
from clusterfusion_tpu_torch.ops import quant as tq
from clusterfusion_tpu_torch.ops import stack_kernel as sk

# G = 2 head groups of 2 kv heads: the O projection's per-group scales are
# applied before the groups are summed, which one group would not test
HEAD_GROUP = 2


def _pair(a: np.ndarray, bf16: bool):
    """The same values as a JAX array and a torch tensor."""
    if bf16:
        j = jnp.asarray(a).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _eq(t: torch.Tensor, j) -> bool:
    """Bit equality of a torch tensor and a JAX/numpy array."""
    a = np.asarray(j)
    if a.dtype.name == "bfloat16":
        return t.dtype == torch.bfloat16 and np.array_equal(
            t.view(torch.int16).numpy(), a.view(np.int16))
    return np.array_equal(t.numpy(), a) and t.numpy().dtype == a.dtype


def _same_qt(t: tq.QuantizedTensor, j: jq.QuantizedTensor) -> bool:
    return (_eq(t.q, j.q) and _eq(t.s, j.s) and t.kind == j.kind
            and t.axis == j.axis and t.group_size == j.group_size
            and t.pack_axis == j.pack_axis and t.shape == tuple(j.shape))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,pack_axis", [("int8", None), ("int4", None),
                                            ("int4", -1)],
                         ids=["int8", "int4", "int4_pack_out"])
def test_weight_codes_bit_equal(kind, pack_axis, bf16):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3, 256, 384)) * 0.3).astype(np.float32)
    wj, wt = _pair(w, bf16)
    j = jq.quantize(wj, kind, -2, 128, pack_axis)
    t = tq.quantize(wt, kind, -2, 128, pack_axis)
    assert t.q.dtype == torch.int8 and t.s.dtype == torch.float32
    assert _same_qt(t, j)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                   jnp.bfloat16)):
        assert _eq(t.dequantize(dt), j.dequantize(jdt))
    # a layer of the stacked tensor keeps its (negative) axes
    assert _same_qt(t[1], jax.tree.map(lambda a: a[1], j))


def test_unpack_and_group_scales_bit_equal():
    rng = np.random.default_rng(4)
    packed = rng.integers(-128, 128, (6, 64, 40), dtype=np.int8)
    for axis in (-2, -1, 0):
        assert _eq(tq.unpack_int4(torch.from_numpy(packed), axis),
                   jq.unpack_int4(jnp.asarray(packed), axis))
    # the in-kernel layout's plain unpack is the same rows in order
    tile = packed[0]
    assert _eq(tq.unpack_int4_bitcast(torch.from_numpy(tile)),
               np.asarray(jq.unpack_int4(jnp.asarray(tile), 0)).astype(
                   np.int8))
    s = rng.standard_normal((2, 3, 5)).astype(np.float32)
    for axis in (-2, 0):
        assert _eq(tq.expand_group_scales(torch.from_numpy(s), axis, 4),
                   jq.expand_group_scales(jnp.asarray(s), axis, 4))


@pytest.mark.parametrize("M", [1, 3])
def test_w4a8_dot_is_the_grouped_int8_product(M):
    """The plain W4A8 product: per-row int8 x, integer group sums scaled by
    the group scales, then the row scale (numpy in float64 as the
    reference), and within the JAX suite's W4A8 error of the exact
    W4A16 product."""
    rng = np.random.default_rng(5)
    K, N, gs = 256, 96, 128
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    x = rng.standard_normal((M, K)).astype(np.float32)
    qt = tq.quantize_int4(torch.from_numpy(w), -2, gs)
    y = tq.w4a8_int4_dot(torch.from_numpy(x), qt.q, qt.s, gs).numpy()
    xs = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) * np.float32(
        1 / 127)
    x8 = np.round(x / xs)
    w8 = tq.unpack_int4(qt.q, -2).numpy().astype(np.float64)
    part = np.einsum("mgk,gkn->gmn", x8.reshape(M, K // gs, gs),
                     w8.reshape(K // gs, gs, N))
    ref = (part * qt.s.numpy()[:, None, :]).sum(0) * xs
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6)
    exact = x @ qt.dequantize(torch.float32).numpy()
    assert np.abs(y - exact).max() < 0.02 * np.abs(exact).max()


@pytest.fixture(scope="module")
def tree():
    """A JAX tiny Llama tree (G = 2) and its bf16 bridge to the port."""
    jcfg = JConfig.tiny()
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0),
                            head_group=HEAD_GROUP)
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.mark.parametrize("kind,lm_head", [("int8", False), ("int8", True),
                                          ("int4", False)])
def test_quantize_llama_params_matches_jax(tree, kind, lm_head):
    _, jp, tp = tree
    j = jq.quantize_llama_params(jp, kind, 128, lm_head=lm_head)
    t = tq.quantize_llama_params(tp, kind, 128, lm_head=lm_head)
    for name in ("wqkv_f", "wo_f", "w13", "w2"):
        assert _same_qt(t["layers"][name], j["layers"][name]), name
    for name in ("attn_norm", "ffn_norm"):
        assert t["layers"][name] is tp["layers"][name]
    assert t["embed"] is tp["embed"]
    if lm_head:
        assert _same_qt(t["lm_head"], j["lm_head"])
    else:
        assert t["lm_head"] is tp["lm_head"]
    # quantized leaves are left as they are
    again = tq.quantize_llama_params(t, kind, 128, lm_head=lm_head)
    assert again["layers"]["w13"] is t["layers"]["w13"]


def test_quantize_deepseek_params_matches_jax():
    rng = np.random.default_rng(6)
    shapes = {"wproj": (2, 64, 96), "wuk": (2, 4, 32, 16),
              "wuv": (2, 4, 16, 32), "wo_t": (2, 128, 64),
              "w13": (2, 2, 64, 128), "w2": (2, 128, 64),
              "w13_e": (2, 3, 2, 64, 128), "w2_e": (2, 3, 128, 64),
              "router": (2, 64, 3)}
    layers = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    lm = rng.standard_normal((64, 32)).astype(np.float32)
    j = jq.quantize_deepseek_params(
        {"layers": {k: jnp.asarray(v) for k, v in layers.items()},
         "lm_head": jnp.asarray(lm)}, "int8", lm_head=True)
    t = tq.quantize_deepseek_params(
        {"layers": {k: torch.from_numpy(v) for k, v in layers.items()},
         "lm_head": torch.from_numpy(lm)}, "int8", lm_head=True)
    for name in shapes:
        if name == "router":
            assert torch.is_tensor(t["layers"][name])
        else:
            assert _same_qt(t["layers"][name], j["layers"][name]), name
    assert _same_qt(t["lm_head"], j["lm_head"])


def test_kv_formats_bit_equal():
    rng = np.random.default_rng(7)
    L, H, cap, hd, T, pos0 = 2, 3, 300, 64, 20, 250
    rows = (rng.standard_normal((L, H, T, hd)) * 3).astype(np.float32)
    q_j, s_j = jq.quantize_kv_rows(jnp.asarray(rows))
    q_t, s_t = tq.quantize_kv_rows(torch.from_numpy(rows))
    assert _eq(q_t, q_j) and _eq(s_t, s_j)
    kj = jq.init_kv_int8(L, H, cap, hd)
    kt = tq.init_kv_int8(L, H, cap, hd, device="cpu")
    assert _eq(kt.q, kj.q) and _eq(kt.s, kj.s)
    assert kt.dtype == torch.int8 and tuple(kt.shape) == tuple(kj.shape)
    kj = jq.cache_fill_rows(kj, jnp.asarray(rows), pos0)
    out = tq.cache_fill_rows(kt, torch.from_numpy(rows), pos0)
    assert out.q is kt.q and out.s is kt.s                     # in place
    assert _eq(kt.q, kj.q) and _eq(kt.s, kj.s)
    assert _eq(tq.kv_scales_flat(kt.s, cap), jq.kv_scales_flat(kj.s, cap))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float8_e4m3fn, torch.float8_e4m3fn)):
        cj = jq.cache_fill_rows(jnp.zeros((L, H, cap, hd), jdt),
                                jnp.asarray(rows), pos0)
        ct = tq.cache_fill_rows(torch.zeros((L, H, cap, hd), dtype=tdt),
                                torch.from_numpy(rows), pos0)
        assert np.array_equal(ct.view(torch.uint8 if tdt.itemsize == 1
                                      else torch.int16).numpy(),
                              np.asarray(cj).view(np.uint8 if tdt.itemsize == 1
                                                  else np.int16))


def test_fp8_decode_all_codes_bit_equal():
    codes = np.arange(256, dtype=np.uint8)
    j = jq.fp8_decode_scaled(jnp.asarray(codes.view(ml_dtypes.float8_e4m3fn)))
    t = tq.fp8_decode_scaled(torch.from_numpy(codes.copy()).view(
        torch.float8_e4m3fn))
    assert _eq(t, j)
    assert tq.FP8_DECODE_FIX == jq.FP8_DECODE_FIX


def test_quantized_tree_crosses_bit_exact(tree):
    """A JAX quantized tree (numpy leaves, int8 and int4 leaves, an int8 LM
    head) crosses ``params_from_numpy`` bit for bit, fields and all."""
    _, jp, _ = tree
    j8 = jq.quantize_llama_params(jp, "int8", lm_head=True)
    j4 = jq.quantize_llama_params(jp, "int4")
    for j in (j8, j4):
        t = params_from_numpy(jax.tree.map(np.asarray, j), device="cpu")
        for name in ("wqkv_f", "wo_f", "w13", "w2"):
            assert isinstance(t["layers"][name], tq.QuantizedTensor)
            assert _same_qt(t["layers"][name], j["layers"][name])
        assert _eq(t["layers"]["attn_norm"], j["layers"]["attn_norm"])
    assert _same_qt(t8 := params_from_numpy(
        jax.tree.map(np.asarray, j8), device="cpu")["lm_head"], j8["lm_head"])
    # bf16 int4 scales, as the TPU kernel streams them, keep their dtype
    leaf = dataclasses.replace(j4["layers"]["w2"],
                               s=j4["layers"]["w2"].s.astype(jnp.bfloat16))
    got = params_from_numpy({"w": jax.tree.map(np.asarray, leaf)},
                            device="cpu")["w"]
    assert got.s.dtype == torch.bfloat16 and _same_qt(got, leaf)
    assert t8.q.dtype == torch.int8


@pytest.fixture(scope="module")
def int8_decode(tree):
    """JAX's int8 decode step, fused (Pallas, interpret mode) and eager, at
    pos 6 after a prefill, with the bf16 and the int8 LM head; the caches it
    started from."""
    jcfg, jp, _ = tree
    toks = np.asarray([5, 17, 42, 9, 100, 3], np.int32)
    out = {}
    for lm8 in (False, True):
        jqp = jq.quantize_llama_params(jp, "int8", lm_head=lm8)
        _, jk, jv = jmodel.prefill(jqp, *jmodel.init_cache(jcfg),
                                   jnp.asarray(toks), jcfg)
        steps = {fused: jmodel.decode_step(
            jqp, jk, jv, jnp.asarray(7, jnp.int32),
            jnp.asarray(len(toks), jnp.int32), jcfg, fused=fused)
            for fused in (True, False)}
        out[lm8] = (jqp, jk, jv, steps)
    return toks, out


@pytest.mark.parametrize("lm8", [False, True], ids=["lm_bf16", "lm_int8"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_int8_decode_step_matches_jax(int8_decode, lm8, fused):
    """The port's int8 decode step (fused: kernel 7's twin) against JAX's
    fused and eager int8 steps, on the same quantized weights and caches."""
    toks, out = int8_decode
    jqp, jk, jv, steps = out[lm8]
    tp = params_from_numpy(jax.tree.map(np.asarray, jqp), device="cpu")
    assert isinstance(tp["layers"]["wo_f"], tq.QuantizedTensor)
    assert tp["layers"]["wo_f"].q.shape[1] == HEAD_GROUP and \
        isinstance(tp["lm_head"], tq.QuantizedTensor) == lm8
    tcfg = LlamaConfig.tiny()
    pos = len(toks)
    kc0 = params_from_numpy({"k": np.asarray(jk)}, device="cpu")["k"]
    vc0 = params_from_numpy({"v": np.asarray(jv)}, device="cpu")["v"]
    kc, vc = kc0.clone(), vc0.clone()
    before = sk.launches
    tl, kc, vc = tmodel.decode_step(tp, kc, vc, 7, pos, tcfg, fused=fused)
    assert sk.launches == before                # the CPU runs the twin
    for jl, jk2, jv2 in steps.values():
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                                   atol=0.12, rtol=0.05)
        for got, want in ((kc, jk2), (vc, jv2)):
            np.testing.assert_allclose(
                got[:, :, pos].float().numpy(),
                np.asarray(want, np.float32)[:, :, pos], atol=0.06)
    assert torch.equal(kc[:, :, :pos], kc0[:, :, :pos])


def test_int8_prefill_matches_jax(tree, int8_decode):
    jcfg, _, _ = tree
    toks, out = int8_decode
    jqp = out[False][0]
    jl, jk, jv = jmodel.prefill(jqp, *jmodel.init_cache(jcfg),
                                jnp.asarray(toks), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jqp), device="cpu")
    tcfg = LlamaConfig.tiny()
    tl, tk, tv = tmodel.prefill(tp, *tmodel.init_cache(tcfg, device="cpu"),
                                toks, tcfg)
    jl = np.asarray(jl, np.float32)
    assert np.abs(tl.numpy() - jl).max() < 0.05 * max(np.abs(jl).max(), 1.0)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=0.05)


@pytest.mark.parametrize("lm8", [False, True], ids=["lm_bf16", "lm_int8"])
def test_int8_twin_scales_each_group_before_the_sum(tree, lm8):
    """Kernel 7's int8 twin against a float64 product of the dequantized
    weights at the same step: the per-group O scales (G = 2), the gate/up
    scales before SwiGLU and the down and LM scales after their sums give
    the dequantized model's function."""
    _, jp, tp = tree
    qp = tq.quantize_llama_params(tp, "int8", lm_head=lm8)
    deq = dict(qp, layers={k: tq.maybe_dequantize(v, torch.float32)
                           if isinstance(v, tq.QuantizedTensor) else v
                           for k, v in qp["layers"].items()},
               lm_head=tq.maybe_dequantize(qp["lm_head"], torch.float32))
    tcfg = LlamaConfig.tiny()
    g, hd = tcfg.n_heads // tcfg.kv_heads, tcfg.head_dim_
    pos = 11
    kc, vc = tmodel.init_cache(tcfg, device="cpu")
    rng = np.random.default_rng(8)
    kc[:, :, :pos] = torch.from_numpy(
        rng.standard_normal(kc[:, :, :pos].shape).astype(np.float32))
    vc[:, :, :pos] = torch.from_numpy(
        rng.standard_normal(vc[:, :, :pos].shape).astype(np.float32))
    cos, sin = tmodel.rope_row(tcfg, pos)
    outs = []
    for p in (qp, deq):
        lw = p["layers"]
        outs.append(sk.fused_decoder_stack_plain(
            qp["embed"][[7]], lw["attn_norm"], lw["ffn_norm"], cos, sin,
            lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc.clone(),
            vc.clone(), pos, group=g, head_dim=hd, rope_style="gptj",
            eps=tcfg.norm_eps, final_norm=qp["final_norm"],
            lm_head=p["lm_head"]))
    # the two round xn, o and the SwiGLU activation to bf16 from sums that
    # differ in their last float32 bits, so a few roundings flip: 1 % of the
    # largest logit (a scale applied in the wrong place moves them by tens)
    a, b = outs[0][0].numpy(), outs[1][0].numpy()
    assert np.abs(a - b).max() < 0.01 * np.abs(b).max()


def test_head_group_matches_jax():
    for name in ("tiny", "llama2_7b", "llama3_8b", "tinyllama_1b",
                 "llama2_70b"):
        j, t = getattr(JConfig, name)(), getattr(LlamaConfig, name)()
        for quant in (None, "int8", "int4"):
            assert tmodel.default_head_group(t, quant) == \
                jmodel.default_head_group(j, quant), (name, quant)
    assert tmodel.default_head_group(LlamaConfig.llama2_7b(), "int8") == 8


def test_int8_engine_streams():
    cfg = LlamaConfig.tiny(max_seq_len=64)
    eng = Llama.synthetic(cfg, quant="int8", device="cpu")
    lw = eng.params["layers"]
    assert all(isinstance(lw[k], tq.QuantizedTensor)
               for k in ("wqkv_f", "wo_f", "w13", "w2"))
    assert torch.is_tensor(eng.params["lm_head"])
    assert lw["wqkv_f"].shape[1] == cfg.kv_heads // tmodel.default_head_group(
        cfg, "int8")
    toks = list(eng.stream_generate([1, 2, 3], max_gen_len=4,
                                    temperature=0.0))
    assert len(toks) == 4 and all(0 <= t < cfg.vocab_size for t in toks)
    # greedy: the fused and eager engines on the same weights agree
    eager = Llama(eng.params, cfg, eng.tokenizer, fused=False)
    assert list(eager.stream_generate([1, 2, 3], max_gen_len=4,
                                      temperature=0.0)) == toks


def test_quantized_paths_still_refused(tree):
    """What stays refused once int8 and int4 run on every path
    (``tests/test_torch_int8.py``, ``tests/test_torch_int8_parallel.py``,
    ``tests/test_torch_int4.py`` and ``tests/test_torch_int4_parallel.py``
    hold those), and that mode 1.4's paths now run: int4 in kernel 7 with
    ``reduce_axis`` (on an axis of one rank, the unsharded step's bits)
    and in ``shard_params``; still refused, int4 in a group size other than
    128 in kernels 6, 7 (with ``reduce_axis`` too) and 8,
    ``spec_generate``, ``generate`` and the serving engine, and an int4 LM
    head in mode 5 (mode 1.5); ``serving_w8a8``, with int8 or int4 weights
    (mode 6); int8 KV in the serving pools (JAX's are unscaled,
    ``ROADMAP.md`` section 3) and kernel 6 on int4 weights (item 2.2), and
    an int8 tensor without scales in kernel 8 (mode 2).  Since item 2.1
    kernel 8 takes an fp8 cache and ``chat --quant int4 --kv_int8`` runs;
    since item 2.3 the serving pools take fp8 beside int8 weights."""
    _, _, tp = tree
    tcfg = LlamaConfig.tiny()
    g, hd = tcfg.n_heads // tcfg.kv_heads, tcfg.head_dim_
    kc, vc = tmodel.init_cache(tcfg, device="cpu")
    cos, sin = tmodel.rope_row(tcfg, 3)
    from clusterfusion_tpu_torch.parallel.mesh import AXES, Mesh
    mesh = Mesh(shape=dict.fromkeys(AXES, 1), coords=dict.fromkeys(AXES, 0),
                groups=dict.fromkeys(AXES))
    mode5 = dict(reduce_axis="tp", mesh=mesh)
    lw4 = tq.quantize_llama_params(tp, "int4", 128)["layers"]

    def stack4(lw, **kw):
        return sk.fused_decoder_stack(
            tp["embed"][[7]], lw["attn_norm"], lw["ffn_norm"], cos, sin,
            lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc.clone(),
            vc.clone(), 3, group=g, head_dim=hd, rope_style="gptj",
            eps=1e-5, **kw)

    # mode 1.4: int4 with reduce_axis runs (one rank: the unsharded step)
    got, want = stack4(lw4, **mode5), stack4(lw4)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    lm4 = tq.quantize(tp["lm_head"], "int4", -2, 128)
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        sk._fused_decoder_stack_gathered(
            tp["embed"][[7]], lw4["attn_norm"], lw4["ffn_norm"], cos, sin,
            lw4["wqkv_f"], lw4["wo_f"], lw4["w13"], lw4["w2"], kc.clone(),
            vc.clone(), 3, group=g, head_dim=hd, rope_style="gptj",
            eps=1e-5, final_norm=tp["final_norm"], lm_head=lm4,
            reduce_axis="tp", mesh=mesh)
    lw = tq.quantize_llama_params(tp, "int4", 64)["layers"]
    for kw in ({}, mode5):
        with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
            stack4(lw, **kw)
    from clusterfusion_tpu_torch.ops import decoder_layer as tdl
    for w, cache, item in ((lw, kc, "1.5"), (lw4, kc.to(torch.int8), "2")):
        with pytest.raises(NotImplementedError, match=f"queue 2, mode {item}"):
            tdl._fused_decoder_layer(
                tp["embed"][[7]], tp["embed"][[8]], w["attn_norm"], cos, sin,
                w["wqkv_f"], w["wo_f"], cache, cache, 3, 1, group=g,
                head_dim=hd, rope_style="gptj", fuse_residual=True,
                eps=1e-5)
    from clusterfusion_tpu_torch.ops.stack_verify import fused_verify_stack
    cos2, sin2 = tmodel.rope_rows(tcfg, 3, 2)
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        fused_verify_stack(tp["embed"][[7, 8]], lw["attn_norm"],
                           lw["ffn_norm"], cos2, sin2, lw["wqkv_f"],
                           lw["wo_f"], lw["w13"], lw["w2"], kc, vc, 3,
                           group=g, head_dim=hd, rope_style="gptj", eps=1e-5)
    from clusterfusion_tpu_torch.models.tokenizer import ByteTokenizer
    eng64 = Llama(tq.quantize_llama_params(tp, "int4", 64), tcfg,
                  ByteTokenizer())
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        eng64.spec_generate([1, 2, 3], 4, eng64)
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        eng64.generate([[1, 2, 3]], 4)
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.runtime import ServingEngine
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        ServingEngine(eng64.params, tcfg)
    eng4 = Llama(tp, tcfg, None, quant="int4")
    eng = Llama(tp, tcfg, None, quant="int8")
    for e in (eng, eng4):
        with pytest.raises(NotImplementedError, match="queue 2, mode 6"):
            ServingEngine(e.params, tcfg, kcfg=KernelConfig(serving_w8a8=True))
    with pytest.raises(NotImplementedError, match="ROADMAP.md section 3"):
        ServingEngine(eng.params, tcfg, kv_dtype=torch.int8)
    f8 = ServingEngine(eng.params, tcfg, kv_dtype=torch.float8_e4m3fn)
    assert f8.k_pool.dtype == f8.v_pool.dtype == torch.float8_e4m3fn
    lw = tq.quantize_llama_params(tp, "int8")["layers"]

    def verify8(kc8, vc8):
        return fused_verify_stack(
            tp["embed"][[7, 8]], lw["attn_norm"], lw["ffn_norm"], cos2, sin2,
            lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc8, vc8, 3,
            group=g, head_dim=hd, rope_style="gptj", eps=1e-5)

    with pytest.raises(NotImplementedError, match="queue 2, mode 2"):
        verify8(kc.to(torch.int8), vc.to(torch.int8))
    # item 2.1: an fp8 cache runs (kernel 8's twin), its rows appended
    kc8, vc8 = kc.to(torch.float8_e4m3fn), vc.to(torch.float8_e4m3fn)
    out = verify8(kc8, vc8)
    assert torch.isfinite(out[0].float()).all()
    assert kc8[:, :, 3:5].float().any()
    from clusterfusion_tpu_torch.parallel.sharding import shard_params
    shards = shard_params(eng4.params, tcfg, mesh)    # mode 1.4: it cuts
    for name, w in eng4.params["layers"].items():
        assert shards["layers"][name] is w if not isinstance(
            w, tq.QuantizedTensor) else shards["layers"][name].q is w.q
    from clusterfusion_tpu_torch import chat
    chat.main(["--synthetic", "--quant", "int4", "--kv_int8", "--device",
               "cpu", "--max_gen_len", "2", "--temperature", "0",
               "--max_seq_len", "64"])


def test_chat_cli_int8(capsys):
    from clusterfusion_tpu_torch import chat
    chat.main(["--synthetic", "--quant", "int8", "--device", "cpu",
               "--max_gen_len", "3", "--temperature", "0", "--max_seq_len",
               "64"])
    out = capsys.readouterr().out
    assert "quant=int8" in out and "tokens/sec" in out
