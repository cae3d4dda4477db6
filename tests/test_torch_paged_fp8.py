"""The port's fp8 e4m3 serving pools against the JAX package's, on the CPU:
kernel 10 (``paged_attention``) and kernel 9 (``llama_decoder_layer_paged``)
on e4m3 pools, their plain twins against JAX's Pallas kernels in
interpret mode; the e4m3 denormal split; ``ServingEngine(kv_dtype=
float8_e4m3fn)`` on both step kinds and ``Llama.generate`` with an fp8
cache against JAX's engine at ``LlamaConfig.tiny(max_seq_len=64)``.

Inputs come from numpy seeds and stay below 448 in magnitude: JAX's CPU
cast to e4m3 gives NaN above it, where the port saturates.  Both packages
read the past rows through the TPU kernels' decode (e4m3 denormals flushed
to 0) and take each kernel's own rule for the current row: kernel 10 is
handed e4m3 of the bf16 row, folds it as stored and appends it; kernel 9
folds its float32 row and appends e4m3 of it where JAX appends in-kernel
(hd % 128 == 0 and page % 8 == 0), else e4m3 of its bf16 rounding.

Tolerances: outputs at atol 2e-2 / rtol 2e-2 (``test_torch_paged.py``'s
bf16 limits: the two walk the rows in other chunks).  Kernel 10's appended
codes are equal (both store e4m3 of the same bf16 row).  Kernel 9's are
each within one code of JAX's and at least 99 % equal: the two round
float32 rows that differ by a sum order, which moves a code only where a
row sits at a rounding boundary; the other rule would move about one code
in 30 (the bf16 rounding before e4m3 is a second rounding).  Every other
byte of the pools is the input's.  The engines follow
``test_torch_serving.py``'s rule (tokens agree wherever the top-2 gap of
the eager path, here on an fp8 cache, exceeds 0.05; logprobs at atol
2e-2 on the agreed prefix).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import KernelConfig as JKernelConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu.models.generation import Llama as JLlama
from clusterfusion_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from clusterfusion_tpu.ops import paged_decoder_layer as jpd
from clusterfusion_tpu.ops import quant as jq
from clusterfusion_tpu.runtime.serving import ServingEngine as JEngine
from clusterfusion_tpu_torch.models import generation as tgeneration
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.models.generation import Llama
from clusterfusion_tpu_torch.models.tokenizer import ByteTokenizer
from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
from clusterfusion_tpu_torch.runtime import ServingEngine
from test_torch_paged import TOL, _pair, _paged_setup, _rope_tables
from test_torch_serving import (JCFG, LP_TOL, TCFG, _agreed, _check_engines,
                                _rule_bites)

FP8 = torch.float8_e4m3fn
JFP8 = jnp.float8_e4m3fn
MIN_EQUAL = 0.99        # kernel 9's appended codes equal to JAX's


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _codes(x):
    """An e4m3 tensor or array as its bytes (int32)."""
    if torch.is_tensor(x):
        return x.view(torch.uint8).numpy().astype(np.int32)
    return np.asarray(x).view(np.uint8).astype(np.int32)


def _fp8_pair(a):
    """numpy -> (JAX e4m3 array, torch float8_e4m3fn) with the same bytes."""
    j = jnp.asarray(np.asarray(a, np.float32)).astype(JFP8)
    t = torch.from_numpy(np.asarray(j).view(np.uint8).copy()).view(FP8)
    return j, t


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _check_fp8_pools(t_pool, j_pool, t_in, table, lens, layer, min_equal):
    """The appended codes within one code of JAX's (adjacent values of one
    sign, or both zero or the least denormal) and at least ``min_equal``
    of them equal; every other byte as the input's, in both."""
    page = t_in.shape[3]
    app = np.zeros(t_in.shape, bool)
    for b, n in enumerate(lens):
        app[layer, table[b, n // page], :, n % page] = True
    t, j, t0 = _codes(t_pool), _codes(j_pool), _codes(t_in)
    a, b = t[app], j[app]
    near = (((a ^ b) & 0x80) == 0) & (np.abs(a - b) <= 1)
    near |= ((a & 0x7F) <= 1) & ((b & 0x7F) <= 1)
    assert near.all(), (a[~near], b[~near])
    assert (a == b).mean() >= min_equal, (a == b).mean()
    np.testing.assert_array_equal(t[~app], t0[~app])
    np.testing.assert_array_equal(j[~app], t0[~app])


# -- kernel 10 ------------------------------------------------------------------


# (kv, group, page, lens) of kernel 10's GQA case, which the denormal case
# shares so that JAX compiles it once
GQA10 = (2, 4, 8, [9, 0, 129])          # page 8, a split and a row


@pytest.mark.parametrize("kv,g,page,lens", [
    (2, 1, 16, [0, 16, 5, 140]),          # empty, page boundary, 2 splits
    GQA10,
], ids=["mha_page16", "gqa_page8"])
def test_fp8_paged_attention_matches_jax(kv, g, page, lens):
    rng = np.random.RandomState(10)
    L, layer, hd, B = 2, 1, 128, len(lens)
    kp, vp, table, lens = _paged_setup(rng, L, kv, page, hd, lens)
    jq_, tq = _pair(rng.randn(B, kv, g, hd))
    jk, tk = _pair(rng.randn(B, kv, hd))
    jv, tv = _pair(rng.randn(B, kv, hd))
    jkp, tkp = _fp8_pair(kp)
    jvp, tvp = _fp8_pair(vp)
    tk_in, tv_in = tkp.clone(), tvp.clone()
    jo, jkp2, jvp2 = jpd.paged_attention(
        jq_, jk, jv, jkp, jvp, jnp.asarray(table), jnp.asarray(lens), layer,
        kcfg=JKernelConfig(kv_chunk=32))      # several windows per request
    before = dict(pd.launches)
    to, tkp2, tvp2 = pd.paged_attention(tq, tk, tv, tkp, tvp,
                                        torch.from_numpy(table),
                                        torch.from_numpy(lens), layer)
    assert pd.launches == before                       # the twin ran
    assert tkp2 is tkp and tvp2 is tvp and tkp.dtype == FP8
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    _check_fp8_pools(tkp, jkp2, tk_in, table, lens, layer, min_equal=1.0)
    _check_fp8_pools(tvp, jvp2, tv_in, table, lens, layer, min_equal=1.0)


def test_fp8_denormals_flushed_in_past_rows_kept_in_current_row():
    """Kernel 10 on past K rows that are all e4m3 denormals (2^-7, aligned
    with q) and a current k_new in the denormal range too.  The past rows
    are read flushed to 0 and the current row as stored, so the current
    token's score stands ~6.4 (log2) above the past rows' and it takes
    ~80 % of the weight; reading the past rows unflushed, or flushing the
    current row, would give every row the same score.  The port matches
    JAX and is far from both other readings; the pool keeps the current
    row's denormal codes."""
    rng = np.random.RandomState(11)
    kv, g, page, lens_l = GQA10
    L, layer, hd, B = 2, 1, 128, len(lens_l)
    kp, vp, table, lens = _paged_setup(rng, L, kv, page, hd, lens_l)
    sign = np.where(rng.rand(B, kv, hd) < 0.5, -1.0, 1.0)
    tiny = 2.0 ** -7                      # e4m3 denormal (magnitude code 4)
    for b, n in enumerate(lens_l):
        for j in range(n):
            kp[layer, table[b, j // page], :, j % page] = tiny * sign[b]
    jq_, tq = _pair(50.0 * sign[:, :, None, :].repeat(g, 2))
    jk, tk = _pair(tiny * sign)
    jv, tv = _pair(3.0 * np.where(rng.rand(B, kv, hd) < 0.5, -1.0, 1.0))
    jkp, tkp = _fp8_pair(kp)
    jvp, tvp = _fp8_pair(vp)
    tk_in = tkp.clone()
    jo, jkp2, _ = jpd.paged_attention(
        jq_, jk, jv, jkp, jvp, jnp.asarray(table), jnp.asarray(lens), layer,
        kcfg=JKernelConfig(kv_chunk=32))
    tt, tl = torch.from_numpy(table), torch.from_numpy(lens)
    kr, vr = tkp.clone(), tvp.clone()        # the pools before the append
    to, _, _ = pd.paged_attention(tq, tk, tv, tkp, tvp, tt, tl, layer)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    _check_fp8_pools(tkp, jkp2, tk_in, table, lens, layer, min_equal=1.0)
    k_cur = tk.to(FP8)
    assert bool((k_cur.float().abs() == tiny).all())   # stored, not flushed
    qs = pd._scaled_q(tq)
    kept = pd._walk_plain(qs, qs, k_cur, tv.to(FP8), kr.float().bfloat16(),
                          vr, tt, tl, layer)           # past rows unflushed
    flushed = pd._walk_plain(qs, qs, torch.zeros_like(k_cur), tv.to(FP8), kr,
                             vr, tt, tl, layer)         # current row flushed
    for other in (kept, flushed):
        assert float((to.reshape(other.shape).float() - other.float())
                     .abs().max()) > 0.5


# -- kernel 9 --------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["bf16", "int8"])
@pytest.mark.parametrize("kv,g,hd,hg,page,lens,style", [
    (2, 2, 128, 2, 16, [0, 16, 140], "neox"),     # in-kernel append
    (2, 2, 64, 1, 8, [9, 0, 140], "gptj"),        # the wrapper's scatter
], ids=["hd128_f32_row", "hd64_bf16_row"])
def test_fp8_paged_layer_matches_jax(kv, g, hd, hg, page, lens, style,
                                     weights):
    rng = np.random.RandomState(12)
    L, layer, hidden, B = 2, 1, 256, len(lens)
    G = kv // hg
    kp, vp, table, lens = _paged_setup(rng, L, kv, page, hd, lens)
    jx, tx = _pair(rng.randn(B, hidden))
    jr, tr = _pair(rng.randn(B, hidden))
    jwq, twq = _pair(rng.randn(L, G, hidden, hg * (g + 2) * hd)
                     * hidden ** -0.5)
    jwo, two = _pair(rng.randn(L, G, hg * g * hd, hidden)
                     * (kv * g * hd) ** -0.5)
    if weights == "int8":
        jw = jq.quantize_llama_params({"layers": {"wqkv_f": jwq, "wo_f": jwo}},
                                      "int8", targets=("wqkv_f", "wo_f"))
        jwq, jwo = jw["layers"]["wqkv_f"], jw["layers"]["wo_f"]
        tw = _to_port(jw)["layers"]
        twq, two = tw["wqkv_f"], tw["wo_f"]
    jrms, trms = _pair(1 + 0.1 * rng.randn(1, hidden))
    jkp, tkp = _fp8_pair(kp)
    jvp, tvp = _fp8_pair(vp)
    tk_in, tv_in = tkp.clone(), tvp.clone()
    cos, sin = _rope_tables(hd, max_pos=512)
    pos = lens + 3
    jout = jpd.llama_decoder_layer_paged(
        jx, jr, jwq, jwo, jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(pos), jkp, jvp, layer, jrms, 1e-5, jnp.asarray(cos),
        jnp.asarray(sin), group=g, rope_style=style)
    tout = pd.llama_decoder_layer_paged(
        tx, tr, twq, two, torch.from_numpy(table), torch.from_numpy(lens),
        torch.from_numpy(pos), tkp, tvp, layer, trms, 1e-5,
        torch.from_numpy(cos), torch.from_numpy(sin), group=g,
        rope_style=style)
    assert tout[2] is tkp and tout[3] is tvp
    for i in (0, 1):
        np.testing.assert_allclose(_np(tout[i]), _np(jout[i]), **TOL)
    _check_fp8_pools(tkp, jout[2], tk_in, table, lens, layer, MIN_EQUAL)
    _check_fp8_pools(tvp, jout[3], tv_in, table, lens, layer, MIN_EQUAL)


def test_fp8_pools_refuse_mixed_dtypes():
    """Both pools of one dtype; an fp8 pool takes no int8 partner."""
    rng = np.random.RandomState(13)
    kp, _, table, lens = _paged_setup(rng, 1, 2, 8, 64, [3])
    kb = torch.from_numpy(kp).bfloat16()
    q = torch.zeros((1, 2, 1, 64), dtype=torch.bfloat16)
    kn = torch.zeros((1, 2, 64), dtype=torch.bfloat16)
    args = (torch.from_numpy(table), torch.from_numpy(lens), 0)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        pd.paged_attention(q, kn, kn, kb.to(FP8), kb, *args)
    with pytest.raises(NotImplementedError, match="int8"):
        pd.paged_attention(q, kn, kn, kb.to(FP8), kb.to(torch.int8), *args)


# -- the engine and generate -------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, _to_port(jp)


LONG = [int(x) for x in (np.arange(41) * 11 + 3) % 384]


# (page_size, num_pages, prefill_chunk) of each step kind's engine: the
# pools ``generate`` gives one prompt of 44 tokens and 6 new, so that JAX
# compiles each step, and each prefill shape, once for the file
ENGINE_GEOMETRY = dict(batched=(16, 5, 16), fused=(16, 5, 1024))


@pytest.mark.parametrize("impl", ["batched", "fused"])
def test_fp8_engine_matches_jax(params, impl):
    """Three requests on e4m3 pools, one submitted mid-flight, logprobs on
    one; in the four pages the third request waits for the first to
    finish, and the batched engine prefills the 41-token one in chunks of
    16 into an fp8 cache."""
    jp, tp = params
    prompts = {0: [1, 2, 3], 1: LONG, 2: [11, 12, 13, 14]}
    page, num_pages, chunk = ENGINE_GEOMETRY[impl]
    res, stats = [], []
    for Eng, p, cfg, dt in ((ServingEngine, tp, TCFG, FP8),
                            (JEngine, jp, JCFG, JFP8)):
        eng = Eng(p, cfg, page_size=page, num_pages=num_pages, max_batch=4,
                  step_impl=impl, kv_dtype=dt, prefill_chunk=chunk)
        assert eng.k_pool.dtype == dt and eng.v_pool.dtype == dt
        eng.submit(0, prompts[0], max_gen_len=6, temperature=0.0,
                   logprobs=True)
        eng.submit(1, prompts[1], max_gen_len=6, temperature=0.0)
        for _ in range(2):
            assert eng.step()
        stats.append(eng.stats())
        eng.submit(2, prompts[2], max_gen_len=3, temperature=0.0)
        eng.run()
        res.append(eng.last_results)
    assert stats[0] == stats[1]
    _check_engines(tp, prompts, res[0], res[1], kv_dtype=FP8)
    n = _agreed(tp, prompts[0], res[0][0].generated, res[1][0].generated,
                FP8)
    np.testing.assert_allclose(res[0][0].logprobs[:n], res[1][0].logprobs[:n],
                               atol=LP_TOL)
    np.testing.assert_allclose(res[0][0].prompt_logprobs,
                               res[1][0].prompt_logprobs, atol=LP_TOL,
                               rtol=1e-2)
    _rule_bites()


def test_fp8_generate_matches_jax(params, monkeypatch):
    """``Llama.generate`` with an fp8 cache on one prompt (the fused step,
    in ``ENGINE_GEOMETRY["fused"]``'s pools) against JAX's, logprobs at
    atol 2e-2 on the agreed prefix; ``text_completion`` (two prompts: the
    batched step) and ``chat_completion`` (one: the fused step) reach fp8
    pools; an "int8" cache is refused by the engine, naming JAX's unscaled
    int8 pools."""
    jp, tp = params
    teng = Llama(tp, TCFG, ByteTokenizer(), fused=True, kv_dtype=FP8)
    jeng = JLlama(jp, JCFG, JByteTokenizer(), fused=True, kv_dtype=JFP8)
    prompt = [256] + LONG[:43]
    (t1,), (tl,) = teng.generate([prompt], 6, temperature=0.0, logprobs=True)
    (j1,), (jl,) = jeng.generate([prompt], 6, temperature=0.0, logprobs=True)
    n = _agreed(tp, prompt, t1, j1, FP8)
    np.testing.assert_allclose(tl[:n], jl[:n], atol=LP_TOL)
    _rule_bites()
    pools = []

    class Spy(ServingEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            pools.append((self.k_pool.dtype, self.step_impl))

    monkeypatch.setattr(tgeneration, "ServingEngine", Spy)
    out = teng.text_completion(["hello", "the cat"], temperature=0.0,
                               max_gen_len=3)
    chat = teng.chat_completion([[{"role": "user", "content": "hi"}]],
                                temperature=0.0, max_gen_len=3)
    assert len(out) == 2 and chat[0]["generation"]["role"] == "assistant"
    assert pools == [(FP8, "batched"), (FP8, "fused")]
    with pytest.raises(NotImplementedError, match="int8"):
        Llama(tp, TCFG, ByteTokenizer(), kv_dtype="int8").generate(
            [prompt], 2, temperature=0.0)
