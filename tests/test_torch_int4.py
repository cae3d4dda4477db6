"""The port's int4 weight-only paths against the JAX package's, on the CPU,
at ``LlamaConfig.tiny()`` (MHA, two head groups, two f-blocks) and a GQA
variant: the plain int4 products (``_int4_dot``, W4A8 and exact), kernel
7's int4 twin in both modes (the fused ``decode_step``), kernel 8's
(``verify_step`` at n 2 and 5) and ``spec_generate`` on an int4 target,
kernel 9's int4 twin (``llama_decoder_layer_paged``), one batched and one
fused serving step, ``ServingEngine``'s default step, ``Llama.generate``
and the chat flag.

Both trees are quantized with their own ``quantize_llama_params(...,
"int4")`` (the codes and scales are bit-equal, ``test_torch_quant.py``);
JAX's Pallas kernels run in interpret mode, the port's wrappers their
plain twins.  The trees are skewed before quantization (trap 1 of W4A8):
the v columns of the second head group and the up columns of the second
f-block are 10x the others, so the O projection's and the down product's
activation blocks differ 10x in absmax, and a twin that quantized over the
wrong block would stray from JAX's W4A8.

Tolerances are the JAX suite's own: a decode step's logits at atol 0.12 /
rtol 0.05 and K/V at 0.06 in the exact mode, 0.35 / 0.15 in W4A8
(``tests/test_quant.py:97-103``); the verify's logits within 0.06 of
max(|logits|, 1) and K/V at 0.08 (``tests/test_stack_verify.py``); the
paged layer's outputs and rows at 2e-2 (``test_torch_int8.py``); a serving
step's logprobs at 2e-2 and rows at 0.06 (``test_torch_int8.py``).  The
plain products match JAX's to float32 rounding (both sum the same exact
integer group dots, or the same bf16 products, in another order).  Greedy
streams follow the top-2-gap rule of ``test_torch_speculative.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from clusterfusion_tpu.config import KernelConfig as JKernelConfig
from clusterfusion_tpu.config import LlamaConfig as JConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu.models import speculative as jspec
from clusterfusion_tpu.ops import decoder_layer as jdl
from clusterfusion_tpu.ops import paged_decoder_layer as jpd
from clusterfusion_tpu.ops import quant as jq
from clusterfusion_tpu.runtime import serving as jserving
from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models import speculative as tspec
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.models.generation import Llama
from clusterfusion_tpu_torch.models.sampling import sample_batch
from clusterfusion_tpu_torch.models.tokenizer import ByteTokenizer
from clusterfusion_tpu_torch.ops import decoder_layer as tdl
from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
from clusterfusion_tpu_torch.ops import quant as tq
from clusterfusion_tpu_torch.ops import stack_kernel as sk
from clusterfusion_tpu_torch.ops import stack_verify as sv
from clusterfusion_tpu_torch.runtime import ServingEngine
from clusterfusion_tpu_torch.runtime import serving as tserving

gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")

GAP = 0.05
PROMPT = 21           # cached rows before the step
SKEW = 10.0


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _skew(jp, jcfg, hg):
    """Trap 1's inputs: the second head group's v columns and the second
    f-block's up columns times SKEW (f_pad 2048: two blocks of 1024)."""
    lw = dict(jp["layers"])
    g, hd = jcfg.n_heads // jcfg.kv_heads, jcfg.head_dim_
    wq = np.asarray(lw["wqkv_f"], np.float32).copy()
    for h in range(hg):
        c0 = h * (g + 2) * hd + (g + 1) * hd
        wq[:, 1, :, c0:c0 + hd] *= SKEW
    w13 = np.asarray(lw["w13"], np.float32).copy()
    assert w13.shape[-1] == 2048
    w13[:, 1, :, 1024:] *= SKEW
    lw["wqkv_f"] = jnp.asarray(wq, jnp.bfloat16)
    lw["w13"] = jnp.asarray(w13, jnp.bfloat16)
    return dict(jp, layers=lw)


def _setup(kv_heads, seed):
    """A skewed JAX tiny tree (two head groups, two f-blocks) quantized to
    int4 with a bf16 and with an int8 LM head, prefilled with the same
    prompt; the port's copies."""
    jcfg = JConfig.tiny(n_kv_heads=kv_heads, ffn_dim=2048)
    tcfg = LlamaConfig.tiny(n_kv_heads=kv_heads, ffn_dim=2048)
    hg = jcfg.kv_heads // 2
    jp = _skew(jmodel.init_params(jcfg, jax.random.PRNGKey(seed),
                                  head_group=hg), jcfg, hg)
    toks = jnp.asarray((np.arange(PROMPT) * 7 + 1) % tcfg.vocab_size,
                       jnp.int32)
    out = dict(jcfg=jcfg, tcfg=tcfg)
    for lm8 in (False, True):
        jqp = jq.quantize_llama_params(jp, "int4", lm_head=lm8)
        _, jk, jv = jmodel.prefill(jqp, *jmodel.init_cache(jcfg), toks, jcfg)
        out[lm8] = dict(jp=jqp, tp=_to_port(jqp), jk=jk, jv=jv,
                        kc=_to_port({"k": np.asarray(jk)})["k"],
                        vc=_to_port({"v": np.asarray(jv)})["v"])
    return out


@pytest.fixture(scope="module")
def mha():
    return _setup(None, 0)


@pytest.fixture(scope="module")
def gqa():
    return _setup(2, 1)


def _jax_in_kernel(fn, out_shape, *args):
    """fn(*arrays) inside a Pallas kernel in interpret mode: JAX's int4
    unpack is a Pallas-only bitcast."""
    def kern(*refs):
        refs[-1][...] = fn(*(r[...] for r in refs[:-1]))
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)(*args))


def test_kernel_config_default_matches_jax():
    assert KernelConfig().int4_w4a8 is JKernelConfig().int4_w4a8 is True


@pytest.mark.parametrize("gs", [128, 64])
@pytest.mark.parametrize("w4a8", [True, False], ids=["w4a8", "exact"])
@pytest.mark.parametrize("M", [1, 3])
def test_int4_dot_matches_jax(M, w4a8, gs):
    """The plain ``_int4_dot`` against JAX's (its W4A8 path at gs 128, the
    exact tile dequant otherwise, as JAX falls back), x rows whose halves
    differ 10x.  W4A8 agrees to float32 rounding.  The exact product rounds
    each weight to bf16(code * s) once (trap 3: these scales make the two
    differ), as the TPU kernel's bf16 multiply does; XLA on the CPU keeps
    that product in float32 (its excess precision), so there the two agree
    within half a bf16 step of each weight."""
    rng = np.random.default_rng(M + gs)
    K, N = 384, 256
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[:, : K // 2] *= SKEW
    w = rng.standard_normal((K, N)).astype(np.float32)
    jqt = jq.quantize_int4(jnp.asarray(w), -2, gs)
    tqt = tq.quantize_int4(torch.from_numpy(w), -2, gs)
    # scales whose products with the codes need more than 8 bits
    s = np.asarray(jqt.s, np.float32)
    assert np.any(np.asarray(
        jnp.asarray(7 * s, jnp.bfloat16), np.float32) != 7 * s)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    def jdot(mode):
        return _jax_in_kernel(
            lambda a, q, sc: jdl._int4_dot(a, q, sc, gs, mode), (M, N), jx,
            jqt.q, jqt.s)

    want = jdot(w4a8)
    got = tdl._int4_dot(tx, tqt.q, tqt.s, gs, w4a8).numpy()
    codes = tq.unpack_int4(tqt.q, 0).numpy().astype(np.float32)
    wf = codes * np.repeat(s, gs, axis=0)
    if w4a8 and gs == 128:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        # W4A8 differs from the exact product
        assert np.abs(got - jdot(False)).max() > \
            100 * np.abs(got - want).max()
    else:
        bound = np.abs(np.asarray(jx, np.float32)) @ (np.abs(wf) * 2.0 ** -8)
        assert np.all(np.abs(got - want) <= bound + 1e-4)
    # the exact mode's weights: bf16(code * s), rounded once (trap 3)
    deq = tdl._dequant_int4_tile(tqt.q, tqt.s, gs)
    want_w = torch.from_numpy(wf).to(torch.bfloat16)
    assert torch.equal(deq, want_w) and not np.array_equal(
        deq.float().numpy(), wf)


def test_int4_gemv_plain_quantizes_per_block():
    """``_gemv_int4_plain`` with activation blocks of 128 (the O
    projection's head groups) is JAX's W4A8 product block by block, and
    not the product quantized over the whole row."""
    rng = np.random.default_rng(3)
    K, N = 256, 128
    x = rng.standard_normal((2, K)).astype(np.float32)
    x[:, :128] *= SKEW
    w = rng.standard_normal((K, N)).astype(np.float32)
    qt = jq.quantize_int4(jnp.asarray(w), -2, 128)
    jx = jnp.asarray(x, jnp.bfloat16)
    def w4a8(a, q, sc):
        return _jax_in_kernel(lambda *t: jq.w4a8_int4_dot(*t, 128),
                              (2, N), a, q, sc)

    want = sum(w4a8(jx[:, b:b + 128], qt.q[b // 2:(b + 128) // 2],
                    qt.s[b // 128:b // 128 + 1]) for b in (0, 128))
    row = w4a8(jx, qt.q, qt.s)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    tqt = tq.quantize_int4(torch.from_numpy(w), -2, 128)
    got = gemv._gemv_int4(tx, tqt.q, tqt.s, kg=128, a8=True).numpy()
    err = np.abs(got - want).max()
    assert err < 1e-5 * np.abs(want).max()
    assert np.abs(got - row).max() > 100 * err


def _rows_close(got, want, atol):
    """K/V rows within ``atol`` of max(1, the head row's largest value):
    the skewed heads' v rows are 10x the others, and bf16 rounds them in
    steps 10x as large."""
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1.0)
    assert np.all(np.abs(got - want) <= atol * scale), \
        float(np.abs((got - want) / scale).max())


def _step_jax(d, jcfg, w4a8, fused=True):
    return jmodel.decode_step(d["jp"], d["jk"], d["jv"],
                              jnp.asarray(7, jnp.int32),
                              jnp.asarray(PROMPT, jnp.int32), jcfg,
                              JKernelConfig(int4_w4a8=w4a8), fused=fused)


@pytest.fixture(scope="module")
def mha_steps(mha):
    """JAX's fused int4 decode steps, both modes, both heads (interpret)."""
    return {(lm8, w4a8): _step_jax(mha[lm8], mha["jcfg"], w4a8)
            for lm8 in (False, True) for w4a8 in (True, False)}


def _step_port(d, tcfg, w4a8):
    kc, vc = d["kc"].clone(), d["vc"].clone()
    before = sk.launches
    tl, kc, vc = tmodel.decode_step(d["tp"], kc, vc, 7, PROMPT, tcfg,
                                    KernelConfig(int4_w4a8=w4a8), fused=True)
    assert sk.launches == before                # the CPU runs the twin
    assert torch.equal(kc[:, :, :PROMPT], d["kc"][:, :, :PROMPT])
    return tl, kc, vc


@pytest.mark.parametrize("lm8", [False, True], ids=["lm_bf16", "lm_int8"])
@pytest.mark.parametrize("w4a8", [True, False], ids=["w4a8", "exact"])
def test_int4_decode_step_matches_jax(mha, mha_steps, w4a8, lm8):
    """Kernel 7's int4 twin (the fused ``decode_step``) against JAX's fused
    int4 step in the same mode, on the same codes and caches."""
    d = mha[lm8]
    assert isinstance(d["tp"]["layers"]["w2"], tq.QuantizedTensor)
    assert d["tp"]["layers"]["wo_f"].q.shape[1] == 2
    assert isinstance(d["tp"]["lm_head"], tq.QuantizedTensor) == lm8
    tl, kc, vc = _step_port(d, mha["tcfg"], w4a8)
    jl, jk, jv = mha_steps[(lm8, w4a8)]
    atol_lg, atol_kv = (0.35, 0.15) if w4a8 else (0.12, 0.06)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=atol_lg, rtol=0.05)
    for got, want in ((kc, jk), (vc, jv)):
        _rows_close(_np(got)[:, :, PROMPT], _np(want)[:, :, PROMPT], atol_kv)


def test_int4_w4a8_twin_is_jax_w4a8(mha, mha_steps):
    """On the skewed tree the W4A8 twin's logits are far closer to JAX's
    W4A8 step than to JAX's exact one: it quantizes the same blocks."""
    tl, _, _ = _step_port(mha[False], mha["tcfg"], True)
    to_w4a8 = np.abs(tl.numpy() - _np(mha_steps[(False, True)][0])).max()
    to_exact = np.abs(tl.numpy() - _np(mha_steps[(False, False)][0])).max()
    assert to_w4a8 < 0.25 * to_exact, (to_w4a8, to_exact)


def _verify_close(tl, tk, tv, jl, jk, jv):
    jl = _np(jl)
    scale = max(float(np.abs(jl).max()), 1.0)
    assert float(np.abs(_np(tl) - jl).max()) < 0.06 * scale
    _rows_close(_np(tk), _np(jk), 0.08)
    _rows_close(_np(tv), _np(jv), 0.08)


@pytest.mark.parametrize("w4a8", [True, False], ids=["w4a8", "exact"])
@pytest.mark.parametrize("n", [2, 5])
def test_int4_verify_matches_jax(gqa, n, w4a8):
    """Kernel 8's int4 twin (``verify_step(fused=True)``) against JAX's
    fused int4 verify in the same mode, int8 LM head."""
    d = gqa[True]
    toks = (np.arange(n) * 3 + 2) % gqa["tcfg"].vocab_size
    jl, jk, jv = jspec.verify_step(d["jp"], d["jk"], d["jv"],
                                   jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(PROMPT, jnp.int32),
                                   gqa["jcfg"],
                                   JKernelConfig(int4_w4a8=w4a8), fused=True)
    kc, vc = d["kc"].clone(), d["vc"].clone()
    before = sv.launches
    tl, tk, tv = tspec.verify_step(d["tp"], kc, vc, toks, PROMPT, gqa["tcfg"],
                                   KernelConfig(int4_w4a8=w4a8))
    assert sv.launches == before
    _verify_close(tl, tk, tv, jl, jk, jv)


def _top2_gap_at(tp, cfg, prompt, prefix):
    kc, vc = tmodel.init_cache(cfg, device="cpu")
    lg, _, _ = tmodel.prefill(tp, kc, vc, list(prompt) + list(prefix), cfg,
                              flash=False)
    s = torch.sort(lg[-1].float()).values
    return float(s[-1] - s[-2])


@pytest.mark.parametrize("draft", ["self", "tiny_bf16"])
def test_int4_spec_generate_is_the_int4_stream(draft):
    """``spec_generate`` on an int4 target (kernel 8's int4 twin for the
    verify; with itself as the draft, kernel 7's for the drafts; or a bf16
    tiny draft) emits the engine's own int4 greedy stream, under the
    top-2-gap rule."""
    cfg = LlamaConfig.tiny(max_seq_len=96)
    eng = Llama.synthetic(cfg, seed=4, quant="int4", device="cpu")
    assert eng.params["layers"]["w13"].kind == "int4"
    dr = eng if draft == "self" else Llama.synthetic(cfg, seed=5,
                                                     device="cpu")
    prompt = [2, 7, 18, 28, 30, 31, 40]
    stream = list(eng.stream_generate(prompt, 16, temperature=0.0))
    got = eng.spec_generate(prompt, 16, dr, n_draft=4)
    st = eng.spec_stats
    assert len(got) == 16 and st["tokens"] == 16
    if draft == "self":
        assert st["accepted_drafts"] >= 2 * 4, st
    i = next((i for i, (a, b) in enumerate(zip(got, stream)) if a != b),
             None)
    if i is not None:
        assert _top2_gap_at(eng.params, cfg, prompt, got[:i]) <= GAP, \
            (i, got, stream)


def _rope_tables(hd, max_pos=512):
    angle = np.outer(np.arange(max_pos), 0.2 * np.arange(hd // 2) + 0.05)
    c, s = np.cos(angle), np.sin(angle)
    return (np.concatenate([c, c], -1).astype(np.float32),
            np.concatenate([s, s], -1).astype(np.float32))


@pytest.mark.parametrize("kv,g,hg,page,lens,style", [
    (4, 1, 2, 16, [0, 16, 260], "neox"),
    (4, 2, 4, 8, [9, 0, 140], "gptj"),
], ids=["mha_G2_page16", "gqa_G1_page8"])
def test_int4_paged_layer_matches_jax(kv, g, hg, page, lens, style):
    """Kernel 9's int4 twin (exact) against JAX's int4
    ``llama_decoder_layer_paged`` (interpret mode) on the same codes,
    scales, pools and table; rows outside the appends stay as they were."""
    rng = np.random.RandomState(3)
    L, layer, hidden, hd, B = 2, 1, 512, 128, len(lens)
    G = kv // hg
    need = [n // page + 1 for n in lens]
    n_pages = 1 + sum(need) + 3
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((B, max(need)), np.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at:at + n]
        at += n
    lens = np.asarray(lens, np.int32)
    pos = lens + 3

    def pair(a):
        j = jnp.asarray(a, jnp.bfloat16)
        return j, _to_port({"t": np.asarray(j)})["t"]

    jx, tx = pair(rng.randn(B, hidden))
    jr, tr = pair(rng.randn(B, hidden))
    jwq, _ = pair(rng.randn(L, G, hidden, hg * (g + 2) * hd) * hidden ** -0.5)
    jwo, _ = pair(rng.randn(L, G, hg * g * hd, hidden) * (kv * g * hd) ** -0.5)
    jrms, trms = pair(1 + 0.1 * rng.randn(1, hidden))
    jkp, tkp = pair(rng.randn(L, n_pages, kv, page, hd))
    jvp, tvp = pair(rng.randn(L, n_pages, kv, page, hd))
    jq4 = jq.quantize_llama_params({"layers": {"wqkv_f": jwq, "wo_f": jwo}},
                                   "int4", targets=("wqkv_f", "wo_f"))
    tq4 = _to_port(jq4)["layers"]
    assert tq4["wo_f"].kind == "int4"
    tk_in = tkp.clone()
    cos, sin = _rope_tables(hd)
    jout = jpd.llama_decoder_layer_paged(
        jx, jr, jq4["layers"]["wqkv_f"], jq4["layers"]["wo_f"],
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(pos), jkp, jvp,
        layer, jrms, 1e-5, jnp.asarray(cos), jnp.asarray(sin), group=g,
        rope_style=style)
    before = pd.launches["llama_decoder_layer_paged_int4"]
    tout = pd.llama_decoder_layer_paged(
        tx, tr, tq4["wqkv_f"], tq4["wo_f"], torch.from_numpy(table),
        torch.from_numpy(lens), torch.from_numpy(pos), tkp, tvp, layer, trms,
        1e-5, torch.from_numpy(cos), torch.from_numpy(sin), group=g,
        rope_style=style)
    assert pd.launches["llama_decoder_layer_paged_int4"] == before
    for i in (0, 1):
        np.testing.assert_allclose(_np(tout[i]), _np(jout[i]), atol=2e-2,
                                   rtol=2e-2)
    app = np.zeros(tkp.shape, bool)
    for b, n in enumerate(lens):
        app[layer, table[b, n // page], :, n % page] = True
    np.testing.assert_allclose(_np(tkp)[app], _np(jout[2])[app], atol=2e-2,
                               rtol=2e-2)
    assert np.array_equal(_np(tkp)[~app], _np(tk_in)[~app])


@pytest.fixture(scope="module")
def serving_tree():
    jcfg = JConfig.tiny(max_seq_len=64)
    jp = jq.quantize_llama_params(
        jmodel.init_params(jcfg, jax.random.PRNGKey(3),
                           head_group=jmodel.default_head_group(jcfg, "int4")),
        "int4")
    return jcfg, LlamaConfig.tiny(max_seq_len=64), jp, _to_port(jp)


@pytest.mark.parametrize("impl", ["batched", "fused"])
def test_int4_serving_step_matches_jax(serving_tree, impl, monkeypatch):
    """One int4 serving step of each kind against JAX's on the same pools
    and table (the batched step's int4 products around the paged walk; the
    fused step's kernel 9 and int4 FFN): the appended rows of every layer,
    the greedy tokens where the top-2 gap exceeds the rule's and their
    logprobs."""
    jcfg, tcfg, jp, tp = serving_tree
    B, page, P, num_pages = 4, 8, 4, 24
    rng = np.random.RandomState(0)
    shape = (tcfg.n_layers, num_pages, tcfg.kv_heads, page, tcfg.head_dim_)
    jkp = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
    jvp = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
    tkp = _to_port({"k": np.asarray(jkp)})["k"]
    tvp = _to_port({"v": np.asarray(jvp)})["v"]
    table = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
    lens = np.asarray([11, 5, 16, 0], np.int32)
    toks = np.asarray([3, 9, 1, 7], np.int32)
    greedy, tops = np.zeros(B, np.float32), np.full(B, 0.9, np.float32)
    jstep = (jserving._paged_decode_step_batched if impl == "batched"
             else jserving._paged_decode_step)
    jn, jlp, jk2, _ = jstep(
        jp, jkp, jvp, jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(table), jnp.asarray(lens), jax.random.PRNGKey(0),
        jnp.asarray(greedy), jnp.asarray(tops), jcfg, JKernelConfig())
    logits = []

    def keep_logits(lg, *a):
        logits.append(lg)
        return sample_batch(lg, *a)

    monkeypatch.setattr(tserving, "sample_batch", keep_logits)
    k_in = tkp.clone()
    tstep = (tserving._paged_decode_step_batched if impl == "batched"
             else tserving._paged_decode_step)
    tn, tlp = tstep(
        tp, tkp, tvp, torch.from_numpy(toks).long(), torch.from_numpy(lens),
        torch.from_numpy(table), torch.from_numpy(lens), None, greedy, tops,
        tcfg, tmodel.rope_table(tcfg))
    top = torch.topk(logits[0], 2, dim=-1).values
    sure = ((top[:, 0] - top[:, 1]) > GAP).numpy()
    assert sure.sum() >= 2
    assert np.array_equal(tn.numpy()[sure], np.asarray(jn)[sure])
    np.testing.assert_allclose(tlp.numpy()[sure], np.asarray(jlp)[sure],
                               atol=2e-2)
    app = np.zeros(shape, bool)
    for b, n in enumerate(lens):
        app[:, table[b, n // page], :, n % page] = True
    np.testing.assert_allclose(_np(tkp)[app], _np(jk2)[app], atol=0.06,
                               rtol=0)
    assert np.array_equal(_np(tkp)[~app], _np(k_in)[~app])


def test_int4_engine_defaults_to_fused_and_generates(serving_tree,
                                                     monkeypatch):
    """An int4 tree takes the fused step by default, as in the JAX engine
    (an int8 or bf16 tree the batched one), and ``Llama.generate`` runs
    kernel 9's int4 twin on it for one prompt and for two."""
    _, tcfg, _, tp = serving_tree
    assert ServingEngine(tp, tcfg).step_impl == "fused"
    assert ServingEngine(tq.quantize_llama_params(
        {**tp, "layers": {k: (v.dequantize() if isinstance(
            v, tq.QuantizedTensor) else v) for k, v in tp["layers"].items()}},
        "int8"), tcfg).step_impl == "batched"
    eng = Llama(tp, tcfg, ByteTokenizer(), fused=True)
    calls = []

    def counted(*a, **k):
        calls.append(a[2].kind)
        return pd.llama_decoder_layer_paged(*a, **k)

    monkeypatch.setattr(tserving, "llama_decoder_layer_paged", counted)
    p0, p1 = [1, 2, 3, 4], [9, 8, 7]
    (one,), _ = eng.generate([p0], 6, temperature=0.0)
    two, _ = eng.generate([p0, p1], 6, temperature=0.0)
    assert calls and set(calls) == {"int4"}
    assert len(calls) % tcfg.n_layers == 0
    assert len(one) == 6 and len(two[1]) == 6
    assert one == two[0]         # each row's products are its own


def test_int4_refusals_name_their_items(mha):
    """What stays refused with int4 weights, each with its ROADMAP.md
    item: group sizes other than 128 in the kernels' wrappers and the
    serving engine (mode 1.5), an int4 LM head (1.5), W8A8 serving (6);
    and what mode 1.4 opened now runs: int4 in kernel 7 with
    ``reduce_axis`` (on an axis of one rank, the unsharded step's bits) and
    in kernel 6 (its plain twin here, both int4 modes)."""
    d, tcfg = mha[False], mha["tcfg"]
    tp = d["tp"]
    g, hd = tcfg.n_heads // tcfg.kv_heads, tcfg.head_dim_
    lw64 = tq.quantize_llama_params(
        {**tp, "layers": {k: (v.dequantize() if isinstance(
            v, tq.QuantizedTensor) else v) for k, v in tp["layers"].items()}},
        "int4", group_size=64)["layers"]
    cos, sin = tmodel.rope_row(tcfg, PROMPT)
    kw = dict(group=g, head_dim=hd, rope_style=tcfg.rope_style,
              eps=tcfg.norm_eps)
    args = (lw64["attn_norm"], lw64["ffn_norm"], cos, sin, lw64["wqkv_f"],
            lw64["wo_f"], lw64["w13"], lw64["w2"], d["kc"].clone(),
            d["vc"].clone(), PROMPT)
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        sk.fused_decoder_stack(tp["embed"][[7]], *args, **kw)
    cos2, sin2 = tmodel.rope_rows(tcfg, PROMPT, 2)
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        sv.fused_verify_stack(tp["embed"][[7, 8]], *args[:2], cos2, sin2,
                              *args[4:], **kw)
    eng64 = dict(tp, layers=lw64)
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        ServingEngine(eng64, tcfg)
    head4 = tq.quantize_int4(tp["lm_head"], -2)
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        sk.fused_decoder_stack(tp["embed"][[7]], *(args[:4]),
                               *(tp["layers"][k] for k in
                                 ("wqkv_f", "wo_f", "w13", "w2")),
                               *args[8:], final_norm=tp["final_norm"],
                               lm_head=head4, **kw)
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        ServingEngine(dict(tp, lm_head=head4), tcfg)
    with pytest.raises(NotImplementedError, match="queue 2, mode 6"):
        ServingEngine(tp, tcfg, kcfg=KernelConfig(serving_w8a8=True))
    from clusterfusion_tpu_torch.parallel.mesh import AXES, Mesh
    one = Mesh(shape=dict.fromkeys(AXES, 1), coords=dict.fromkeys(AXES, 0),
               groups=dict.fromkeys(AXES))
    w4 = [tp["layers"][k] for k in ("wqkv_f", "wo_f", "w13", "w2")]

    def stack(**kw5):
        return sk.fused_decoder_stack(
            tp["embed"][[7]], *(args[:4]), *w4, d["kc"].clone(),
            d["vc"].clone(), PROMPT, **kw5, **kw)

    got, want = stack(reduce_axis="tp", mesh=one), stack()
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    with pytest.raises(NotImplementedError, match="queue 2, mode 1.5"):
        sk.fused_decoder_stack(tp["embed"][[7]], *(args[:4]), *w4,
                               *args[8:], final_norm=tp["final_norm"],
                               lm_head=head4, reduce_axis="tp", mesh=one,
                               **kw)
    lw = tp["layers"]
    outs = {}
    for a8 in (True, False):
        outs[a8] = tdl._fused_decoder_layer(
            tp["embed"][[7]], None, lw["attn_norm"], cos.float(),
            sin.float(), lw["wqkv_f"], lw["wo_f"], d["kc"].clone(),
            d["vc"].clone(), PROMPT, 0, group=g, head_dim=hd,
            rope_style=tcfg.rope_style, fuse_residual=False,
            eps=tcfg.norm_eps, kcfg=KernelConfig(int4_w4a8=a8))[0]
        assert torch.isfinite(outs[a8].float()).all()
    assert not torch.equal(outs[True], outs[False])


def test_chat_cli_int4(capsys):
    from clusterfusion_tpu_torch import chat
    chat.main(["--synthetic", "--quant", "int4", "--spec_draft", "synthetic",
               "--n_draft", "3", "--device", "cpu", "--max_gen_len", "6",
               "--max_seq_len", "64"])
    out = capsys.readouterr().out
    assert "fused=True W4A8" in out and "quant=int4" in out and \
        "drafts accepted" in out and "tokens/sec" in out
