"""The port's int8 weight-only speculative decoding and serving against the
JAX package's, on the CPU, at ``LlamaConfig.tiny()`` (MHA) and a GQA
variant (``n_kv_heads=2``): kernel 8's int8 twin (``verify_step``),
``spec_generate`` on an int8 target, kernel 9's int8 twin
(``llama_decoder_layer_paged``), the batched serving step's int8 products
and ``ServingEngine``/``Llama.generate`` on int8 weights, and the chat
flag.

Both trees are quantized with their own ``quantize_llama_params(...,
"int8")`` (the codes and scales are bit-equal, ``test_torch_quant.py``);
JAX's Pallas kernels run in interpret mode, the port's wrappers their
plain twins.

Tolerances are the JAX suite's own for each op: the verify's logits
within 0.06 of max(|logits|, 1) and K/V rows at atol 0.08
(``tests/test_stack_verify.py``); the paged layer's outputs and appended
rows at atol 2e-2 / rtol 2e-2 (``test_torch_paged.py``, whose reasons
hold: the two walk the rows in other chunks, and each rounds its own
float32 projection to bf16); one batched step's logprobs at atol 2e-2 and
its appended rows of every layer at atol 0.06 (``test_torch_serving.py``'s
limits between two steps: a bf16 flip of layer 0's output moves layer
1's rows).  Greedy streams follow the top-2-gap rule of
``test_torch_speculative.py``.  Batching invariance is exact, as in JAX
``tests/test_runtime.py:174``: the step pads rows to ``max_batch``, and
each row's products do not depend on the others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import KernelConfig as JKernelConfig
from clusterfusion_tpu.config import LlamaConfig as JConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu.models import speculative as jspec
from clusterfusion_tpu.ops import paged_decoder_layer as jpd
from clusterfusion_tpu.ops import quant as jq
from clusterfusion_tpu.runtime import serving as jserving
from clusterfusion_tpu_torch.config import LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models import speculative as tspec
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.models.generation import Llama
from clusterfusion_tpu_torch.models.sampling import sample_batch
from clusterfusion_tpu_torch.models.tokenizer import ByteTokenizer
from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
from clusterfusion_tpu_torch.ops import quant as tq
from clusterfusion_tpu_torch.ops import stack_verify as sv
from clusterfusion_tpu_torch.runtime import ServingEngine
from clusterfusion_tpu_torch.runtime import serving as tserving

GAP = 0.05
PROMPT = 21           # cached rows before the verify


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _setup(kv_heads, seed):
    """A JAX tiny tree (two head groups) quantized to int8 with a bf16 and
    with an int8 LM head, both prefilled with the same prompt; the port's
    copies."""
    jcfg = JConfig.tiny(n_kv_heads=kv_heads)
    tcfg = LlamaConfig.tiny(n_kv_heads=kv_heads)
    # two head groups, so that the O projection's scales differ per group
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed),
                            head_group=jcfg.kv_heads // 2)
    toks = jnp.asarray((np.arange(PROMPT) * 7 + 1) % tcfg.vocab_size,
                       jnp.int32)
    out = dict(jcfg=jcfg, tcfg=tcfg)
    for lm8 in (False, True):
        jqp = jq.quantize_llama_params(jp, "int8", lm_head=lm8)
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


def _verify_close(tl, tk, tv, jl, jk, jv):
    """The JAX suite's limits for the verify (``test_stack_verify.py``)."""
    jl = _np(jl)
    scale = max(float(np.abs(jl).max()), 1.0)
    assert float(np.abs(_np(tl) - jl).max()) < 0.06 * scale
    np.testing.assert_allclose(_np(tk), _np(jk), atol=0.08, rtol=0)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=0.08, rtol=0)


@pytest.mark.parametrize("lm8", [False, True], ids=["lm_bf16", "lm_int8"])
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_int8_verify_matches_jax_eager(which, n, lm8, request):
    """The port's int8 ``verify_step(fused=True)`` (kernel 8's int8 twin)
    and its eager oracle against JAX's eager int8 verify.  JAX's eager
    verify has no int8 LM head (its fused verify does:
    ``test_int8_verify_matches_jax_fused``), so with the int8 head it runs
    on the dequantized head, the function the scales encode."""
    s = request.getfixturevalue(which)
    d = s[lm8]
    assert isinstance(d["tp"]["layers"]["wo_f"], tq.QuantizedTensor)
    assert isinstance(d["tp"]["lm_head"], tq.QuantizedTensor) == lm8
    toks = (np.arange(n) * 3 + 2) % s["tcfg"].vocab_size
    jp = dict(d["jp"], lm_head=jq.maybe_dequantize(d["jp"]["lm_head"],
                                                   jnp.bfloat16))
    jl, jk, jv = jspec.verify_step(jp, d["jk"], d["jv"],
                                   jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(PROMPT, jnp.int32), s["jcfg"],
                                   fused=False)
    for fused in (True, False):
        kc, vc = d["kc"].clone(), d["vc"].clone()
        before = sv.launches
        tl, tk, tv = tspec.verify_step(d["tp"], kc, vc, toks, PROMPT,
                                       s["tcfg"], fused=fused)
        assert sv.launches == before                # the CPU runs the twin
        assert tl.shape == (n, s["tcfg"].vocab_size)
        _verify_close(tl, tk, tv, jl, jk, jv)
        assert torch.equal(tk[:, :, :PROMPT], d["kc"][:, :, :PROMPT])


def test_int8_verify_matches_jax_fused(mha):
    """At n 4 against JAX's fused int8 verify (its Pallas kernel in
    interpret mode), int8 LM head."""
    d = mha[True]
    toks = np.asarray([9, 2, 6, 100])
    jl, jk, jv = jspec.verify_step(d["jp"], d["jk"], d["jv"],
                                   jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(PROMPT, jnp.int32),
                                   mha["jcfg"], fused=True)
    kc, vc = d["kc"].clone(), d["vc"].clone()
    tl, tk, tv = tspec.verify_step(d["tp"], kc, vc, toks, PROMPT, mha["tcfg"])
    _verify_close(tl, tk, tv, jl, jk, jv)


def test_int8_verify_twin_scales_each_group_before_the_sum(gqa):
    """Kernel 8's int8 twin against the bf16 twin on the dequantized
    weights (float32 products of the same values): the per-group O scales
    (two head groups), gate/up before the SwiGLU, down and the LM head
    after their sums give the dequantized model's function, to 1 % of the
    largest logit (the two round xn, o and the activation to bf16 from
    float32 sums that differ in their last bits)."""
    d, cfg = gqa[True], gqa["tcfg"]
    qp = d["tp"]
    assert qp["layers"]["wo_f"].q.shape[1] == 2
    deq = {k: tq.maybe_dequantize(v, torch.float32)
           for k, v in qp["layers"].items()}
    n = 4
    x = qp["embed"][torch.tensor([7, 8, 9, 10])]
    cos, sin = tmodel.rope_rows(cfg, PROMPT, n)
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, eps=cfg.norm_eps,
              final_norm=qp["final_norm"])
    outs = []
    for lw, head in ((qp["layers"], qp["lm_head"]),
                     (deq, tq.maybe_dequantize(qp["lm_head"], torch.float32))):
        outs.append(sv.fused_verify_stack_plain(
            x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"], d["kc"].clone(), d["vc"].clone(),
            PROMPT, lm_head=head, **kw))
    a, b = outs[0][0].numpy(), outs[1][0].numpy()
    assert np.abs(a - b).max() < 0.01 * np.abs(b).max()


def _top2_gap_at(tp, cfg, prompt, prefix):
    """The target's top-2 gap predicting the token after prompt + prefix
    (the eager prefill)."""
    kc, vc = tmodel.init_cache(cfg, device="cpu")
    lg, _, _ = tmodel.prefill(tp, kc, vc, list(prompt) + list(prefix), cfg,
                              flash=False)
    s = torch.sort(lg[-1].float()).values
    return float(s[-1] - s[-2])


@pytest.mark.parametrize("draft", ["self", "tiny_bf16"])
def test_int8_spec_generate_is_the_int8_stream(draft):
    """``spec_generate`` on an int8 target (kernel 8's int8 twin for the
    verify; with itself as the draft, kernel 7's int8 twin for the drafts;
    or a bf16 tiny draft) emits the engine's own int8 greedy stream: where
    the two part, the target's top-2 gap is at most the rule's 0.05."""
    cfg = LlamaConfig.tiny(max_seq_len=96)
    eng = Llama.synthetic(cfg, seed=4, quant="int8", device="cpu")
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
def test_int8_paged_layer_matches_jax(kv, g, hg, page, lens, style):
    """Kernel 9's int8 twin against JAX's int8 ``llama_decoder_layer_paged``
    (interpret mode) on the same codes, scales, pools and table."""
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
    jq8 = jq.quantize_llama_params({"layers": {"wqkv_f": jwq, "wo_f": jwo}},
                                   "int8", targets=("wqkv_f", "wo_f"))
    tq8 = _to_port(jq8)["layers"]
    assert isinstance(tq8["wo_f"], tq.QuantizedTensor)
    tk_in = tkp.clone()
    cos, sin = _rope_tables(hd)
    jout = jpd.llama_decoder_layer_paged(
        jx, jr, jq8["layers"]["wqkv_f"], jq8["layers"]["wo_f"],
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(pos), jkp, jvp,
        layer, jrms, 1e-5, jnp.asarray(cos), jnp.asarray(sin), group=g,
        rope_style=style)
    before = pd.launches["llama_decoder_layer_paged_int8"]
    tout = pd.llama_decoder_layer_paged(
        tx, tr, tq8["wqkv_f"], tq8["wo_f"], torch.from_numpy(table),
        torch.from_numpy(lens), torch.from_numpy(pos), tkp, tvp, layer, trms,
        1e-5, torch.from_numpy(cos), torch.from_numpy(sin), group=g,
        rope_style=style)
    assert pd.launches["llama_decoder_layer_paged_int8"] == before
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
                           head_group=jmodel.default_head_group(jcfg, "int8")),
        "int8")
    return jcfg, LlamaConfig.tiny(max_seq_len=64), jp, _to_port(jp)


def test_int8_batched_step_matches_jax(serving_tree, monkeypatch):
    """One int8 batched serving step (the M=B int8 products: QKV scaled per
    column, O per group before the sum, the int8 FFN) against JAX's
    ``_paged_decode_step_batched`` on the same pools and table: the
    appended rows of every layer, the greedy tokens where the top-2 gap
    exceeds the rule's and their logprobs."""
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
    jn, jlp, jk2, _ = jserving._paged_decode_step_batched(
        jp, jkp, jvp, jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(table), jnp.asarray(lens), jax.random.PRNGKey(0),
        jnp.asarray(greedy), jnp.asarray(tops), jcfg,
        JKernelConfig())
    logits = []

    def keep_logits(lg, *a):
        logits.append(lg)
        return sample_batch(lg, *a)

    monkeypatch.setattr(tserving, "sample_batch", keep_logits)
    k_in = tkp.clone()
    tn, tlp = tserving._paged_decode_step_batched(
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


@pytest.mark.parametrize("impl", ["batched", "fused"])
def test_int8_engine_is_batching_invariant(serving_tree, impl):
    """JAX ``tests/test_runtime.py:174`` for the port: int8 requests decoded
    together give each the tokens it gets alone, in both step kinds, and
    int8 defaults to the batched step, as in the JAX engine."""
    _, tcfg, _, tp = serving_tree
    assert ServingEngine(tp, tcfg).step_impl == "batched"
    prompts = {0: [1, 2, 3], 1: [5, 6, 7, 8], 2: list(range(20, 37))}
    solo = {}
    for rid, p in prompts.items():
        eng = ServingEngine(tp, tcfg, page_size=8, num_pages=64, max_batch=4,
                            step_impl=impl)
        eng.submit(rid, p, max_gen_len=5, temperature=0.0)
        solo.update(eng.run())
    eng = ServingEngine(tp, tcfg, page_size=8, num_pages=64, max_batch=4,
                        step_impl=impl)
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=5, temperature=0.0)
    assert eng.run() == solo


def test_int8_generate_runs_both_steps(serving_tree, monkeypatch):
    """``Llama.generate`` on int8 weights: one prompt takes the fused step
    (kernel 9's int8 twin on the int8 tree), two the batched one; the
    prompt they share gets the same tokens but where the top-2 gap is
    within the rule's."""
    _, tcfg, _, tp = serving_tree
    eng = Llama(tp, tcfg, ByteTokenizer(), fused=True)
    p0, p1 = [1, 2, 3, 4], [9, 8, 7]
    calls = []

    def counted(*a, **k):
        calls.append(isinstance(a[2], tq.QuantizedTensor))
        return pd.llama_decoder_layer_paged(*a, **k)

    monkeypatch.setattr(tserving, "llama_decoder_layer_paged", counted)
    (one,), _ = eng.generate([p0], 6, temperature=0.0)
    assert calls and all(calls) and len(calls) % tcfg.n_layers == 0
    calls.clear()
    two, _ = eng.generate([p0, p1], 6, temperature=0.0)
    assert not calls
    assert len(one) == 6 and len(two[1]) == 6
    i = next((i for i, (a, b) in enumerate(zip(one, two[0])) if a != b),
             None)
    if i is not None:
        assert _top2_gap_at(tp, tcfg, p0, one[:i]) <= GAP, (one, two[0])


def test_chat_cli_int8_spec_draft(capsys):
    from clusterfusion_tpu_torch import chat
    chat.main(["--synthetic", "--quant", "int8", "--spec_draft", "synthetic",
               "--n_draft", "3", "--device", "cpu", "--max_gen_len", "6",
               "--max_seq_len", "64"])
    out = capsys.readouterr().out
    assert "quant=int8" in out and "spec n_draft=3" in out and \
        "drafts accepted" in out and "tokens/sec" in out
