"""The port's speculative decoding against the JAX package's, on the CPU, at
``LlamaConfig.tiny()`` (MHA) and a GQA variant (``n_kv_heads=2``).

One JAX parameter tree crosses to the port through ``params_from_numpy``.
JAX's ``fused_verify_stack`` runs in interpret mode; the port's wrapper
runs its plain twin on CPU tensors.

Tolerances: verify logits within 0.06 of max(|logits|, 1) and K/V rows
within atol 0.08, the JAX suite's own limits for this op
(``tests/test_stack_verify.py``).  The fresh K/V rows of layer 0 come from
the same inputs in both packages and may differ only where a float32 sum
order flips a bf16 rounding: within one bf16 ulp (2^-7 of |row|, +1e-6).
Greedy streams follow the rule of ``test_torch_model.py``: wherever the
top-2 logit gap exceeds 0.05 the tokens must agree, and past the first
legitimate divergence the streams are not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import LlamaConfig as JConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu.models import speculative as jspec
from clusterfusion_tpu.models.generation import Llama as JLlama
from clusterfusion_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models import speculative as tspec
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.models.generation import Llama
from clusterfusion_tpu_torch.models.tokenizer import ByteTokenizer
from clusterfusion_tpu_torch.ops import stack_kernel as sk
from clusterfusion_tpu_torch.ops import stack_verify as sv

GAP = 0.05
PROMPT = 45           # cached rows before the verify


def _setup(kv_heads=None, seed=0):
    jcfg = JConfig.tiny(n_kv_heads=kv_heads)
    tcfg = LlamaConfig.tiny(n_kv_heads=kv_heads)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = (np.arange(PROMPT) * 7 + 1) % tcfg.vocab_size
    _, jk, jv = jmodel.prefill(jp, *jmodel.init_cache(jcfg),
                               jnp.asarray(toks, jnp.int32), jcfg)
    kc, vc = tmodel.init_cache(tcfg, device="cpu")
    tmodel.prefill(tp, kc, vc, toks, tcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jk=jk, jv=jv, kc=kc,
                vc=vc)


@pytest.fixture(scope="module")
def mha():
    return _setup()


@pytest.fixture(scope="module")
def gqa():
    return _setup(kv_heads=2, seed=1)


def _logits_close(t, j, frac=0.06):
    jn = np.asarray(j, np.float32)
    scale = max(float(np.max(np.abs(jn))), 1.0)
    err = float(np.max(np.abs(t.float().numpy() - jn)))
    assert err < frac * scale, (err, scale)


def _verify_both(s, n, fused, kcfg=KernelConfig()):
    toks = (np.arange(n) * 3 + 2) % s["tcfg"].vocab_size
    jl, jk, jv = jspec.verify_step(s["jp"], s["jk"], s["jv"],
                                   jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(PROMPT, jnp.int32), s["jcfg"],
                                   fused=fused)
    kc, vc = s["kc"].clone(), s["vc"].clone()
    tl, tk, tv = tspec.verify_step(s["tp"], kc, vc, toks, PROMPT, s["tcfg"],
                                   kcfg, fused=fused)
    assert tk is kc and tv is vc                          # in place
    assert tl.shape == (n, s["tcfg"].vocab_size) and tl.dtype == torch.float32
    return tl, tk, tv, jl, np.asarray(jk, np.float32), np.asarray(jv, np.float32)


@pytest.mark.parametrize("which,n,kv_split", [
    ("mha", 1, 128), ("mha", 3, 128), ("mha", 8, 128),
    # 3 splits of the 45 cached rows; the 8 rows straddle the boundary at 48
    ("mha", 8, 16),
    ("gqa", 4, 128),
])
def test_verify_fused_matches_jax(which, n, kv_split, request):
    s = request.getfixturevalue(which)
    tl, tk, tv, jl, jk, jv = _verify_both(s, n, True,
                                          KernelConfig(kv_split=kv_split))
    _logits_close(tl, jl)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.float().numpy(), j, atol=0.08, rtol=0)
        fresh_t = t[0, :, PROMPT:PROMPT + n].float().numpy()
        fresh_j = j[0, :, PROMPT:PROMPT + n]
        np.testing.assert_allclose(fresh_t, fresh_j, rtol=2 ** -7, atol=1e-6)
        # rows below pos are untouched, rows above pos+n stay empty
        assert np.array_equal(t[:, :, :PROMPT].float().numpy(),
                              s["kc" if t is tk else "vc"][:, :, :PROMPT]
                              .float().numpy())
        assert not t[:, :, PROMPT + n:].any()


@pytest.mark.parametrize("which,n", [("mha", 3), ("gqa", 4)])
def test_verify_eager_matches_jax(which, n, request):
    s = request.getfixturevalue(which)
    tl, tk, tv, jl, jk, jv = _verify_both(s, n, False)
    _logits_close(tl, jl)
    np.testing.assert_allclose(tk.float().numpy(), jk, atol=0.08, rtol=0)
    np.testing.assert_allclose(tv.float().numpy(), jv, atol=0.08, rtol=0)


@pytest.mark.parametrize("with_lm", [True, False], ids=["lm", "no_lm"])
@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_verify_plain_n1_matches_stack_plain(which, with_lm, request):
    """At n=1 the verify twin is the one-row stack's twin but for the bf16
    rounding of the current token's p and v (the TPU verify kernel rounds
    them; the stack folds them in float32): logits within 2e-2 of the
    largest logit, outputs and K/V rows within atol 0.05."""
    s = request.getfixturevalue(which)
    cfg, p = s["tcfg"], s["tp"]
    lw = p["layers"]
    x = p["embed"][torch.tensor([7])]
    cos, sin = tmodel.rope_row(cfg, PROMPT)
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, eps=cfg.norm_eps)
    if with_lm:
        kw.update(final_norm=p["final_norm"], lm_head=p["lm_head"])
    args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"])
    kv, vv = s["kc"].clone(), s["vc"].clone()
    ks, vs = s["kc"].clone(), s["vc"].clone()
    out_v = sv.fused_verify_stack_plain(*args, kv, vv, PROMPT, **kw)
    out_s = sk.fused_decoder_stack_plain(*args, ks, vs, PROMPT, **kw)
    if with_lm:
        scale = out_s[0].abs().max().item()
        assert (out_v[0] - out_s[0]).abs().max().item() <= 2e-2 * scale
    else:
        torch.testing.assert_close(out_v[0].float(), out_s[0].float(),
                                   atol=0.05, rtol=0)
    torch.testing.assert_close(out_v[1].float(), out_s[1].float(), atol=0.05,
                               rtol=0)
    torch.testing.assert_close(kv.float(), ks.float(), atol=0.05, rtol=0)
    torch.testing.assert_close(vv.float(), vs.float(), atol=0.05, rtol=0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_stale_rows_above_pos_change_nothing(mha, fused):
    """Rows at and above pos may hold K/V of rejected drafts: the verify
    reads none of them, overwrites rows pos..pos+n-1 and leaves the rest."""
    cfg, n = mha["tcfg"], 5
    toks = [9, 2, 6, 100, 3]
    clean = [mha["kc"].clone(), mha["vc"].clone()]
    stale = [mha["kc"].clone(), mha["vc"].clone()]
    gen = torch.Generator().manual_seed(3)
    for t in stale:
        t[:, :, PROMPT:] = (8 * torch.randn(t[:, :, PROMPT:].shape,
                                            generator=gen)).to(t.dtype)
    garbage = [t[:, :, PROMPT + n:].clone() for t in stale]
    l1, *_ = tspec.verify_step(mha["tp"], *clean, toks, PROMPT, cfg,
                               fused=fused)
    l2, *_ = tspec.verify_step(mha["tp"], *stale, toks, PROMPT, cfg,
                               fused=fused)
    assert torch.equal(l1, l2)
    for c, st, gb in zip(clean, stale, garbage):
        assert torch.equal(c[:, :, :PROMPT + n], st[:, :, :PROMPT + n])
        assert torch.equal(st[:, :, PROMPT + n:], gb)


def test_verify_refuses_bad_rows_and_configs(mha):
    cfg = mha["tcfg"]
    kc, vc = mha["kc"].clone(), mha["vc"].clone()
    cap = kc.shape[2]
    for fused in (True, False):
        with pytest.raises(ValueError, match="capacity"):
            tspec.verify_step(mha["tp"], kc, vc, [1, 2, 3], cap - 2, cfg,
                              fused=fused)
    with pytest.raises(NotImplementedError):
        tspec.verify_step(mha["tp"], kc, vc, [1, 2], PROMPT,
                          LlamaConfig.tiny(sliding_window=16,
                                           window_pattern="even"))
    lw = mha["tp"]["layers"]
    cos, sin = tmodel.rope_rows(cfg, PROMPT, 2)
    args = (mha["tp"]["embed"][:2], lw["attn_norm"], lw["ffn_norm"], cos,
            sin, lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc, vc,
            PROMPT)
    common = dict(group=1, head_dim=128, rope_style="gptj", eps=1e-5)
    for extra in (dict(window=8, window_pattern="even"), dict(softcap=30.0),
                  dict(ffn_act="gelu_tanh"),
                  dict(reduce_axis="tp"), dict(post_attn_norm=lw["ffn_norm"],
                                               post_ffn_norm=lw["ffn_norm"])):
        with pytest.raises(NotImplementedError):
            sv.fused_verify_stack(*args, **common, **extra)


@pytest.mark.parametrize("bad", [dict(kv_split=0), dict(kv_split=-64),
                                 dict(kv_split=1025), dict(kv_split=4096),
                                 dict(gemv_threads=0), dict(gemv_threads=48),
                                 dict(gemv_threads=1024)],
                         ids=lambda d: "-".join(f"{k}{v}" for k, v in
                                                d.items()))
def test_verify_wrapper_refuses_bad_kcfg(mha, bad):
    """Kernel 8 takes what kernel 7 takes of the KernelConfig (kv_split in
    [1, 1024], gemv_threads a multiple of 32 in [32, 992], the ring GEMV's
    consumers); anything else is refused on the CPU too, before any work."""
    cfg = mha["tcfg"]
    kc, vc = mha["kc"].clone(), mha["vc"].clone()
    lw = mha["tp"]["layers"]
    cos, sin = tmodel.rope_rows(cfg, PROMPT, 2)
    with pytest.raises(ValueError):
        sv.fused_verify_stack(
            mha["tp"]["embed"][:2], lw["attn_norm"], lw["ffn_norm"], cos, sin,
            lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc, vc, PROMPT,
            group=1, head_dim=128, rope_style="gptj", eps=1e-5,
            kcfg=KernelConfig(**bad))
    assert torch.equal(kc, mha["kc"]) and torch.equal(vc, mha["vc"])


@pytest.mark.parametrize("style", ["gptj", "neox"])
def test_rope_rows_are_rows_of_the_table(style):
    cfg = LlamaConfig.tiny(rope_style=style)
    tc, ts = tmodel.rope_table(cfg)
    for pos, n in ((0, 1), (45, 8), (cfg.max_seq_len - 5, 5)):
        c, s = tmodel.rope_rows(cfg, pos, n)
        assert torch.equal(c, tc[pos:pos + n]) and torch.equal(s, ts[pos:pos + n])


def _top2_gap(logits):
    s = torch.sort(logits.float()).values
    return float(s[-1] - s[-2])


def _check_greedy(tp, cfg, prompt, stream):
    """``stream`` (the successors of the prompt) must be the target's greedy
    stream: teacher-forced one-row verify steps along it give its token
    wherever their top-2 gap exceeds GAP.  Returns how many places the rule
    bound."""
    kc, vc = tmodel.init_cache(cfg, device="cpu")
    lg, kc, vc = tmodel.prefill(tp, kc, vc, prompt, cfg)
    lg = lg[-1]
    bound = 0
    for i, t in enumerate(stream):
        if _top2_gap(lg) > GAP:
            bound += 1
            assert int(torch.argmax(lg)) == t, (i, stream)
        elif int(torch.argmax(lg)) != t:
            break          # past a legitimate divergence the streams differ
        lg, kc, vc = tspec.verify_step(tp, kc, vc, [t], len(prompt) + i, cfg)
        lg = lg[0]
    return bound


@pytest.mark.parametrize("draft", ["self", "bad"])
def test_spec_decode_loop_is_greedy(mha, draft):
    """Whatever the draft proposes, the flattened stream is the target's
    own greedy stream; a self-draft accepts every draft (but at a near-tie
    between the one-row stack and the n-row verify), a bad draft emits at
    least the bonus token per round."""
    cfg, tp = mha["tcfg"], mha["tp"]
    dp = tp if draft == "self" else tmodel.init_params(cfg, seed=99,
                                                       device="cpu")
    prompt = [5, 17, 42, 9]
    n_draft, n_rounds = 3, 4
    kc, vc = tmodel.init_cache(cfg, device="cpu")
    lg, _, _ = tmodel.prefill(tp, kc, vc, prompt, cfg)
    kd, vd = tmodel.init_cache(cfg, device="cpu")
    tmodel.prefill(dp, kd, vd, prompt, cfg)
    first = torch.argmax(lg[-1])
    targets, counts, *_ = tspec.spec_decode_loop(
        tp, kc, vc, dp, kd, vd, first, len(prompt), cfg, cfg,
        n_draft=n_draft, n_rounds=n_rounds)
    assert targets.shape == (n_rounds, n_draft + 1)
    assert counts.shape == (n_rounds,) and bool((counts >= 1).all())
    if draft == "self":
        assert int(counts.sum()) >= n_rounds * n_draft, counts
    got = tspec.flatten_rounds(targets, counts)
    assert len(got) == int(counts.sum())
    assert tspec.flatten_rounds(targets, counts, 3) == got[:3]
    assert _check_greedy(tp, cfg, prompt, [int(first)] + got) >= 4


def test_spec_generate_matches_stream_and_jax():
    """Llama.spec_generate: the port's stream_generate(temperature=0) and
    JAX's spec_generate on the same weights, under the top-2-gap rule, with
    the same cache budget (the same number of tokens), and the same stream
    for any rounds_per_dispatch."""
    jcfg, tcfg = JConfig.tiny(max_seq_len=64), LlamaConfig.tiny(max_seq_len=64)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(6))
    jdp = jmodel.init_params(jcfg, jax.random.PRNGKey(7))
    jt = JLlama(jp, jcfg, JByteTokenizer(), fused=False)
    jd = JLlama(jdp, jcfg, JByteTokenizer(), fused=False)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tdp = params_from_numpy(jax.tree.map(np.asarray, jdp), device="cpu")
    tt = Llama(tp, tcfg, ByteTokenizer(), fused=True)
    td = Llama(tdp, tcfg, ByteTokenizer(), fused=True)
    prompt = [2, 7, 18, 28] + list(range(30, 70))     # 44 tokens
    # the budget binds: max_seq_len 64 leaves room for 20 tokens at most
    want_j = jt.spec_generate(prompt, 30, jd, n_draft=3)
    got = tt.spec_generate(prompt, 30, td, n_draft=3)
    assert tt.spec_stats["tokens"] == len(got) == len(want_j)
    assert tt.spec_stats["rounds"] == len(tt.spec_stats["round_counts"]) >= 1
    assert len(got) < 30
    stream = list(tt.stream_generate(prompt, len(got), temperature=0.0))
    assert _check_greedy(tp, tcfg, prompt, got) >= 4
    for other in (stream, want_j):
        # the streams may part only where the target's top-2 gap is small
        i = next((i for i, (a, b) in enumerate(zip(got, other)) if a != b),
                 None)
        if i is not None:
            assert _top2_gap_at(tp, tcfg, prompt, got[:i]) <= GAP, \
                (i, got, other)
    assert tt.spec_generate(prompt, 30, td, n_draft=3,
                            rounds_per_dispatch=2) == got


def _top2_gap_at(tp, cfg, prompt, prefix):
    """The target's top-2 gap predicting the token after prompt + prefix."""
    kc, vc = tmodel.init_cache(cfg, device="cpu")
    lg, _, _ = tmodel.prefill(tp, kc, vc, list(prompt) + list(prefix), cfg)
    return _top2_gap(lg[-1])


def test_spec_generate_stops_at_eos(mha):
    cfg, tp = mha["tcfg"], mha["tp"]
    eng = Llama(tp, cfg, ByteTokenizer(), fused=True)
    prompt = [5, 17, 42]
    full = list(eng.stream_generate(prompt, 10, temperature=0.0))
    eng.tokenizer.eos_id = full[4]
    stop = full.index(full[4]) + 1
    got = eng.spec_generate(prompt, 10, eng, n_draft=3)
    assert got == full[:stop] and got[-1] == eng.tokenizer.eos_id
    assert eng.spec_stats["tokens"] == stop


def test_chat_cli_spec_draft(capsys):
    from clusterfusion_tpu_torch import chat
    chat.main(["--synthetic", "--spec_draft", "synthetic", "--n_draft", "3",
               "--device", "cpu", "--max_gen_len", "6", "--max_seq_len", "64"])
    out = capsys.readouterr().out
    assert "spec n_draft=3" in out and "rounds" in out and \
        "drafts accepted" in out and "tokens/sec" in out
    with pytest.raises(SystemExit, match="not yet ported"):
        chat.main(["--synthetic", "--spec_draft", "/some/draft/dir"])
