"""The port's serving layer against the JAX package's, on the CPU, at
``LlamaConfig.tiny(max_seq_len=64)``: the C++ page scheduler, the
continuous-batching ``ServingEngine`` (both step impls, staggered
submission, queue overflow, recompute preemption, chunked prefill,
logprobs, cancel/stats, the watchdog) and ``Llama.generate`` /
``text_completion`` / ``chat_completion``.

One JAX parameter tree crosses to the port through ``params_from_numpy``.
JAX's paged kernels run in interpret mode, the port's wrappers their plain
twins.  Greedy tokens follow ``test_torch_model.py``'s rule: wherever the
top-2 logit gap exceeds 0.05 the port must pick JAX's token, up to the
first legitimate divergence; the gaps are those of the float32 eager path
teacher-forced along JAX's tokens.  Logprobs of generated tokens agree to
atol 2e-2 on the agreed prefix; prompt-token logprobs, which reach -9 for
the unlikely tokens of a random-weight model, to atol 2e-2 + rtol 1e-2
(a bf16 rounding of the hidden state moves a logit by a relative amount).
"""

import jax
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import LlamaConfig as JConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu.models.generation import Llama as JLlama
from clusterfusion_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from clusterfusion_tpu.runtime.native import PagedKVScheduler as JScheduler
from clusterfusion_tpu.runtime.serving import ServingEngine as JEngine
from clusterfusion_tpu_torch.config import LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.models.generation import Llama
from clusterfusion_tpu_torch.models.sampling import sample_batch
from clusterfusion_tpu_torch.models.tokenizer import ByteTokenizer
from clusterfusion_tpu_torch.runtime import (EngineHealthError,
                                             PagedKVScheduler, ServingEngine)
from clusterfusion_tpu_torch.runtime import serving as tserving

JCFG = JConfig.tiny(max_seq_len=64)
TCFG = LlamaConfig.tiny(max_seq_len=64)
GAP = 0.05
LP_TOL = 2e-2
_gaps_seen = []


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _gaps(tp, prompt, tokens, kv_dtype=torch.bfloat16, cfg=TCFG):
    """Top-2 logit gaps of the float32 eager path of ``cfg`` at each of
    ``tokens``, teacher-forced along them, on a cache of ``kv_dtype``."""
    kc, vc = tmodel.init_cache(cfg, device="cpu", dtype=kv_dtype)
    lg, kc, vc = tmodel.prefill(tp, kc, vc, prompt, cfg, flash=False)
    lg, gaps = lg[-1], []
    for i, t in enumerate(tokens):
        top = torch.topk(lg, 2).values
        gaps.append(float(top[0] - top[1]))
        if i + 1 < len(tokens):
            lg, kc, vc = tmodel.decode_step(tp, kc, vc, t, len(prompt) + i,
                                            cfg, fused=False)
    _gaps_seen.extend(gaps)
    return gaps


def _rule_bites():
    """Most steps compared since the last call had a gap above the rule's
    threshold, so the comparison was not vacuous."""
    gaps = list(_gaps_seen)
    _gaps_seen.clear()
    assert sum(g > GAP for g in gaps) >= 0.5 * len(gaps) > 0, gaps


def _agreed(tp, prompt, t_toks, j_toks, kv_dtype=torch.bfloat16, cfg=TCFG):
    """Length of the prefix the rule holds the port to; asserts it."""
    assert len(t_toks) == len(j_toks), (t_toks, j_toks)
    gaps = _gaps(tp, prompt, j_toks, kv_dtype, cfg)
    for i, (a, b) in enumerate(zip(t_toks, j_toks)):
        if gaps[i] > GAP:
            assert a == b, (i, t_toks, j_toks, gaps)
        if a != b:
            return i
    return len(j_toks)


def _check_engines(tp, prompts, t_res, j_res, logprobs=False,
                   kv_dtype=torch.bfloat16):
    for rid, prompt in prompts.items():
        t, j = t_res[rid], j_res[rid]
        n = _agreed(tp, prompt, t.generated, j.generated, kv_dtype)
        if logprobs:
            np.testing.assert_allclose(t.logprobs[:n], j.logprobs[:n],
                                       atol=LP_TOL)
            np.testing.assert_allclose(t.prompt_logprobs, j.prompt_logprobs,
                                       atol=LP_TOL, rtol=1e-2)


# -- the page scheduler --------------------------------------------------------


@pytest.mark.parametrize("window", [0, 9], ids=["full", "window9"])
def test_scheduler_matches_jax(window):
    """One seeded trace of add / prepare / commit / discard / release on
    both schedulers: every output identical."""
    rng = np.random.RandomState(window)
    scheds = [S(num_pages=12, page_size=4, max_pages_per_req=6)
              for S in (PagedKVScheduler, JScheduler)]
    if window:
        assert scheds[0].set_window(window) == scheds[1].set_window(window)
    live, next_id = [], 0
    for _ in range(300):
        op = rng.choice(["add", "prepare", "commit", "discard", "release"],
                        p=[0.2, 0.35, 0.3, 0.05, 0.1])
        if op == "add":
            n = int(rng.randint(0, 30))
            outs = []
            for s in scheds:
                try:
                    s.add(next_id, n)
                    outs.append("ok")
                except ValueError:
                    outs.append("refused")
            assert outs[0] == outs[1]
            if outs[0] == "ok":
                live.append(next_id)
            next_id += 1
        elif op == "prepare":
            mb = int(rng.randint(1, 5))
            a, b = (s.prepare_batch(mb) for s in scheds)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif op == "release" and live:
            rid = live.pop(int(rng.randint(len(live))))
            for s in scheds:
                s.release(rid)
        elif op in ("commit", "discard"):
            for s in scheds:
                getattr(s, op + "_batch")()
        assert scheds[0].free_pages == scheds[1].free_pages
        assert scheds[0].num_requests == scheds[1].num_requests
        for rid in live:
            assert scheds[0].request_len(rid) == scheds[1].request_len(rid)
            if scheds[0].request_len(rid) >= 0:
                np.testing.assert_array_equal(scheds[0].request_pages(rid),
                                              scheds[1].request_pages(rid))


# -- the decode steps and the engine -----------------------------------------


def test_serving_step_impls_agree(params, monkeypatch):
    """The batched step and the fused step give the same logits (to bf16
    rounding), the same tokens wherever the top-2 gap exceeds the rule's
    threshold, and, to bf16 rounding, the same pools."""
    _, tp = params
    B, page, P, num_pages = 3, 8, 8, 32
    rng = np.random.RandomState(0)
    shape = (TCFG.n_layers, num_pages, TCFG.kv_heads, page, TCFG.head_dim_)
    kp = torch.from_numpy(rng.randn(*shape)).bfloat16()
    vp = torch.from_numpy(rng.randn(*shape)).bfloat16()
    table = torch.arange(1, 1 + B * P, dtype=torch.int32).reshape(B, P)
    lens = torch.tensor([11, 5, 16], dtype=torch.int32)
    toks = torch.tensor([3, 9, 1])
    rope = tmodel.rope_table(TCFG)
    logits = []

    def keep_logits(lg, *a):
        logits.append(lg)
        return sample_batch(lg, *a)

    monkeypatch.setattr(tserving, "sample_batch", keep_logits)
    outs = {}
    for name, impl in (("fused", tserving._paged_decode_step),
                       ("batched", tserving._paged_decode_step_batched)):
        k2, v2 = kp.clone(), vp.clone()
        nxt, lp = impl(tp, k2, v2, toks, lens, table, lens, None,
                       np.zeros(B), np.full(B, 0.9), TCFG, rope)
        assert nxt.shape == (B,) and torch.isfinite(lp).all()
        outs[name] = (nxt, k2.float())
    assert (logits[0] - logits[1]).abs().max() < 0.1
    top = torch.topk(logits[1], 2, dim=-1).values
    sure = (top[:, 0] - top[:, 1]) > GAP
    assert sure.sum() >= 2
    assert torch.equal(outs["fused"][0][sure], outs["batched"][0][sure])
    torch.testing.assert_close(outs["fused"][1], outs["batched"][1],
                               atol=0.06, rtol=0)


@pytest.mark.parametrize("impl", ["batched", "fused"])
def test_engine_matches_jax(params, impl):
    """Three requests, one submitted mid-flight, with logprobs on one."""
    jp, tp = params
    prompts = {0: [1, 2, 3], 1: [4, 5, 6, 7, 8, 9, 10], 2: [11, 12, 13, 14]}
    res, stats = [], []
    for Eng, p in ((ServingEngine, tp), (JEngine, jp)):
        eng = Eng(p, TCFG if Eng is ServingEngine else JCFG, page_size=8,
                  num_pages=64, max_batch=4, step_impl=impl)
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
    assert len(res[0][0].logprobs) == 6 and len(res[0][2].generated) == 3
    _check_engines(tp, prompts, res[0], res[1])
    n = _agreed(tp, prompts[0], res[0][0].generated, res[1][0].generated)
    np.testing.assert_allclose(res[0][0].logprobs[:n], res[1][0].logprobs[:n],
                               atol=LP_TOL)
    _rule_bites()


def test_engine_overflow_and_preemption_match_jax(params):
    """Three usable pages for four requests: the fourth waits in the queue,
    and crossing the first page boundary preempts the newest running
    request, which is re-prefilled from prompt + generated[:-1]."""
    jp, tp = params
    prompts = {0: [1, 2, 3], 1: [4, 5, 6], 2: [7, 8], 3: [9, 10, 11, 12]}
    res = []
    readmitted = []
    for Eng, p, cfg in ((ServingEngine, tp, TCFG), (JEngine, jp, JCFG)):
        eng = Eng(p, cfg, page_size=8, num_pages=4, max_batch=4,
                  max_pages_per_req=3)
        if Eng is ServingEngine:
            orig = eng.sched.prepare_batch

            def spy(mb, eng=eng, orig=orig):
                out = orig(mb)
                for i, f in zip(out[0], out[4]):
                    if f and eng._reqs[int(i)].generated:
                        readmitted.append(int(i))
                return out

            eng.sched.prepare_batch = spy
        for rid, pr in prompts.items():
            eng.submit(rid, pr, max_gen_len=8, temperature=0.0)
        eng.run()
        res.append(eng.last_results)
    assert readmitted, "the pool geometry no longer forces a preemption"
    assert all(len(r.generated) == 8 for r in res[0].values())
    _check_engines(tp, prompts, res[0], res[1])
    _rule_bites()


def test_chunked_prefill_matches_jax(params):
    """A 41-token prompt prefilled in chunks of 16 (flash prefill with
    q_offset), prompt logprobs from every chunk, on the fused step."""
    jp, tp = params
    prompts = {0: [int(x) for x in (np.arange(41) * 11 + 3) % 384],
               1: [7, 8, 9]}
    res = []
    for Eng, p, cfg in ((ServingEngine, tp, TCFG), (JEngine, jp, JCFG)):
        eng = Eng(p, cfg, page_size=8, num_pages=64, max_batch=4,
                  prefill_chunk=16, step_impl="fused")
        for rid, pr in prompts.items():
            eng.submit(rid, pr, max_gen_len=3, temperature=0.0, logprobs=True)
        eng.run()
        res.append(eng.last_results)
    assert len(res[0][0].prompt_logprobs) == 41
    _check_engines(tp, prompts, res[0], res[1], logprobs=True)
    _rule_bites()


def test_cancel_and_stats(params):
    _, tp = params
    eng = ServingEngine(tp, TCFG, page_size=8, num_pages=32, max_batch=4)
    eng.submit(0, [1, 2, 3], max_gen_len=10, temperature=0.0)
    eng.submit(1, [4, 5], max_gen_len=10, temperature=0.0)
    for _ in range(2):
        assert eng.step()
    st = eng.stats()
    assert st["active"] == 2 and st["free_pages"] < st["total_pages"]
    assert len(eng.cancel(0)) >= 1
    with pytest.raises(KeyError):
        eng.cancel(0)
    out = eng.run()
    assert 0 not in out and len(out[1]) == 10
    assert eng.stats() == {"free_pages": 31, "total_pages": 31,
                           "requests": 0, "active": 0, "failed": 0}


def test_watchdog_nan_weights_trip_the_breaker(params):
    """NaN weights fail every row; three fully failed steps in a row raise
    EngineHealthError."""
    _, tp = params
    bad = dict(tp, lm_head=torch.full_like(tp["lm_head"], float("nan")))
    eng = ServingEngine(bad, TCFG, page_size=8, num_pages=64, max_batch=4)
    eng.submit(0, [1, 2, 3], max_gen_len=50, temperature=0.0)
    steps = 0
    with pytest.raises(EngineHealthError):
        for i in range(10):
            steps += 1
            if not eng.step():
                eng.submit(100 + i, [1, 2, 3], max_gen_len=50,
                           temperature=0.7)
    assert eng.stats()["failed"] >= eng.max_bad_steps
    assert all("numeric watchdog" in r.error for r in eng._reqs.values()
               if r.error)


def test_prefill_fault_is_isolated(params, monkeypatch):
    _, tp = params
    real = tmodel.prefill

    def flaky(params, kc, vc, toks, cfg, **kw):
        if toks[0] == 99:
            raise ValueError("injected prefill fault")
        return real(params, kc, vc, toks, cfg, **kw)

    monkeypatch.setattr(tmodel, "prefill", flaky)
    eng = ServingEngine(tp, TCFG, page_size=8, num_pages=64, max_batch=4)
    eng.submit(0, [99, 2, 3], max_gen_len=4, temperature=0.0)
    eng.submit(1, [4, 5, 6], max_gen_len=4, temperature=0.0)
    out = eng.run()
    r0, r1 = eng.last_results[0], eng.last_results[1]
    assert "injected prefill fault" in r0.error and out[0] == []
    assert r1.error is None and len(r1.generated) == 4
    assert eng.stats()["free_pages"] == 63


@pytest.mark.parametrize("cfg_kw", [
    dict(sliding_window=16, window_pattern="even"),
    dict(attn_logit_softcap=50.0),
    dict(final_logit_softcap=30.0), dict(qkv_bias=True),
    dict(sandwich_norms=True), dict(ffn_act="gelu_tanh")])
def test_engine_refuses_unported_configs(params, cfg_kw):
    _, tp = params
    with pytest.raises(NotImplementedError):
        ServingEngine(tp, LlamaConfig.tiny(max_seq_len=64, **cfg_kw))


def test_engine_refuses_unported_pools_and_weights(params):
    _, tp = params
    for dt in (torch.float16, torch.int8):         # fp8 pools are served
        with pytest.raises(NotImplementedError):
            ServingEngine(tp, TCFG, kv_dtype=dt)
    q8 = dict(tp, layers=dict(tp["layers"],
                              wqkv_f=tp["layers"]["wqkv_f"].to(torch.int8)))
    with pytest.raises(NotImplementedError):
        ServingEngine(q8, TCFG)
    with pytest.raises(ValueError):
        ServingEngine(tp, TCFG, step_impl="other")
    with pytest.raises(ValueError):
        ServingEngine(tp, TCFG, prefill_chunk=24)
    eng = ServingEngine(tp, TCFG)
    with pytest.raises(ValueError):
        eng.submit(0, [], 4)


def test_head_dim_64_routes_to_fused():
    cfg = LlamaConfig.tiny(max_seq_len=64, head_dim=64)
    p = tmodel.init_params(cfg, seed=1, device="cpu")
    assert ServingEngine(p, cfg, step_impl="batched").step_impl == "fused"


# -- generation entry points ---------------------------------------------------


@pytest.fixture(scope="module")
def llamas(params):
    jp, tp = params
    return (Llama(tp, TCFG, ByteTokenizer(), fused=True),
            JLlama(jp, JCFG, JByteTokenizer(), fused=True))


def test_generate_matches_jax(params, llamas):
    _, tp = params
    teng, jeng = llamas
    prompts = [[256, 104, 105], [256, 1, 2, 3, 4, 5, 6, 7, 8, 9], [256, 77]]
    t_toks, t_lp = teng.generate(prompts, 5, temperature=0.0, logprobs=True,
                                 echo=True)
    j_toks, j_lp = jeng.generate(prompts, 5, temperature=0.0, logprobs=True,
                                 echo=True)
    assert teng.stats.prompt_tokens == sum(len(p) for p in prompts)
    for p, t, j, tl, jl in zip(prompts, t_toks, j_toks, t_lp, j_lp):
        assert t[:len(p)] == p and len(tl) == len(t)
        n = _agreed(tp, p, t[len(p):], j[len(p):])
        np.testing.assert_allclose(tl[:len(p) + n], jl[:len(p) + n],
                                   atol=LP_TOL, rtol=1e-2)   # prompt's too
    # one prompt: the fused step (llama_decoder_layer_paged)
    (t1,), _ = teng.generate(prompts[:1], 6, temperature=0.0)
    (j1,), _ = jeng.generate(prompts[:1], 6, temperature=0.0)
    _agreed(tp, prompts[0], t1, j1)
    _rule_bites()


def test_text_and_chat_completion_match_jax(params, llamas):
    _, tp = params
    teng, jeng = llamas
    texts = ["hello", "the cat sat"]
    t_out = teng.text_completion(texts, temperature=0.0, max_gen_len=4,
                                 logprobs=True)
    j_out = jeng.text_completion(texts, temperature=0.0, max_gen_len=4,
                                 logprobs=True)
    dialog = [{"role": "system", "content": "be brief"},
              {"role": "user", "content": "hi"}]
    t_chat = teng.chat_completion([dialog], temperature=0.0, max_gen_len=4,
                                  logprobs=True)
    j_chat = jeng.chat_completion([dialog], temperature=0.0, max_gen_len=4,
                                  logprobs=True)
    assert t_chat[0]["generation"]["role"] == "assistant"
    prompts = [teng.tokenizer.encode(s, bos=True, eos=False) for s in texts]
    prompts.append(teng._encode_dialog(dialog))
    j_ids, _ = jeng.generate(prompts[:2], 4, temperature=0.0)
    j_ids += jeng.generate(prompts[2:], 4, temperature=0.0)[0]
    for t, j, prompt, ids in zip(t_out + t_chat, j_out + j_chat, prompts,
                                 j_ids):
        gaps = _gaps(tp, prompt, ids)
        n = next((i for i, g in enumerate(gaps) if g <= GAP), len(gaps))
        assert t["tokens"][:n] == j["tokens"][:n]
        np.testing.assert_allclose(t["logprobs"][:n], j["logprobs"][:n],
                                   atol=LP_TOL)
        if n == len(gaps):
            assert t["generation"] == j["generation"]
    _rule_bites()


@pytest.mark.parametrize("dialog", [
    [{"role": "user", "content": " hi "}],
    [{"role": "system", "content": "sys"}, {"role": "user", "content": "a"}],
    [{"role": "user", "content": "a"}, {"role": "assistant", "content": "b"},
     {"role": "user", "content": "c"}],
    [{"role": "system", "content": "s"}, {"role": "user", "content": "a"},
     {"role": "assistant", "content": " b "}, {"role": "user", "content": "c"}],
], ids=["user", "system", "turns", "system_turns"])
def test_encode_dialog_matches_jax(llamas, dialog):
    teng, jeng = llamas
    assert teng._encode_dialog(dialog) == jeng._encode_dialog(dialog)


def test_encode_dialog_refuses_bad_dialogs(llamas):
    teng, _ = llamas
    for bad in ([], [{"role": "assistant", "content": "x"}],
                [{"role": "user", "content": "a"},
                 {"role": "assistant", "content": "b"}]):
        with pytest.raises(ValueError):
            teng._encode_dialog(bad)


def test_sample_batch_mixes_greedy_and_nucleus_rows():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(4, 50).astype(np.float32) * 2)
    temps, tops = [0.0, 1.0, 0.0, 1.0], [0.9, 0.8, 0.9, 0.0]
    greedy = logits.argmax(-1)
    probs = torch.softmax(logits[1], -1)
    order = torch.argsort(probs, descending=True)
    mass_before = torch.cumsum(probs[order], 0) - probs[order]
    nucleus = set(order[mass_before <= 0.8].tolist())
    seen = set()
    gen = torch.Generator().manual_seed(1)
    for _ in range(200):
        out = sample_batch(logits, temps, tops, gen)
        assert out.dtype == torch.long and out.shape == (4,)
        assert out[0] == greedy[0] and out[2] == greedy[2]
        assert out[3] == greedy[3]            # top_p 0 keeps the first token
        seen.add(int(out[1]))
    assert seen <= nucleus and len(seen) > 1
    a = sample_batch(logits, temps, tops, torch.Generator().manual_seed(5))
    b = sample_batch(logits, temps, tops, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert torch.equal(sample_batch(logits, [0.0] * 4, tops), greedy)
