"""Mistral's sliding window in the port's serving kernels 9 and 10, its
rolling page buffer and the serving entries around them, on the CPU,
against the JAX package.

Geometry: JAX's ``tests/test_window.py`` serving config,
``LlamaConfig.tiny(max_seq_len=64, sliding_window=12)`` (4 heads of 128, 2
layers), and a GQA variant on 2 kv heads; one JAX parameter tree of each
crosses to the port through ``params_from_numpy``.  JAX's paged kernels run
in interpret mode, the port's wrappers their plain twins.

- the twins of kernels 10 (``paged_attention``) and 9
  (``llama_decoder_layer_paged``) against JAX's kernels with ``window=w``,
  at ``tests/test_torch_paged.py``'s TOL (atol/rtol 2e-2; appended rows of
  kernel 10 exact), lens 5, 20 and 37, page 8, windows 1, 12 (its bound
  inside a page) and 30, over a block table whose slots wholly below the
  window hold the NULL page 0, as the rolling buffer leaves them; JAX's
  windowed output lies more than twice TOL from its window-0 output on the
  same inputs, so a port that dropped the window would miss;
- NaN in page 0 and in every row below each request's bound leaves the
  twins' outputs finite and equal, bit for bit, to those over finite rows;
  a window past row 0 (max(lens) + 1) gives window 0's bits;
- ``ServingEngine`` against JAX's ``ServingEngine`` on
  ``test_window_serving_matches_single_seq``'s two prompts (20 and 3
  tokens, 4 new each), both step kinds, then GQA batched, int8 batched,
  int4 fused and an fp8 pool, under ``tests/test_torch_serving.py``'s rule
  (wherever the top-2 gap of the port's windowed eager path, teacher-
  forced along JAX's tokens, exceeds 0.05 the tokens agree, up to the first
  legitimate divergence); a recompute preemption under the rolling buffer;
  ``Llama.generate`` and the completions;
- the rolling buffer: ``test_rolling_buffer_scheduler``'s sequence on the
  port's ``set_window_pages(2)`` beside JAX's scheduler (tables and free
  counts equal), the unsafe cap refused; the capacity run of
  ``test_rolling_buffer_serving_capacity`` (5 pages where full context
  needs 6), each token within 0.02 x scale of the argmax of JAX's windowed
  decode step fed the same prefix;
- what stays refused: both tp steps, the sp step, kernel 7's mode 5, and
  Gemma-2's ``"even"`` pattern in the engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import KernelConfig as JKernelConfig
from clusterfusion_tpu.config import LlamaConfig as JConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu.models.generation import Llama as JLlama
from clusterfusion_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from clusterfusion_tpu.ops import paged_decoder_layer as jpd
from clusterfusion_tpu.ops import quant as jq
from clusterfusion_tpu.runtime.native import PagedKVScheduler as JScheduler
from clusterfusion_tpu.runtime.serving import ServingEngine as JEngine
from clusterfusion_tpu_torch.config import LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.models.generation import Llama
from clusterfusion_tpu_torch.models.tokenizer import ByteTokenizer
from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
from clusterfusion_tpu_torch.runtime import PagedKVScheduler, ServingEngine

from test_torch_paged import TOL, _check_pools, _np, _pair, _paged_setup, \
    _rope_tables
from test_torch_serving import GAP, _agreed, _gaps, _gaps_seen, _rule_bites

WINDOW = 12
LENS, PAGE = [5, 20, 37], 8
FP8 = torch.float8_e4m3fn


@pytest.fixture(scope="module", autouse=True)
def _fresh_gaps():
    """The rule's record of gaps starts empty for this module (another
    module in the same worker may leave some)."""
    _gaps_seen.clear()


def _cfgs(**kw):
    kw = dict(max_seq_len=64, sliding_window=WINDOW, **kw)
    return JConfig.tiny(**kw), LlamaConfig.tiny(**kw)


# ---- kernels 9 and 10: the twins against JAX's kernels ---------------------

def _wlo(n, window):
    return max(0, n + 1 - window) if window else 0


def _rolled(table, lens, window):
    """The rolling buffer's table: slots wholly below each request's window
    bound hold the NULL page 0."""
    t = table.copy()
    for b, n in enumerate(lens):
        t[b, :_wlo(n, window) // PAGE] = 0
    return t


def _nan_below(pool, table, lens, window):
    """A copy of ``pool`` [L, pages, kv, page, hd] with NaN in page 0 and
    in every request's rows below its window bound, in every layer."""
    pool = pool.copy()
    pool[:, 0] = np.nan
    for b, n in enumerate(lens):
        for j in range(_wlo(n, window)):
            pool[:, table[b, j // PAGE], :, j % PAGE] = np.nan
    return pool


def _told_apart(windowed, full):
    """JAX's windowed result lies more than twice TOL from its window-0
    result on the same inputs somewhere."""
    w, f = _np(windowed), _np(full)
    far = np.abs(w - f) > 2 * (TOL["atol"] + TOL["rtol"] * np.abs(f))
    assert far.any(), float(np.abs(w - f).max())


def _attn_case(seed, window, kv=2, g=2, hd=128, L=2):
    rng = np.random.RandomState(seed)
    kp, vp, table, lens = _paged_setup(rng, L, kv, PAGE, hd, LENS)
    B = len(LENS)
    return dict(kp=kp, vp=vp, table=_rolled(table, lens, window), lens=lens,
                q=rng.randn(B, kv, g, hd), k=rng.randn(B, kv, hd),
                v=rng.randn(B, kv, hd))


def _port_attention(c, window, kp=None, vp=None, dtype=torch.bfloat16):
    """The port's kernel 10 (its twin here) on case ``c``: (o, k_pool,
    v_pool)."""
    tk, tv = (_pair(x)[1].to(dtype) for x in (
        c["kp"] if kp is None else kp, c["vp"] if vp is None else vp))
    q, k, v = (_pair(c[n])[1] for n in ("q", "k", "v"))
    return pd.paged_attention(q, k, v, tk, tv, torch.from_numpy(c["table"]),
                              torch.from_numpy(c["lens"]), 1, window=window)


@pytest.mark.parametrize("window", [1, 12, 30])
def test_paged_attention_window_matches_jax(window):
    c = _attn_case(20, window)
    layer = 1
    jq_, jk, jv, jkp, jvp = (_pair(c[n])[0] for n in ("q", "k", "v", "kp",
                                                      "vp"))
    jtable, jlens = jnp.asarray(c["table"]), jnp.asarray(c["lens"])

    def run_jax(w):
        return jpd.paged_attention(jq_, jk, jv, jkp, jvp, jtable, jlens,
                                   layer, kcfg=JKernelConfig(kv_chunk=16),
                                   window=w)

    jo, jkp2, jvp2 = run_jax(window)
    to, tkp, tvp = _port_attention(c, window)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    tk_in, tv_in = (_pair(c[n])[1] for n in ("kp", "vp"))
    _check_pools(tkp, jkp2, tk_in, c["table"], c["lens"], layer, exact=True)
    _check_pools(tvp, jvp2, tv_in, c["table"], c["lens"], layer, exact=True)
    _told_apart(jo, run_jax(0)[0])


def _layer_case(seed, window, kv=2, g=2, hd=128, hidden=256, L=2):
    rng = np.random.RandomState(seed)
    kp, vp, table, lens = _paged_setup(rng, L, kv, PAGE, hd, LENS)
    B = len(LENS)
    cos, sin = _rope_tables(hd, max_pos=64)
    return dict(
        kp=kp, vp=vp, table=_rolled(table, lens, window), lens=lens,
        x=rng.randn(B, hidden), res=rng.randn(B, hidden),
        wq=rng.randn(L, kv, hidden, (g + 2) * hd) * hidden ** -0.5,
        wo=rng.randn(L, kv, g * hd, hidden) * (kv * g * hd) ** -0.5,
        rms=1 + 0.1 * rng.randn(1, hidden), cos=cos, sin=sin, g=g)


def _port_layer(c, window, kp=None, vp=None, dtype=torch.bfloat16):
    """The port's kernel 9 (its twin here) on case ``c``: (out, res_out,
    k_pool, v_pool)."""
    tk, tv = (_pair(x)[1].to(dtype) for x in (
        c["kp"] if kp is None else kp, c["vp"] if vp is None else vp))
    t = {n: _pair(c[n])[1] for n in ("x", "res", "wq", "wo", "rms")}
    lens = torch.from_numpy(c["lens"])
    return pd.llama_decoder_layer_paged(
        t["x"], t["res"], t["wq"], t["wo"], torch.from_numpy(c["table"]),
        lens, lens, tk, tv, 1, t["rms"], 1e-5, torch.from_numpy(c["cos"]),
        torch.from_numpy(c["sin"]), group=c["g"], rope_style="neox",
        window=window)


@pytest.mark.parametrize("window", [1, 12, 30])
def test_paged_layer_window_matches_jax(window):
    c = _layer_case(21, window)
    layer = 1
    j = {n: _pair(c[n])[0] for n in ("x", "res", "wq", "wo", "rms", "kp",
                                     "vp")}
    jtable, jlens = jnp.asarray(c["table"]), jnp.asarray(c["lens"])

    def run_jax(w):
        return jpd.llama_decoder_layer_paged(
            j["x"], j["res"], j["wq"], j["wo"], jtable, jlens, jlens, j["kp"],
            j["vp"], layer, j["rms"], 1e-5, jnp.asarray(c["cos"]),
            jnp.asarray(c["sin"]), group=c["g"], rope_style="neox", window=w)

    jout = run_jax(window)
    tout = _port_layer(c, window)
    for i in (0, 1):
        np.testing.assert_allclose(_np(tout[i]), _np(jout[i]), **TOL)
    tk_in, tv_in = (_pair(c[n])[1] for n in ("kp", "vp"))
    _check_pools(tout[2], jout[2], tk_in, c["table"], c["lens"], layer,
                 exact=False)
    _check_pools(tout[3], jout[3], tv_in, c["table"], c["lens"], layer,
                 exact=False)
    _told_apart(jout[0], run_jax(0)[0])


@pytest.mark.parametrize("kernel", ["attention", "layer"])
@pytest.mark.parametrize("pool", ["bf16", "fp8"])
def test_window_twins_never_read_below_the_bound(kernel, pool):
    """NaN in page 0 and in every row below each request's bound: the
    output is finite and equal, bit for bit, to the output over finite
    rows, and so are the appended rows."""
    dtype = FP8 if pool == "fp8" else torch.bfloat16
    case, run = ((_attn_case, _port_attention) if kernel == "attention"
                 else (_layer_case, _port_layer))
    c = case(22, WINDOW)
    clean = run(c, WINDOW, dtype=dtype)
    dirty = run(c, WINDOW, _nan_below(c["kp"], c["table"], c["lens"],
                                      WINDOW),
                _nan_below(c["vp"], c["table"], c["lens"], WINDOW),
                dtype=dtype)
    o_clean, o_dirty = clean[0], dirty[0]
    assert torch.isfinite(o_dirty.float()).all()
    assert torch.equal(o_clean, o_dirty)
    page = PAGE
    for pc, pdirty in zip(clean[-2:], dirty[-2:]):
        for b, n in enumerate(c["lens"]):
            pg = c["table"][b, n // page]
            a = pc[1, pg, :, n % page].view(torch.uint8)
            d = pdirty[1, pg, :, n % page].view(torch.uint8)
            assert torch.equal(a, d)


@pytest.mark.parametrize("kernel", ["attention", "layer"])
def test_window_past_row_0_gives_no_window_bits(kernel):
    """Window max(lens) + 1 reaches row 0 for every request: window 0's
    output and appended rows, bit for bit; window 12 differs."""
    case, run = ((_attn_case, _port_attention) if kernel == "attention"
                 else (_layer_case, _port_layer))
    c = case(23, 0)
    none = run(c, 0)
    wide = run(c, max(LENS) + 1)
    assert torch.equal(none[0], wide[0])
    for a, b in zip(none[-2:], wide[-2:]):
        assert torch.equal(a, b)
    assert not torch.equal(run(c, WINDOW)[0], none[0])


# ---- the engine against JAX's engine ----------------------------------------

@pytest.fixture(scope="module")
def trees():
    """JAX's window-12 trees (MHA: bf16, int8, int4; GQA on 2 kv heads:
    bf16) of one seed each and the port's bridged copies."""
    out = {}
    for name, kw in (("mha", {}), ("gqa", dict(n_kv_heads=2))):
        jcfg, tcfg = _cfgs(**kw)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(13))
        kinds = {"bf16": jp}
        if name == "mha":
            kinds["int8"] = jq.quantize_llama_params(jp, "int8", 128)
            kinds["int4"] = jq.quantize_llama_params(jp, "int4", 128)
        for kind, p in kinds.items():
            out[name, kind] = (jcfg, tcfg, p, params_from_numpy(
                jax.tree.map(np.asarray, p), device="cpu"))
    return out


def _run_engines(tree, prompts, n_new, kv="bf16", **kw):
    """The port's and JAX's engines on the same requests: their results."""
    jcfg, tcfg, jp, tp = tree
    res = []
    for Eng, p, cfg, dt in ((ServingEngine, tp, tcfg,
                             FP8 if kv == "fp8" else torch.bfloat16),
                            (JEngine, jp, jcfg,
                             jnp.float8_e4m3fn if kv == "fp8"
                             else jnp.bfloat16)):
        eng = Eng(p, cfg, page_size=PAGE, kv_dtype=dt, **kw)
        for rid, pr in prompts.items():
            eng.submit(rid, pr, max_gen_len=n_new, temperature=0.0)
        eng.run()
        res.append((eng, eng.last_results))
    return res


PROMPTS = {0: list(range(1, 21)), 1: [4, 5, 6]}


@pytest.mark.parametrize("impl", ["batched", "fused"])
def test_window_engine_matches_jax(trees, impl):
    tree = trees["mha", "bf16"]
    (teng, t_res), (_, j_res) = _run_engines(tree, PROMPTS, 4, num_pages=64,
                                             max_batch=4, step_impl=impl)
    assert teng.step_impl == impl
    for rid, pr in PROMPTS.items():
        assert t_res[rid].error is None
        _agreed(tree[3], pr, t_res[rid].generated, j_res[rid].generated,
                cfg=tree[1])


@pytest.mark.parametrize("tree,impl,kv", [
    (("gqa", "bf16"), "batched", "bf16"), (("mha", "int8"), "batched", "bf16"),
    (("mha", "int4"), "fused", "bf16"), (("mha", "bf16"), "fused", "fp8")],
    ids=["gqa_batched", "int8_batched", "int4_fused", "fp8_pool_fused"])
def test_window_engine_variants_match_jax(trees, tree, impl, kv):
    tree = trees[tree]
    (teng, t_res), (_, j_res) = _run_engines(tree, PROMPTS, 4, kv=kv,
                                             num_pages=64, max_batch=4,
                                             step_impl=impl)
    assert teng.step_impl == impl
    for rid, pr in PROMPTS.items():
        _agreed(tree[3], pr, t_res[rid].generated, j_res[rid].generated,
                FP8 if kv == "fp8" else torch.bfloat16, cfg=tree[1])


def test_window_engine_preempts_and_readmits_under_the_cap(trees):
    """Five usable pages for two windowed requests, one admitted with the
    three of its cap: the other fails to grow to its third page at 16
    cached rows and is preempted, then re-admitted once the first is done
    and prefilled again from prompt + generated[:-1], past the window (a
    request never grows once it holds its cap, so it re-enters with at
    most the cap's slots); both engines give the same tokens under the
    rule."""
    tree = trees["mha", "bf16"]
    prompts = {0: [1, 2, 3], 1: list(range(7, 27))}
    readmitted = []

    class Spy(ServingEngine):
        def _prefill_into_pool(self, req):
            if req.generated:
                readmitted.append(len(req.prompt) + len(req.generated) - 1)
            return super()._prefill_into_pool(req)

    jcfg, tcfg, jp, tp = tree
    t_eng = Spy(tp, tcfg, page_size=PAGE, num_pages=6, max_batch=2)
    j_eng = JEngine(jp, jcfg, page_size=PAGE, num_pages=6, max_batch=2)
    for eng in (t_eng, j_eng):
        for rid, pr in prompts.items():
            eng.submit(rid, pr, max_gen_len=24, temperature=0.0)
        eng.run()
    assert readmitted and min(readmitted) > WINDOW
    for rid, pr in prompts.items():
        t, j = t_eng.last_results[rid], j_eng.last_results[rid]
        assert t.error is None and len(t.generated) == 24
        _agreed(tp, pr, t.generated, j.generated, cfg=tcfg)


def test_window_generate_and_completions_match_jax(trees):
    """``Llama.generate`` (both rows past the window, then one prompt on
    the fused step) and the text and chat completions, against JAX's."""
    jcfg, tcfg, jp, tp = trees["mha", "bf16"]
    teng = Llama(tp, tcfg, ByteTokenizer(), fused=True)
    jeng = JLlama(jp, jcfg, JByteTokenizer(), fused=True)
    prompts = [[256] + list(range(30, 49)), [256] + list(range(60, 75))]
    t_toks, _ = teng.generate(prompts, 5, temperature=0.0)
    j_toks, _ = jeng.generate(prompts, 5, temperature=0.0)
    for p, t, j in zip(prompts, t_toks, j_toks):
        _agreed(tp, p, t, j, cfg=tcfg)
    (t1,), _ = teng.generate(prompts[:1], 5, temperature=0.0)
    (j1,), _ = jeng.generate(prompts[:1], 5, temperature=0.0)
    _agreed(tp, prompts[0], t1, j1, cfg=tcfg)
    text = "a window of twelve tokens"
    t_out = teng.text_completion([text], temperature=0.0, max_gen_len=4,
                                 logprobs=True)
    j_out = jeng.text_completion([text], temperature=0.0, max_gen_len=4,
                                 logprobs=True)
    ids = teng.tokenizer.encode(text, bos=True, eos=False)
    assert len(ids) > WINDOW
    gaps = _gaps(tp, ids, jeng.generate([ids], 4, temperature=0.0)[0][0],
                 cfg=tcfg)
    n = next((i for i, g in enumerate(gaps) if g <= GAP), len(gaps))
    assert t_out[0]["tokens"][:n] == j_out[0]["tokens"][:n]
    dialog = [{"role": "user", "content": "say something long"}]
    chat = teng.chat_completion([dialog], temperature=0.0, max_gen_len=3)
    assert chat[0]["generation"]["role"] == "assistant"


# ---- the rolling page buffer ------------------------------------------------

def test_rolling_buffer_scheduler_matches_jax():
    """``test_rolling_buffer_scheduler``'s sequence on both schedulers with
    ``set_window_pages(2)``: the same tables and free counts at each step;
    the NULL slots, the recycled tail page and the release as JAX asserts
    them."""
    scheds = [S(num_pages=8, page_size=4, max_pages_per_req=8)
              for S in (PagedKVScheduler, JScheduler)]
    seen = [[], []]
    for i, s in enumerate(scheds):
        s.set_window_pages(2)
        s.add(1, prompt_len=13)
        out = s.prepare_batch(2)
        seen[i].append((out[0].tolist(), out[1].tolist(), out[4].tolist(),
                        s.request_pages(1).tolist(), s.free_pages))
        for _ in range(3):
            s.commit_batch()
            out = s.prepare_batch(2)
            seen[i].append((out[1].tolist(), out[2].tolist(),
                            s.request_pages(1).tolist(), s.free_pages))
        s.release(1)
        seen[i].append(s.free_pages)
    assert seen[0] == seen[1]
    first, last = seen[0][0], seen[0][-2]
    pages = first[3]
    assert len(pages) == 4 and pages[:2] == [0, 0] and all(pages[2:])
    assert first[4] == 5 and last[3] == 5 and seen[0][-1] == 7
    assert last[2][4] == pages[2] and last[2][2] == 0


def test_rolling_buffer_refuses_an_unsafe_cap():
    """A cap below ceil(window / page) + 1 would recycle a page that still
    holds rows in the window; set_window derives the safe one; neither
    takes effect once a request exists."""
    s = PagedKVScheduler(num_pages=8, page_size=4, max_pages_per_req=8)
    with pytest.raises(ValueError, match="unsafe"):
        s.set_window_pages(2, _window_tokens=6)     # needs 3
    s.set_window_pages(3, _window_tokens=6)
    assert s.set_window(6) == 3
    with pytest.raises(ValueError):
        s.set_window(0)
    s.add(1, prompt_len=3)
    with pytest.raises(ValueError):
        s.set_window_pages(3)
    with pytest.raises(ValueError):
        s.set_window(6)


def test_rolling_buffer_serving_capacity():
    """A 24-token prompt and 16 new tokens in a pool of 4 usable pages,
    where full context needs ceil(41 / 8) = 6: only the window's cap of 3
    pages lets it run, with no error; every token within 0.02 x scale of
    the argmax of JAX's windowed decode step fed the same prefix."""
    jcfg, tcfg = _cfgs()
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(14))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompt, n_gen = list(range(1, 25)), 16
    eng = ServingEngine(tp, tcfg, page_size=PAGE, num_pages=5, max_batch=2)
    eng.submit(0, prompt, max_gen_len=n_gen, temperature=0.0)
    out = eng.run()
    assert eng.last_results[0].error is None and len(out[0]) == n_gen
    kc, vc = jmodel.init_cache(jcfg)
    logits, kc, vc = jmodel.prefill(jp, kc, vc,
                                    jnp.asarray(prompt, jnp.int32), jcfg)
    lg = logits[len(prompt) - 1]
    for i, tok in enumerate(out[0]):
        gap = float(jnp.max(lg) - lg[tok])
        assert gap < 0.02 * max(float(jnp.max(jnp.abs(lg))), 1.0), (i, gap)
        lg, kc, vc = jmodel.decode_step(
            jp, kc, vc, jnp.asarray(tok, jnp.int32),
            jnp.asarray(len(prompt) + i, jnp.int32), jcfg, fused=False)


def test_window_rule_bites():
    """Most compared steps of this module had a gap above the rule's
    threshold, so the token comparisons were not vacuous."""
    _rule_bites()


# ---- what stays refused -----------------------------------------------------

def test_multi_card_paths_still_refuse_the_window():
    """Both tp steps, the sp step and kernel 7's mode 5 take the window
    (``tests/test_torch_window_parallel.py``) and refuse only Gemma-2's
    "even" pattern, which also stays refused in the engine and in both
    serving kernels."""
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import (make_sharded_decode_step,
                                                  make_sp_sharded_decode_step)
    from clusterfusion_tpu_torch.parallel.mesh import AXES, Mesh
    _, tcfg = _cfgs(n_kv_heads=2, rope_style="neox")
    mesh = Mesh(shape=dict.fromkeys(AXES, 1), coords=dict.fromkeys(AXES, 0),
                groups=dict.fromkeys(AXES))
    for fused in (False, True):
        assert callable(make_sharded_decode_step(tcfg, mesh,
                                                 fused_collectives=fused))
    assert callable(make_sp_sharded_decode_step(tcfg, mesh))
    tp = tmodel.init_params(tcfg, 0, device="cpu")
    lw = tp["layers"]
    kc, vc = tmodel.init_cache(tcfg, device="cpu")
    cos, sin = tmodel.rope_row(tcfg, 3)
    with pytest.raises(NotImplementedError, match="even"):
        sk.fused_decoder_stack(
            tp["embed"][:1], lw["attn_norm"], lw["ffn_norm"], cos, sin,
            lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc, vc, 3,
            group=2, head_dim=128, rope_style="neox", eps=1e-5, window=16,
            window_pattern="even", reduce_axis="tp", mesh=mesh)
    even = dataclasses.replace(tcfg, window_pattern="even")
    with pytest.raises(NotImplementedError, match="even"):
        ServingEngine(tp, even)
    c = _attn_case(24, 0)
    with pytest.raises(NotImplementedError, match="even"):
        pd.paged_attention(*(_pair(c[n])[1] for n in ("q", "k", "v", "kp",
                                                      "vp")),
                           torch.from_numpy(c["table"]),
                           torch.from_numpy(c["lens"]), 1, window=8,
                           window_pattern="even")
