"""Sliding-window attention (Mistral's semantics, ``window_pattern="all"``)
in the port's kernels 4, 7 and 8 and the single-card bs=1 entries, on the
CPU, against the JAX package at ``tests/test_window.py``'s tolerances.

Geometry: a tiny Mistral-shaped config, ``LlamaConfig.tiny(sliding_window=
w, n_kv_heads=2, rope_style="neox", max_seq_len=512)`` (4 heads on 2 kv
heads of 128, 2 layers), one bridged parameter tree (``params_from_numpy``)
and caches made with numpy from a seed, so both packages see the same
inputs.  On the CPU the port's wrappers run their kernels' plain twins.

- prefill, the port's flash path (kernel 4's twin) against JAX's eager
  prefill at windows 64, 130 and 1000 over 300 tokens: logits within 0.08
  of max(|logits|, 1), the K rows at atol 0.05;
- one decode step at pos 400 over a random cache (rows < 400 of N(0,
  0.25)), the port's fused step (kernel 7's twin, kv_split 64, so window
  100 starts inside a split) and its eager step against JAX's eager step at
  windows 100, 130 and 256, within 0.08 of the scale;
- a windowed prefill of 150 tokens, then 3 windowed fused steps, against
  JAX's prefill and eager steps (teacher-forced on JAX's tokens), each
  step's logits within 0.1;
- the weight x cache matrix of JAX's ``test_window_quant_kv_matrix`` (int8
  + ``Int8KV``, int4 + ``Int8KV``, int4 + fp8; 3 windowed steps at
  positions 200-202 from zero caches), the port's fused step against JAX's
  eager one, within 0.1 of the scale, finite;
- the n = 4 verify at pos 400, windows 100 and 401, the port's fused verify
  (kernel 8's twin) against JAX's eager verify within 0.025 of the scale
  (JAX's verify limit, 0.06, cannot tell window 401 from no window), the K
  rows at atol 0.08.

Each of these also runs JAX without a window on the same inputs and
asserts that JAX's windowed result lies more than twice its tolerance from
it (a window past the prompt, 1000 over 300 tokens: the same bits), so a
port that ran its window as 0 and otherwise kept to the tolerance would
miss it.  JAX compiles one prefill or step per (window, shape, tree) in
all: 19 compiles, well inside jaxlib's CPU limit of about 150 a process.  The
JAX-free tests hold the port's twins against its own float32 oracles (the
eager paths and plain masked softmaxes): a window that reaches row 0 gives
the bits of no window in all three twins; window 1 attends the current
token alone; a window that starts inside a split; a verify whose first live
split holds no live row for its later tokens (their partials fold as
nothing, no NaN); a window changes the result.  Then the multi-card
entries: both tp steps, the sp step and kernel 7's mode 5 take a window
and refuse Gemma-2's ``"even"`` pattern, which is refused everywhere.
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
from clusterfusion_tpu.models import speculative as jspec
from clusterfusion_tpu.ops import quant as jq
from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models import speculative as tspec
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.ops import stack_kernel as sk
from clusterfusion_tpu_torch.ops import stack_verify as sv
from clusterfusion_tpu_torch.ops.flash_prefill import (
    flash_prefill_attention, flash_prefill_attention_plain)

CAP, POS = 512, 400
GEOM = dict(n_kv_heads=2, rope_style="neox", max_seq_len=CAP)
FP8 = torch.float8_e4m3fn


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _cfgs(window, **kw):
    return (JConfig.tiny(sliding_window=window, **GEOM, **kw),
            LlamaConfig.tiny(sliding_window=window, **GEOM, **kw))


@pytest.fixture(scope="module")
def trees():
    """JAX's parameter trees (bf16, int8, int4) of one seed and the port's
    bridged copies.  The window is not a parameter: one tree serves all."""
    jcfg, _ = _cfgs(0)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(31))
    out = {"bf16": jp, "int8": jq.quantize_llama_params(jp, "int8", 128),
           "int4": jq.quantize_llama_params(jp, "int4", 128)}
    return {k: (v, params_from_numpy(jax.tree.map(np.asarray, v),
                                     device="cpu"))
            for k, v in out.items()}


def _random_cache(cfg, seed, rows=POS, scale=0.5):
    """(JAX's pair, the port's pair): bf16 rows < ``rows`` of N(0, scale^2),
    zero above."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, cfg.kv_heads, CAP, cfg.head_dim_)
    jpair, tpair = [], []
    for _ in range(2):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        x[:, :, rows:] = 0
        raw = x.astype(ml_dtypes.bfloat16)
        jpair.append(jnp.asarray(raw))
        tpair.append(torch.from_numpy(raw.view(np.uint16).copy()).view(
            torch.bfloat16))
    return jpair, tpair


def _within(got, want, frac):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(_np(got) - want).max())
    assert np.isfinite(_np(got)).all()
    assert err < frac * scale, (err, frac * scale)


def _told_apart(windowed, full, frac):
    """JAX's windowed result and its window-0 result on the same inputs lie
    more than twice the parity limit apart (its form: ``frac`` of the
    windowed result's scale), so a port that ignored the window would
    miss the limit."""
    windowed = _np(windowed)
    scale = max(float(np.abs(windowed).max()), 1.0)
    diff = float(np.abs(windowed - _np(full)).max())
    assert diff > 2 * frac * scale, (diff, 2 * frac * scale)


_NO_WINDOW = {}


def _jax_no_window(key, run):
    """JAX's window-0 result of one parity case, computed once a module."""
    if key not in _NO_WINDOW:
        _NO_WINDOW[key] = run(_cfgs(0)[0])
    return _NO_WINDOW[key]


# ---- against the JAX package ----------------------------------------------

@pytest.mark.parametrize("window", [64, 130, 1000])
def test_prefill_flash_window_matches_jax_eager(trees, window):
    jcfg, tcfg = _cfgs(window)
    jp, tp = trees["bf16"]
    toks = (np.arange(300) * 13 + 1) % tcfg.vocab_size

    def run(cfg):
        jkc, jvc = jmodel.init_cache(cfg)
        return jmodel.prefill(jp, jkc, jvc, jnp.asarray(toks, jnp.int32),
                              cfg, flash=False)[:2]

    le, ke = run(jcfg)
    kc, vc = tmodel.init_cache(tcfg, device="cpu")
    lf, kc, vc = tmodel.prefill(tp, kc, vc, toks.tolist(), tcfg, flash=True)
    _within(lf, le, 0.08)
    np.testing.assert_allclose(_np(kc), _np(ke), atol=0.05)
    l0, k0 = _jax_no_window("prefill", run)
    if window >= len(toks):       # the window holds every key: no window
        assert np.array_equal(_np(le), _np(l0))
        assert np.array_equal(_np(ke), _np(k0))
    else:
        _told_apart(le, l0, 0.08)
        assert float(np.abs(_np(ke) - _np(k0)).max()) > 2 * 0.05


@pytest.mark.parametrize("window", [100, 130, 256])
def test_decode_window_fused_and_eager_match_jax(trees, window):
    jcfg, tcfg = _cfgs(window)
    jp, tp = trees["bf16"]
    (jkc, jvc), (kc, vc) = _random_cache(tcfg, 11)

    def run(cfg):
        return jmodel.decode_step(jp, jkc, jvc, jnp.asarray(7, jnp.int32),
                                  jnp.asarray(POS, jnp.int32), cfg,
                                  fused=False)[0]

    le = run(jcfg)
    for fused in (True, False):
        lt, _, _ = tmodel.decode_step(tp, kc.clone(), vc.clone(), 7, POS,
                                      tcfg, fused=fused)
        _within(lt, le, 0.08)
    _told_apart(le, _jax_no_window("decode", run), 0.08)


def test_prefill_then_windowed_decode_tracks_jax(trees):
    jcfg, tcfg = _cfgs(100)
    jp, tp = trees["bf16"]
    toks = (np.arange(150) * 11 + 2) % tcfg.vocab_size
    jkc, jvc = jmodel.init_cache(jcfg)
    _, jkc, jvc = jmodel.prefill(jp, jkc, jvc, jnp.asarray(toks, jnp.int32),
                                 jcfg)
    kc, vc = tmodel.init_cache(tcfg, device="cpu")
    _, kc, vc = tmodel.prefill(tp, kc, vc, toks.tolist(), tcfg)
    jcfg0 = _cfgs(0)[0]        # JAX without a window, on the same tokens
    _, jk0, jv0 = jmodel.prefill(jp, *jmodel.init_cache(jcfg0),
                                 jnp.asarray(toks, jnp.int32), jcfg0)
    tok = 9
    for step in range(3):
        pos = len(toks) + step
        le, jkc, jvc = jmodel.decode_step(
            jp, jkc, jvc, jnp.asarray(tok, jnp.int32),
            jnp.asarray(pos, jnp.int32), jcfg, fused=False)
        l0, jk0, jv0 = jmodel.decode_step(
            jp, jk0, jv0, jnp.asarray(tok, jnp.int32),
            jnp.asarray(pos, jnp.int32), jcfg0, fused=False)
        lf, kc, vc = tmodel.decode_step(tp, kc, vc, tok, pos, tcfg,
                                        fused=True)
        err = float(np.abs(_np(lf) - _np(le)).max())
        assert err < 0.1, (step, err)
        diff = float(np.abs(_np(l0) - _np(le)).max())
        assert diff > 2 * 0.1, (step, diff)
        tok = int(jnp.argmax(le))


@pytest.mark.parametrize("quant,kv", [("int8", "int8"), ("int4", "int8"),
                                      ("int4", "fp8")])
def test_window_quant_kv_matrix_matches_jax(trees, quant, kv):
    jcfg, tcfg = _cfgs(100)
    jp, tp = trees[quant]

    def run(cfg):
        jkc, jvc = jmodel.init_cache(
            cfg, dtype="int8" if kv == "int8" else jnp.float8_e4m3fn)
        for pos in range(200, 203):
            le, jkc, jvc = jmodel.decode_step(
                jp, jkc, jvc, jnp.asarray(7, jnp.int32),
                jnp.asarray(pos, jnp.int32), cfg, fused=False)
        return le

    le = run(jcfg)
    kc, vc = tmodel.init_cache(tcfg, device="cpu",
                               dtype="int8" if kv == "int8" else FP8)
    for pos in range(200, 203):
        lf, kc, vc = tmodel.decode_step(tp, kc, vc, 7, pos, tcfg, fused=True)
    _within(lf, le, 0.1)
    _told_apart(le, run(_cfgs(0)[0]), 0.1)


@pytest.mark.parametrize("window", [100, 401])
def test_verify_window_matches_jax_eager(trees, window):
    jcfg, tcfg = _cfgs(window)
    jp, tp = trees["bf16"]
    (jkc, jvc), (kc, vc) = _random_cache(tcfg, 21)
    toks = (np.arange(4) * 3 + 2) % tcfg.vocab_size

    def run(cfg):
        return jspec.verify_step(jp, jkc, jvc, jnp.asarray(toks, jnp.int32),
                                 jnp.asarray(POS, jnp.int32), cfg,
                                 fused=False)[:2]

    le, ke = run(jcfg)
    lf, kc, _ = tspec.verify_step(tp, kc, vc, toks.tolist(), POS, tcfg,
                                  fused=True)
    _within(lf, le, 0.025)
    np.testing.assert_allclose(_np(kc), _np(ke), atol=0.08)
    l0, k0 = _jax_no_window("verify", run)
    _told_apart(le, l0, 0.025)
    assert float(np.abs(_np(ke) - _np(k0)).max()) > 2 * 0.08


# ---- the port's twins against its own oracles --------------------------------

def _flash_inputs(T, q_offset, kv=2, g=2, hd=128, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((kv, T, g, hd), generator=gen).bfloat16()
    k = torch.randn((kv, q_offset + T, hd), generator=gen).bfloat16()
    v = torch.randn((kv, q_offset + T, hd), generator=gen).bfloat16()
    return q, k, v


def _masked_attention(q, k, v, q_offset, window):
    """A straightforward float32 attention, one query at a time."""
    kv, T, g, hd = q.shape
    out = torch.empty(q.shape)
    for i in range(T):
        p = q_offset + i
        lo = max(0, p + 1 - window) if window else 0
        s = torch.einsum("kgd,ksd->kgs", q[:, i].float(),
                         k[:, lo:p + 1].float()) / hd ** 0.5
        out[:, i] = torch.einsum("kgs,ksd->kgd", torch.softmax(s, -1),
                                 v[:, lo:p + 1].float())
    return out


@pytest.mark.parametrize("T,q_offset,window", [
    (200, 0, 64), (200, 0, 1), (70, 130, 100), (70, 130, 77), (33, 5, 4)])
def test_prefill_twin_window_against_oracle(T, q_offset, window):
    """Kernel 4's twin (and the wrapper on CPU tensors) against a plain
    per-query softmax over keys ``p + 1 - window .. p``, chunked too."""
    q, k, v = _flash_inputs(T, q_offset)
    got = flash_prefill_attention(q, k, v, q_offset=q_offset, window=window)
    assert torch.equal(got, flash_prefill_attention_plain(
        q, k, v, q_offset=q_offset, window=window))
    want = _masked_attention(q, k, v, q_offset, window)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    if window == 1:     # each query attends its own key alone
        assert torch.equal(got, v[:, q_offset:, None].expand_as(got))


def test_twins_full_window_equal_no_window_bits():
    """A window that reaches row 0 (>= pos + 1; for the verify >= pos + n)
    masks nothing: kernels 4, 7 and 8's twins give window 0's bits."""
    q, k, v = _flash_inputs(90, 40)
    want = flash_prefill_attention_plain(q, k, v, q_offset=40)
    for w in (130, 131, 5000):
        assert torch.equal(flash_prefill_attention_plain(
            q, k, v, q_offset=40, window=w), want)
    _, tcfg = _cfgs(0)
    tp = tmodel.init_params(tcfg, 3, device="cpu")
    _, (kc, vc) = _random_cache(tcfg, 5)
    base = tmodel.decode_step(tp, kc.clone(), vc.clone(), 7, POS, tcfg)[0]
    vbase = tspec.verify_step(tp, kc.clone(), vc.clone(), [3, 4, 5], POS,
                              tcfg)[0]
    for w in (POS + 1, 4096):
        cfg = dataclasses.replace(tcfg, sliding_window=w)
        assert torch.equal(tmodel.decode_step(tp, kc.clone(), vc.clone(), 7,
                                              POS, cfg)[0], base)
    for w in (POS + 3, 4096):          # token 2's bound is pos + 3 - w
        cfg = dataclasses.replace(tcfg, sliding_window=w)
        assert torch.equal(tspec.verify_step(tp, kc.clone(), vc.clone(),
                                             [3, 4, 5], POS, cfg)[0], vbase)


def _split_case(seq=400, kv=2, g=4, hd=128, seed=7):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((kv, g, hd), generator=gen) * 0.1
    kc = torch.randn((kv, 512, hd), generator=gen).bfloat16()
    vc = torch.randn((kv, 512, hd), generator=gen).bfloat16()
    kc[:, seq:] = vc[:, seq:] = float("nan")     # never read
    k_cur = torch.randn((kv, hd), generator=gen)
    v_cur = torch.randn((kv, hd), generator=gen)
    return q, k_cur, v_cur, kc, vc


@pytest.mark.parametrize("window,split", [(100, 64), (1, 64), (2, 64),
                                          (64, 64), (65, 64), (257, 128)])
def test_split_twin_window_against_oracle(window, split):
    """Kernel 7's split-and-merge twin under a window: the token at seq
    attends rows >= seq + 1 - window (100: from row 301, inside the split
    of rows 256-319) and itself, against a plain float32 softmax over the
    same rows (the twin rounds q and p to bf16: atol 2e-2); window 1
    reads no cached row and gives v_cur exactly."""
    seq = 400
    q, k_cur, v_cur, kc, vc = _split_case(seq)
    acc, _, l_f = sk.split_attention_plain(q, k_cur, v_cur, kc, vc, seq,
                                           split, window=window)
    got = acc / l_f[..., None]
    lo = max(0, seq + 1 - window)
    keys = torch.cat([kc[:, lo:seq].float(), k_cur[:, None]], dim=1)
    vals = torch.cat([vc[:, lo:seq].float(), v_cur[:, None]], dim=1)
    p = torch.softmax(torch.einsum("kgd,ksd->kgs", q, keys) / sk._LOG2E, -1)
    want = torch.einsum("kgs,ksd->kgd", p, vals)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    if window == 1:
        assert torch.equal(got, v_cur[:, None].expand_as(got))
    # the rows read: from the split that holds the window's first row
    assert sk.first_live_row(seq, split, window) == (
        seq if lo >= seq else lo // split * split)


def test_verify_split_dead_for_later_tokens():
    """Kernel 8's twin where the first live split (rows 320-335, from token
    0's bound 333) holds no live row for tokens 3 and 4 (bounds 336 and
    337): their partials must fold as nothing.  Against the eager verify
    within 0.06 of the scale (JAX's verify limit), finite; and against a
    verify with kv_split 8, whose splits differ but whose masked rows do
    not."""
    cfg = LlamaConfig.tiny(sliding_window=8, **GEOM)
    tp = tmodel.init_params(cfg, 4, device="cpu")
    _, (kc, vc) = _random_cache(cfg, 6, rows=340)
    toks = [5, 6, 7, 8, 9]
    kcfg = KernelConfig(kv_split=16)
    assert sk.first_live_row(340, 16, 8) == 320
    lf, kf, _ = tspec.verify_step(tp, kc.clone(), vc.clone(), toks, 340, cfg,
                                  kcfg=kcfg, fused=True)
    le, ke, _ = tspec.verify_step(tp, kc.clone(), vc.clone(), toks, 340, cfg,
                                  fused=False)
    l8, _, _ = tspec.verify_step(tp, kc.clone(), vc.clone(), toks, 340, cfg,
                                 kcfg=KernelConfig(kv_split=8), fused=True)
    _within(lf, le, 0.06)
    _within(lf, l8, 0.02)
    np.testing.assert_allclose(_np(kf), _np(ke), atol=0.08)


def test_window_changes_the_result():
    """Window 100 at pos 400 must differ from full attention (the guard of
    JAX's ``test_stack_window_differs_from_full_attention``), in the fused
    step, the verify and the prefill."""
    _, tcfg = _cfgs(100)
    full = dataclasses.replace(tcfg, sliding_window=0)
    tp = tmodel.init_params(tcfg, 3, device="cpu")
    _, (kc, vc) = _random_cache(tcfg, 5)
    for fn, arg in ((tmodel.decode_step, 7), (tspec.verify_step, [3, 4])):
        lw = fn(tp, kc.clone(), vc.clone(), arg, POS, tcfg)[0]
        lfull = fn(tp, kc.clone(), vc.clone(), arg, POS, full)[0]
        assert float((lw - lfull).abs().max()) > 1e-3
    toks = list(range(1, 200))
    kw, vw = tmodel.init_cache(tcfg, device="cpu")
    kf, vf = tmodel.init_cache(full, device="cpu")
    pw = tmodel.prefill(tp, kw, vw, toks, tcfg)[0]
    pf = tmodel.prefill(tp, kf, vf, toks, full)[0]
    assert torch.equal(pw[:100], pf[:100])           # inside the window
    assert float((pw[100:] - pf[100:]).abs().max()) > 1e-3


# ---- what stays refused -----------------------------------------------------

def test_paths_without_a_window_refuse_it_by_name():
    """Both tp steps, the sp step and kernel 7's mode 5 run Mistral's
    window (their parity with JAX's windowed steps:
    ``tests/test_torch_window_parallel.py``): each builds or runs on a
    windowed config and refuses only Gemma-2's ``"even"`` pattern by name.
    Mode 5 over an axis of one rank gives the one-card window step's
    bits."""
    from clusterfusion_tpu_torch.parallel import (make_sharded_decode_step,
                                                  make_sp_sharded_decode_step)
    from clusterfusion_tpu_torch.parallel.mesh import AXES, Mesh
    _, tcfg = _cfgs(16)
    even = dataclasses.replace(tcfg, window_pattern="even")
    mesh = Mesh(shape=dict.fromkeys(AXES, 1), coords=dict.fromkeys(AXES, 0),
                groups=dict.fromkeys(AXES))
    for fused in (False, True):
        assert callable(make_sharded_decode_step(tcfg, mesh,
                                                 fused_collectives=fused))
        with pytest.raises(NotImplementedError, match="even"):
            make_sharded_decode_step(even, mesh, fused_collectives=fused)
    assert callable(make_sp_sharded_decode_step(tcfg, mesh))
    with pytest.raises(NotImplementedError, match="even"):
        make_sp_sharded_decode_step(even, mesh)
    tp = tmodel.init_params(tcfg, 0, device="cpu")
    lw = tp["layers"]
    _, (kc, vc) = _random_cache(tcfg, 7, rows=40)
    cos, sin = tmodel.rope_row(tcfg, 40)

    def stack(**kw):
        return sk.fused_decoder_stack(
            tp["embed"][:1], lw["attn_norm"], lw["ffn_norm"], cos, sin,
            lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc.clone(),
            vc.clone(), 40, group=2, head_dim=128, rope_style="neox",
            eps=1e-5, window=16, **kw)

    one_card = stack()
    mode5 = stack(reduce_axis="tp", mesh=mesh)
    assert all(torch.equal(a, b) for a, b in zip(one_card, mode5))
    with pytest.raises(NotImplementedError, match="even"):
        stack(reduce_axis="tp", mesh=mesh, window_pattern="even")


def test_even_window_pattern_is_refused_everywhere():
    """Gemma-2's interleaved ``"even"`` pattern is refused by name on every
    entry that takes a window: prefill, both decode steps, the verify and
    the two stack wrappers (which also refuse a negative window)."""
    _, tcfg = _cfgs(16, window_pattern="even")
    tp = tmodel.init_params(tcfg, 0, device="cpu")
    kc, vc = tmodel.init_cache(tcfg, device="cpu")
    calls = [lambda: tmodel.prefill(tp, kc, vc, [1, 2], tcfg),
             lambda: tmodel.decode_step(tp, kc, vc, 1, 3, tcfg, fused=True),
             lambda: tmodel.decode_step(tp, kc, vc, 1, 3, tcfg, fused=False),
             lambda: tspec.verify_step(tp, kc, vc, [1, 2], 3, tcfg)]
    lw = tp["layers"]
    cos, sin = tmodel.rope_rows(tcfg, 3, 2)
    args = (tp["embed"][:2], lw["attn_norm"], lw["ffn_norm"], cos, sin,
            lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc, vc, 3)
    kw = dict(group=2, head_dim=128, rope_style="neox", eps=1e-5)
    calls += [lambda: sv.fused_verify_stack(*args, window=16,
                                            window_pattern="even", **kw),
              lambda: sk.fused_decoder_stack(
                  args[0][:1], *args[1:3], cos[:1], sin[:1], *args[5:],
                  window=16, window_pattern="even", **kw)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="even"):
            call()
    with pytest.raises(ValueError, match="window"):
        sv.fused_verify_stack(*args, window=-1, **kw)
