"""The port's 8-bit KV caches against the JAX package's, on the CPU, at
``LlamaConfig.tiny(max_seq_len=256)`` (hd 128, two layers): an ``Int8KV``
pair (int8 rows, float32 scales per (kv head, position) in [L, kv, R, 128]
planes) and a float8 e4m3 pair, each test parametrised over both.

Kernel 7's twin (the fused ``decode_step``) and kernel 8's (the fused
``verify_step``) run on the same random 8-bit cache as JAX's
``fused_decoder_stack`` and ``fused_verify_stack`` (Pallas in interpret
mode), with bf16, int8 and int4 (exact) weights, at positions whose
appends cross the 128-column plane row (pos 120 and 130; n 5 from 126).
The model paths (prefill, chunked too; the eager step; ``stream_generate``
and a self-draft ``spec_generate`` of 12 tokens) run on JAX's bf16 tree.

Tolerances, each where it is used: logits within 0.06 of max(|logits|, 1)
(the verify's limit, ``tests/test_stack_verify.py``); an appended int8 row
within one code and its scale at rtol 1e-2 at layer 0 (the f32 rows it
comes from differ by bf16 roundings), below it the scale at 2e-2 (those
roundings compound, and a code moves with its scale), dequantized rows at
atol 0.08; fp8 rows at atol 0.08 and rtol 0.125 (one e4m3 step).  Greedy
streams follow the rule of ``test_torch_generation.py``: wherever JAX's
top-2 logit gap exceeds 0.05 the tokens agree, and past the first
legitimate divergence they are not compared.  The fp8 denormal rule: the kernels (and their twins) flush
e4m3 denormals to 0, as the TPU kernels' decode does, while the prefill
and the eager paths keep them, as XLA's conversion does.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import KernelConfig as JKernelConfig
from clusterfusion_tpu.config import LlamaConfig as JConfig
from clusterfusion_tpu.models import llama as jmodel
from clusterfusion_tpu.models import speculative as jspec
from clusterfusion_tpu.models.generation import Llama as JLlama
from clusterfusion_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from clusterfusion_tpu.ops import quant as jq
from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models import speculative as tspec
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.models.generation import Llama
from clusterfusion_tpu_torch.models.tokenizer import ByteTokenizer
from clusterfusion_tpu_torch.ops import quant as tq
from clusterfusion_tpu_torch.ops import stack_kernel as sk
from clusterfusion_tpu_torch.ops import stack_verify as sv

FORMATS = ("int8", "fp8")
WEIGHTS = ("bf16", "int8", "int4")
GAP = 0.05
CAP = 256
PROMPT = 120          # the model paths' prompt: the stream crosses row 128
FP8 = torch.float8_e4m3fn


def _kv_dtypes(fmt):
    """(JAX's kv_dtype, the port's) of a format."""
    return {"int8": ("int8", "int8"),
            "fp8": (jnp.float8_e4m3fn, FP8)}[fmt]


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _port_cache(j):
    """A JAX cache (Int8KV or fp8 array) as the port's, bit for bit."""
    if isinstance(j, jq.Int8KV):
        return tq.Int8KV(torch.from_numpy(np.array(j.q)),
                         torch.from_numpy(np.array(j.s)))
    raw = np.array(j).view(np.uint8)
    return torch.from_numpy(raw).view(FP8)


def _clone(c):
    return tq.Int8KV(c.q.clone(), c.s.clone()) if isinstance(c, tq.Int8KV) \
        else c.clone()


def _logits_close(t, j, frac=0.06):
    jn = _np(j)
    scale = max(float(np.abs(jn).max()), 1.0)
    err = float(np.abs(_np(t) - jn).max())
    assert err < frac * scale, (err, scale)


def _rows(c, lo, hi):
    """Rows lo..hi-1 of every layer as float32 values (int8: dequantized)."""
    if isinstance(c, (tq.Int8KV, jq.Int8KV)):
        L, H, R, _ = c.s.shape
        s = _np(c.s).reshape(L, H, R * 128)[:, :, lo:hi]
        return _np(c.q)[:, :, lo:hi] * s[..., None]
    return _np(c)[:, :, lo:hi]


def _cache_close(t, j, lo, hi):
    """Rows lo..hi-1 of a port cache against JAX's at the module's
    tolerances (int8: codes within 1 and scales at rtol 1e-2 at layer 0,
    scales at 2e-2 below it, dequantized rows at atol 0.08; fp8: rows at
    atol 0.08 + rtol 0.125)."""
    if isinstance(t, tq.Int8KV):
        dq = np.abs(t.q[:, :, lo:hi].numpy().astype(np.int32)
                    - np.asarray(j.q)[:, :, lo:hi].astype(np.int32))
        # layer 0 from the same inputs; a deeper layer's rows carry the
        # earlier layers' bf16 flips (ROADMAP.md queue 3, depth drift) and
        # are held by their values (below), a code moving with its scale
        assert dq[0].max() <= 1, dq[0].max()
        L, H, R, _ = t.s.shape
        ts = t.s.reshape(L, H, -1)[:, :, lo:hi].numpy()
        js = np.asarray(j.s).reshape(L, H, -1)[:, :, lo:hi]
        np.testing.assert_allclose(ts[0], js[0], rtol=1e-2)
        np.testing.assert_allclose(ts, js, rtol=2e-2)
        np.testing.assert_allclose(_rows(t, lo, hi), _rows(j, lo, hi),
                                   atol=0.08, rtol=0)
    else:
        np.testing.assert_allclose(_rows(t, lo, hi), _rows(j, lo, hi),
                                   atol=0.08, rtol=0.125)


def _random_cache(fmt, cfg, seed):
    """A random 8-bit cache pair, every row filled (JAX's kernels mask the
    rows at and above pos, the port's never read them): int8 codes with
    scales of 0.005-0.03; fp8 values of N(0, 1), a tenth of them scaled
    to e4m3 denormals (|v| < 0.0137)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, cfg.kv_heads, CAP, cfg.head_dim_)
    out = []
    for _ in range(2):
        if fmt == "int8":
            q = rng.integers(-127, 128, shape).astype(np.int8)
            s = np.ones((*shape[:2], max(CAP // 128, 8), 128), np.float32)
            s[:] = rng.uniform(0.005, 0.03, s.shape)
            out.append(jq.Int8KV(jnp.asarray(q), jnp.asarray(s)))
        else:
            x = rng.standard_normal(shape).astype(np.float32)
            x[rng.random(shape) < 0.1] *= 0.005
            out.append(jnp.asarray(x.astype(ml_dtypes.float8_e4m3fn)))
    return out


@pytest.fixture(scope="module")
def base():
    jcfg = JConfig.tiny(max_seq_len=CAP)
    tcfg = LlamaConfig.tiny(max_seq_len=CAP)
    assert tcfg.head_dim_ == 128 and tcfg.n_layers == 2
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    trees = {"bf16": jp,
             "int8": jq.quantize_llama_params(jp, "int8"),
             "int4": jq.quantize_llama_params(jp, "int4")}
    return dict(jcfg=jcfg, tcfg=tcfg, jp=trees,
                tp={k: _to_port(v) for k, v in trees.items()},
                cache={fmt: _random_cache(fmt, tcfg, i)
                       for i, fmt in enumerate(FORMATS)})


# int4 in the exact mode on both sides (W4A8 parts from its twin by an
# int8 activation flip per bf16 rounding; ROADMAP.md queue 3)
_JK = JKernelConfig(int4_w4a8=False)
_TK = KernelConfig(int4_w4a8=False)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel7_twin_matches_jax(base, fmt, weights):
    """The fused decode step (kernel 7's twin) against JAX's fused step on
    the same 8-bit cache, at pos 120 and 130 (its append in plane row 0,
    then 1): logits, the appended rows, the rows below untouched."""
    jk, jv = base["cache"][fmt]
    jp, tp = base["jp"][weights], base["tp"][weights]
    for pos in (120, 130):
        jl, jk2, jv2 = jmodel.decode_step(
            jp, jk, jv, jnp.asarray(7, jnp.int32), jnp.asarray(pos, jnp.int32),
            base["jcfg"], _JK, fused=True)
        tk, tv = _port_cache(jk), _port_cache(jv)
        before = (sk.launches, dict(sk.kv8_launches))
        tl, tk2, tv2 = tmodel.decode_step(tp, tk, tv, 7, pos, base["tcfg"],
                                          _TK, fused=True)
        assert (sk.launches, sk.kv8_launches) == before   # the CPU's twin
        assert tk2 is tk and tv2 is tv
        _logits_close(tl, jl)
        for t, j, j0 in ((tk, jk2, jk), (tv, jv2, jv)):
            _cache_close(t, j, pos, pos + 1)
            assert np.array_equal(_rows(t, 0, pos), _rows(j0, 0, pos))


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel8_twin_matches_jax(base, fmt, weights):
    """The fused verify (kernel 8's twin) of n 5 rows from pos 126 (the
    five appends straddle plane row 1) against JAX's fused verify."""
    jk, jv = base["cache"][fmt]
    jp, tp = base["jp"][weights], base["tp"][weights]
    pos, n = 126, 5
    toks = (np.arange(n) * 3 + 2) % base["tcfg"].vocab_size
    jl, jk2, jv2 = jspec.verify_step(jp, jk, jv, jnp.asarray(toks, jnp.int32),
                                     jnp.asarray(pos, jnp.int32),
                                     base["jcfg"], _JK, fused=True)
    tk, tv = _port_cache(jk), _port_cache(jv)
    before = (sv.launches, dict(sv.kv8_launches))
    tl, _, _ = tspec.verify_step(tp, tk, tv, toks, pos, base["tcfg"], _TK,
                                 fused=True)
    assert (sv.launches, sv.kv8_launches) == before
    _logits_close(tl, jl)
    for t, j in ((tk, jk2), (tv, jv2)):
        _cache_close(t, j, pos, pos + n)


def _prefill_both(base, fmt, chunks):
    """JAX's and the port's prefill of the prompt into an 8-bit cache, in
    ``chunks`` (lengths): the last chunk's logits and both caches."""
    jd, td = _kv_dtypes(fmt)
    jcfg, tcfg = base["jcfg"], base["tcfg"]
    jp, tp = base["jp"]["bf16"], base["tp"]["bf16"]
    toks = (np.arange(PROMPT) * 7 + 1) % tcfg.vocab_size
    jk, jv = jmodel.init_cache(jcfg, dtype=jd)
    tk, tv = tmodel.init_cache(tcfg, device="cpu", dtype=td)
    pos0 = 0
    for T in chunks:
        part = toks[pos0:pos0 + T]
        jl, jk, jv = jmodel.prefill_chunk(jp, jk, jv,
                                          jnp.asarray(part, jnp.int32), jcfg,
                                          pos0=pos0)
        tl, tk, tv = tmodel.prefill_chunk(tp, tk, tv, part, tcfg, pos0=pos0)
        pos0 += T
    return tl, tk, tv, jl, jk, jv


@pytest.mark.parametrize("chunks", [(PROMPT,), (64, PROMPT - 64)],
                         ids=["whole", "chunked"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_prefill_matches_jax(base, fmt, chunks):
    """A prefill of 120 tokens into an 8-bit cache (whole, and in two chunks:
    the second attends over the dequantized prefix and its own bf16 rows)
    against JAX's ``prefill_chunk``: the last chunk's logits and all rows."""
    tl, tk, tv, jl, jk, jv = _prefill_both(base, fmt, chunks)
    _logits_close(tl, jl)
    for t, j in ((tk, jk), (tv, jv)):
        _cache_close(t, j, 0, PROMPT)
    if fmt == "int8":       # the capacity is the plane's, the rest ones
        assert tk.q.shape[2] == CAP and torch.all(
            tk.s.reshape(2, -1, CAP)[:, :, PROMPT:] == 1)


@pytest.fixture(scope="module")
def prefilled(base):
    return {fmt: _prefill_both(base, fmt, (PROMPT,)) for fmt in FORMATS}


@pytest.mark.parametrize("fmt", FORMATS)
def test_eager_decode_matches_jax(base, prefilled, fmt):
    """``decode_step(fused=False)`` against JAX's eager step on the same
    prefilled 8-bit cache: the row is stored first and attended as stored."""
    _, tk, tv, _, jk, jv = prefilled[fmt]
    jl, jk2, jv2 = jmodel.decode_step(
        base["jp"]["bf16"], jk, jv, jnp.asarray(9, jnp.int32),
        jnp.asarray(PROMPT, jnp.int32), base["jcfg"], fused=False)
    tk, tv = _clone(tk), _clone(tv)
    tl, _, _ = tmodel.decode_step(base["tp"]["bf16"], tk, tv, 9, PROMPT,
                                  base["tcfg"], fused=False)
    _logits_close(tl, jl)
    for t, j in ((tk, jk2), (tv, jv2)):
        _cache_close(t, j, PROMPT, PROMPT + 1)


def _jax_gaps(base, prefilled, stream):
    """JAX's top-2 logit gaps along ``stream`` (after the prompt, then after
    each token) through its fused step on the prefilled 8-bit cache."""
    _, _, _, jl, jk, jv = prefilled
    gaps = [float(np.diff(np.sort(_np(jl[-1])))[-1])]
    for i, t in enumerate(stream[:-1]):
        lg, jk, jv = jmodel.decode_step(
            base["jp"]["bf16"], jk, jv, jnp.asarray(t, jnp.int32),
            jnp.asarray(PROMPT + i, jnp.int32), base["jcfg"], fused=True)
        gaps.append(float(np.diff(np.sort(_np(lg)))[-1]))
    return gaps


def _same_where_clear(got, want, gaps):
    """Tokens agree wherever JAX's gap clears GAP, up to the first
    legitimate divergence; at least three positions were decided."""
    for i in range(min(len(got), len(want))):
        if got[i] != want[i]:
            assert gaps[i] <= GAP, (i, got, want, gaps)
            break
    assert sum(g > GAP for g in gaps[:i + 1]) >= 3, gaps


@pytest.mark.parametrize("fmt", FORMATS)
def test_stream_and_spec_generate_match_jax(base, prefilled, fmt):
    """``Llama.stream_generate`` (kernel 7's twin) and a self-draft
    ``spec_generate`` (kernel 8's twin for the verify) with an 8-bit cache,
    12 tokens after a 120-token prompt, against JAX's, under the top-2-gap
    rule."""
    jd, td = _kv_dtypes(fmt)
    prompt = list((np.arange(PROMPT) * 7 + 1) % base["tcfg"].vocab_size)
    jeng = JLlama(base["jp"]["bf16"], base["jcfg"], JByteTokenizer(),
                  fused=True, kv_dtype=jd)
    teng = Llama(base["tp"]["bf16"], base["tcfg"], ByteTokenizer(),
                 fused=True, kv_dtype=td)
    n = 12
    jt = list(jeng.stream_generate(prompt, n, temperature=0.0))
    before = dict(sk.kv8_launches)
    tt = list(teng.stream_generate(prompt, n, temperature=0.0))
    assert len(tt) == n and sk.kv8_launches == before
    gaps = _jax_gaps(base, prefilled[fmt], jt)
    _same_where_clear(tt, jt, gaps)
    js = jeng.spec_generate(prompt, n, jeng, n_draft=3)
    ts = teng.spec_generate(prompt, n, teng, n_draft=3)
    assert len(ts) == len(js) == n
    assert teng.spec_stats["accepted_drafts"] > 0      # the self-draft agrees
    _same_where_clear(ts, js, gaps)


def _denormal_pair(fmt_cache, seed):
    """An fp8 cache pair whose V rows are all e4m3 denormals, and the same
    pair with those V rows zeroed."""
    k, v = fmt_cache
    tk = _port_cache(k)
    rng = np.random.default_rng(seed)
    codes = rng.integers(1, 8, tuple(tk.shape)).astype(np.uint8) | \
        (rng.integers(0, 2, tuple(tk.shape)).astype(np.uint8) << 7)
    tv = torch.from_numpy(codes).view(FP8)
    assert torch.all(tv.float().abs() < 0.0137) and torch.all(tv.float() != 0)
    return (tk, tv), (tk.clone(), torch.zeros_like(tv))


def test_fp8_denormals_kernels_flush_eager_and_prefill_keep(base):
    """The decode the twins use is JAX's kernel decode bit for bit, zero on
    exactly the 14 denormal codes, where XLA's conversion keeps them; so a
    V cache of denormals reads as zeros in kernels 7 and 8 (their twins give
    the bits of a zero V cache) and as values in the eager step and the
    chunked prefill (which then differ from the zeroed cache)."""
    codes = np.arange(256, dtype=np.uint8)
    f8 = codes.view(ml_dtypes.float8_e4m3fn)
    want = np.asarray(jq.fp8_decode_scaled(jnp.asarray(f8)), np.float32) \
        * jq.FP8_DECODE_FIX
    tf8 = torch.from_numpy(codes.copy()).view(FP8)
    got = sk.kv_rows_plain(tf8).numpy()
    ok = ~np.isnan(f8.astype(np.float32))
    assert np.array_equal(got[ok], want[ok])
    kept = tf8.float().numpy()
    differ = ok & (got != kept)
    assert differ.sum() == 14 and np.all(np.abs(kept[differ]) < 0.0137)
    assert np.array_equal(tq.cache_read_layer(tf8.reshape(1, 1, 256, 1), 0,
                                              256).numpy().ravel(), kept,
                          equal_nan=True)

    tcfg, tp = base["tcfg"], base["tp"]["bf16"]
    (dk, dv), (zk, zv) = _denormal_pair(base["cache"]["fp8"], 5)
    pos = 130

    def run(fn, k, v):
        k, v = k.clone(), v.clone()
        return fn(k, v)

    fused = [run(lambda k, v: tmodel.decode_step(tp, k, v, 7, pos, tcfg)[0],
                 *c) for c in ((dk, dv), (zk, zv))]
    assert torch.equal(*fused)                      # kernel 7 flushes
    verify = [run(lambda k, v: tspec.verify_step(tp, k, v, [3, 4, 5], pos,
                                                 tcfg)[0], *c)
              for c in ((dk, dv), (zk, zv))]
    assert torch.equal(*verify)                     # kernel 8 flushes
    eager = [run(lambda k, v: tmodel.decode_step(tp, k, v, 7, pos, tcfg,
                                                 fused=False)[0], *c)
             for c in ((dk, dv), (zk, zv))]
    assert not torch.equal(*eager)                  # the eager step keeps
    chunk = [run(lambda k, v: tmodel.prefill_chunk(tp, k, v, [3, 4], tcfg,
                                                   pos0=pos)[0], *c)
             for c in ((dk, dv), (zk, zv))]
    assert not torch.equal(*chunk)                  # the prefill keeps


@pytest.mark.parametrize("fmt", FORMATS)
def test_rows_above_pos_are_never_read(base, fmt):
    """Kernel 7's and 8's twins read rows < pos only: NaN scales (int8) or
    NaN bytes 0x7F (fp8) above pos change no bit of their results."""
    jk, jv = base["cache"][fmt]
    tp, tcfg = base["tp"]["bf16"], base["tcfg"]
    pos = 130

    def poisoned(j):
        c = _port_cache(j)
        if isinstance(c, tq.Int8KV):
            L, H, R, _ = c.s.shape
            c.s.view(L, H, R * 128)[:, :, pos:] = float("nan")
        else:
            c.view(torch.uint8)[:, :, pos:] = 0x7F
        return c

    for step in (lambda k, v: tmodel.decode_step(tp, k, v, 7, pos, tcfg)[0],
                 lambda k, v: tspec.verify_step(tp, k, v, [3, 4, 5], pos,
                                                tcfg)[0]):
        clean = step(_port_cache(jk), _port_cache(jv))
        dirty = step(poisoned(jk), poisoned(jv))
        assert torch.isfinite(clean).all() and torch.equal(clean, dirty)


def test_init_cache_formats_match_jax(base):
    """``init_cache``: JAX's capacity rounding (to 128 above 128) and
    contents for "int8" / ``torch.int8``; fp8 zeros; other dtypes raise."""
    jcfg, tcfg = base["jcfg"], base["tcfg"]
    for cap in (100, 200, 256):
        jk, _ = jmodel.init_cache(jcfg, max_seq=cap, dtype="int8")
        for dt in ("int8", torch.int8):
            tk, tv = tmodel.init_cache(tcfg, max_seq=cap, device="cpu",
                                       dtype=dt)
            assert isinstance(tk, tq.Int8KV) and tk.q is not tv.q
            assert tuple(tk.q.shape) == tuple(jk.q.shape)
            assert tuple(tk.s.shape) == tuple(jk.s.shape)
            assert not tk.q.any() and torch.all(tk.s == 1)
            assert tk.device.type == "cpu" and tk.dtype == torch.int8
    tk, _ = tmodel.init_cache(tcfg, device="cpu", dtype=FP8)
    assert tk.dtype == FP8 and not tk.float().any()
    with pytest.raises(ValueError):
        tmodel.init_cache(tcfg, device="cpu", dtype=torch.float16)


@pytest.mark.parametrize("flags", [["--kv_int8"], ["--kv_fp8"],
                                   ["--kv_int8", "--kv_fp8"],
                                   ["--kv_fp8", "--spec_draft", "synthetic"]])
def test_chat_kv8(capsys, flags):
    """``chat --kv_int8 / --kv_fp8`` streams (with ``--spec_draft``, the
    verify) on the CPU; --kv_int8 wins over --kv_fp8; the header names the
    kind."""
    from clusterfusion_tpu_torch import chat
    chat.main(["--synthetic", "--device", "cpu", "--max_gen_len", "3",
               "--temperature", "0", "--max_seq_len", "160", *flags])
    out = capsys.readouterr().out
    kind = "int8" if "--kv_int8" in flags else "fp8"
    assert f"kv={kind}]" in out or f"kv={kind} |" in out
    assert "tokens/sec" in out


def test_kv8_refusals_name_their_items(base):
    """What stays refused: a pair of two kinds, an int8 tensor without
    scales, planes that do not cover the capacity; an ``Int8KV`` pair in
    kernel 6 (the JAX package's kernel 6 takes none); an "int8" pool in
    the serving engine, so ``generate`` too (JAX's int8 pools are
    unscaled).  Since item 2.2 kernel 7's mode 5 takes both formats (on an
    axis of one rank, the unsharded step's bits) and kernel 6 an fp8 pair;
    since item 2.3 the engine, and so ``generate``, serves fp8 pools."""
    from clusterfusion_tpu_torch.ops import decoder_layer as tdl
    from clusterfusion_tpu_torch.parallel.mesh import AXES, Mesh
    from clusterfusion_tpu_torch.runtime import ServingEngine
    tcfg, tp = base["tcfg"], base["tp"]["bf16"]
    lw = tp["layers"]
    g, hd = tcfg.n_heads // tcfg.kv_heads, tcfg.head_dim_
    cos, sin = tmodel.rope_row(tcfg, 3)
    k8, v8 = tmodel.init_cache(tcfg, device="cpu", dtype="int8")
    f8, _ = tmodel.init_cache(tcfg, device="cpu", dtype=FP8)
    bf, _ = tmodel.init_cache(tcfg, device="cpu")
    mesh = Mesh(shape=dict.fromkeys(AXES, 1), coords=dict.fromkeys(AXES, 0),
                groups=dict.fromkeys(AXES))

    def stack(kc, vc, **kw):
        return sk.fused_decoder_stack(
            tp["embed"][[7]], lw["attn_norm"], lw["ffn_norm"], cos, sin,
            lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc, vc, 3,
            group=g, head_dim=hd, rope_style="gptj", eps=1e-5, **kw)

    for kc, vc in ((k8, v8), (f8, f8.clone())):
        got = stack(_clone(kc), _clone(vc), reduce_axis="tp", mesh=mesh)
        want = stack(_clone(kc), _clone(vc))
        assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    for kc, vc in ((k8, f8), (f8, bf)):
        with pytest.raises(ValueError, match="one kind"):
            stack(kc, vc)
    with pytest.raises(NotImplementedError, match="queue 2, mode 2"):
        stack(k8.q, v8.q)
    short = tq.Int8KV(k8.q, k8.s[:, :, :1])
    with pytest.raises(ValueError, match="cover the capacity"):
        stack(short, tq.Int8KV(v8.q, v8.s[:, :, :1]))
    def layer(kc, vc):
        return tdl._fused_decoder_layer(
            tp["embed"][[7]], tp["embed"][[8]], lw["attn_norm"], cos, sin,
            lw["wqkv_f"], lw["wo_f"], kc, vc, 3, 1, group=g, head_dim=hd,
            rope_style="gptj", fuse_residual=True, eps=1e-5)

    with pytest.raises(NotImplementedError, match="take none"):
        layer(k8, v8)
    assert torch.isfinite(layer(f8, f8.clone())[0].float()).all()
    with pytest.raises(NotImplementedError, match="int8 pools are unscaled"):
        ServingEngine(tp, tcfg, kv_dtype="int8")
    eng = Llama(tp, tcfg, ByteTokenizer(), kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="int8 pools are unscaled"):
        eng.generate([[1, 2, 3]], 2)
    assert ServingEngine(tp, tcfg, kv_dtype=FP8).k_pool.dtype == FP8
    (toks,), _ = Llama(tp, tcfg, ByteTokenizer(), kv_dtype=FP8).generate(
        [[1, 2, 3]], 2, temperature=0.0)
    assert len(toks) == 2
