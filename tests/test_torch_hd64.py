"""Head dim 64 through kernel 7 (the TPU stack kernel's ``defer_append``
variant) on the CPU, at the JAX package's own hd-64 geometry
(``LlamaConfig.tiny(head_dim=64, n_kv_heads=2, n_layers=2,
max_seq_len=256, rope_style="neox")``, as ``tests/test_hd64.py``).

Both packages' ``decode_step(fused=True)`` run on the same bridged tree and
the same random cache (a numpy seed; 8-bit values well inside e4m3's
+-448): JAX's ``fused_decoder_stack`` in interpret mode, the port's plain
twin of kernel 7.  Five cases of weights and cache: (bf16, bf16),
(int8, bf16), (int4 W4A8, ``Int8KV``) (JAX's production operating point,
``tests/test_hd64.py:45``), (bf16, fp8) and (int4 exact, fp8); then the
port's ``decode_loop`` over 3 steps at the operating point, teacher-forced
into JAX's step.

Tolerances, each where it is used: logits within 0.06 of max(|logits|, 1)
(the verify's limit, ``tests/test_stack_verify.py``), int4 W4A8 within
0.35 + 0.05 of |logit| (JAX's int4 suite: an int8 activation flips where
the two sides take a bf16 rounding apart), int4 exact within 0.12 + 0.05
(XLA on the CPU keeps JAX's bf16(code * s) in float32, the port rounds it
as the TPU does: ``ROADMAP.md`` section 3).  The appended row at ``pos``,
layer 0 (the same input on both sides, so the same float32 row up to a
sum order): bf16 equal, ``Int8KV`` codes within one and scales at rtol
1e-2, fp8 codes within one e4m3 step and at least 99 % equal (int4 exact:
the values, at the fp8 rows' tolerance below, since JAX's own row differs
by the caveat above).  Layer 1 takes layer 0's output, which the two
sides sum in other orders, and there the bf16 rows part by a rounding in
most places, at hd 128 as at hd 64 (``tests/test_torch_kv8.py`` holds
the same drift): rows by value, bf16 at atol 0.05 (the JAX suite's bf16
limit), dequantized int8 rows at atol 0.08, fp8 rows at atol 0.08 + rtol
0.125 (one e4m3 step), and int8 scales at rtol 2e-2.  Rows below ``pos``
untouched.

One layer at the operating point goes through JAX's kernel directly, its
O weights' scales powers of two, so that the attention's share of the
residual tells an exact int4 O product from a W4A8 one.

The JAX-free tests hold the two hd-64 rules apart: the twin stores an
8-bit row from the bf16-rounded row at hd 64 and from the float32 row at
hd 128 (a row built so that the two give other codes), and its int4 O
product is exact at hd 64 under ``int4_w4a8=True``; and mode 5's twin
over two ranks against the one-card twin on the same tree.  JAX compiles
one step per case and the one-layer kernel (six shapes in all), well
inside jaxlib's CPU limit of about 150 compiles a process.
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
from clusterfusion_tpu.ops import quant as jq
from clusterfusion_tpu_torch import parallel as par
from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as tmodel
from clusterfusion_tpu_torch.models.convert import params_from_numpy
from clusterfusion_tpu_torch.ops import decoder_layer as tdl
from clusterfusion_tpu_torch.ops import quant as tq
from clusterfusion_tpu_torch.ops import stack_kernel as sk
from clusterfusion_tpu_torch.parallel.mesh import AXES

CAP, POS, GAP = 256, 120, 0.05
FP8 = torch.float8_e4m3fn
GEOM = dict(head_dim=64, n_kv_heads=2, n_layers=2, max_seq_len=CAP,
            rope_style="neox")
# (weights, W4A8, cache): the five cases
CASES = [("bf16", True, "bf16"), ("int8", True, "bf16"),
         ("int4", True, "int8"), ("bf16", True, "fp8"),
         ("int4", False, "fp8")]
# logits: (atol as a share of max(|logits|, 1), rtol)
LOGIT_TOL = {("int4", True): (0.35, 0.05), ("int4", False): (0.12, 0.05)}


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _rows(c, lo, hi):
    """Rows lo..hi-1 of every layer as float32 values (int8: dequantized)."""
    if isinstance(c, (tq.Int8KV, jq.Int8KV)):
        L, H, R, _ = c.s.shape
        s = _np(c.s).reshape(L, H, R * 128)[:, :, lo:hi]
        return _np(c.q)[:, :, lo:hi] * s[..., None]
    return _np(c)[:, :, lo:hi]


def _random_cache(fmt, cfg, seed):
    """(JAX's pair, the port's pair) of one random cache, every row filled:
    bf16 or e4m3 values of N(0, 1); int8 codes with scales of
    0.005-0.03."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, cfg.kv_heads, CAP, cfg.head_dim_)
    jax_pair, port_pair = [], []
    for _ in range(2):
        if fmt == "int8":
            q = rng.integers(-127, 128, shape).astype(np.int8)
            s = rng.uniform(0.005, 0.03, (*shape[:2], 8, 128)).astype(
                np.float32)
            jax_pair.append(jq.Int8KV(jnp.asarray(q), jnp.asarray(s)))
            port_pair.append(tq.Int8KV(torch.from_numpy(q.copy()),
                                       torch.from_numpy(s.copy())))
            continue
        x = rng.standard_normal(shape).astype(np.float32)
        dt = ml_dtypes.bfloat16 if fmt == "bf16" else ml_dtypes.float8_e4m3fn
        raw = x.astype(dt)
        jax_pair.append(jnp.asarray(raw))
        bits = torch.from_numpy(raw.view(np.uint16 if fmt == "bf16"
                                         else np.uint8).copy())
        port_pair.append(bits.view(torch.bfloat16 if fmt == "bf16" else FP8))
    return jax_pair, port_pair


@pytest.fixture(scope="module")
def base():
    jcfg, tcfg = JConfig.tiny(**GEOM), LlamaConfig.tiny(**GEOM)
    assert tcfg.head_dim_ == 64 and tcfg.n_heads // tcfg.kv_heads == 2
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    trees = {"bf16": jp, "int8": jq.quantize_llama_params(jp, "int8"),
             "int4": jq.quantize_llama_params(jp, "int4")}
    return dict(jcfg=jcfg, tcfg=tcfg, jp=trees,
                tp={k: params_from_numpy(jax.tree.map(np.asarray, v),
                                         device="cpu")
                    for k, v in trees.items()})


def _check_logits(t, j, weights, a8):
    frac, rtol = LOGIT_TOL.get((weights, a8), (0.06, 0.0))
    jn = _np(j)
    scale = max(float(np.abs(jn).max()), 1.0)
    err = np.abs(_np(t) - jn)
    assert np.all(err <= frac * scale + rtol * np.abs(jn)), err.max()


def _check_rows(t, j, fmt, lo, n=1, exact_int4=False):
    """The appended rows lo..lo+n-1 of the port's cache against JAX's (the
    module's tolerances: layer 0 by its codes, every layer by value)."""
    tr, jr = _rows(t, lo, lo + n), _rows(j, lo, lo + n)
    if fmt == "int8":
        dq = np.abs(t.q[0, :, lo:lo + n].numpy().astype(np.int32)
                    - np.asarray(j.q)[0, :, lo:lo + n].astype(np.int32))
        assert dq.max() <= 1, dq.max()
        L, H, R, _ = t.s.shape
        ts = t.s.reshape(L, H, -1)[:, :, lo:lo + n].numpy()
        js = np.asarray(j.s).reshape(L, H, -1)[:, :, lo:lo + n]
        np.testing.assert_allclose(ts[0], js[0], rtol=1e-2)
        np.testing.assert_allclose(ts, js, rtol=2e-2)
        np.testing.assert_allclose(tr, jr, atol=0.08, rtol=0)
    elif fmt == "fp8":
        if not exact_int4:
            tb = t[0, :, lo:lo + n].view(torch.uint8).numpy().astype(np.int32)
            jb = np.asarray(j)[0, :, lo:lo + n].view(np.uint8).astype(np.int32)
            # a sign's codes are in order: one e4m3 step is one code apart
            assert np.abs(tb - jb).max() <= 1, np.abs(tb - jb).max()
            assert np.mean(tb == jb) >= 0.99, np.mean(tb == jb)
        np.testing.assert_allclose(tr, jr, atol=0.08, rtol=0.125)
    else:
        assert np.array_equal(tr[0], jr[0])
        np.testing.assert_allclose(tr, jr, atol=0.05, rtol=0)


@pytest.mark.parametrize("weights,a8,fmt", CASES,
                         ids=[f"{w}{'' if w != 'int4' else '_w4a8' if a else '_exact'}-{c}"
                              for w, a, c in CASES])
def test_decode_step_fused_matches_jax(base, weights, a8, fmt):
    """``decode_step(fused=True)`` at hd 64: the port's kernel-7 twin
    against JAX's fused step (``defer_append``) on the same tree and
    cache: logits, the appended row at POS, the rows below it untouched."""
    (jk, jv), (tk, tv) = _random_cache(fmt, base["tcfg"], 1)
    jl, jk2, jv2 = jmodel.decode_step(
        base["jp"][weights], jk, jv, jnp.asarray(7, jnp.int32),
        jnp.asarray(POS, jnp.int32), base["jcfg"],
        JKernelConfig(int4_w4a8=a8), fused=True)
    before = sk.launches
    tl, tk2, tv2 = tmodel.decode_step(base["tp"][weights], tk, tv, 7, POS,
                                      base["tcfg"],
                                      KernelConfig(int4_w4a8=a8), fused=True)
    assert sk.launches == before              # the CPU runs the twin
    assert tk2 is tk and tv2 is tv
    _check_logits(tl, jl, weights, a8)
    for t, j, j0 in ((tk, jk2, jk), (tv, jv2, jv)):
        _check_rows(t, j, fmt, POS, exact_int4=weights == "int4" and not a8)
        assert np.array_equal(_rows(t, 0, POS), _rows(j0, 0, POS))


def test_decode_loop_operating_point_matches_jax(base):
    """The port's ``decode_loop`` (3 greedy steps, int4 W4A8 weights and an
    ``Int8KV`` cache, kernel 7's twin) teacher-forced into JAX's fused
    step: wherever JAX's top-2 gap exceeds 0.05 it picks the port's token,
    and the three appended rows agree at the module's ``Int8KV``
    tolerances."""
    (jk, jv), (tk, tv) = _random_cache("int8", base["tcfg"], 1)
    toks, tk, tv = tmodel.decode_loop(base["tp"]["int4"], tk, tv, 7, POS,
                                      base["tcfg"], KernelConfig(),
                                      fused=True, n_steps=3)
    tok = 7
    for i in range(3):
        jl, jk, jv = jmodel.decode_step(
            base["jp"]["int4"], jk, jv, jnp.asarray(tok, jnp.int32),
            jnp.asarray(POS + i, jnp.int32), base["jcfg"], JKernelConfig(),
            fused=True)
        jn = _np(jl)
        top = np.sort(jn)[-2:]
        if top[1] - top[0] > GAP:
            assert int(np.argmax(jn)) == int(toks[i]), i
        tok = int(toks[i])
    for t, j in ((tk, jk), (tv, jv)):
        _check_rows(t, j, "int8", POS, 3)


# ---- JAX-free: the two hd-64 rules and mode 5 -----------------------------

def _crafted_row(hd):
    """A float32 row, each value the exact sum of two bf16 numbers (so a
    bf16 product against a row of ones gives it bit for bit), whose int8
    codes and e4m3 codes differ between the row and its bf16 rounding: its
    absmax 1 + 2^-9 rounds to 1 in bf16, so the int8 scale differs and so
    does the code of every bf16 value in [1/2, 1) whose 127 multiple lies
    just above a half (the rest of the row cycles through that grid); and
    e4m3 midpoints nudged up by 2^-12 of themselves round up from float32
    but to even from their bf16 rounding (the midpoint)."""
    vals = [(1.0, 2.0 ** -9)]
    for v in (0.5, 0.625, 0.75, 0.875):     # e4m3 values of even mantissa
        mid = v + 0.03125                    # halfway to the next (step 1/16)
        vals.append((-mid, -mid * 2.0 ** -12))
    m = 128
    while len(vals) < hd:
        vals.append((m / 256, 0.0))          # bf16 exactly
        m = m + 1 if m < 255 else 128
    a = torch.tensor([v[0] for v in vals]).bfloat16()
    b = torch.tensor([v[1] for v in vals]).bfloat16()
    return a, b


def _row_stack(hd, kv_cache):
    """A one-layer stack whose k and v rows at pos 1 are ``_crafted_row``:
    x of ones, eps 0 (the normed row is exactly ones), the k and v columns
    of wqkv_f holding the row's two bf16 parts in hidden rows 0 and 1,
    cos 1 and sin 0 (rope the identity)."""
    hidden, g, kv, f = 256, 2, 1, 256
    a, b = _crafted_row(hd)
    wqkv = torch.zeros(1, 1, hidden, (g + 2) * hd, dtype=torch.bfloat16)
    for j in (g, g + 1):                     # k, then v
        wqkv[0, 0, 0, j * hd:(j + 1) * hd] = a
        wqkv[0, 0, 1, j * hd:(j + 1) * hd] = b
    rng = np.random.default_rng(6)
    wo = torch.from_numpy(rng.standard_normal((1, 1, g * hd, hidden)) * 0.05)
    args = (torch.ones(1, hidden, dtype=torch.bfloat16),
            torch.ones(1, hidden, dtype=torch.bfloat16),
            torch.ones(1, hidden, dtype=torch.bfloat16),
            torch.ones(1, hd), torch.zeros(1, hd), wqkv,
            wo.bfloat16(), torch.zeros(1, 2, hidden, f, dtype=torch.bfloat16),
            torch.zeros(1, f, hidden, dtype=torch.bfloat16))
    if kv_cache == "int8":
        caches = [tq.init_kv_int8(1, kv, 16, hd) for _ in range(2)]
    else:
        caches = [torch.zeros(1, kv, 16, hd, dtype=FP8) for _ in range(2)]
    row = a.float() + b.float()
    return args, caches, row, dict(group=g, head_dim=hd, rope_style="neox",
                                   eps=0.0)


@pytest.mark.parametrize("kv_cache", ["int8", "fp8"])
def test_append_rule_bf16_row_at_hd64(kv_cache):
    """The twin's stored copy of the new row: at hd 64 the 8-bit codes
    (and int8 scale) of the bf16-rounded row, as the TPU kernel's deferred
    append lands it; at hd 128 those of the float32 row.  The crafted row
    makes the two differ, and the fold (the output) uses the float32 row
    at both widths."""
    for hd in (64, 128):
        args, caches, row, kw = _row_stack(hd, kv_cache)
        assert torch.equal(row, args[5][0, 0, :2, 2 * hd:3 * hd].float()
                           .sum(dim=0))
        sk.fused_decoder_stack_plain(*args, *caches, 1, **kw)
        want_rows = {"f32": row, "bf16": row.bfloat16().float()}
        want = {}
        for k, r in want_rows.items():
            if kv_cache == "int8":
                q, s = tq.quantize_kv_rows(r[None])
                want[k] = (q[0], s[0])
            else:
                want[k] = (r.to(FP8).view(torch.uint8), None)
        assert not torch.equal(want["f32"][0], want["bf16"][0])
        rule = "bf16" if hd == 64 else "f32"
        for c in caches:
            if kv_cache == "int8":
                assert torch.equal(c.q[0, 0, 1], want[rule][0])
                assert torch.equal(tq.kv_scales_flat(c.s, 16)[0, 0, 1],
                                   want[rule][1])
            else:
                assert torch.equal(c[0, 0, 1].view(torch.uint8),
                                   want[rule][0])


@pytest.mark.parametrize("hd", [64, 128])
def test_int4_o_product_exact_at_hd64(monkeypatch, hd):
    """Under ``int4_w4a8=True`` the twin's int4 O product is the exact
    product at hd 64 (the TPU kernel's per-row O contraction dequantizes
    its tile) and W4A8 at hd 128, while the QKV and FFN products stay
    W4A8 at both widths.  Each product's mode is read at the call, and
    the O product's result is held against an independent exact product
    (x in bf16 against bf16(code * bf16(s)), summed in float64)."""
    cfg = LlamaConfig.tiny(head_dim=hd, n_kv_heads=2, n_layers=1,
                           max_seq_len=CAP, rope_style="neox")
    p = tq.quantize_llama_params(tmodel.init_params(cfg, seed=3,
                                                    device="cpu"), "int4")
    lw = p["layers"]
    calls = []
    real = tdl._int4_dot

    def spy(x, q, s, gs, w4a8):
        out = real(x, q, s, gs, w4a8)
        calls.append((x, q, s, w4a8, out))
        return out

    monkeypatch.setattr(tdl, "_int4_dot", spy)
    kc, vc = tmodel.init_cache(cfg, device="cpu")
    cos, sin = tmodel.rope_row(cfg, 5, "cpu")
    x = p["embed"][torch.tensor([3])]
    sk.fused_decoder_stack_plain(
        x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
        lw["wo_f"], lw["w13"], lw["w2"], kc, vc, 5, group=2, head_dim=hd,
        rope_style="neox", eps=cfg.norm_eps, int4_w4a8=True)
    wo = lw["wo_f"]
    o_calls = [c for c in calls if c[1].data_ptr() in
               {wo.q[0, i].data_ptr() for i in range(wo.q.shape[1])}]
    others = [c for c in calls if all(c is not o for o in o_calls)]
    assert len(o_calls) == wo.q.shape[1] and others
    assert all(c[3] for c in others)
    for xo, q, s, w4a8, out in o_calls:
        assert w4a8 == (hd == 128)
        if hd == 64:
            w = tq.unpack_int4_bitcast(q).to(torch.bfloat16) * \
                tq.expand_group_scales(s.to(torch.bfloat16), 0, 128)
            want = xo.to(torch.bfloat16).double() @ w.double()
            torch.testing.assert_close(out.double(), want, rtol=1e-5,
                                       atol=1e-5 * want.abs().max().item())


def test_int4_o_product_exact_matches_jax(base, monkeypatch):
    """The exact int4 O product under W4A8 at hd 64, held against JAX's
    kernel: one layer of int4 W4A8 weights on an ``Int8KV`` cache through
    JAX's ``fused_decoder_stack`` (interpret mode) and the port's twin, the
    O weights' scales rounded to powers of two so that bf16(code * s) is
    exact on both sides (JAX's CPU caveat, ``ROADMAP.md`` section 3, does
    not apply).  The attention's share of the residual (residual - x) then
    differs only by the summation orders before the O product: its mean
    error within 3.5e-3 of its mean magnitude and at least 40 % of the
    residual's bf16 values equal.  The same twin with its O product forced
    to W4A8 (an int8 activation per head group) misses both, so the limits
    tell the two rules apart."""
    import dataclasses

    from clusterfusion_tpu.ops import stack_kernel as jsk
    geom = dict(GEOM, n_layers=1)
    jcfg, tcfg = JConfig.tiny(**geom), LlamaConfig.tiny(**geom)
    jp = jq.quantize_llama_params(
        jmodel.init_params(jcfg, jax.random.PRNGKey(0)), "int4")
    wo = jp["layers"]["wo_f"]
    jp = dict(jp, layers=dict(jp["layers"], wo_f=dataclasses.replace(
        wo, s=jnp.exp2(jnp.round(jnp.log2(wo.s))))))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    (jk, jv), (tk, tv) = _random_cache("int8", tcfg, 1)
    cos_t, sin_t = jmodel.rope_table(jcfg)
    cos, sin = cos_t[POS][None], sin_t[POS][None]
    kw = dict(group=2, head_dim=64, rope_style="neox", eps=jcfg.norm_eps)
    names = ("attn_norm", "ffn_norm", "wqkv_f", "wo_f", "w13", "w2")
    jl = jp["layers"]
    _, jres, _, _ = jsk.fused_decoder_stack(
        jp["embed"][7][None], jl["attn_norm"], jl["ffn_norm"], cos, sin,
        *(jl[k] for k in names[2:]), jk, jv, jnp.asarray(POS, jnp.int32),
        kcfg=JKernelConfig(int4_w4a8=True), interpret=True, **kw)
    tl = tp["layers"]
    x = tp["embed"][torch.tensor([7])]
    o_ptrs = {tl["wo_f"].q[0, i].data_ptr()
              for i in range(tl["wo_f"].q.shape[1])}
    real = tdl._int4_dot

    def attn_share(o_w4a8):
        def dot(xr, q, s, gs, w4a8):
            return real(xr, q, s, gs, o_w4a8 if q.data_ptr() in o_ptrs
                        else w4a8)
        monkeypatch.setattr(tdl, "_int4_dot", dot)
        caches = [tq.Int8KV(c.q.clone(), c.s.clone()) for c in (tk, tv)]
        _, res, _, _ = sk.fused_decoder_stack_plain(
            x, tl["attn_norm"], tl["ffn_norm"], torch.tensor(np.asarray(cos)),
            torch.tensor(np.asarray(sin)),
            *(tl[k] for k in names[2:]), *caches, POS, int4_w4a8=True, **kw)
        monkeypatch.setattr(tdl, "_int4_dot", real)
        want = _np(jres) - _np(x)
        err = np.abs(_np(res) - _np(x) - want).mean() / np.abs(want).mean()
        return err, np.mean(_np(res) == _np(jres))

    err, equal = attn_share(False)
    assert err <= 3.5e-3 and equal >= 0.4, (err, equal)
    err, equal = attn_share(True)
    assert err > 3.5e-3 and equal < 0.4, (err, equal)


def _tp_mesh(rank, tp=2):
    return par.Mesh(shape=dict(dict.fromkeys(AXES, 1), tp=tp),
                    coords=dict(dict.fromkeys(AXES, 0), tp=rank),
                    groups=dict.fromkeys(AXES))


@pytest.mark.parametrize("kind", ["bf16", "int8_int8kv"])
def test_mode5_twin_at_hd64_matches_one_card(kind):
    """Mode 5 at hd 64: ``fused_decoder_stack_plain_ranks`` at tp 2 (each
    rank its ``shard_params`` / ``shard_cache`` slices, hg 1 so that G
    divides over the ranks, the reduces summed in rank order) against the
    one-card twin on the same tree and cache: x_out and the residual
    within 2e-2 of their largest value (the O and down sums split over
    the ranks), the ranks identical, each rank's appended rows its heads'
    rows of the one-card step (layer 0: equal), the other rows untouched.
    Runs bf16 weights on a bf16 cache, and int8 weights on an ``Int8KV``
    cache (the hd-64 append rule on the ranks' rows)."""
    cfg = LlamaConfig.tiny(**GEOM)
    p = tmodel.init_params(cfg, seed=4, head_group=1, device="cpu")
    if kind != "bf16":
        p = tq.quantize_llama_params(p, "int8")
    kc, vc = tmodel.init_cache(cfg, device="cpu",
                               dtype="int8" if kind != "bf16"
                               else torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    for c in (kc, vc):
        rows = torch.randn(cfg.n_layers, cfg.kv_heads, POS, 64,
                           generator=gen)
        for l in range(cfg.n_layers):
            tq.cache_write_layer(c, l, rows[l], 0)
    lw = p["layers"]
    cos, sin = tmodel.rope_row(cfg, POS, "cpu")
    x = p["embed"][torch.tensor([9])]
    kw = dict(group=2, head_dim=64, rope_style="neox", eps=cfg.norm_eps)
    names = ("attn_norm", "ffn_norm", "wqkv_f", "wo_f", "w13", "w2")

    def clone(c):
        return tq.Int8KV(c.q.clone(), c.s.clone()) \
            if isinstance(c, tq.Int8KV) else c.clone()

    k1, v1 = clone(kc), clone(vc)
    one = sk.fused_decoder_stack_plain(
        x, lw["attn_norm"], lw["ffn_norm"], cos, sin,
        *(lw[k] for k in names[2:]), k1, v1, POS, **kw)
    meshes = [_tp_mesh(r) for r in range(2)]
    shards = [par.shard_params(p, cfg, m) for m in meshes]
    caches = [(clone(par.shard_cache(kc, m)), clone(par.shard_cache(vc, m)))
              for m in meshes]
    outs = sk.fused_decoder_stack_plain_ranks(
        [(x, sh["layers"]["attn_norm"], sh["layers"]["ffn_norm"], cos, sin,
          *(sh["layers"][k] for k in names[2:]), *caches[r], POS)
         for r, sh in enumerate(shards)], **kw)
    for o in outs:
        assert torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
        for j in (0, 1):
            want = one[j].float()
            err = (o[j].float() - want).abs().max().item()
            assert err <= 2e-2 * want.abs().max().item(), (j, err)
    for r, (kr, vr) in enumerate(caches):
        for got, full, c0 in ((kr, k1, kc), (vr, v1, vc)):
            heads = slice(r, r + 1)
            sl = (tq.Int8KV(full.q[:, heads], full.s[:, heads])
                  if isinstance(full, tq.Int8KV) else full[:, heads])
            s0 = (tq.Int8KV(c0.q[:, heads], c0.s[:, heads])
                  if isinstance(c0, tq.Int8KV) else c0[:, heads])
            g_row, w_row = _rows(got, POS, POS + 1), _rows(sl, POS, POS + 1)
            assert np.array_equal(g_row[0], w_row[0])
            np.testing.assert_allclose(g_row, w_row, atol=0.05, rtol=1e-2)
            assert np.array_equal(_rows(got, 0, POS), _rows(s0, 0, POS))
            assert np.array_equal(_rows(got, POS + 1, CAP),
                                  _rows(s0, POS + 1, CAP))


@pytest.mark.parametrize("hd", [32, 96])
def test_stack_refuses_other_head_dims(hd):
    """Kernel 7 takes head dims 64 and 128 (the widths its card tests
    cover); 32 and 96 raise NotImplementedError by name before any work,
    here as on the card, and leave the caches as they were."""
    cfg = LlamaConfig.tiny(head_dim=hd, n_kv_heads=2, n_layers=1,
                           max_seq_len=CAP, rope_style="neox")
    p = tmodel.init_params(cfg, seed=2, device="cpu")
    kc, vc = tmodel.init_cache(cfg, device="cpu")
    k0 = kc.clone()
    with pytest.raises(NotImplementedError,
                       match=f"head_dim {hd}; the kernels take 64 and 128"):
        tmodel.decode_step(p, kc, vc, 3, 5, cfg, fused=True)
    assert torch.equal(kc, k0)
