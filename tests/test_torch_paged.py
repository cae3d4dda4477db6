"""The port's paged kernels (plain twins, on the CPU) against the JAX
package's Pallas kernels in interpret mode, on the same numpy-seeded
inputs: ``paged_attention``, ``llama_decoder_layer_paged`` and the sglang
page-1 entry.

Tolerances: outputs at atol 2e-2 / rtol 2e-2 (bf16 outputs; the two walk
the rows in other chunks, so bf16(p) and the sums round differently).
Appended rows are exact for ``paged_attention`` (both cast the given bf16
K/V) and at atol/rtol 2e-2 for the layer (each rounds its own float32
projection to bf16, a flip is one bf16 ulp).  Every other pool row must be
bit-equal to the input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clusterfusion_tpu.config import KernelConfig as JKernelConfig
from clusterfusion_tpu.ops import llama_decoder_layer_batch_decode_sglang \
    as j_sglang
from clusterfusion_tpu.ops import paged_decoder_layer as jpd
from clusterfusion_tpu_torch.models.convert import tensor_from_numpy
from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd

TOL = dict(atol=2e-2, rtol=2e-2)


def _pair(a, dtype=jnp.bfloat16):
    """numpy -> (jax array, torch CPU tensor) with the same bits."""
    j = jnp.asarray(a, dtype)
    return j, tensor_from_numpy(np.asarray(j), device="cpu")


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _paged_setup(rng, L, kv, page, hd, lens, n_spare=3):
    """Random pools and a block table over shuffled pages (page 0 unowned);
    request b owns lens[b] // page + 1 pages."""
    need = [n // page + 1 for n in lens]
    n_pages = 1 + sum(need) + n_spare
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((len(lens), max(need)), np.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at:at + n]
        at += n
    kp = rng.randn(L, n_pages, kv, page, hd)
    vp = rng.randn(L, n_pages, kv, page, hd)
    return kp, vp, table, np.asarray(lens, np.int32)


def _check_pools(t_pool, j_pool, t_in, table, lens, layer, exact):
    """Appended rows agree, every other row is the input's."""
    page = t_in.shape[3]
    app = np.zeros(t_in.shape, bool)
    for b, n in enumerate(lens):
        app[layer, table[b, n // page], :, n % page] = True
    tp, jp = _np(t_pool), _np(j_pool)
    if exact:
        np.testing.assert_array_equal(tp[app], jp[app])
    else:
        np.testing.assert_allclose(tp[app], jp[app], **TOL)
    np.testing.assert_array_equal(tp[~app], _np(t_in)[~app])
    np.testing.assert_array_equal(jp[~app], _np(t_in)[~app])


@pytest.mark.parametrize("kv,g,page,lens", [
    (2, 1, 16, [0, 16, 5, 300]),          # empty, page boundary, 3 splits
    (2, 4, 8, [9, 0, 129]),               # GQA, page 8, a split and a row
], ids=["mha_page16", "gqa_page8"])
def test_paged_attention_matches_jax(kv, g, page, lens):
    rng = np.random.RandomState(0)
    L, layer, hd, B = 2, 1, 128, len(lens)
    kp, vp, table, lens = _paged_setup(rng, L, kv, page, hd, lens)
    jq, tq = _pair(rng.randn(B, kv, g, hd))
    jk, tk = _pair(rng.randn(B, kv, hd))
    jv, tv = _pair(rng.randn(B, kv, hd))
    jkp, tkp = _pair(kp)
    jvp, tvp = _pair(vp)
    tk_in, tv_in = tkp.clone(), tvp.clone()
    jo, jkp2, jvp2 = jpd.paged_attention(
        jq, jk, jv, jkp, jvp, jnp.asarray(table), jnp.asarray(lens), layer,
        kcfg=JKernelConfig(kv_chunk=32))      # several windows per request
    to, tkp2, tvp2 = pd.paged_attention(tq, tk, tv, tkp, tvp,
                                        torch.from_numpy(table),
                                        torch.from_numpy(lens), layer)
    assert tkp2 is tkp and tvp2 is tvp                 # in place
    assert to.shape == (B, kv * g * hd) and to.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    _check_pools(tkp, jkp2, tk_in, table, lens, layer, exact=True)
    _check_pools(tvp, jvp2, tv_in, table, lens, layer, exact=True)


def _rope_tables(hd, max_pos=256):
    angle = np.outer(np.arange(max_pos), 0.2 * np.arange(hd // 2) + 0.05)
    c, s = np.cos(angle), np.sin(angle)
    return (np.concatenate([c, c], -1).astype(np.float32),
            np.concatenate([s, s], -1).astype(np.float32))


@pytest.mark.parametrize("kv,g,hd,hg,page,lens,style", [
    (4, 1, 128, 2, 16, [0, 16, 260], "neox"),
    (2, 2, 64, 1, 8, [9, 0, 140], "gptj"),
], ids=["mha_hd128_page16", "gqa_hd64_page8"])
def test_paged_layer_matches_jax(kv, g, hd, hg, page, lens, style):
    rng = np.random.RandomState(1)
    L, layer, hidden, B = 2, 1, 512, len(lens)
    G = kv // hg
    kp, vp, table, lens = _paged_setup(rng, L, kv, page, hd, lens)
    jx, tx = _pair(rng.randn(B, hidden))
    jr, tr = _pair(rng.randn(B, hidden))
    jwq, twq = _pair(rng.randn(L, G, hidden, hg * (g + 2) * hd)
                     * hidden ** -0.5)
    jwo, two = _pair(rng.randn(L, G, hg * g * hd, hidden)
                     * (kv * g * hd) ** -0.5)
    jrms, trms = _pair(1 + 0.1 * rng.randn(1, hidden))
    jkp, tkp = _pair(kp)
    jvp, tvp = _pair(vp)
    tk_in, tv_in = tkp.clone(), tvp.clone()
    cos, sin = _rope_tables(hd, max_pos=512)
    pos = lens + 3                                  # any positions
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
    np.testing.assert_allclose(_np(tout[0]), _np(jout[0]), **TOL)
    np.testing.assert_allclose(_np(tout[1]), _np(jout[1]), **TOL)
    _check_pools(tkp, jout[2], tk_in, table, lens, layer, exact=False)
    _check_pools(tvp, jout[3], tv_in, table, lens, layer, exact=False)


def test_sglang_entry_matches_jax():
    """Page size 1, indptr/indices naming shuffled pool rows."""
    rng = np.random.RandomState(2)
    heads, hd, hidden, L, layer = 4, 128, 512, 2, 1
    lens = [5, 140, 1]                             # one crosses a split
    B, total = len(lens), sum(lens) + len(lens)
    num_pages = total + 7
    indices = rng.permutation(num_pages)[:total].astype(np.int32)
    indptr = np.cumsum([0] + [n + 1 for n in lens]).astype(np.int32)
    jx, tx = _pair(rng.randn(B, hidden))
    jr, tr = _pair(rng.randn(B, hidden))
    jwq, twq = _pair(rng.randn(3 * hidden, hidden) * 0.05)
    jwo, two = _pair(rng.randn(hidden, hidden) * 0.05)
    jkc, tkc = _pair(rng.randn(L, num_pages, hidden))
    jvc, tvc = _pair(rng.randn(L, num_pages, hidden))
    jrms, trms = _pair(1 + 0.1 * rng.randn(hidden))
    angle = np.outer(np.arange(160), 0.3 * np.arange(hd // 2) + 0.1)
    cos_sin = np.concatenate([np.cos(angle), np.sin(angle)], -1) \
        .astype(np.float32)
    pos = np.asarray(lens, np.int32)
    tk_in = tkc.clone()
    jout = j_sglang(jx, jr, jwq, jwo, jnp.asarray(indptr),
                    jnp.asarray(indices), jkc, jvc, layer, jrms, 1e-5,
                    jnp.asarray(pos), jnp.asarray(cos_sin), n_heads=heads,
                    head_dim=hd)
    tout = pd.llama_decoder_layer_batch_decode_sglang(
        tx, tr, twq, two, torch.from_numpy(indptr), torch.from_numpy(indices),
        tkc, tvc, layer, trms, 1e-5, torch.from_numpy(pos),
        torch.from_numpy(cos_sin), n_heads=heads, head_dim=hd)
    assert tout[2] is tkc and tout[3] is tvc
    for t, j in zip(tout[:2], jout[:2]):
        np.testing.assert_allclose(_np(t), _np(j), **TOL)
    new_rows = indptr[1:] - 1                      # each request's last slot
    for t, j in zip(tout[2:], jout[2:]):
        np.testing.assert_allclose(_np(t)[layer, indices[new_rows]],
                                   _np(j)[layer, indices[new_rows]], **TOL)
    others = np.ones(num_pages, bool)
    others[indices[new_rows]] = False
    np.testing.assert_array_equal(_np(tkc)[layer, others],
                                  _np(tk_in)[layer, others])
    np.testing.assert_array_equal(_np(tkc)[0], _np(tk_in)[0])


def _sglang_case(seed):
    """Page size 1, indptr/indices naming shuffled pool rows: numpy
    inputs of kernel 9's sglang entry (layer 1 of two)."""
    rng = np.random.RandomState(seed)
    heads, hd, hidden, L = 4, 128, 512, 2
    lens = [5, 140, 1]
    B, total = len(lens), sum(lens) + len(lens)
    num_pages = total + 7
    d = dict(indices=rng.permutation(num_pages)[:total].astype(np.int32),
             indptr=np.cumsum([0] + [n + 1 for n in lens]).astype(np.int32),
             x=rng.randn(B, hidden), res=rng.randn(B, hidden),
             wq=rng.randn(3 * hidden, hidden) * 0.05,
             wo=rng.randn(hidden, hidden) * 0.05,
             kc=rng.randn(L, num_pages, hidden),
             vc=rng.randn(L, num_pages, hidden),
             rms=1 + 0.1 * rng.randn(hidden),
             pos=np.asarray(lens, np.int32))
    angle = np.outer(np.arange(160), 0.3 * np.arange(hd // 2) + 0.1)
    d["cos_sin"] = np.concatenate([np.cos(angle), np.sin(angle)], -1) \
        .astype(np.float32)
    return d, heads, hd


def test_paged_layer_oracle_matches_jax_and_the_sglang_entry():
    """``llama_decoder_layer_batch_paged_ref`` (float32) against JAX's, to a
    bf16 rounding of each output and every pool row equal; then kernel 9's
    sglang entry (its plain twin here) against the oracle at this file's
    tolerance, the appended rows within 0.05."""
    from clusterfusion_tpu.ops import reference as jref
    from clusterfusion_tpu_torch.ops import reference as tref
    d, heads, hd = _sglang_case(5)
    layer = 1
    pair = {k: _pair(d[k]) for k in ("x", "res", "wq", "wo", "kc", "vc",
                                     "rms")}
    idx = {k: (jnp.asarray(d[k]), torch.from_numpy(d[k]))
           for k in ("indptr", "indices", "pos", "cos_sin")}
    kw = dict(n_heads=heads, head_dim=hd)

    def args(side):
        a = [pair[k][side] for k in ("x", "res", "wq", "wo")]
        a += [idx["indptr"][side], idx["indices"][side]]
        a += [pair["kc"][side][layer], pair["vc"][side][layer]]
        a += [pair["rms"][side], 1e-5, idx["pos"][side],
              idx["cos_sin"][side]]
        return a

    want = jref.llama_decoder_layer_batch_paged_ref(*args(0), **kw)
    ref = tref.llama_decoder_layer_batch_paged_ref(*args(1), **kw)
    for t, j in zip(ref[:2], want[:2]):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-2, atol=1e-2)
    for t, j in zip(ref[2:], want[2:]):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-2, atol=1e-2)
    tkc, tvc = pair["kc"][1].clone(), pair["vc"][1].clone()
    out = pd.llama_decoder_layer_batch_decode_sglang(
        pair["x"][1], pair["res"][1], pair["wq"][1], pair["wo"][1],
        idx["indptr"][1], idx["indices"][1], tkc, tvc, layer,
        pair["rms"][1], 1e-5, idx["pos"][1], idx["cos_sin"][1], **kw)
    for t, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(_np(t), _np(r), **TOL)
    new = d["indices"][d["indptr"][1:] - 1]
    for t, r in ((tkc, ref[2]), (tvc, ref[3])):
        np.testing.assert_allclose(_np(t)[layer, new], _np(r)[new], rtol=0,
                                   atol=0.05)


@pytest.mark.parametrize("g,page,lens", [
    (1, 16, [0, 1, 127, 128, 129, 300]),
    (4, 1, [0, 130, 37]),
], ids=["mha_page16", "gqa_page1"])
def test_split_walk_matches_one_split(g, page, lens):
    """The twins' walk in SPLIT-row splits against the same walk in one
    split covering every row.  The two round p to bf16 against different
    running maxima (each split restarts its own), so a p may differ by one
    bf16 rounding (2^-8 of itself) and the output by a bf16 rounding of
    its own: outputs at atol 2e-2 / rtol 2e-2, the suite's bf16 limit."""
    rng = np.random.RandomState(4)
    kv, hd, layer, B = 2, 64, 1, len(lens)
    kp, vp, table, lens = _paged_setup(rng, 2, kv, page, hd, lens)
    kp, vp = (torch.from_numpy(x).bfloat16() for x in (kp, vp))
    q = torch.from_numpy(rng.randn(B, kv, g, hd)).float()
    qs = pd._scaled_q(q)
    k_cur = torch.from_numpy(rng.randn(B, kv, hd)).bfloat16()
    v_cur = torch.from_numpy(rng.randn(B, kv, hd)).bfloat16()
    args = (qs, qs, k_cur, v_cur, kp, vp, torch.from_numpy(table),
            torch.from_numpy(lens), layer)
    split = pd._walk_plain(*args)
    one = pd._walk_plain(*args, split=pd.TILE * (max(lens) // pd.TILE + 1))
    assert max(lens) > pd.SPLIT                       # several splits
    np.testing.assert_allclose(_np(split), _np(one), **TOL)


@pytest.mark.parametrize("kw", [dict(window=8, window_pattern="even"),
                                dict(softcap=30.0)],
                         ids=["window", "softcap"])
def test_paged_kernels_refuse_unported_variants(kw):
    rng = np.random.RandomState(3)
    kp, vp, table, lens = _paged_setup(rng, 1, 2, 8, 64, [3])
    kp = torch.from_numpy(kp).bfloat16()
    q = torch.zeros((1, 2, 1, 64), dtype=torch.bfloat16)
    kn = torch.zeros((1, 2, 64), dtype=torch.bfloat16)
    args = (torch.from_numpy(table), torch.from_numpy(lens))
    with pytest.raises(NotImplementedError):
        pd.paged_attention(q, kn, kn, kp, kp.clone(), *args, 0, **kw)
    with pytest.raises(NotImplementedError):           # non-bf16 pool
        pd.paged_attention(q, kn, kn, kp.float(), kp.float(), *args, 0)
    kp8 = kp.to(torch.int8)                            # JAX's unscaled int8
    with pytest.raises(NotImplementedError, match="int8"):
        pd.paged_attention(q, kn, kn, kp8, kp8.clone(), *args, 0)
    w = torch.zeros((1, 2, 512, 3 * 64), dtype=torch.bfloat16)
    wo = torch.zeros((1, 2, 64, 512), dtype=torch.bfloat16)
    x = torch.zeros((1, 512), dtype=torch.bfloat16)
    cos = torch.zeros((16, 64))
    layer_args = (x, x, w, wo, *args, args[1], kp, kp.clone(), 0,
                  torch.ones(512, dtype=torch.bfloat16), 1e-5, cos, cos)
    with pytest.raises(NotImplementedError):
        pd.llama_decoder_layer_paged(*layer_args, **kw)
    if "window" in kw:                     # a negative window is an error
        with pytest.raises(ValueError, match="window"):
            pd.paged_attention(q, kn, kn, kp, kp.clone(), *args, 0, window=-1)
        with pytest.raises(ValueError, match="window"):
            pd.llama_decoder_layer_paged(*layer_args, window=-1)
    with pytest.raises(NotImplementedError):
        pd.llama_decoder_layer_paged(*layer_args, bias_qkv=torch.zeros(3))
    with pytest.raises(NotImplementedError, match="int8"):   # int8 pools
        pd.llama_decoder_layer_paged(*layer_args[:7], kp8, kp8.clone(),
                                     *layer_args[9:])
    with pytest.raises(NotImplementedError):           # int8 weights
        pd.llama_decoder_layer_paged(x, x, w.to(torch.int8), wo, *args,
                                     args[1], kp, kp.clone(), 0,
                                     torch.ones(512, dtype=torch.bfloat16),
                                     1e-5, cos, cos)
