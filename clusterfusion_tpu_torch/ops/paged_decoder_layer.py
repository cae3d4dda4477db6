"""Batched decode over a paged KV cache (twin of
``clusterfusion_tpu/ops/paged_decoder_layer.py``).

The pools are ``[L, n_pages, kv_heads, page, hd]``, bf16 or float8 e4m3
(``torch.float8_e4m3fn``, both of one dtype); request ``b`` owns the pages
``block_table[b]`` and has ``seq_lens[b]`` cached rows (the current token
excluded).  Two kernels:

- ``paged_attention`` (``csrc/paged_attention.cu``): each request's
  flash-decode over its pages plus the current token, and the append of
  that token's K/V row; the batched serving step runs it between its M=B
  projections.
- ``llama_decoder_layer_paged`` (``csrc/paged_decoder_layer.cu``): the
  attention half of a layer around the same walk (residual add + RMSNorm,
  the M=B QKV product, RoPE, the walk and append, the M=B O-projection);
  the fused serving step runs it.
- ``llama_decoder_layer_batch_decode_sglang`` is the reference-parity
  entry over it (sglang indptr/indices, page size 1); ``sglang_layer_args``
  gives the layer's arguments for one of its calls.

CUDA tensors launch the kernels; CPU tensors run the ``*_plain`` twins,
which repeat the kernels' arithmetic in PyTorch and round where they round:

- the walk takes each request's cached rows in splits of ``SPLIT`` rows
  (one block each on the card) and each split in tiles of ``TILE`` rows
  with an online exp2 softmax whose running max restarts at every split;
  p is rounded to bf16 against the running max for the p.V product and
  summed unrounded, and the splits and the current token are merged in
  float32;
- ``paged_attention``: q is scaled by log2(e)/sqrt(hd) and rounded to bf16
  (as the TPU wrapper does before its kernel; on the card inside the
  kernels); the current token's K/V are cast to bf16 (then to the pool's
  dtype) and folded in float32;
- ``llama_decoder_layer_paged``: x + residual is summed in float32
  (``res_out`` is its bf16), the QKV product stays float32, q and k are
  roped in float32; q is rounded to bf16 for the walk's dots only, and the
  current q, k and v join the fold unrounded; the appended rows are bf16
  (fp8 pools: below);
  o is rounded to bf16 before the O-projection, whose sum over head groups
  is float32.

Int8 weights (``ops.quant.QuantizedTensor``, per output column; the TPU
kernel's ``wq_kind == "int8"``): ``llama_decoder_layer_paged`` takes int8
``wqkv_g`` and ``wo_g`` together (scales [.., G, 1, C] and [.., G, 1,
hidden]).  Each product is x_bf16 @ bf16(code) summed in float32: QKV
scaled per head group and column after the sum over hidden, the O
projection per group on each group's partial, before the groups are summed
and the output is rounded to bf16.  On the card the codes stream through
the GEMVs' int8 instances, never as a bf16 copy.

An fp8 e4m3 pool (the TPU kernels' ``_kv_tile``): the past rows are read
exactly with e4m3 denormals (|v| <= 0.0137) flushed to 0
(``fp8_decode_scaled``); scores and bf16(p).V as on a bf16 pool.  The
current row follows each TPU kernel's rule: ``paged_attention`` stores
e4m3 of the bf16 ``k_new``/``v_new`` and folds that row as stored
(denormals kept); ``llama_decoder_layer_paged`` folds its float32 row and
appends e4m3 of it where the TPU kernel appends in-kernel (hd % 128 == 0
and page % 8 == 0), else e4m3 of its bf16 rounding (the TPU wrapper's
scatter of the bf16 ``k_new``, a double rounding).  The card saturates at
+-448, as PyTorch's cast does, where the JAX package's CPU cast gives NaN.
Int8 pools (JAX's are unscaled) and every other dtype are refused.

Int4 weights (the TPU kernel's ``wq_kind == "int4"``): ``wqkv_g`` and
``wo_g`` int4 together (codes packed two a byte along K, group scales [..,
G, K/gs, N]).  The TPU kernel always takes the exact tile dequant here:
each product is x_bf16 @ bf16(code * s) summed in float32 (the O
projection per head group, the groups summed in float32, then rounded to
bf16).  On the card the packed codes stream through the GEMVs' int4
instances in their exact mode, in group size 128 only (``ROADMAP.md``
queue 2, mode 1.5).

Sliding window (Mistral's semantics, ``window`` > 0 with
``window_pattern="all"``; the TPU kernels' ``wlo = seq + 1 - window``): the
token at ``seq_lens[b]`` attends cached rows ``>= seq_lens[b] + 1 -
window`` and itself.  The splits keep their boundaries from row 0; only
those that hold a row in the window run, and the rows below the bound in
the first of them are never read (on the card never copied) and weigh
nothing, so table slots below the window may hold the NULL page 0, as the
serving engine's rolling page buffer leaves them.  A window that reaches
row 0 gives the bits of no window.  Gemma-2's ``"even"`` pattern is refused
(``ROADMAP.md`` queue 2, mode 3).

The pools are updated in place: the returned pools are the tensors that
were passed in.  Padding rows (``seq_lens`` 0 over a table row of page 0)
append into the NULL page 0, which no request owns.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from clusterfusion_tpu_torch.ops import _build
from clusterfusion_tpu_torch.ops.decoder_layer import (HEAD_GROUP,
                                                      _int4_dot,
                                                      _pick_head_group,
                                                      fuse_qkv_o_for_kernel)
from clusterfusion_tpu_torch.ops._support import cdiv
from clusterfusion_tpu_torch.ops.quant import QuantizedTensor
from clusterfusion_tpu_torch.ops.stack_kernel import (KV_BF16, KV_FP8, WK_BF16,
                                                      WK_INT4, WK_INT8, _norm,
                                                      _rope, check_int4_group,
                                                      kv_rows_plain,
                                                      quant_operands)

_LOG2E = 1.4426950408889634
_NEG_INF = -1e30
FP8 = torch.float8_e4m3fn
#: Cached rows per block of the kernels' split pass (and per split of the
#: twins' walk): each request's rows are cut into splits of SPLIT rows,
#: each split bulk-copied whole into one block's shared memory.  Chosen on
#: the H100 among 64, 128 and 256 (``scripts/tune_torch_paged.py``).
SPLIT = 128
#: Rows per step of the online softmax inside a split (``PA_TILE``).
TILE = 32
#: Largest GQA group the kernels take (``PA_MAX_GROUP``).
MAX_GROUP = 16

#: Calls of each wrapper that launched its kernel (CUDA tensors only);
#: "llama_decoder_layer_paged_int8" counts the layer's calls with int8
#: weights (kernel 9's int8 mode), the "_fp8" keys the calls on fp8 pools,
#: the "_window" keys those with a sliding window; the wrapper's own key
#: counts them too.
launches = {"paged_attention": 0, "llama_decoder_layer_paged": 0,
            "llama_decoder_layer_paged_int8": 0,
            "llama_decoder_layer_paged_int4": 0,
            "paged_attention_fp8": 0, "llama_decoder_layer_paged_fp8": 0,
            "paged_attention_window": 0,
            "llama_decoder_layer_paged_window": 0}


def _refuse(what: str, window, softcap, bias_qkv=None,
            window_pattern: str = "all") -> int:
    """Raise on what the kernels do not take; returns the window as an
    int."""
    window = int(window)
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")
    if window_pattern not in ("all", "even"):
        raise ValueError(f"{what}: unknown window_pattern {window_pattern!r}")
    if window and window_pattern == "even":
        raise NotImplementedError(
            f"{what}: window_pattern 'even' (Gemma-2's interleaved local/"
            "global layers and their split pools) is not ported yet "
            "(ROADMAP.md queue 2, mode 3.3)")
    if softcap or bias_qkv is not None:
        raise NotImplementedError(f"{what}: softcap and QKV bias are not "
                                  "ported yet (ROADMAP.md queue 2, mode 3's "
                                  "later slices)")
    return window


def _walk_plain(q_walk, q_fold, k_cur, v_cur, k_pool, v_pool, table, lens,
                layer: int, split: int | None = None, window: int = 0):
    """The kernels' walk: q_walk/q_fold [B, kv, g, hd] (scaled; q_walk
    bf16-valued), k_cur/v_cur [B, kv, hd], rows in splits of ``split``
    (default ``SPLIT``); ``window`` > 0: only rows ``>= lens[b] + 1 -
    window`` (the module's note).  Returns o [B, kv, g, hd] bf16."""
    split = SPLIT if split is None else split
    B, kv, g, hd = q_walk.shape
    page = k_pool.shape[3]
    dev = q_walk.device
    table = table.long()
    lens = lens.long()
    ns = cdiv(int(lens.max()), split) if B else 0
    acc = torch.zeros((B, kv, g, hd), dtype=torch.float32, device=dev)
    l_sum = torch.zeros((B, kv, g), dtype=torch.float32, device=dev)
    m = torch.full((B, kv, g), _NEG_INF, dtype=torch.float32, device=dev)
    if ns:
        nt = cdiv(split, TILE)
        S = ns * nt * TILE                 # each split padded to whole tiles
        pos = torch.arange(S, device=dev)
        row = (pos // (nt * TILE)) * split + pos % (nt * TILE)    # request row
        valid = (pos % (nt * TILE) < split)[None] & (row[None] < lens[:, None])
        if window:
            wlo = (lens + 1 - window).clamp(min=0)
            valid = valid & (row[None] >= wlo[:, None])
        pg = table[:, (row // page).clamp(max=table.shape[1] - 1)]   # [B, S]
        # rows past the end or below the window never enter
        keep = valid[..., None, None]
        k, v = (torch.where(keep, kv_rows_plain(_rows(p[layer], pg,
                                                      row % page)), 0.)
                for p in (k_pool, v_pool))
        s = torch.einsum("bkgd,bskd->bkgs", q_walk.float(), k)
        s = s.masked_fill(~valid[:, None, None], _NEG_INF)
        s = s.reshape(B, kv, g, ns, nt, TILE)
        # the running max after each tile, restarting at every split
        m_run = torch.cummax(s.amax(dim=-1), dim=-1).values       # [B, kv, g, ns, nt]
        p = torch.exp2(s - m_run[..., None]) \
            * valid.reshape(B, 1, 1, ns, nt, TILE)
        pv = torch.einsum("bkgnut,bnutkd->bkgnud", p.to(torch.bfloat16).float(),
                          v.reshape(B, ns, nt, TILE, kv, hd))
        m_s = m_run[..., -1]                                      # [B, kv, g, ns]
        e_t = torch.exp2(m_run - m_s[..., None])
        acc_s = (pv * e_t[..., None]).sum(dim=4)                  # [B, kv, g, ns, hd]
        l_s = (p.sum(dim=-1) * e_t).sum(dim=-1)
        m = m_s.amax(dim=-1)
        e = torch.exp2(m_s - m[..., None])       # 0 for the empty splits
        acc = (acc_s * e[..., None]).sum(dim=3)
        l_sum = (l_s * e).sum(dim=-1)
    s_cur = (q_fold.float() * k_cur.float()[:, :, None]).sum(dim=-1)  # [B, kv, g]
    m_f = torch.maximum(m, s_cur)
    alpha = torch.exp2(m - m_f)
    p_cur = torch.exp2(s_cur - m_f)
    o = (acc * alpha[..., None] + p_cur[..., None] * v_cur.float()[:, :, None]) \
        / (l_sum * alpha + p_cur)[..., None]
    return o.to(torch.bfloat16)


def _bytes_of(pool):
    """An fp8 pool as its bytes (indexed reads and writes of e4m3 go
    through them), any other pool as it is."""
    return pool.view(torch.uint8) if pool.dtype == FP8 else pool


def _rows(pool_l, pg, r):
    """``pool_l[pg, :, r]`` of one layer's pool, in its dtype."""
    return _bytes_of(pool_l)[pg, :, r].view(pool_l.dtype)


def _append_plain(k_pool, v_pool, table, lens, layer: int, k_row, v_row):
    """Row ``lens[b]`` of request b's pages (layer ``layer``) <- k_row[b],
    v_row[b] ([B, kv, hd], cast to the pool dtype; e4m3 saturating)."""
    page = k_pool.shape[3]
    lens = lens.long()
    pg = table.long()[torch.arange(lens.shape[0], device=lens.device),
                      lens // page]
    for pool, row in ((k_pool, k_row), (v_pool, v_row)):
        _bytes_of(pool)[layer][pg, :, lens % page] = \
            _bytes_of(row.to(pool.dtype))


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """q * log2(e)/sqrt(hd), rounded to bf16 (``paged_attention``'s q)."""
    return (q.float() * (_LOG2E / math.sqrt(q.shape[-1]))).to(torch.bfloat16)


def paged_attention_plain(q, k_new, v_new, k_pool, v_pool, block_table,
                          seq_lens, layer_id: int, window: int = 0):
    """Plain PyTorch version of :func:`paged_attention` (same arguments,
    same results, pools appended in place)."""
    B = q.shape[0]
    qs = _scaled_q(q)
    # the current row as the pool stores it (fp8: e4m3 of the bf16 row),
    # folded as stored
    k_b, v_b = (t.to(torch.bfloat16).to(k_pool.dtype) for t in (k_new, v_new))
    o = _walk_plain(qs, qs, k_b, v_b, k_pool, v_pool, block_table, seq_lens,
                    int(layer_id), window=int(window))
    _append_plain(k_pool, v_pool, block_table, seq_lens, int(layer_id), k_b,
                  v_b)
    return o.reshape(B, -1), k_pool, v_pool


def _check_pools(what, k_pool, v_pool, dev) -> int:
    """The pools' kind for the C entries (``KV_BF16`` or ``KV_FP8``)."""
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype not in (torch.bfloat16, FP8):
            raise NotImplementedError(
                f"{what}: {name} is {t.dtype}; the kernels take a bf16 or "
                "float8_e4m3fn KV pool (JAX's int8 pools are unscaled and "
                "stay refused: ROADMAP.md section 3)")
        if t.device != dev or not t.is_contiguous() or (
                dev.type == "cuda" and t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte "
                             f"aligned tensor on {dev}")
    if k_pool.dtype != v_pool.dtype:
        raise ValueError(f"{what}: k_pool is {k_pool.dtype}, v_pool "
                         f"{v_pool.dtype}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"{what}: pool shapes differ")
    return KV_FP8 if k_pool.dtype == FP8 else KV_BF16


@functools.lru_cache(maxsize=64)
def _scratch_floats(fn: str, B, kv, g, hd, page, max_pages, split) -> int:
    """Floats of f32 scratch the C entry ``fn`` needs (its split pass's
    partials, and the layer's projection)."""
    return getattr(_build.lib(), fn)(B, kv, g, hd, page, max_pages, split)


def _indices(dev, *ts):
    return [torch.as_tensor(t).to(device=dev, dtype=torch.int32).contiguous()
            for t in ts]


def paged_attention(q, k_new, v_new, k_pool, v_pool, block_table, seq_lens,
                    layer_id, *, window: int = 0, softcap: float = 0.0,
                    window_pattern: str = "all"):
    """Batched paged flash-decode attention + in-place append.

    q [B, kv_heads, group, hd] (roped, unscaled); k_new/v_new
    [B, kv_heads, hd] (roped current token); pools [L, n_pages, kv_heads,
    page, hd] bf16 or float8_e4m3fn (the module's note); block_table [B,
    max_pages] and seq_lens [B] integer.
    Attends each request's ``seq_lens[b]`` cached rows of layer
    ``layer_id`` plus the current token, appends the current K/V at
    ``block_table[b, seq_lens[b] // page], seq_lens[b] % page`` and returns
    (o [B, kv_heads*group*hd] bf16, k_pool, v_pool).  On the card each
    request's rows are walked in splits of ``SPLIT`` rows, one block each
    (two launches: the split pass and the merge).  ``window`` > 0: the
    sliding window (the module's note)."""
    window = _refuse("paged_attention", window, softcap,
                     window_pattern=window_pattern)
    B, kv, g, hd = q.shape
    L, n_pages, kv_p, page, hd_p = k_pool.shape
    if (kv_p, hd_p) != (kv, hd) or k_new.shape != (B, kv, hd) or \
            v_new.shape != (B, kv, hd):
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, k_new "
                         f"{tuple(k_new.shape)} and pool {tuple(k_pool.shape)}"
                         " disagree")
    if not 0 <= int(layer_id) < L:
        raise ValueError(f"layer_id {layer_id} outside the pool's {L} layers")
    kind = _check_pools("paged_attention", k_pool, v_pool, q.device)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_new, v_new, k_pool, v_pool,
                                     block_table, seq_lens, layer_id, window)
    dev = q.device
    if hd not in (64, 128) or g > MAX_GROUP:
        raise NotImplementedError(f"paged_attention: head_dim {hd} or group "
                                  f"{g} (the kernel takes hd 64/128, group "
                                  f"<= {MAX_GROUP})")
    q_b = q.to(dtype=torch.bfloat16).contiguous()     # scaled in the kernel
    k_b = k_new.to(device=dev, dtype=torch.bfloat16).contiguous()
    v_b = v_new.to(device=dev, dtype=torch.bfloat16).contiguous()
    table, lens = _indices(dev, block_table, seq_lens)
    if table.shape[0] != B or lens.shape != (B,):
        raise ValueError("paged_attention: block_table/seq_lens rows != B")
    o = torch.empty((B, kv * g * hd), dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(_scratch_floats("cf_paged_scratch_floats", B, kv, g,
                                          hd, page, table.shape[1], SPLIT),
                          dtype=torch.float32, device=dev)
    err = _build.lib().cf_paged_attention(
        q_b.data_ptr(), k_b.data_ptr(), v_b.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), table.data_ptr(), lens.data_ptr(), o.data_ptr(),
        scratch.data_ptr(), B, kv, g, hd, page, n_pages, table.shape[1],
        int(layer_id), SPLIT, torch.cuda.current_stream(dev).cuda_stream, kind,
        window)
    _build.check(err, "paged_attention")
    launches["paged_attention"] += 1
    launches["paged_attention_fp8"] += int(kind == KV_FP8)
    launches["paged_attention_window"] += int(window > 0)
    return o, k_pool, v_pool


def llama_decoder_layer_paged_plain(input, residual, wqkv_g, wo_g,
                                    block_table, seq_lens, positions, k_pool,
                                    v_pool, layer_id, rms_w, eps, cos_t, sin_t,
                                    *, group: int, rope_style: str,
                                    window: int = 0):
    """Plain PyTorch version of :func:`llama_decoder_layer_paged` (same
    arguments, same results, pools appended in place).  Int8 weights: each
    product over the codes, scaled where the kernel scales; int4: the exact
    products (the module's note)."""
    B, hidden = input.shape
    layer_id = int(layer_id)
    w = wqkv_g[layer_id] if wqkv_g.ndim == 4 else wqkv_g
    wo = wo_g[layer_id] if wo_g.ndim == 4 else wo_g
    kv, hd = k_pool.shape[2], k_pool.shape[4]
    r = input.float() + residual.float()
    xn = _norm(r, rms_w.reshape(-1), eps)
    w4 = isinstance(w, QuantizedTensor) and w.kind == "int4"
    if w4:
        gs = w.group_size
        qkv = torch.stack([_int4_dot(xn, w.q[i], w.s[i], gs, False)
                           for i in range(w.q.shape[0])], dim=1)
    elif isinstance(w, QuantizedTensor):
        qkv = torch.einsum("bd,Gdc->bGc", xn.float(), w.q.float()) * w.s[:, 0]
    else:
        qkv = torch.einsum("bd,Gdc->bGc", xn.float(), w.float())
    qkv = qkv.reshape(B, kv, group + 2, hd)
    pos = torch.as_tensor(positions, device=input.device).long()
    cos = cos_t[pos].float()[:, None]                       # [B, 1, hd]
    sin = sin_t[pos].float()[:, None]
    q = _rope(qkv[:, :, :group], cos[:, None], sin[:, None], rope_style) \
        * (_LOG2E / math.sqrt(hd))
    k = _rope(qkv[:, :, group], cos, sin, rope_style)
    v = qkv[:, :, group + 1]
    table = torch.as_tensor(block_table, device=input.device)
    lens = torch.as_tensor(seq_lens, device=input.device)
    o = _walk_plain(q.to(torch.bfloat16), q, k, v, k_pool, v_pool, table,
                    lens, layer_id, window=int(window))
    if k_pool.dtype == FP8 and (hd % 128 or k_pool.shape[3] % 8):
        # where the TPU wrapper scatters its bf16 k_new: e4m3 of bf16(k)
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    _append_plain(k_pool, v_pool, table, lens, layer_id, k, v)
    if w4:                                # the groups' products, summed in order
        G = wo.q.shape[0]
        og = o.reshape(B, G, -1)
        out = torch.zeros((B, hidden), dtype=torch.float32, device=input.device)
        for i in range(G):
            out = out + _int4_dot(og[:, i], wo.q[i], wo.s[i], gs, False)
    elif isinstance(wo, QuantizedTensor):   # each group's partial scaled, summed
        G = wo.q.shape[0]
        out = (torch.einsum("bGc,Gco->bGo", o.reshape(B, G, -1).float(),
                            wo.q.float()) * wo.s[:, 0]).sum(dim=1)
    else:
        out = o.reshape(B, -1).float() @ wo.reshape(-1, hidden).float()
    return out.to(input.dtype), r.to(input.dtype), k_pool, v_pool


def llama_decoder_layer_paged(input, residual, wqkv_g, wo_g, block_table,
                              seq_lens, positions, k_pool, v_pool, layer_id,
                              rms_w, eps: float, cos_t, sin_t, *,
                              group: int = 1, rope_style: str = "neox",
                              bias_qkv=None, window: int = 0,
                              softcap: float = 0.0,
                              window_pattern: str = "all"):
    """Paged batch-decode attention half of a Llama layer.

    input/residual [B, hidden] bf16; wqkv_g [L, G, hidden, hg*(group+2)*hd]
    (or one layer's [G, ...]); wo_g [L, G, hg*group*hd, hidden] (or [G,
    ...]); block_table [B, max_pages], seq_lens/positions [B] integer;
    pools [L, n_pages, kv_heads, page, hd] bf16 or float8_e4m3fn (the
    module's note); rms_w [hidden] or [1, hidden]; cos_t/sin_t [max_pos,
    hd] full-dim float32 tables.  wqkv_g
    and wo_g may be int8 or int4 ``QuantizedTensor``s together (the
    module's note).

    Returns (output [B, hidden], residual_out [B, hidden], k_pool, v_pool),
    the new token's K/V written in place at ``block_table[b, seq_lens[b] //
    page], seq_lens[b] % page`` of layer ``layer_id``.  Stacked weights are
    read at ``layer_id``.  ``window`` > 0: the sliding window (the module's
    note)."""
    window = _refuse("llama_decoder_layer_paged", window, softcap, bias_qkv,
                     window_pattern)
    B, hidden = input.shape
    L, n_pages, kv, page, hd = k_pool.shape
    layer_id = int(layer_id)
    if not 0 <= layer_id < L:
        raise ValueError(f"layer_id {layer_id} outside the pool's {L} layers")
    if wqkv_g.ndim not in (3, 4) or wo_g.ndim != wqkv_g.ndim:
        raise ValueError("wqkv_g/wo_g must both be [G, ...] or [L, G, ...]")
    quant = isinstance(wqkv_g, QuantizedTensor)
    if quant != isinstance(wo_g, QuantizedTensor) or \
            (quant and wqkv_g.kind != wo_g.kind):
        raise ValueError("llama_decoder_layer_paged: wqkv_g and wo_g are "
                         "quantized together, of one kind, or not at all")
    w8 = quant and wqkv_g.kind == "int8"
    w4 = quant and wqkv_g.kind == "int4"
    if w4:
        check_int4_group(wqkv_g.group_size, "llama_decoder_layer_paged")
        check_int4_group(wo_g.group_size, "llama_decoder_layer_paged")
    G, hidden_w, C = wqkv_g.shape[-3:]
    hg = kv // G if G else 0
    if hidden_w != hidden or G * hg != kv or C != hg * (group + 2) * hd or \
            tuple(wo_g.shape[-3:]) != (G, hg * group * hd, hidden):
        raise ValueError(f"llama_decoder_layer_paged: weights {tuple(wqkv_g.shape)}"
                         f"/{tuple(wo_g.shape)} do not fit kv {kv}, group "
                         f"{group}, hd {hd}, hidden {hidden}")
    dev = input.device
    kind = _check_pools("llama_decoder_layer_paged", k_pool, v_pool, dev)
    rms_w = rms_w.reshape(-1)
    weights, scales = quant_operands(dict(wqkv_g=wqkv_g, wo_g=wo_g),
                                     (C, hidden) if quant else (), 0)
    named = (("rms_w", rms_w), ("input", input), ("residual", residual),
             *(() if quant else tuple(weights.items())))
    for name, t in named:
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(f"llama_decoder_layer_paged: {name} is "
                                      f"{t.dtype}; only bf16, int8 and int4 "
                                      "weights are ported")
    if dev.type == "cpu":
        return llama_decoder_layer_paged_plain(
            input, residual, wqkv_g, wo_g, block_table, seq_lens, positions,
            k_pool, v_pool, layer_id, rms_w, eps, cos_t, sin_t, group=group,
            rope_style=rope_style, window=window)
    for name, t in (*named, *weights.items(), *scales.items()):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"llama_decoder_layer_paged: {name} must be a "
                             f"contiguous, 16-byte aligned tensor on {dev}")
    if residual.shape != input.shape or rms_w.numel() != hidden:
        raise ValueError("llama_decoder_layer_paged: residual/rms_w shapes")
    if hd not in (64, 128) or group > MAX_GROUP:
        raise NotImplementedError(f"llama_decoder_layer_paged: head_dim {hd} "
                                  f"or group {group} (the kernel takes hd "
                                  f"64/128, group <= {MAX_GROUP})")
    if rope_style not in ("neox", "gptj"):
        raise ValueError(f"unknown rope style {rope_style!r}")
    if hidden % 8:
        raise ValueError(f"hidden {hidden} is not a multiple of 8")
    table, lens, poss = _indices(dev, block_table, seq_lens, positions)
    if table.shape[0] != B or lens.shape != (B,) or poss.shape != (B,):
        raise ValueError("llama_decoder_layer_paged: table/lens/positions "
                         "rows != B")
    cos_f = cos_t.to(device=dev, dtype=torch.float32).contiguous()
    sin_f = sin_t.to(device=dev, dtype=torch.float32).contiguous()
    if cos_f.shape[-1] != hd or sin_f.shape != cos_f.shape:
        raise ValueError("cos_t/sin_t must be [max_pos, head_dim]")
    bf16, f32 = torch.bfloat16, torch.float32
    out = torch.empty((B, hidden), dtype=bf16, device=dev)
    res_out = torch.empty((B, hidden), dtype=bf16, device=dev)
    xn = torch.empty((B, hidden), dtype=bf16, device=dev)
    o = torch.empty((B, kv * group * hd), dtype=bf16, device=dev)
    scratch = torch.empty(_scratch_floats("cf_paged_layer_scratch_floats", B,
                                          kv, group, hd, page, table.shape[1],
                                          SPLIT),
                          dtype=f32, device=dev)
    n_launch = ctypes.c_int(0)
    err = _build.lib().cf_paged_decoder_layer(
        input.data_ptr(), residual.data_ptr(), weights["wqkv_g"].data_ptr(),
        weights["wo_g"].data_ptr(), rms_w.data_ptr(), cos_f.data_ptr(),
        sin_f.data_ptr(),
        poss.data_ptr(), table.data_ptr(), lens.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), out.data_ptr(), res_out.data_ptr(), xn.data_ptr(),
        o.data_ptr(), scratch.data_ptr(), B, hidden, kv, hg, group, hd, page,
        n_pages, table.shape[1], cos_f.shape[0], layer_id,
        layer_id if wqkv_g.ndim == 4 else 0,
        1 if rope_style == "neox" else 0, float(eps), SPLIT,
        ctypes.byref(n_launch), torch.cuda.current_stream(dev).cuda_stream,
        *(scales[k].data_ptr() if k in scales else None
          for k in ("wqkv_g_s", "wo_g_s")),
        WK_INT4 if w4 else WK_INT8 if w8 else WK_BF16, kind, window)
    _build.check(err, "llama_decoder_layer_paged")
    launches["llama_decoder_layer_paged"] += 1
    launches["llama_decoder_layer_paged_int8"] += int(w8)
    launches["llama_decoder_layer_paged_int4"] += int(w4)
    launches["llama_decoder_layer_paged_fp8"] += int(kind == KV_FP8)
    launches["llama_decoder_layer_paged_window"] += int(window > 0)
    return out, res_out, k_pool, v_pool


def sglang_layer_args(input, residual, weight_qkv, weight_o,
                      paged_kv_indptr, paged_kv_indices, k_cache, v_cache,
                      layer_id: int, rms_w, eps: float, positions, cos_sin,
                      n_heads: int = 32, head_dim: int = 128):
    """The (args, kwargs) of :func:`llama_decoder_layer_paged` (or its plain
    twin) for one call of :func:`llama_decoder_layer_batch_decode_sglang`
    (same arguments): the weights re-laid into the kernel layout, a block
    table of page size 1 and views of the caches as pools."""
    B, hidden = input.shape
    hd, heads = head_dim, n_heads
    L, num_pages, _ = k_cache.shape
    per_head = (weight_qkv.reshape(3, heads, hd, hidden)
                .permute(1, 3, 0, 2).reshape(heads, hidden, 3 * hd))
    wo_per_head = weight_o.t().reshape(heads, hd, hidden)
    wqkv_g, wo_g = fuse_qkv_o_for_kernel(per_head, wo_per_head, heads, 1, hd,
                                         _pick_head_group(heads, HEAD_GROUP))
    indptr = torch.as_tensor(paged_kv_indptr, device=input.device).long()
    indices = torch.as_tensor(paged_kv_indices, device=input.device).long()
    max_pages = indices.shape[0]
    j = torch.arange(max_pages, device=input.device)[None]
    table = indices[(indptr[:-1, None] + j).clamp(0, max_pages - 1)]
    seq_lens = indptr[1:] - indptr[:-1] - 1          # the new slot excluded
    k_pool = k_cache.view(L, num_pages, heads, 1, hd)
    v_pool = v_cache.view(L, num_pages, heads, 1, hd)
    cos_h, sin_h = cos_sin[:, : hd // 2], cos_sin[:, hd // 2:]
    args = (input, residual, wqkv_g.contiguous(), wo_g.contiguous(), table,
            seq_lens, positions, k_pool, v_pool, layer_id, rms_w, eps,
            torch.cat([cos_h, cos_h], dim=-1), torch.cat([sin_h, sin_h], dim=-1))
    return args, dict(group=1, rope_style="neox")


def llama_decoder_layer_batch_decode_sglang(
        input, residual, weight_qkv, weight_o, paged_kv_indptr,
        paged_kv_indices, k_cache, v_cache, layer_id: int, rms_w, eps: float,
        positions, cos_sin, n_heads: int = 32, head_dim: int = 128):
    """Reference-parity entry (sglang calling convention, page size 1).

    weight_qkv [3*hidden, hidden] and weight_o [hidden, hidden] in
    torch.nn.Linear layout; paged_kv_indptr [B+1] and paged_kv_indices
    [total] name each request's pool rows, its last row being the slot of
    the new token; k_cache/v_cache [L, num_pages, hidden]; cos_sin
    [max_pos, head_dim] holds the cos half then the sin half (neox).
    Returns (output, residual_out, k_cache, v_cache), the new K/V written in
    place at row ``indices[indptr[b+1]-1]``."""
    args, kw = sglang_layer_args(
        input, residual, weight_qkv, weight_o, paged_kv_indptr,
        paged_kv_indices, k_cache, v_cache, layer_id, rms_w, eps, positions,
        cos_sin, n_heads, head_dim)
    out, res_out, _, _ = llama_decoder_layer_paged(*args, **kw)
    return out, res_out, k_cache, v_cache
