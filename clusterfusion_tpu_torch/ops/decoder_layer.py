"""The fused attention half of a Llama decoder layer, bs=1 (twin of
``clusterfusion_tpu/ops/decoder_layer.py``).

``_fused_decoder_layer`` computes residual add + RMSNorm + QKV projection +
RoPE + flash-decode over the cached rows + the current token + the
O-projection for one layer.  CUDA tensors launch the hand-written kernel
of ``csrc/decoder_layer.cu`` (one launch: a thread-block cluster per kv
head, sums in a fixed order, so a call repeats its bits); CPU tensors run
``_fused_decoder_layer_plain``, which repeats the kernel's arithmetic and
rounds where it rounds, as the TPU kernel does:

- h = x (+ residual) in float32, ``res_out`` its bf16; the norm's output is
  rounded to bf16 for the QKV product, which stays float32;
- q is roped in float32, pre-scaled by 1/sqrt(hd)*log2(e) and rounded to
  bf16 for the dots over cached rows; the softmax is exp2 and p is rounded
  to bf16 for the p.V products (per split of ``kcfg.kv_split`` rows, each
  against its own max);
- the current token joins from the float32 q, k and v, not from the bf16
  row that is appended;
- o is rounded to bf16 before the O-projection, whose sum over head groups
  is float32.

The modes follow the TPU kernel: ``fuse_residual``, ``append_kv`` (the new
row written in place at ``seq_len`` of layer ``layer_id``),
``emit_partials`` (no O-projection; the unnormalised acc and the (m, l)
rows in the log2 domain for a merge across sequence shards, with the empty
state m = -1e30, l = 0, acc = 0) and ``fold_current``.

Int8 weights (``ops.quant.QuantizedTensor``, per output column; the TPU
kernel's ``wq_kind == "int8"``): ``wqkv_f`` and ``wo_f`` int8 together.
The codes stream as they are (never a bf16 copy) and each product sums
over the codes in float32 (exact, |q| <= 127); the scales go where the TPU
kernel applies them: each QKV column after its sum over hidden (``wqkv_f.s``
is [G, 1, C]), and each kv head's O-projection partial by its head group's
scale (``wo_f.s`` [G, 1, hidden]) before the heads are summed in order.

Int4 weights (group-wise along K, groups of 128, two codes a byte; the TPU
kernel's ``wq_kind == "int4"``): both products are the TPU kernel's
``_int4_dot`` with the scales as bf16, per head group, the groups' float32
O partials summed in order: W4A8 with ``kcfg.int4_w4a8`` (QKV's x the
normed row, the O projection's one head group's o, each quantized to int8
against its own absmax), else the exact product over bf16(code * s).  On
the card the code pairs stream as they are through the kernel's own ring;
in W4A8 the O projection is a second launch, the ring GEMV's W4A8
instance over the head groups' o (no thread-block cluster holds a whole
head group), so a full-mode W4A8 call is two kernels.  The plain int4
products that the other kernels' twins share (``_dequant_int4_tile`` and
``_int4_dot``, the TPU kernels' own) live in this module, as in the JAX
package.

An fp8 e4m3 KV cache (``torch.float8_e4m3fn`` pair; the TPU kernel's
``kv_kind == "fp8"``), beside any weight kind and in every mode: the rows
below ``seq_len`` are read as the TPU kernel reads them, each byte decoded
exactly with e4m3 denormals (|v| <= 0.0137) flushed to 0
(``fp8_decode_scaled``), the score bf16(q) . k in float32 and p rounded to
bf16 for the p.V dot; the append stores e4m3 straight from the float32
roped k and the float32 v (the TPU kernel's ``kv_s.astype`` of a float32
row; the card saturates at +-448, where the JAX package's CPU cast gives
NaN), while ``k_new``/``v_new`` stay bf16 and the current token's fold
float32.  An ``Int8KV`` pair raises: the JAX package's kernel 6, and so
its tp and sp steps, take none (its tp step runs one through
``fused_collectives=True``, kernel 7's mode 5).

Sliding window (Mistral's, ``window`` > 0 with ``window_pattern="all"``;
the TPU kernel's ``window`` and prefetched ``window_lo``): the token
attends the cached rows at or above the bound and itself.  The bound is
``window_lo``, the first in-window row in this cache's own coordinates
(the sp step's shards translate the global ``pos + 1 - window`` into
theirs: ``parallel.sp_decode.shard_window_lo``), by default ``seq_len + 1
- window``; below 0 every cached row is in the window (the bits of no
window), at or above ``seq_len`` none is (partials mode then gives the
empty state, m = -1e30, l = 0, acc = 0, unless the token is folded).  The
split pass keeps its split boundaries (multiples of ``kcfg.kv_split``
from row 0) and reads only the splits that hold a row in the window, the
first of them from the bound's row: rows below the bound are neither
copied nor weighed, so whatever they hold (NaN too) cannot reach an
output.  The append writes row ``seq_len``, which always lies in the
window.  Gemma-2's ``"even"`` pattern, QKV bias and the softcap raise.

The public ops ``llama_decoder_layer`` (GPT-J rope, no residual add) and
``llama_decoder_layer_sglang`` (NEOX rope, fused residual) take the
reference's tensor layouts (bf16 or fp8 caches) and build the kernel
layout on every call, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.ops import _build
from clusterfusion_tpu_torch.ops._support import stream_scratch
from clusterfusion_tpu_torch.ops.quant import (Int8KV, QuantizedTensor,
                                               expand_group_scales,
                                               unpack_int4_bitcast,
                                               w4a8_int4_dot)
from clusterfusion_tpu_torch.ops.stack_kernel import (KV_BF16, KV_FP8,
                                                      WK_BF16, WK_INT4,
                                                      WK_INT4A8, WK_INT8,
                                                      _norm, _rope,
                                                      check_int4_group,
                                                      check_stack_kcfg,
                                                      first_live_row,
                                                      quant_operands,
                                                      split_attention_plain,
                                                      window_lo as
                                                      window_lo_of,
                                                      wq_kind_of)

_LOG2E = 1.4426950408889634


def _dequant_int4_tile(q: torch.Tensor, s: torch.Tensor, gs: int) -> torch.Tensor:
    """Packed int4 tile [K/2, N] (packed along K) and group scales
    [K/gs, N] -> bf16 [K, N]: bf16(code * bf16(s)), one bf16 rounding (the
    JAX package's ``_dequant_int4_tile``, a bf16 multiply)."""
    w = unpack_int4_bitcast(q).to(torch.bfloat16)
    return w * expand_group_scales(s.to(torch.bfloat16), 0, gs)


def _int4_dot(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, gs: int,
              w4a8: bool) -> torch.Tensor:
    """x [M, K] @ an int4 tile q [K/2, N] with group scales s [K/gs, N] ->
    float32 [M, N], the scales taken as bf16 (as the TPU kernels stream
    them): W4A8 (``w4a8`` and gs a multiple of 128, ``KernelConfig.
    int4_w4a8``: ``ops.quant.w4a8_int4_dot``) or the exact product over
    ``_dequant_int4_tile`` (any other group size falls back to it, as in
    JAX)."""
    sb = s.to(torch.bfloat16)
    if w4a8 and gs % 128 == 0:
        return w4a8_int4_dot(x, q, sb.float(), gs)
    return x.to(torch.bfloat16).float() @ _dequant_int4_tile(q, sb, gs).float()
#: Largest GQA group the kernels take (``ATT_MAX_GROUP`` in common.cuh).
MAX_GROUP = 8
#: KV heads per group of the public ops' weight layout (the JAX package's
#: default ``KernelConfig.head_group``).
HEAD_GROUP = 8
#: Most head groups W4A8's O projection takes: the ring GEMV keeps each K
#: chunk inside one head group, and a tile's chunks are one cluster of at
#: most 16 blocks (``G1_MAX_CLUSTER``).
MAX_O_GROUPS = 16

#: Calls of :func:`_fused_decoder_layer` that launched the kernels.
launches = 0
#: Those of them with int8 weights (the kernel's int8 mode).
int8_launches = 0
#: Those of them with int4 weights (the kernel's int4 modes).
int4_launches = 0
#: Those of them with an fp8 e4m3 KV cache (the kernel's fp8 mode).
fp8_launches = 0
#: Those of them with a sliding window.
window_launches = 0
#: CUDA kernels the last such call launched (2 in W4A8's full mode: the
#: layer and the ring GEMV's O projection).
last_call_kernels = 0
#: None, or a zeroed int64 CUDA tensor [16 * kv_heads, 8]: every call then
#: writes each block's %globaltimer (ns) at the kernel's phase boundaries
#: (start, norm, QKV, rope, split-KV, merge, O-projection, fold; rows past
#: the launch's blocks stay 0), for a readout of the time inside the launch.
phase_stamps: Optional[torch.Tensor] = None


def _pick_head_group(kv_heads: int, requested: int) -> int:
    """Largest divisor of ``kv_heads`` at most ``requested``."""
    hgv = min(requested, kv_heads)
    while kv_heads % hgv:
        hgv -= 1
    return max(hgv, 1)


def fuse_qkv_o_for_kernel(wqkv_per_head, wo_per_head, kv_heads: int,
                          group: int, head_dim: int, head_group: int):
    """[kv, hidden, (g+2)*hd] + [kv, g*hd, hidden] -> head-grouped layouts
    ([G, hidden, hg*(g+2)*hd], [G, hg*g*hd, hidden])."""
    hg = head_group
    G = kv_heads // hg
    _, hidden, cols = wqkv_per_head.shape
    wqkv_g = (wqkv_per_head.reshape(G, hg, hidden, cols)
              .permute(0, 2, 1, 3).reshape(G, hidden, hg * cols))
    wo_g = wo_per_head.reshape(G, hg * group * head_dim, hidden)
    return wqkv_g, wo_g


def _layer_views(rms_w, wqkv_f, wo_f, layer_id: int, hidden: int):
    """One layer's (rms_w [hidden], wqkv [G, hidden, C], wo [G, R, hidden]
    or None) from stacked ([L, ...]) or per-layer weights (views; an int8
    weight's codes and scales alike)."""
    w = rms_w.reshape(-1, hidden)
    w = w[layer_id] if w.shape[0] > 1 else w[0]
    if wqkv_f.ndim == 4:
        wqkv_f = wqkv_f[layer_id]
        wo_f = None if wo_f is None else wo_f[layer_id]
    return w, wqkv_f, wo_f


def _fused_decoder_layer_plain(
    x, residual, rms_w, cos_f, sin_f, wqkv_f, wo_f, k_cache, v_cache,
    seq_len, layer_id=0, *, group: int, head_dim: int, rope_style: str,
    fuse_residual: bool, eps: float, kcfg: KernelConfig = KernelConfig(),
    emit_partials: bool = False, fold_current=1, append_kv: bool = False,
    window: int = 0, window_lo=None,
):
    """Plain PyTorch version of :func:`_fused_decoder_layer` (same
    arguments, same results, the cache appended in place)."""
    seq, layer_id = int(seq_len), int(layer_id)
    hidden = x.shape[-1]
    rw, wqkv, wo = _layer_views(rms_w, wqkv_f, wo_f, layer_id, hidden)
    G = wqkv.shape[0]
    kv_heads = k_cache.shape[1]
    hd, g = head_dim, group
    dt = x.dtype
    h = x.float().reshape(hidden)
    if fuse_residual:
        h = h + residual.float().reshape(hidden)
    xn = _norm(h, rw, eps)
    w8 = isinstance(wqkv, QuantizedTensor) and wqkv.kind == "int8"
    w4 = isinstance(wqkv, QuantizedTensor) and wqkv.kind == "int4"
    if w4:          # the TPU kernel's _int4_dot per head group
        gs, a8 = wqkv.group_size, kcfg.int4_w4a8
        qkv = torch.stack([_int4_dot(xn[None], wqkv.q[i], wqkv.s[i], gs, a8)[0]
                           for i in range(G)])
    elif w8:        # each column scaled after its sum over hidden
        qkv = torch.einsum("d,Gdc->Gc", xn.float(),
                           wqkv.q.float()) * wqkv.s[:, 0]
    else:
        qkv = torch.einsum("d,Gdc->Gc", xn.float(), wqkv.float())
    qkv = qkv.reshape(kv_heads, g + 2, hd)
    cos = cos_f.float().reshape(hd)
    sin = sin_f.float().reshape(hd)
    q = _rope(qkv[:, :g], cos, sin, rope_style) * (_LOG2E / math.sqrt(hd))
    k_cur = _rope(qkv[:, g], cos, sin, rope_style)
    v_cur = qkv[:, g + 1]
    acc, m, l_sum = split_attention_plain(
        q, k_cur, v_cur, k_cache[layer_id], v_cache[layer_id], seq,
        kcfg.kv_split, fold=bool(int(fold_current)), window=window,
        lo=window_lo)
    k_new, v_new = k_cur.to(dt), v_cur.to(dt)
    res_out = h.to(dt)[None] if fuse_residual else None
    if emit_partials:
        rows = kv_heads * g
        return (acc.reshape(rows, hd), torch.stack([m.reshape(rows),
                                                    l_sum.reshape(rows)]),
                res_out, k_new, v_new)
    o = (acc / l_sum[..., None]).to(torch.bfloat16)
    if w4:          # each head group's o, its partials summed in order
        og = o.reshape(G, -1)
        out = torch.zeros(hidden, dtype=torch.float32, device=x.device)
        for i in range(G):
            out = out + _int4_dot(og[i][None], wo.q[i], wo.s[i], gs, a8)[0]
    elif w8:        # each kv head's partial scaled by its group's scale,
        hg = kv_heads // G      # then the heads summed in order
        part = torch.einsum("hc,hco->ho", o.reshape(kv_heads, -1).float(),
                            wo.q.reshape(kv_heads, g * hd, -1).float())
        out = (part * wo.s[:, 0].repeat_interleave(hg, dim=0)).sum(dim=0)
    else:
        out = torch.einsum("Gc,Gco->o", o.reshape(G, -1).float(),
                           wo.float())
    result = (out.to(dt)[None], res_out, k_new, v_new)
    if append_kv:   # from float32 (bf16: k_new's bits; fp8: e4m3 of f32)
        k_cache[layer_id, :, seq] = k_cur.to(k_cache.dtype)
        v_cache[layer_id, :, seq] = v_cur.to(v_cache.dtype)
        return result + (k_cache, v_cache)
    return result


#: The C entries' weight kind (``WK_*``) of each mode of the kernel.
WEIGHT_KINDS = {"bf16": WK_BF16, "int8": WK_INT8, "exact": WK_INT4,
                "w4a8": WK_INT4A8}
#: The C entries' cache kind (``KV_*``) of each cache the kernel takes.
CACHE_KINDS = {"bf16": KV_BF16, "fp8": KV_FP8}


def launch_plan(hidden: int, kv_heads: int, group: int, head_dim: int,
                kv_split: int = KernelConfig().kv_split,
                kind: str = "bf16", kv: str = "bf16", seq_len: int = 0,
                window: int = 0, window_lo=None) -> dict:
    """The kernel's launch on the current card for this geometry in the
    weights' ``kind`` (``WEIGHT_KINDS``: bf16, int8, or int4 "exact" or
    "w4a8") and the cache's ``kv`` (``CACHE_KINDS``): blocks per cluster
    (one cluster per kv head), blocks, ring stages, shared bytes per block,
    clusters of that size the card holds at once, and (``held_by_size``)
    the clusters the card holds at each size 1..16.  With ``seq_len`` (and
    the call's ``window`` / ``window_lo``) also the call's split-KV walk:
    the first row it reads, its live splits, and the ranks of a cluster
    that get a split (``busy_ranks``; the others only merge)."""
    if kind not in WEIGHT_KINDS:
        raise ValueError(f"weight kind {kind!r}: one of {list(WEIGHT_KINDS)}")
    if kv not in CACHE_KINDS:
        raise ValueError(f"cache kind {kv!r}: one of {list(CACHE_KINDS)}")
    wk = WEIGHT_KINDS[kind]
    info = (ctypes.c_int * 21)()
    _build.check(_build.lib().cf_decoder_layer_plan(
        hidden, kv_heads, group, head_dim, kv_split, wk, CACHE_KINDS[kv],
        info), "_fused_decoder_layer plan")
    plan = dict(cluster=info[0], blocks=info[1], stages=info[2],
                smem_bytes=info[3], clusters_held=info[4],
                held_by_size=list(info[5:21]))
    if seq_len:
        first, live = live_splits(seq_len, kv_split, window, window_lo)
        plan.update(first_row=first, live_splits=live,
                    busy_ranks=min(live, plan["cluster"]))
    return plan


def live_splits(seq: int, kv_split: int, window: int = 0, window_lo=None):
    """(the first cached row the split pass reads, the splits it reads)
    for ``seq`` cached rows under the window's bound, as the kernel
    numbers them: split boundaries at multiples of ``kv_split`` from row
    0, the first live split cut at the bound."""
    lo = window_lo_of(seq, window, window_lo)
    j0 = first_live_row(seq, kv_split, window, window_lo)
    first = 0 if lo is None else min(max(lo, 0), seq)
    return first, -(-(seq - j0) // kv_split)


def cache_kind(k_cache, v_cache) -> int:
    """The C entry's cache kind (``KV_*``) of a K/V pair: bf16 or
    ``float8_e4m3fn``.  A pair of two kinds raises ValueError; an
    ``Int8KV`` pair, or any other dtype, NotImplementedError."""
    kinds = {Int8KV if isinstance(c, Int8KV) else c.dtype
             for c in (k_cache, v_cache)}
    if len(kinds) > 1:
        raise ValueError("_fused_decoder_layer: k_cache and v_cache are of "
                         "one kind")
    kind = kinds.pop()
    if kind is Int8KV:
        raise NotImplementedError(
            "_fused_decoder_layer: an Int8KV cache; the JAX package's kernel "
            "6, and so its tp and sp steps, take none (the tp step runs one "
            "with fused_collectives=True: kernel 7's mode 5)")
    if kind == torch.bfloat16:
        return KV_BF16
    if kind == torch.float8_e4m3fn:
        return KV_FP8
    raise NotImplementedError(f"_fused_decoder_layer: a {kind} KV cache; "
                              "the kernel takes bf16 or float8_e4m3fn "
                              "(ROADMAP.md queue 2, mode 2)")


def _refuse(wqkv_f, wo_f, k_cache, v_cache, *, window, window_pattern,
            bias_qkv, softcap) -> int:
    """Raise on what the kernel does not take; the cache kind."""
    if window < 0:
        raise ValueError(f"_fused_decoder_layer: window {window} < 0")
    if window and window_pattern != "all":
        raise NotImplementedError(
            f"_fused_decoder_layer: window_pattern {window_pattern!r} "
            "(Gemma-2's interleaved local/global layers) is not ported yet "
            "(ROADMAP.md queue 2, mode 3)")
    if bias_qkv is not None or softcap:
        raise NotImplementedError("_fused_decoder_layer: QKV bias and "
                                  "softcap are not ported yet (ROADMAP.md "
                                  "queue 2, mode 3)")
    weights = [w for w in (wqkv_f, wo_f) if w is not None]
    quant = [w for w in weights if isinstance(w, QuantizedTensor)]
    if quant and (len(quant) != len(weights)
                  or len({w.kind for w in quant}) > 1):
        raise ValueError("_fused_decoder_layer: wqkv_f and wo_f are "
                         "quantized together, of one kind, or not at all")
    for w in quant:
        if w.kind == "int4":
            check_int4_group(w.group_size, "_fused_decoder_layer")
    if any(not isinstance(w, QuantizedTensor) and w.dtype != torch.bfloat16
           for w in weights):
        raise NotImplementedError("_fused_decoder_layer: only bf16, int8 "
                                  "and int4 weights are ported (ROADMAP.md "
                                  "queue 2, mode 1)")
    return cache_kind(k_cache, v_cache)


def _fused_decoder_layer(
    x, residual, rms_w, cos_f, sin_f, wqkv_f, wo_f, k_cache, v_cache,
    seq_len, layer_id=0,
    *,
    group: int,
    head_dim: int,
    rope_style: str,
    fuse_residual: bool,
    eps: float,
    kcfg: KernelConfig = KernelConfig(),
    emit_partials: bool = False,
    fold_current=1,
    append_kv: bool = False,
    window: int = 0,
    window_lo=None,
    bias_qkv=None,
    softcap: float = 0.0,
    window_pattern: str = "all",
):
    """The attention half of one layer at ``seq_len`` cached rows.

    x, residual: [1, hidden] bf16 (residual unused unless
    ``fuse_residual``); rms_w [hidden], [1, hidden] or the stack [L, hidden]
    / [L, 1, hidden]; cos_f/sin_f [1, head_dim] full-dim at the token's
    position; wqkv_f [G, hidden, hg*(group+2)*hd] and wo_f
    [G, hg*group*hd, hidden], or their [L, ...] stacks, bf16 or both int8
    or both int4 ``QuantizedTensor``s (the module's note; int4 in groups
    of 128, W4A8 as ``kcfg.int4_w4a8`` says); k_cache/v_cache
    [L, kv_heads, capacity, head_dim], bf16 or fp8 e4m3 (the module's
    note), layer ``layer_id`` read.

    Returns (out [1, hidden], res_out [1, hidden] or None without
    ``fuse_residual``, k_new [kv, hd], v_new [kv, hd]), plus (k_cache,
    v_cache) with ``append_kv`` (the new row written in place at
    ``seq_len``); with ``emit_partials`` (acc [kv*group, hd] f32,
    ml [2, kv*group] f32, res_out, k_new, v_new) and no O-projection.
    ``fold_current`` 0 leaves the current token out of the softmax.
    ``window`` > 0: the sliding window (Mistral's pattern ``"all"``) from
    the bound ``window_lo``, an int in this cache's coordinates, by
    default ``seq_len + 1 - window`` (the module's note).
    ``bias_qkv``, ``softcap`` and the ``"even"`` pattern (the TPU kernel's
    QKV bias, logit softcap and Gemma-2's layers) raise
    NotImplementedError."""
    global launches, int8_launches, int4_launches, fp8_launches
    global window_launches, last_call_kernels
    window = int(window)
    kv_kind = _refuse(wqkv_f, wo_f, k_cache, v_cache, window=window,
                      window_pattern=window_pattern, bias_qkv=bias_qkv,
                      softcap=softcap)
    if append_kv and emit_partials:
        raise ValueError("_fused_decoder_layer: partials mode does not "
                         "append (the owner of the position appends)")
    seq, layer_id, fold = int(seq_len), int(layer_id), int(fold_current)
    hidden = x.shape[-1]
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("k_cache/v_cache must be [L, kv_heads, cap, hd]")
    L, kv_heads, cap, hd = k_cache.shape
    rw, wqkv, wo = _layer_views(rms_w, wqkv_f, wo_f, layer_id, hidden)
    G, hidden_w, C = wqkv.shape
    hg = kv_heads // G if G else 0
    if (hd != head_dim or hidden_w != hidden or G * hg != kv_heads
            or C != hg * (group + 2) * hd):
        raise ValueError(f"_fused_decoder_layer: wqkv {tuple(wqkv.shape)} "
                         f"does not fit kv {kv_heads}, group {group}, hd "
                         f"{head_dim}, hidden {hidden}")
    if not emit_partials and (wo is None or tuple(wo.shape) != (
            G, hg * group * hd, hidden)):
        raise ValueError("_fused_decoder_layer: wo must be "
                         f"[G, hg*group*hd, hidden] = [{G}, "
                         f"{hg * group * hd}, {hidden}]")
    if not 0 <= layer_id < L:
        raise ValueError(f"layer_id {layer_id} outside the cache's {L} "
                         "layers")
    if not 0 <= seq <= cap or (append_kv and seq >= cap):
        raise ValueError(f"seq_len {seq} outside the cache capacity {cap}")
    if fold not in (0, 1):
        raise ValueError(f"fold_current must be 0 or 1, not {fold}")
    if rope_style not in ("neox", "gptj"):
        raise ValueError(f"unknown rope style {rope_style!r}")
    common = dict(group=group, head_dim=head_dim, rope_style=rope_style,
                  fuse_residual=fuse_residual, eps=eps, kcfg=kcfg,
                  emit_partials=emit_partials, fold_current=fold,
                  append_kv=append_kv)
    lo = window_lo_of(seq, window, window_lo)
    if x.device.type == "cpu":
        return _fused_decoder_layer_plain(
            x, residual, rms_w, cos_f, sin_f, wqkv_f, wo_f, k_cache, v_cache,
            seq, layer_id, **common, window=window, window_lo=lo)

    dev = x.device
    if group > MAX_GROUP or hd % 32 or hd > 128:
        raise NotImplementedError(
            f"_fused_decoder_layer: group {group} (at most {MAX_GROUP}) or "
            f"head_dim {hd} (a multiple of 32 up to 128)")
    if not 1 <= kcfg.kv_split <= 1024:
        raise ValueError(f"bad KernelConfig {kcfg}")
    if hidden % 8 or C % 8:
        raise ValueError(f"hidden {hidden} and qkv width {C} must be "
                         "multiples of 8")
    if hidden > 8192:
        raise NotImplementedError(f"_fused_decoder_layer: hidden {hidden} "
                                  "(at most 8192)")
    res = residual if fuse_residual else None
    for name, t in (("x", x), ("residual", res)):
        if t is not None and (t.dtype != torch.bfloat16
                              or t.numel() != hidden):
            raise ValueError(f"{name} must be bf16 [1, hidden]")
    kc_l, vc_l = k_cache[layer_id], v_cache[layer_id]
    if emit_partials:
        wo = None
    quant = isinstance(wqkv, QuantizedTensor)
    w4 = quant and wqkv.kind == "int4"
    wk = wq_kind_of(wqkv, kcfg)
    # W4A8's O projection runs on the ring GEMV after the layer (the
    # module's note): its consumer threads, and the layer's o between them
    o_proj8 = wk == WK_INT4A8 and not emit_partials
    if o_proj8:
        check_stack_kcfg(kcfg)
        if G > MAX_O_GROUPS:        # a cluster's chunks, one head group each
            raise NotImplementedError(
                f"_fused_decoder_layer: W4A8's O projection over {G} head "
                f"groups (at most {MAX_O_GROUPS}; ROADMAP.md queue 2, mode "
                "1.5)")
    ws, scales = quant_operands(dict(wqkv_f=wqkv, wo_f=wo),
                               (C, hidden) if quant else (), 0)
    wqkv, wo = ws["wqkv_f"], ws["wo_f"]
    sq, so = scales.get("wqkv_f_s"), scales.get("wo_f_s")
    for name, t in (("x", x), ("residual", res), ("rms_w", rw),
                    ("wqkv_f", wqkv), ("wo_f", wo), ("wqkv_f scales", sq),
                    ("wo_f scales", so), ("k_cache", kc_l),
                    ("v_cache", vc_l)):
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"_fused_decoder_layer: {name} must be a "
                             f"contiguous, 16-byte aligned tensor on {dev}")
    if rw.dtype != torch.bfloat16:
        raise NotImplementedError("_fused_decoder_layer: rms_w must be bf16")
    cos = cos_f.to(device=dev, dtype=torch.float32).reshape(hd).contiguous()
    sin = sin_f.to(device=dev, dtype=torch.float32).reshape(hd).contiguous()
    bf16, f32 = torch.bfloat16, torch.float32
    rows = kv_heads * group
    res_out = torch.empty((1, hidden), dtype=bf16, device=dev) \
        if fuse_residual else None
    k_new = torch.empty((kv_heads, hd), dtype=bf16, device=dev)
    v_new = torch.empty((kv_heads, hd), dtype=bf16, device=dev)
    if emit_partials:
        out = None
        acc = torch.empty((rows, hd), dtype=f32, device=dev)
        ml = torch.empty((2, rows), dtype=f32, device=dev)
    else:
        out = torch.empty((1, hidden), dtype=bf16, device=dev)
        acc = ml = None
    o_buf = torch.empty(kv_heads * group * hd, dtype=bf16, device=dev) \
        if o_proj8 else None
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = stream_scratch(
        ("decoder_layer", hidden, kv_heads),
        lambda: lib.cf_decoder_layer_scratch_floats(hidden, kv_heads), dev,
        stream)
    n_launch = ctypes.c_int(0)

    def ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    err = lib.cf_decoder_layer(
        ptr(x), ptr(res), ptr(rw), ptr(cos), ptr(sin), ptr(wqkv), ptr(wo),
        ptr(kc_l), ptr(vc_l), ptr(out), ptr(res_out), ptr(k_new),
        ptr(v_new), ptr(acc), ptr(ml), ptr(scratch), hidden, kv_heads, hg,
        group, hd, cap, seq, fold, int(append_kv),
        1 if rope_style == "neox" else 0, float(eps), kcfg.kv_split,
        ptr(phase_stamps), ctypes.byref(n_launch), stream, ptr(sq), ptr(so),
        wk, ptr(o_buf), kcfg.gemv_threads, kv_kind,
        0 if lo is None else min(max(lo, 0), seq))
    if err:
        scratch.zero_()                 # the ticket counters start at 0
        _build.check(err, "_fused_decoder_layer")
    launches += 1
    int8_launches += int(wk == WK_INT8)
    int4_launches += int(w4)
    fp8_launches += int(kv_kind == KV_FP8)
    window_launches += int(lo is not None)
    last_call_kernels = n_launch.value
    if emit_partials:
        return acc, ml, res_out, k_new, v_new
    if append_kv:
        return out, res_out, k_new, v_new, k_cache, v_cache
    return out, res_out, k_new, v_new


# --------------------------------------------------------------------------
# Reference-parity public ops
# --------------------------------------------------------------------------


def _prep_mha(weight_qkv, weight_o, k_cache, v_cache, heads: int, hd: int,
              hg: int, transposed_blocks: bool):
    """Reference tensor layouts -> kernel layouts (MHA): (wqkv_g, wo_g,
    k [1, heads, seq, hd], v, seq).

    transposed_blocks=False: weight_qkv is torch-Linear [3*hidden, hidden]
    (sglang op).  True: stacked [in, out] blocks (the meta op).  Every cache
    row is past: capacity = seq and nothing is appended."""
    hidden = heads * hd
    seq = k_cache.shape[0]
    if transposed_blocks:
        per_head = (weight_qkv.reshape(3, hidden, heads, hd)
                    .permute(2, 1, 0, 3).reshape(heads, hidden, 3 * hd))
        wo_per_head = weight_o.reshape(heads, hd, hidden)
    else:
        per_head = (weight_qkv.reshape(3, heads, hd, hidden)
                    .permute(1, 3, 0, 2).reshape(heads, hidden, 3 * hd))
        wo_per_head = weight_o.t().reshape(heads, hd, hidden)
    wqkv_g, wo_g = fuse_qkv_o_for_kernel(per_head, wo_per_head, heads, 1, hd,
                                         hg)
    kc = k_cache.reshape(seq, heads, hd).transpose(0, 1)[None]
    vc = v_cache.reshape(seq, heads, hd).transpose(0, 1)[None]
    return (wqkv_g.contiguous(), wo_g.contiguous(), kc.contiguous(),
            vc.contiguous(), seq)


def llama_decoder_layer_sglang(input, residual, weight_qkv, weight_o, k_cache,
                               v_cache, rms_w, eps: float, cos, sin,
                               kernel_config: Optional[KernelConfig] = None,
                               window: int = 0):
    """Fused layer, sglang variant: NEOX rope + fused residual add + runtime
    eps, weights in torch.nn.Linear [out, in] layout (weight_qkv
    [3*hidden, hidden], weight_o [hidden, hidden]); caches [seq, hidden];
    cos/sin [head_dim/2].  Twin of the reference op
    ``clusterfusion.llama_decoder_layer_sglang``.

    Returns (output, residual_out, k_new, v_new), each [1, hidden]."""
    kcfg = kernel_config or KernelConfig()
    hidden = input.shape[-1]
    hd = 2 * cos.shape[-1]
    heads = hidden // hd
    hg = _pick_head_group(heads, HEAD_GROUP)
    wqkv_g, wo_g, kc, vc, seq = _prep_mha(
        weight_qkv, weight_o, k_cache, v_cache, heads, hd, hg, False)
    cos_f = torch.cat([cos, cos])[None]
    sin_f = torch.cat([sin, sin])[None]
    out, res_out, k_new, v_new = _fused_decoder_layer(
        input, residual, rms_w[None], cos_f, sin_f, wqkv_g, wo_g, kc, vc,
        seq, group=1, head_dim=hd, rope_style="neox", fuse_residual=True,
        eps=eps, kcfg=kcfg, window=window)
    return out, res_out, k_new.reshape(1, hidden), v_new.reshape(1, hidden)


def llama_decoder_layer(input, weight_qkv, weight_o, k_cache, v_cache, rms_w,
                        cos, sin, eps: float = 1e-6,
                        kernel_config: Optional[KernelConfig] = None):
    """Fused layer, meta-llama variant: GPT-J interleaved rope, no residual
    add (the caller adds), weights in the transposed [in, out] layout
    (weight_qkv [3*hidden, hidden] of stacked W.T blocks, weight_o = wo.T);
    caches [seq, hidden]; cos/sin [1, head_dim] repeat-interleaved.  Twin
    of the reference op ``clusterfusion.llama_decoder_layer``.

    Returns (output, k_new, v_new), each [1, hidden]."""
    kcfg = kernel_config or KernelConfig()
    hidden = input.shape[-1]
    hd = cos.shape[-1]
    heads = hidden // hd
    hg = _pick_head_group(heads, HEAD_GROUP)
    wqkv_g, wo_g, kc, vc, seq = _prep_mha(
        weight_qkv, weight_o, k_cache, v_cache, heads, hd, hg, True)
    out, _, k_new, v_new = _fused_decoder_layer(
        input, None, rms_w[None], cos.reshape(1, hd), sin.reshape(1, hd),
        wqkv_g, wo_g, kc, vc, seq, group=1, head_dim=hd, rope_style="gptj",
        fuse_residual=False, eps=eps, kcfg=kcfg)
    return out, k_new.reshape(1, hidden), v_new.reshape(1, hidden)
