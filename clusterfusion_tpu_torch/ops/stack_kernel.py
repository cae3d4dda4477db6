"""Whole-stack bf16 decode step (twin of ``clusterfusion_tpu/ops/stack_kernel.py``).

``fused_decoder_stack`` runs every layer of one bs=1 decode step, the
attention half and the SwiGLU FFN, plus the final RMSNorm and LM head when
they are given.  CUDA tensors run the hand-written kernels of
``csrc/stack_kernel.cu``, launched in a fixed order per layer by one C
entry point (see the note at the top of that file); CPU tensors run
``fused_decoder_stack_plain``, which repeats the kernels' arithmetic in
PyTorch.  Both follow the TPU kernel where "the same math" could differ:

- the hidden pair (x, residual) is carried in float32 across layers and
  cast to bf16 only at exit;
- q is roped, pre-scaled by 1/sqrt(hd)*log2(e) and kept float32 for the
  current-token fold, and rounded to bf16 for the dots over cached rows;
  the softmax is exp2, and p is rounded to bf16 for the p.V dot;
- cached rows ``< pos`` are read, never the whole capacity; the current
  token's k/v join in float32 from the projection, not as the bf16 row
  that is appended at ``pos``;
- the O-projection input is rounded to bf16 and its partial sums over head
  groups stay float32;
- the LM phase normalises ``hx + residual``, both float32.

Int8 weights (``ops.quant.QuantizedTensor``, per output column; the TPU
kernel's ``wq_kind == "int8"``): ``wqkv_f``, ``wo_f``, ``w13`` and ``w2``
all int8, and ``lm_head`` int8 or bf16 on its own.  Each product sums over
K in float32 on the int8 codes (exact in float32, |q| <= 127), and the
scale is applied where the TPU kernel applies it: QKV per head group and
column after the sum over hidden; the O projection per group and column on
each group's partial, before the sum over groups (``wo_f.s`` is [L, G, 1,
hidden]); gate and up per column before SwiGLU; down per column after the
whole sum over f; the LM head per column after its sum.  On the card the
codes stream as they are (never a bf16 copy) through the ring GEMV's int8
instance.

Int4 weights (group-wise along K, two codes a byte; the TPU kernel's
``wq_kind == "int4"``): the four projections int4 together, the LM head
bf16 or int8 (the JAX package never makes an int4 head).  Each product is
the TPU kernel's ``_int4_dot`` (``ops.decoder_layer``), with the scales as
bf16: with ``kcfg.int4_w4a8`` (the default) W4A8, each activation block
quantized to int8 per row against its absmax (QKV and gate/up: the normed
row; the O projection: one head group's o; down: one f-block of
``ffn_block_size(f_pad)``) and each scale group's integer dot scaled by its
scale; else the exact product over bf16(code * s).  On the card the packed
codes stream once through the ring GEMV's int4 instance
(``ring_gemv4_kernel``), in the kernels' group size of 128 only
(``ROADMAP.md`` queue 2, mode 1.5; the plain twin takes any).

Mode 5, ``reduce_axis`` (the JAX package's ``fused_collectives=True``):
each rank holds its tp shards of the weights and caches, and the float32
partial sums of the O-projection and of the down projection are summed
over the axis inside the step, on the card by kernel 13's protocol inside
the stack's own launches (the two products push their sums to every rank,
the norms after them wait and add the ranks' sums; no launch of its own),
and by ``all_reduce_plain`` on the CPU, in the same rank order.  ``mesh``
(the port's ``parallel.Mesh``) names the ranks.  The tp step
(``parallel.decode``) runs ``_fused_decoder_stack_gathered``: mode 5 with
this rank's vocab shard of the LM head, its logits gathered over the axis
inside the stack's launches too (kernel 14: the LM head's product pushes
its shard to every rank, one wait copies the ranks' shards out in rank
order), and by ``all_gather_plain`` on the CPU.  With int8 weights (and
an int8 or bf16 LM-head shard) and with int4 weights the pushing products
push sums already scaled, as the TPU kernel scales before its reduces; the
scales are the same on every rank, so they commute with the sum over them.
W4A8's activation blocks are this rank's: the O projection's head group
and the down product's f-block of the shard's ``f_pad``
(``ffn_block_size`` of it, JAX's block on a shard), so a sharded W4A8
step is not the unsharded one's function; the plain twin quantizes the
same blocks.

8-bit KV caches (the TPU kernel's ``kv_kind``): an ``Int8KV`` pair
(``ops.quant``: int8 rows, float32 scales per (kv head, position) in [L,
kv, R, 128] planes) or a ``float8_e4m3fn`` pair, beside any weight kind,
in mode 5 too (each rank's tp shard of the pair: ``parallel.shard_cache``
cuts an ``Int8KV``'s rows and scale planes on the kv axis; the split and
merge passes know nothing of the reduces).  The rows below ``pos``
are read as the TPU kernel reads them: int8 scores are (bf16(q) . code) *
sk and p enters the p.V dot as bf16(p * sv); fp8 rows decode exactly with
e4m3 denormals (|v| <= 0.0137) flushed to 0 (``fp8_decode_scaled``).  The
current token's fold stays float32, and only its stored copy is 8-bit:
int8 codes and scale from the float32 row (``quantize_kv_rows``), or e4m3
straight from float32 (saturating at +-448, where the JAX package's CPU
cast gives NaN).

Head dims 128 and 64.  At 64 (TinyLlama; the TPU kernel's
``defer_append`` variant, which emits the new rows as bf16 outputs and
lands them with ``cache_fill_rows`` after the call) two rules change, as
in the TPU kernel: the stored copy is taken from the bf16-rounded row
(an 8-bit cache stores int8 codes and scale of the bf16 row, or e4m3 of
the bf16 row; a bf16 cache stores the same bf16 row either way), while
the token's fold stays float32; and the O projection of int4 weights is
the exact product over bf16(code * s) whatever ``kcfg.int4_w4a8`` says
(the TPU kernel's per-row O contraction at hd 64 dequantizes its tile).
The split reads rows below ``pos`` only, so appending inside the step
gives the results of the TPU kernel's deferred update.  Kernel 8 (the
verify) keeps hd 128: the JAX package's verify has no hd-64 form, and its
``spec_verify`` scores the drafts eagerly there.

Sliding window (Mistral's semantics, ``window`` > 0 with
``window_pattern="all"``; the TPU kernel's ``wlo = seq + 1 - window``): the
token at ``pos`` attends cached rows ``>= pos + 1 - window`` and itself, on
one card and in mode 5 alike (each rank's split and merge over its own kv
heads; the window changes no reduce).  The split pass keeps its split
boundaries and runs only the splits that hold a row in the window, masking
the first of them below the bound, so rows below the window cost no bytes;
``window >= pos + 1`` gives the bits of no window, and window 1 launches
no split pass (7L+2 kernels, 7L+3 with the logits gathered).  Gemma-2's
``"even"`` pattern is refused.

The caches are updated in place: the returned caches are the tensors that
were passed in (an ``Int8KV`` pair is returned as the same pair).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.ops import _build
from clusterfusion_tpu_torch.ops._support import glu_act
from clusterfusion_tpu_torch.ops.ffn import ffn_block_size
from clusterfusion_tpu_torch.ops.quant import (FP8_DECODE_FIX, Int8KV,
                                               QuantizedTensor,
                                               cache_write_layer,
                                               fp8_decode_scaled,
                                               kv_scales_flat)
from clusterfusion_tpu_torch.ops.rope import apply_rope_gptj, apply_rope_neox

_LOG2E = 1.4426950408889634
_NEG_INF = -1e30

#: Calls of :func:`fused_decoder_stack` that launched the kernels.
launches = 0
#: Those of them with int8 weights (kernel 7's int8 mode).
int8_launches = 0
#: Those of them with int4 weights (kernel 7's int4 modes).
int4_launches = 0
#: The int4 group size the kernels take (``GS4`` in ``csrc/common.cuh``).
INT4_GROUP = 128
#: The weight kinds of the C entries (``WK_*`` in ``csrc/common.cuh``).
WK_BF16, WK_INT8, WK_INT4, WK_INT4A8 = 0, 1, 2, 3
#: The cache kinds of the C entries (``KV_*`` in ``csrc/common.cuh``).
KV_BF16, KV_INT8, KV_FP8 = 0, 1, 2
#: Calls of :func:`fused_decoder_stack` with an 8-bit cache, by kind.
kv8_launches = {KV_INT8: 0, KV_FP8: 0}
#: CUDA kernels the last such call launched (8 per layer + 1 or 2, mode 5
#: too; 8 per layer + 3 with the logits gathered; 7 per layer at window 1).
last_step_kernels = 0


def _vocab_block(V: int, target: int = 1024) -> int:
    """Largest 128-aligned divisor of V at most ``target`` (0 if none)."""
    best = 0
    for d in range(1, target // 128 + 1):
        if V % (d * 128) == 0:
            best = d * 128
    return best


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
          style: str) -> torch.Tensor:
    """Rope on [..., hd] with full-dim [..., hd] tables (broadcast)."""
    if style == "neox":
        hd = x.shape[-1]
        return apply_rope_neox(x, cos[..., : hd // 2], sin[..., : hd // 2])
    if style == "gptj":
        return apply_rope_gptj(x, cos, sin)
    raise ValueError(f"unknown rope style {style!r}")


def _norm(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 RMSNorm of a float32 row, rounded to bf16."""
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps) * w.float()).to(torch.bfloat16)


def kv_rows_plain(c: torch.Tensor) -> torch.Tensor:
    """Cache rows as the kernels read them, float32: bf16 and int8 codes
    exactly, fp8 through the TPU kernel's decode (e4m3 denormals flushed to
    0)."""
    if c.dtype == torch.float8_e4m3fn:
        return fp8_decode_scaled(c).float() * FP8_DECODE_FIX
    return c.float()


def kv_layer(cache, l: int):
    """Layer ``l`` of a cache as (rows [kv, cap, hd], flat scales [kv, cap]
    or None)."""
    if isinstance(cache, Int8KV):
        cap = cache.q.shape[2]
        return cache.q[l], kv_scales_flat(cache.s[l:l + 1], cap)[0]
    return cache[l], None


def window_lo(seq: int, window: int, lo=None):
    """The first cached row in the window of the token at ``seq``: ``lo``
    where it is given (a caller's bound in its own coordinates, as the sp
    step's shards take it), else ``seq + 1 - window``; None without a
    window.  It may lie below 0 (every row in the window) or at or above
    ``seq`` (no cached row in it)."""
    if window <= 0:
        return None
    return seq + 1 - window if lo is None else int(lo)


def first_live_row(seq: int, kv_split: int, window: int, lo=None) -> int:
    """The first cached row the split pass reads under a window for the
    token at ``seq`` (0 without one): the start of the split that holds
    the bound (:func:`window_lo`); ``seq`` when no cached row is in the
    window.  The kernels' ``attn_live_splits``."""
    lo = window_lo(seq, window, lo)
    wlo = 0 if lo is None else max(0, lo)
    return wlo // kv_split * kv_split if wlo < seq else seq


def split_attention_plain(q, k_cur, v_cur, kc, vc, seq: int, kv_split: int,
                          fold: bool = True, ks=None, vs=None,
                          window: int = 0, lo=None):
    """The kernels' split-KV flash-decode (``attn_split_kernel`` and
    ``attn_merge_kernel`` of ``csrc/common.cuh``) in PyTorch.

    q [kv, g, hd] float32, roped and pre-scaled by 1/sqrt(hd)*log2(e);
    k_cur/v_cur [kv, hd] float32; kc/vc [kv, cap, hd] (bf16, int8 codes or
    fp8) of which rows < seq are read (:func:`kv_rows_plain`), and for
    int8 codes their scales ks/vs [kv, cap].  Per split of ``kv_split``
    rows: the max m_s, the sum of exp2(s - m_s) and bf16(p) @ V with q
    rounded to bf16 (int8: s = (q . code) * sk and bf16(p * sv) @ codes);
    then the merge, with the current token folded in float32 when
    ``fold``.  ``window`` > 0: only the splits that hold a row at or above
    the bound (:func:`window_lo`: ``lo``, else ``seq + 1 - window``) run,
    as the kernels' split passes do (:func:`first_live_row`); rows below
    the bound are neither read nor weighed, so whatever they hold (NaN
    too) cannot reach the result, and a bound at or below row 0 gives the
    bits of no window.  Returns the unnormalised state (acc [kv, g, hd], m
    [kv, g], l [kv, g]); with nothing folded it is (0, -1e30, 0)."""
    kv_heads, g, hd = q.shape
    bf16 = torch.bfloat16
    lo = window_lo(seq, window, lo)
    wlo = 0 if lo is None else min(max(lo, 0), seq)
    j0 = first_live_row(seq, kv_split, window, lo)
    n, below = seq - j0, wlo - j0
    ns = -(-n // kv_split)
    pad = ns * kv_split - n
    # zeros stand in for the first live split's rows below the bound
    kcp = F.pad(kv_rows_plain(kc[:, wlo:seq]), (0, 0, below, pad))
    vcp = F.pad(kv_rows_plain(vc[:, wlo:seq]), (0, 0, below, pad))
    s = torch.einsum("kgd,ksd->kgs", q.to(bf16).float(), kcp)[..., :n]
    if ks is not None:
        s = s * F.pad(ks[:, wlo:seq], (below, 0))[:, None]
    s[..., :below] = _NEG_INF              # masked: no part in the max
    s = F.pad(s, (0, pad), value=_NEG_INF)
    s = s.reshape(kv_heads, g, ns, kv_split)
    m_s = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m_s)        # 0 below the bound: m_s is finite
    l_s = p.sum(dim=-1)                                        # [kv, g, ns]
    p_in = p
    if vs is not None:
        p_in = p * F.pad(vs[:, wlo:seq], (below, pad)).reshape(kv_heads, 1,
                                                               ns, kv_split)
    pv_s = torch.einsum("kgns,knsd->kgnd", p_in.to(bf16).float(),
                        vcp.reshape(kv_heads, ns, kv_split, hd))
    m_s = m_s[..., 0]
    s_cur = (q * k_cur[:, None]).sum(dim=-1)                   # [kv, g]
    if not fold:
        s_cur = torch.full_like(s_cur, _NEG_INF)
    m_f = torch.maximum(s_cur, m_s.amax(dim=-1)) if ns else s_cur
    e_s = torch.exp2(m_s - m_f[..., None])
    p_cur = torch.exp2(s_cur - m_f) * float(fold)
    l_f = p_cur + (l_s * e_s).sum(dim=-1)
    acc = p_cur[..., None] * v_cur[:, None] + \
        (pv_s * e_s[..., None]).sum(dim=2)
    return acc, m_f, l_f


def check_int4_group(gs: int, what: str) -> None:
    """Raise unless the int4 kernels take group size ``gs`` (128; the
    plain twins take any)."""
    if gs != INT4_GROUP:
        raise NotImplementedError(
            f"{what}: int4 group size {gs}; the kernels take "
            f"{INT4_GROUP} only (ROADMAP.md queue 2, mode 1.5)")


#: The head dims kernel 7 takes (64: the TPU kernel's defer_append variant).
STACK_HEAD_DIMS = (64, 128)


def refuse_unported(what: str, head_dim: int, weights, final_norm, lm_head,
                    k_cache, v_cache, *, window, bias_qkv, ffn_act, softcap,
                    post_attn_norm, post_ffn_norm,
                    window_pattern: str = "all") -> None:
    """Raise on what the whole-stack kernels (``fused_decoder_stack``,
    ``fused_verify_stack``) do not take yet.  ``weights`` starts with the
    four projections, which the kernels take bf16, int8 or int4 (in group
    size 128), beside a bf16 or int8 ``lm_head``.  A sliding window in
    Mistral's pattern ``"all"``; Gemma-2's ``"even"`` pattern is refused.
    Head dims: 64 and 128 (the verify refuses 64 itself, first)."""
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")
    if window and window_pattern != "all":
        raise NotImplementedError(
            f"{what}: window_pattern {window_pattern!r} (Gemma-2's "
            "interleaved local/global layers) is not ported yet (ROADMAP.md "
            "queue 2, mode 3)")
    if softcap or bias_qkv is not None or ffn_act != "silu":
        raise NotImplementedError(f"{what}: softcap, QKV bias and GeGLU are "
                                  "not ported yet (ROADMAP.md queue 2, "
                                  "mode 3)")
    if post_attn_norm is not None or post_ffn_norm is not None:
        raise NotImplementedError(f"{what}: sandwich norms are not ported "
                                  "yet")
    if head_dim == 256:
        raise NotImplementedError(
            f"{what}: head_dim {head_dim} (Gemma-2's 256) is not ported yet "
            "(ROADMAP.md queue 2, mode 3)")
    if head_dim not in STACK_HEAD_DIMS:
        raise NotImplementedError(
            f"{what}: head_dim {head_dim}; the kernels take "
            f"{' and '.join(map(str, STACK_HEAD_DIMS))} (no JAX model runs "
            "another through the stack)")
    quant = [w for w in (*weights, lm_head) if isinstance(w, QuantizedTensor)]
    if quant and not all(isinstance(w, QuantizedTensor) for w in weights[:4]):
        raise ValueError(f"{what}: wqkv_f, wo_f, w13 and w2 are quantized "
                         "together or not at all")
    if len({w.kind for w in weights[:4] if isinstance(w, QuantizedTensor)}) > 1:
        raise ValueError(f"{what}: wqkv_f, wo_f, w13 and w2 are of one kind")
    if isinstance(lm_head, QuantizedTensor) and lm_head.kind == "int4":
        raise NotImplementedError(f"{what}: an int4 LM head (no JAX path makes "
                                  "one) is not ported (ROADMAP.md queue 2, "
                                  "mode 1.5)")
    for w in weights[:4]:
        if isinstance(w, QuantizedTensor) and w.kind == "int4":
            check_int4_group(w.group_size, what)
    if any(w is not None and not isinstance(w, QuantizedTensor)
           and w.dtype != torch.bfloat16 for w in (*weights, lm_head)):
        raise NotImplementedError(f"{what}: only bf16, int8 and int4 weights "
                                  "are ported")
    kv_kind_of(k_cache, v_cache, what)
    if (final_norm is None) != (lm_head is None):
        raise ValueError("final_norm and lm_head go together")


def kv_kind_of(k_cache, v_cache, what: str) -> int:
    """The C entries' cache kind (``KV_*``) of a K/V pair: bf16, an
    ``Int8KV`` pair or a ``float8_e4m3fn`` pair.  A pair of two kinds, and
    any other dtype (an int8 tensor without scales, as the JAX package's
    serving pools hold one, too), raise."""
    kinds = []
    for c in (k_cache, v_cache):
        if isinstance(c, Int8KV):
            kinds.append(KV_INT8)
        elif c.dtype == torch.bfloat16:
            kinds.append(KV_BF16)
        elif c.dtype == torch.float8_e4m3fn:
            kinds.append(KV_FP8)
        else:
            raise NotImplementedError(
                f"{what}: a {c.dtype} KV cache; the kernels take bf16, an "
                "Int8KV pair (int8 rows with their scales) or float8_e4m3fn "
                "(ROADMAP.md queue 2, mode 2)")
    if kinds[0] != kinds[1]:
        raise ValueError(f"{what}: k_cache and v_cache are of one kind")
    return kinds[0]


def _kv_operands(k_cache, v_cache, kind: int, cap: int):
    """What the C entries take of a cache pair: (k rows, v rows, k scale
    planes, v scale planes, plane row stride R * 128); the planes None and
    the stride 0 but for an ``Int8KV`` pair, whose planes must cover the
    capacity."""
    if kind != KV_INT8:
        return k_cache, v_cache, None, None, 0
    for c in (k_cache, v_cache):
        if c.s.dtype != torch.float32 or c.s.shape[-1] != 128 or \
                c.s.shape[:2] != c.q.shape[:2]:
            raise ValueError("Int8KV scales must be float32 [L, kv, R, 128]")
        if c.s.shape[2] * 128 < cap:
            raise ValueError(f"Int8KV scale planes of {c.s.shape[2]} x 128 "
                             f"positions do not cover the capacity {cap}")
    return (k_cache.q, v_cache.q, k_cache.s, v_cache.s,
            k_cache.s.shape[2] * 128)


def wq_kind_of(wqkv_f, kcfg: KernelConfig) -> int:
    """The C entries' weight kind of a stack (``WK_*``): bf16, int8, or
    int4 in W4A8 (``kcfg.int4_w4a8``) or in the exact mode."""
    if not isinstance(wqkv_f, QuantizedTensor):
        return WK_BF16
    if wqkv_f.kind == "int8":
        return WK_INT8
    return WK_INT4A8 if kcfg.int4_w4a8 else WK_INT4


def check_stack_kcfg(kcfg: KernelConfig) -> None:
    """What kernels 7 and 8 take of ``kcfg``, on either device:
    ``kv_split`` in [1, 1024] (the split passes keep a split's scores in
    shared memory) and ``gemv_threads`` a multiple of 32 in [32, 992] (the
    ring GEMV's consumer threads, beside its producer warp)."""
    if not 1 <= kcfg.kv_split <= 1024:
        raise ValueError(f"kv_split {kcfg.kv_split} outside [1, 1024]")
    if kcfg.gemv_threads % 32 or not 32 <= kcfg.gemv_threads <= 992:
        raise ValueError(f"gemv_threads {kcfg.gemv_threads} is not a multiple "
                         "of 32 in [32, 992]")


def check_launch(kcfg: KernelConfig, tensors: dict, widths) -> None:
    """What a whole-stack launch needs: a sane ``kcfg``; every tensor given
    (None entries are skipped) on x's device, contiguous and 16-byte
    aligned; every GEMV width a multiple of 8."""
    if not 1 <= kcfg.kv_split <= 1024 or kcfg.gemv_threads % 32:
        raise ValueError(f"bad KernelConfig {kcfg}")
    dev = tensors["x"].device
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for w in widths:
        if w % 8:
            raise ValueError(f"GEMV width {w} is not a multiple of 8")


def quant_operands(weights: dict, widths, vocab: int):
    """What the kernels pass for ``weights`` (name -> tensor,
    QuantizedTensor or None): (name -> tensor, with each quantized weight's
    codes; name + "_s" -> its float32 scales).  Checks that int8 weights
    are int8 codes with per-column scales over axis -2, int4 weights codes
    packed along axis -2 with group scales over it, and that each quantized
    GEMV width (``widths``, and the LM head's ``vocab`` when it is int8) is
    a multiple of 16 (the tensor maps' rows are 16-byte aligned)."""
    weights, scales = dict(weights), {}
    for name, w in weights.items():
        if isinstance(w, QuantizedTensor):
            if w.q.dtype != torch.int8 or w.s.dtype != torch.float32:
                raise ValueError(f"{name}: int8 codes and float32 scales "
                                 "are expected")
            if w.kind == "int8" and (w.axis != -2 or w.s.shape[-2] != 1):
                raise ValueError(f"{name}: per-column scales over axis -2 "
                                 "are expected")
            if w.kind == "int4" and (w.axis != -2 or w.pack_axis != -2):
                raise ValueError(f"{name}: int4 codes packed along axis -2, "
                                 "with group scales over it, are expected")
            weights[name], scales[name + "_s"] = w.q, w.s
    for w in widths:
        if w % 16:
            raise ValueError(f"int8 GEMV width {w} is not a multiple of 16")
    if "lm_head_s" in scales and vocab % 16:
        raise ValueError(f"int8 LM head width {vocab} is not a multiple of 16")
    return weights, scales


def fused_decoder_stack_plain(x, attn_norm, ffn_norm, cos, sin, wqkv_f, wo_f,
                              w13, w2, k_cache, v_cache, pos, *, group: int,
                              head_dim: int, rope_style: str, eps: float,
                              final_norm=None, lm_head=None,
                              kv_split: int = KernelConfig().kv_split,
                              reduce=None,
                              int4_w4a8: bool = KernelConfig().int4_w4a8,
                              window: int = 0):
    """Plain PyTorch version of :func:`fused_decoder_stack` (same arguments,
    same results, caches appended in place).  ``kv_split`` is the kernel's
    split of the cached rows: bf16(p) is taken against each split's own
    max, as the kernel takes it, so the two round p alike.  ``reduce``
    (mode 5) sums a float32 [hidden] partial over the ranks; it is applied
    to the O-projection and to the down projection of every layer.  Int8
    weights: each product over the codes, scaled where the kernel scales
    (the module's note).  Int4 weights (any group size): the TPU kernel's
    products, W4A8 with ``int4_w4a8`` (the module's note).  8-bit caches:
    read and appended as the kernels read and append them (the module's
    note).  Head dim 64: the TPU kernel's hd-64 rules (the module's note):
    the stored rows from the bf16-rounded k and v, the int4 O product
    exact.  ``window``: the sliding window, the split arithmetic of
    :func:`split_attention_plain`."""
    # the plain int4 products live beside kernel 6, which imports this module
    from clusterfusion_tpu_torch.ops.decoder_layer import _int4_dot
    pos = int(pos)
    L, G, hidden, _ = wqkv_f.shape
    w4 = isinstance(wqkv_f, QuantizedTensor) and wqkv_f.kind == "int4"
    w8 = isinstance(wqkv_f, QuantizedTensor) and not w4
    # hd 64: the TPU kernel's defer_append variant (the module's note)
    defer = head_dim % 128 != 0
    if w4:
        gs, a8 = wqkv_f.group_size, int4_w4a8
        bf = ffn_block_size(w2.shape[-2])

        def dot4(xr, w, i, a8=a8):
            """The int4 product of the row xr with matrix i of w."""
            return _int4_dot(xr[None], w.q[i], w.s[i], gs, a8)[0]
    kv_heads = k_cache.shape[1]
    hd, g = head_dim, group
    scale = _LOG2E / math.sqrt(hd)
    cos_f = cos.float().reshape(hd)
    sin_f = sin.float().reshape(hd)
    bf16 = torch.bfloat16
    hx = x.float().reshape(hidden)
    res = torch.zeros_like(hx)
    for l in range(L):
        res = hx + res
        xn = _norm(res, attn_norm[l], eps)
        if w4:      # per head group, W4A8 over the normed row
            qkv = torch.stack([dot4(xn, wqkv_f[l], i) for i in range(G)])
        elif w8:    # per head group and column, after the sum over hidden
            qkv = torch.einsum("d,Gdc->Gc", xn.float(),
                               wqkv_f.q[l].float()) * wqkv_f.s[l][:, 0]
        else:
            qkv = torch.einsum("d,Gdc->Gc", xn.float(), wqkv_f[l].float())
        qkv = qkv.reshape(kv_heads, g + 2, hd)
        q = _rope(qkv[:, :g], cos_f, sin_f, rope_style) * scale   # [kv, g, hd]
        k_cur = _rope(qkv[:, g], cos_f, sin_f, rope_style)         # [kv, hd]
        v_cur = qkv[:, g + 1]
        kcl, ksl = kv_layer(k_cache, l)
        vcl, vsl = kv_layer(v_cache, l)
        acc, _, l_f = split_attention_plain(q, k_cur, v_cur, kcl, vcl, pos,
                                            kv_split, ks=ksl, vs=vsl,
                                            window=window)
        o = (acc / l_f[..., None]).to(bf16)
        # the stored copy, from float32 (8-bit: quantized or e4m3), or at
        # hd 64 from the bf16 row the TPU kernel's deferred append lands
        k_row, v_row = (k_cur.to(bf16), v_cur.to(bf16)) if defer \
            else (k_cur, v_cur)
        cache_write_layer(k_cache, l, k_row[:, None], pos)
        cache_write_layer(v_cache, l, v_row[:, None], pos)
        if w4:      # the head groups' products, summed in order (hd 64: exact)
            og = o.reshape(G, -1)
            aout = torch.zeros(hidden, dtype=torch.float32, device=x.device)
            for i in range(G):
                aout = aout + dot4(og[i], wo_f[l], i, a8 and not defer)
        elif w8:    # each group's partial scaled, then the groups summed
            aout = (torch.einsum("Gc,Gco->Go", o.reshape(G, -1).float(),
                                 wo_f.q[l].float())
                    * wo_f.s[l][:, 0]).sum(dim=0)
        else:
            aout = torch.einsum("Gc,Gco->o", o.reshape(G, -1).float(),
                                wo_f[l].float())
        if reduce is not None:
            aout = reduce(aout)
        res = aout + res
        xn2 = _norm(res, ffn_norm[l], eps)
        if w4:      # gate and up over the row; down per f-block, summed
            y = torch.stack([dot4(xn2, w13[l], i) for i in range(2)])
            act = glu_act(y[0], y[1]).to(bf16)
            hx = torch.zeros(hidden, dtype=torch.float32, device=x.device)
            for j in range(0, act.shape[0], bf):
                hx = hx + _int4_dot(act[None, j:j + bf], w2.q[l, j // 2:(j + bf) // 2],
                                    w2.s[l, j // gs:(j + bf) // gs], gs, a8)[0]
        elif w8:    # gate and up per column before SwiGLU; down after its sum
            y = torch.einsum("d,udf->uf", xn2.float(),
                             w13.q[l].float()) * w13.s[l][:, 0]
            act = glu_act(y[0], y[1]).to(bf16)
            hx = (act.float() @ w2.q[l].float()) * w2.s[l][0]
        else:
            y = torch.einsum("d,udf->uf", xn2.float(), w13[l].float())
            act = glu_act(y[0], y[1]).to(bf16)
            hx = act.float() @ w2[l].float()
        if reduce is not None:
            hx = reduce(hx)
    if lm_head is not None:
        xn = _norm(hx + res, final_norm, eps)
        if isinstance(lm_head, QuantizedTensor):
            logits = ((xn.float() @ lm_head.q.float()) * lm_head.s[0])[None]
        else:
            logits = (xn.float() @ lm_head.float())[None]
        return logits, res.to(bf16)[None], k_cache, v_cache
    return hx.to(bf16)[None], res.to(bf16)[None], k_cache, v_cache


def fused_decoder_stack_plain_ranks(rank_args, **kw):
    """The plain twin of one mode-5 step of every rank of a tp axis, in one
    process: rank r runs ``fused_decoder_stack_plain(*rank_args[r], **kw)``
    (its shards and caches) on a thread of its own, and the ranks meet at
    each of the step's reduces, which sum their float32 partials in rank
    order (kernel 13's order).  Returns each rank's result.  It holds the
    card's mode 5 where the sharded step is not the unsharded one's
    function (W4A8: the down product's blocks are the shard's)."""
    import threading
    n = len(rank_args)
    parts, outs, errs = [None] * n, [None] * n, []
    meet = threading.Barrier(n)

    def reducer(r):
        def reduce(t):
            parts[r] = t
            meet.wait()
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            meet.wait()                 # every rank has read every part
            return total
        return reduce

    def run(r):
        try:
            outs[r] = fused_decoder_stack_plain(*rank_args[r],
                                                reduce=reducer(r), **kw)
        except BaseException as e:      # noqa: BLE001 (re-raised below)
            errs.append(e)
            meet.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return outs


def fused_decoder_stack(
    x, attn_norm, ffn_norm, cos, sin, wqkv_f, wo_f, w13, w2,
    k_cache, v_cache, pos,
    *,
    group: int,
    head_dim: int,
    rope_style: str,
    eps: float,
    kcfg: KernelConfig = KernelConfig(),
    final_norm=None,
    lm_head=None,
    reduce_axis=None,
    mesh=None,
    window: int = 0,
    bias_qkv=None,
    ffn_act: str = "silu",
    softcap: float = 0.0,
    window_pattern: str = "all",
    post_attn_norm=None,
    post_ffn_norm=None,
):
    """One bs=1 decode step through the whole decoder stack.

    x [1, hidden]; attn_norm/ffn_norm [L, hidden];
    wqkv_f [L, G, hidden, hg*(group+2)*hd]; wo_f [L, G, hg*group*hd, hidden];
    w13 [L, 2, hidden, f_pad]; w2 [L, f_pad, hidden];
    k_cache/v_cache [L, kv_heads, capacity, hd]; cos/sin [1, hd] at ``pos``;
    pos: int, the number of cached tokens.

    Returns (x_out [1, hidden], residual_out [1, hidden], k_cache, v_cache),
    or (logits [1, vocab] f32, residual_out, k_cache, v_cache) when
    ``final_norm`` and ``lm_head`` are given.  The new token's K/V row is
    written at ``pos`` of every layer, in place.

    ``reduce_axis`` (with ``mesh``): this rank's shards of a tp-sharded
    stack (``parallel.shard_params`` / ``shard_cache``), its two partial
    sums per layer summed over that mesh axis inside the step; every rank
    returns the same x_out and residual_out, and with ``lm_head`` (this
    rank's vocab shard, a multiple of 8 columns) the logits of its shard.

    ``window`` > 0 (with ``window_pattern="all"``): the sliding window
    (the module's note), with or without ``reduce_axis``.
    """
    window = int(window)
    refuse_unported("fused_decoder_stack", head_dim,
                    (wqkv_f, wo_f, w13, w2, attn_norm, ffn_norm), final_norm,
                    lm_head, k_cache, v_cache, window=window,
                    bias_qkv=bias_qkv, ffn_act=ffn_act, softcap=softcap,
                    post_attn_norm=post_attn_norm,
                    post_ffn_norm=post_ffn_norm,
                    window_pattern=window_pattern)
    return _stack(x, attn_norm, ffn_norm, cos, sin, wqkv_f, wo_f, w13, w2,
                  k_cache, v_cache, pos, group=group, head_dim=head_dim,
                  rope_style=rope_style, eps=eps, kcfg=kcfg,
                  final_norm=final_norm, lm_head=lm_head,
                  reduce_axis=reduce_axis, mesh=mesh, gather=False,
                  window=window)


def _fused_decoder_stack_gathered(x, attn_norm, ffn_norm, cos, sin, wqkv_f,
                                  wo_f, w13, w2, k_cache, v_cache, pos, *,
                                  group: int, head_dim: int, rope_style: str,
                                  eps: float, final_norm, lm_head,
                                  reduce_axis: str, mesh,
                                  kcfg: KernelConfig = KernelConfig(),
                                  window: int = 0):
    """:func:`fused_decoder_stack` in mode 5 with this rank's vocab shard as
    ``lm_head`` (a multiple of 8 columns, at most 65536), its logits
    gathered over ``reduce_axis`` in rank order: (logits [1, vocab] f32,
    the same bits on every rank, residual_out, k_cache, v_cache).  On the
    card the gather runs inside the stack's launches (kernel 14: the LM
    head's product pushes the shard to every rank and one wait copies the
    shards out; 8 kernels a layer and 3, nothing after them, 7 a layer at
    window 1); on the CPU the plain stack's logits go through
    ``all_gather_plain``.  The tp step of ``parallel.decode`` runs it, with
    the config's sliding ``window`` (Mistral's pattern); on an axis of size
    1 it is the unsharded step with the LM head."""
    window = int(window)
    refuse_unported("fused_decoder_stack", head_dim,
                    (wqkv_f, wo_f, w13, w2, attn_norm, ffn_norm), final_norm,
                    lm_head, k_cache, v_cache, window=window, bias_qkv=None,
                    ffn_act="silu", softcap=0.0, post_attn_norm=None,
                    post_ffn_norm=None)
    if lm_head is None:
        raise ValueError("the gathered step needs the LM head's shard")
    return _stack(x, attn_norm, ffn_norm, cos, sin, wqkv_f, wo_f, w13, w2,
                  k_cache, v_cache, pos, group=group, head_dim=head_dim,
                  rope_style=rope_style, eps=eps, kcfg=kcfg,
                  final_norm=final_norm, lm_head=lm_head,
                  reduce_axis=reduce_axis, mesh=mesh, gather=True,
                  window=window)


def _stack(x, attn_norm, ffn_norm, cos, sin, wqkv_f, wo_f, w13, w2, k_cache,
           v_cache, pos, *, group, head_dim, rope_style, eps, kcfg,
           final_norm, lm_head, reduce_axis, mesh, gather: bool,
           window: int = 0):
    """The two entries' common body, after ``refuse_unported``; ``gather``:
    the logits gathered over ``reduce_axis`` (where it has more than one
    rank); ``window``: the sliding window."""
    global launches, int8_launches, int4_launches, last_step_kernels
    w8 = isinstance(wqkv_f, QuantizedTensor) and wqkv_f.kind == "int8"
    w4 = isinstance(wqkv_f, QuantizedTensor) and wqkv_f.kind == "int4"
    kv_kind = kv_kind_of(k_cache, v_cache, "fused_decoder_stack")
    if reduce_axis is not None and mesh is None:
        raise ValueError("reduce_axis needs the mesh whose axis it names")
    check_stack_kcfg(kcfg)
    pos = int(pos)
    L, G, hidden, C = wqkv_f.shape
    _, kv_heads, cap, hd = k_cache.shape
    kq, vq, ksp, vsp, srow = _kv_operands(k_cache, v_cache, kv_kind, cap)
    hg = kv_heads // G
    f_pad = w2.shape[-2]
    if hd != head_dim or C != hg * (group + 2) * hd:
        raise ValueError(f"wqkv_f columns {C} != hg*(group+2)*hd "
                         f"= {hg}*{group + 2}*{hd}")
    if not 0 <= pos < cap:
        raise ValueError(f"pos {pos} outside the cache capacity {cap}")
    # mode 5 on an axis of size 1 is the unsharded step (no reduce runs)
    sharded = reduce_axis is not None and mesh.groups[reduce_axis] is not None
    gather = gather and sharded
    vocab = 0
    if lm_head is not None:
        vocab = lm_head.shape[-1]
        # the TPU kernel's vocab block; the kernels here need only N % 8,
        # which a vocab shard is held to (a JAX step runs no shard through
        # the TPU kernel's LM phase)
        if reduce_axis is None and _vocab_block(vocab) == 0:
            raise ValueError(f"vocab {vocab} has no 128-aligned block")
        if reduce_axis is not None and vocab % 8:
            raise ValueError(f"the LM head's shard of {vocab} columns is not "
                             "a multiple of 8")
    if sharded:
        from clusterfusion_tpu_torch.parallel import collective
    if x.device.type == "cpu":
        reduce = None
        if sharded:
            def reduce(t):
                return collective.pallas_all_reduce(t, reduce_axis, mesh)
        out = fused_decoder_stack_plain(
            x, attn_norm, ffn_norm, cos, sin, wqkv_f, wo_f, w13, w2, k_cache,
            v_cache, pos, group=group, head_dim=head_dim,
            rope_style=rope_style, eps=eps, final_norm=final_norm,
            lm_head=lm_head, kv_split=kcfg.kv_split, reduce=reduce,
            int4_w4a8=kcfg.int4_w4a8, window=window)
        if gather:
            logits = collective.cluster_gather(out[0][0], reduce_axis,
                                               backend="pallas", mesh=mesh)
            out = (logits[None],) + out[1:]
        return out
    comm = None
    if sharded:
        comm = collective.communicator(mesh, reduce_axis)
        if comm.device != x.device.index:
            raise ValueError(f"x is on {x.device}, the {reduce_axis} "
                             f"communicator on cuda:{comm.device}")

    if rope_style not in ("neox", "gptj"):
        raise ValueError(f"unknown rope style {rope_style!r}")
    if group > 8:
        raise NotImplementedError(f"GQA group {group} > 8")
    if x.dtype != torch.bfloat16 or x.numel() != hidden:
        raise ValueError("x must be bf16 [1, hidden]")
    dev = x.device
    weights, scales = quant_operands(
        dict(wqkv_f=wqkv_f, wo_f=wo_f, w13=w13, w2=w2, lm_head=lm_head),
        (C, hidden, f_pad) if w8 or w4 else (), vocab)
    wq_kind = wq_kind_of(wqkv_f, kcfg)
    check_launch(kcfg, dict(x=x, attn_norm=attn_norm, ffn_norm=ffn_norm,
                            k_cache=kq, v_cache=vq, k_scales=ksp,
                            v_scales=vsp, final_norm=final_norm, **weights,
                            **scales),
                 (C, hidden, f_pad, vocab))
    cos_f = cos.to(device=dev, dtype=torch.float32).reshape(hd).contiguous()
    sin_f = sin.to(device=dev, dtype=torch.float32).reshape(hd).contiguous()

    lib = _build.lib()
    n_scratch = lib.cf_stack_scratch_floats(hidden, kv_heads, hg, group, hd,
                                            cap, f_pad, kcfg.kv_split, vocab)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    res_out = torch.empty((1, hidden), dtype=torch.bfloat16, device=dev)
    if lm_head is not None:
        width = vocab * (comm.size if gather else 1)
        logits = torch.empty((1, width), dtype=torch.float32, device=dev)
        x_out = None
    else:
        logits = None
        x_out = torch.empty((1, hidden), dtype=torch.bfloat16, device=dev)
    n_launch = ctypes.c_int(0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.cf_decoder_stack(
        ptr(x), ptr(attn_norm), ptr(ffn_norm), ptr(cos_f), ptr(sin_f),
        ptr(weights["wqkv_f"]), ptr(weights["wo_f"]), ptr(weights["w13"]),
        ptr(weights["w2"]), ptr(kq), ptr(vq), ptr(final_norm),
        ptr(weights["lm_head"]), ptr(x_out),
        ptr(res_out), ptr(logits), ptr(scratch),
        L, hidden, kv_heads, hg, group, hd, cap, f_pad, vocab, pos,
        1 if rope_style == "neox" else 0, float(eps), kcfg.kv_split,
        kcfg.gemv_threads, ctypes.byref(n_launch),
        None if comm is None else comm.handle, int(gather),
        torch.cuda.current_stream(dev).cuda_stream,
        *(ptr(scales.get(k)) for k in ("wqkv_f_s", "wo_f_s", "w13_s", "w2_s",
                                       "lm_head_s")),
        wq_kind, ffn_block_size(f_pad), kv_kind, ptr(ksp), ptr(vsp), srow,
        window)
    _build.check(err, "fused_decoder_stack")
    launches += 1
    int8_launches += int(w8)
    int4_launches += int(w4)
    if kv_kind != KV_BF16:
        kv8_launches[kv_kind] += 1
    last_step_kernels = n_launch.value
    if comm is not None:
        collective.launches["all_reduce"] += 2 * L
        collective.launches["all_gather"] += int(gather)
        comm.raise_on_error()
    if lm_head is not None:
        return logits, res_out, k_cache, v_cache
    return x_out, res_out, k_cache, v_cache
