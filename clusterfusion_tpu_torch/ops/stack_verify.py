"""Whole-stack n-row verify for speculative decoding (twin of
``clusterfusion_tpu/ops/stack_verify.py``).

``fused_verify_stack`` scores n tokens at positions ``pos .. pos+n-1`` in
one call through every layer, causal among themselves and attending the
whole cache below ``pos``, and appends all n K/V rows in place.  CUDA
tensors run the hand-written kernels of ``csrc/stack_verify.cu``, launched
in a fixed order per layer by one C entry point (see the note at the top of
that file); CPU tensors run ``fused_verify_stack_plain``, which repeats the
kernels' arithmetic in PyTorch.  Both follow the TPU kernel where bf16
rounds, which is not where the one-row stack rounds:

- q is roped, pre-scaled by 1/sqrt(hd)*log2(e) and kept float32; it is
  rounded to bf16 for the dots over cached rows, whose p is rounded to bf16
  for the p.V dot;
- the n x n causal block of fresh rows takes its scores from the float32 q
  and k, but rounds p and v to bf16 before their product (the one-row stack
  folds its current token in float32);
- only cache rows ``< pos`` are read: rows at and above ``pos`` may hold
  stale rows of rejected drafts;
- ``o`` is rounded to bf16 and the O-projection sums stay float32; the
  hidden pair stays float32 across layers and the LM phase normalises
  ``hx + residual`` in float32.

With n=1 this computes what ``fused_decoder_stack`` computes but for those
bf16 roundings of the current token's p and v.

Int8 weights (``ops.quant.QuantizedTensor``, per output column; the TPU
kernel's ``wq_kind == "int8"``): ``wqkv_f``, ``wo_f``, ``w13`` and ``w2``
all int8, and ``lm_head`` int8 or bf16 on its own, as in
``fused_decoder_stack``.  Each product is x_bf16 @ bf16(code) summed in
float32, the scale applied where the TPU kernel applies it: QKV per head
group and column after the sum over hidden; the O projection per group on
each group's partial, before the sum over groups; gate and up per column
before SwiGLU; down after the whole sum over f; the LM head after its sum.
On the card the codes stream as they are through the GEMVs' int8
instances (the rows GEMV's from 2 rows).

Int4 weights: the four projections int4 together, the LM head bf16 or
int8, each product the TPU kernel's ``_int4_dot`` as in
``fused_decoder_stack`` (W4A8 with ``kcfg.int4_w4a8``, each of the n rows
quantized on its own per activation block; else exact), on the card
through the GEMVs' int4 instances (the rows GEMV's ``rows_gemv4_kernel``
from 2 rows, the ring GEMV's at one), in group size 128 only (``ROADMAP.md``
queue 2, mode 1.5).  ``reduce_axis`` raises ``NotImplementedError``.

8-bit KV caches (an ``Int8KV`` pair or a ``float8_e4m3fn`` pair), as
``fused_decoder_stack`` takes them: the rows below ``pos`` are read as the
TPU kernel reads them (int8: scores times sk, bf16(p * sv) into the p.V
dot; fp8: e4m3 denormals flushed to 0), and each fresh row's stored copy is
quantized per (kv head, token) from float32 (int8: the n positions may
straddle a 128-column plane row) or cast to e4m3.  The n x n causal block
of fresh rows stays float32 K with bf16-rounded V, whatever the cache
kind.

Sliding window (Mistral's semantics, ``window`` > 0 with
``window_pattern="all"``; the TPU kernel's per-row bound): token t at
``pos + t`` attends positions ``>= pos + t + 1 - window``, cached and
fresh.  The split pass runs the splits from the one that holds token 0's
bound (the lowest) and masks each row below its own; a split with no live
row for a later token gives that row p 0 and a max of -1e30, which the
merge folds as nothing.  The fresh n x n block is masked the same way.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.ops import _build
from clusterfusion_tpu_torch.ops._support import cdiv, glu_act
from clusterfusion_tpu_torch.ops.decoder_layer import _int4_dot
from clusterfusion_tpu_torch.ops.ffn import ffn_block_size
from clusterfusion_tpu_torch.ops.quant import (QuantizedTensor,
                                               cache_write_layer)
from clusterfusion_tpu_torch.ops.stack_kernel import (
    _LOG2E, _NEG_INF, KV_BF16, KV_FP8, KV_INT8, _kv_operands, _norm, _rope,
    _vocab_block, check_launch, check_stack_kcfg, first_live_row, kv_kind_of,
    kv_layer, kv_rows_plain, quant_operands, refuse_unported, wq_kind_of)

#: Calls of :func:`fused_verify_stack` that launched the kernels.
launches = 0
#: Those of them with int8 weights (kernel 8's int8 mode).
int8_launches = 0
#: Those of them with int4 weights (kernel 8's int4 modes).
int4_launches = 0
#: Those of them with an 8-bit cache, by kind (``stack_kernel.KV_*``).
kv8_launches = {KV_INT8: 0, KV_FP8: 0}
#: CUDA kernels the last such call launched (8 per layer + 1 or 2; W4A8 from
#: 2 rows: 12 per layer, each product's x quantized in a launch of its own).
last_step_kernels = 0
#: Rows one call takes (the merge kernel keeps them in shared memory).
MAX_ROWS = 32


def fused_verify_stack_plain(x, attn_norm, ffn_norm, cos, sin, wqkv_f, wo_f,
                             w13, w2, k_cache, v_cache, pos, *, group: int,
                             head_dim: int, rope_style: str, eps: float,
                             final_norm=None, lm_head=None,
                             kv_split: int = KernelConfig().kv_split,
                             int4_w4a8: bool = KernelConfig().int4_w4a8,
                             window: int = 0):
    """Plain PyTorch version of :func:`fused_verify_stack` (same arguments,
    same results, caches appended in place).  ``kv_split`` is the kernel's
    split of the cached rows: bf16(p) is taken against each split's own
    max, as the kernel takes it, so the two round p alike.  Int8 weights:
    each product over the codes, scaled where the kernel scales (the
    module's note).  Int4 weights (any group size): the TPU kernel's
    products, W4A8 with ``int4_w4a8``.  8-bit caches: read and appended as
    the kernels read and append them (the module's note).  ``window``: the
    sliding window, split and masked as the kernels do (the module's
    note)."""
    pos = int(pos)
    n, hidden = x.shape
    L, G = wqkv_f.shape[:2]
    w4 = isinstance(wqkv_f, QuantizedTensor) and wqkv_f.kind == "int4"
    w8 = isinstance(wqkv_f, QuantizedTensor) and not w4
    if w4:
        gs, a8 = wqkv_f.group_size, int4_w4a8
        bf = ffn_block_size(w2.shape[-2])
    kv = k_cache.shape[1]
    hd, g = head_dim, group
    scale = _LOG2E / math.sqrt(hd)
    cos_f = cos.float().reshape(n, 1, 1, hd)
    sin_f = sin.float().reshape(n, 1, 1, hd)
    bf16 = torch.bfloat16
    causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    # the splits from the one that holds token 0's window bound; each
    # token's rows below its own bound (cached and fresh) are masked
    j0 = first_live_row(pos, kv_split, window)
    nc = pos - j0                                 # cached rows read
    ns = cdiv(nc, kv_split)
    pad = ns * kv_split - nc
    live = torch.ones((n, nc), dtype=torch.bool, device=x.device)
    if window > 0:
        tok = torch.arange(n, device=x.device)
        live = (j0 + torch.arange(nc, device=x.device))[None] >= \
            (pos + tok + 1 - window)[:, None]
        causal = causal & (tok[None] >= (tok + 1 - window)[:, None])
    live = F.pad(live, (0, pad)).reshape(n, ns, kv_split)
    hx = x.float()
    res = torch.zeros_like(hx)
    for l in range(L):
        res = hx + res
        xn = _norm(res, attn_norm[l], eps)                        # [n, hidden]
        if w4:      # per head group, each row's W4A8 over its normed row
            qkv = torch.stack([_int4_dot(xn, wqkv_f.q[l, i], wqkv_f.s[l, i],
                                         gs, a8) for i in range(G)], dim=1)
        elif w8:    # per head group and column, after the sum over hidden
            qkv = torch.einsum("nd,Gdc->nGc", xn.float(),
                               wqkv_f.q[l].float()) * wqkv_f.s[l][:, 0]
        else:
            qkv = torch.einsum("nd,Gdc->nGc", xn.float(), wqkv_f[l].float())
        qkv = qkv.reshape(n, kv, g + 2, hd)
        q = _rope(qkv[:, :, :g], cos_f, sin_f, rope_style) * scale   # [n,kv,g,hd]
        k_new = _rope(qkv[:, :, g], cos_f[:, 0], sin_f[:, 0], rope_style)
        v_new = qkv[:, :, g + 1]                                  # [n, kv, hd]
        # the fresh n x n causal block: float32 scores, query t x key j
        s_cur = torch.einsum("tkgd,jkd->kgtj", q, k_new)
        s_cur = s_cur.masked_fill(~causal, _NEG_INF)
        m_f = s_cur.amax(dim=-1)                                  # [kv, g, n]
        l_f = acc = 0.0
        if ns:
            # split-KV pass over rows < pos: per split of kv_split rows a
            # max m_s, a sum l_s of exp2(s - m_s), and bf16(p) @ V (int8:
            # scores times sk, bf16(p * sv) @ codes)
            kcl, ksl = kv_layer(k_cache, l)
            vcl, vsl = kv_layer(v_cache, l)
            kc = F.pad(kv_rows_plain(kcl[:, j0:pos]), (0, 0, 0, pad))
            vc = F.pad(kv_rows_plain(vcl[:, j0:pos]), (0, 0, 0, pad))
            s = torch.einsum("tkgd,ksd->kgts", q.to(bf16).float(),
                             kc)[..., :nc]
            if ksl is not None:
                s = s * ksl[:, None, None, j0:pos]
            s = F.pad(s, (0, pad), value=_NEG_INF)
            s = s.reshape(kv, g, n, ns, kv_split).masked_fill(~live,
                                                              _NEG_INF)
            m_s = s.amax(dim=-1, keepdim=True)
            # p 0 where masked: a split with no live row keeps l 0 and acc 0
            p = torch.exp2(s - m_s) * live
            p_in = p
            if vsl is not None:
                p_in = p * F.pad(vsl[:, j0:pos], (0, pad)).reshape(
                    kv, 1, 1, ns, kv_split)
            pv_s = torch.einsum("kgtns,knsd->kgtnd", p_in.to(bf16).float(),
                                vc.reshape(kv, ns, kv_split, hd))
            m_s = m_s[..., 0]                                     # [kv,g,n,ns]
            m_f = torch.maximum(m_f, m_s.amax(dim=-1))
            e_s = torch.exp2(m_s - m_f[..., None])
            l_f = (p.sum(dim=-1) * e_s).sum(dim=-1)
            acc = (pv_s * e_s[..., None]).sum(dim=-2)
        p_cur = torch.exp2(s_cur - m_f[..., None]) * causal
        l_f = l_f + p_cur.sum(dim=-1)
        acc = acc + torch.einsum("kgtj,jkd->kgtd", p_cur.to(bf16).float(),
                                 v_new.to(bf16).float())
        o = (acc / l_f[..., None]).to(bf16)                       # [kv,g,n,hd]
        # the stored copies, from float32 (8-bit: per (kv head, token))
        cache_write_layer(k_cache, l, k_new.transpose(0, 1), pos)
        cache_write_layer(v_cache, l, v_new.transpose(0, 1), pos)
        o_flat = o.permute(2, 0, 1, 3).reshape(n, kv * g * hd)
        if w4:      # the head groups' products, summed in order
            og = o_flat.reshape(n, G, -1)
            aout = torch.zeros((n, hidden), dtype=torch.float32,
                               device=x.device)
            for i in range(G):
                aout = aout + _int4_dot(og[:, i], wo_f.q[l, i], wo_f.s[l, i],
                                        gs, a8)
        elif w8:    # each group's partial scaled, then the groups summed
            aout = (torch.einsum("nGc,Gco->nGo",
                                 o_flat.float().reshape(n, G, -1),
                                 wo_f.q[l].float())
                    * wo_f.s[l][:, 0]).sum(dim=1)
        else:
            aout = o_flat.float() @ wo_f[l].reshape(-1, hidden).float()
        res = aout + res
        xn2 = _norm(res, ffn_norm[l], eps)
        if w4:      # gate and up over the rows; down per f-block, summed
            y = [_int4_dot(xn2, w13.q[l, i], w13.s[l, i], gs, a8)
                 for i in range(2)]
            act = glu_act(y[0], y[1]).to(bf16)
            hx = torch.zeros((n, hidden), dtype=torch.float32,
                             device=x.device)
            for j in range(0, act.shape[1], bf):
                hx = hx + _int4_dot(act[:, j:j + bf],
                                    w2.q[l, j // 2:(j + bf) // 2],
                                    w2.s[l, j // gs:(j + bf) // gs], gs, a8)
        elif w8:    # gate and up per column before SwiGLU; down after its sum
            y = torch.einsum("nd,udf->unf", xn2.float(),
                             w13.q[l].float()) * w13.s[l]
            act = glu_act(y[0], y[1]).to(bf16)
            hx = (act.float() @ w2.q[l].float()) * w2.s[l][0]
        else:
            y = torch.einsum("nd,udf->unf", xn2.float(), w13[l].float())
            act = glu_act(y[0], y[1]).to(bf16)
            hx = act.float() @ w2[l].float()
    if lm_head is not None:
        xn = _norm(hx + res, final_norm, eps)
        if isinstance(lm_head, QuantizedTensor):
            logits = (xn.float() @ lm_head.q.float()) * lm_head.s[0]
        else:
            logits = xn.float() @ lm_head.float()
        return logits, res.to(bf16), k_cache, v_cache
    return hx.to(bf16), res.to(bf16), k_cache, v_cache


def fused_verify_stack(
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
    window: int = 0,
    bias_qkv=None,
    ffn_act: str = "silu",
    softcap: float = 0.0,
    window_pattern: str = "all",
    post_attn_norm=None,
    post_ffn_norm=None,
):
    """Score n tokens through the whole decoder stack in one call.

    Same operands as ``fused_decoder_stack`` except x [n, hidden] and
    cos/sin [n, hd] (rows for positions pos..pos+n-1); needs
    ``0 <= pos`` and ``pos + n <= capacity``.  Returns (x_out [n, hidden],
    residual_out [n, hidden], k_cache, v_cache), or (logits [n, vocab] f32,
    residual_out, k_cache, v_cache) when ``final_norm`` and ``lm_head`` are
    given.  All n K/V rows are written at pos..pos+n-1 of every layer, in
    place.  ``window`` > 0 (with ``window_pattern="all"``): the sliding
    window (the module's note).
    """
    global launches, int8_launches, int4_launches, last_step_kernels
    window = int(window)
    kv_kind = kv_kind_of(k_cache, v_cache, "fused_verify_stack")
    if reduce_axis is not None:
        raise NotImplementedError("fused_verify_stack: reduce_axis (the tp "
                                  "mode of the decode stack) has no verify "
                                  "counterpart")
    if head_dim % 128:
        raise NotImplementedError(
            f"fused_verify_stack: head_dim {head_dim}: the JAX package's "
            "verify kernel keeps hd >= 128, and its spec_verify scores the "
            "drafts eagerly below that (clusterfusion_tpu/models/"
            "speculative.py:74-82), as models.speculative does here; no hd-64 "
            "form exists to port")
    refuse_unported("fused_verify_stack", head_dim,
                    (wqkv_f, wo_f, w13, w2, attn_norm, ffn_norm), final_norm,
                    lm_head, k_cache, v_cache, window=window,
                    bias_qkv=bias_qkv, ffn_act=ffn_act, softcap=softcap,
                    post_attn_norm=post_attn_norm,
                    post_ffn_norm=post_ffn_norm,
                    window_pattern=window_pattern)
    check_stack_kcfg(kcfg)
    pos = int(pos)
    n, hidden = x.shape
    L, G, _, C = wqkv_f.shape
    _, kv_heads, cap, hd = k_cache.shape
    kq, vq, ksp, vsp, srow = _kv_operands(k_cache, v_cache, kv_kind, cap)
    hg = kv_heads // G
    f_pad = w2.shape[-2]
    if hd != head_dim or C != hg * (group + 2) * hd:
        raise ValueError(f"wqkv_f columns {C} != hg*(group+2)*hd "
                         f"= {hg}*{group + 2}*{hd}")
    if pos < 0 or pos + n > cap:
        raise ValueError(f"rows {pos}..{pos + n - 1} outside the cache "
                         f"capacity {cap}")
    if tuple(cos.shape) != (n, hd) or tuple(sin.shape) != (n, hd):
        raise ValueError(f"cos/sin must be [{n}, {hd}], got "
                         f"{tuple(cos.shape)} and {tuple(sin.shape)}")
    vocab = 0
    if lm_head is not None:
        vocab = lm_head.shape[-1]
        if _vocab_block(vocab) == 0:
            raise ValueError(f"vocab {vocab} has no 128-aligned block")
    if x.device.type == "cpu":
        return fused_verify_stack_plain(
            x, attn_norm, ffn_norm, cos, sin, wqkv_f, wo_f, w13, w2, k_cache,
            v_cache, pos, group=group, head_dim=head_dim,
            rope_style=rope_style, eps=eps, final_norm=final_norm,
            lm_head=lm_head, kv_split=kcfg.kv_split,
            int4_w4a8=kcfg.int4_w4a8, window=window)

    if rope_style not in ("neox", "gptj"):
        raise ValueError(f"unknown rope style {rope_style!r}")
    if not 1 <= n <= MAX_ROWS:
        raise NotImplementedError(f"fused_verify_stack: {n} rows; the kernel "
                                  f"takes 1..{MAX_ROWS}")
    if x.dtype != torch.bfloat16:
        raise ValueError("x must be bf16 [n, hidden]")
    dev = x.device
    wq_kind = wq_kind_of(wqkv_f, kcfg)
    w8 = isinstance(wqkv_f, QuantizedTensor) and wqkv_f.kind == "int8"
    w4 = isinstance(wqkv_f, QuantizedTensor) and wqkv_f.kind == "int4"
    weights, scales = quant_operands(
        dict(wqkv_f=wqkv_f, wo_f=wo_f, w13=w13, w2=w2, lm_head=lm_head),
        (C, hidden, f_pad) if w8 or w4 else (), vocab)
    check_launch(kcfg, dict(x=x, attn_norm=attn_norm, ffn_norm=ffn_norm,
                            k_cache=kq, v_cache=vq, k_scales=ksp,
                            v_scales=vsp, final_norm=final_norm, **weights,
                            **scales),
                 (C, hidden, f_pad, vocab))
    cos_f = cos.to(device=dev, dtype=torch.float32).contiguous()
    sin_f = sin.to(device=dev, dtype=torch.float32).contiguous()

    lib = _build.lib()
    n_scratch = lib.cf_verify_scratch_floats(n, hidden, kv_heads, group, hd,
                                             cap, f_pad, kcfg.kv_split)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    res_out = torch.empty((n, hidden), dtype=torch.bfloat16, device=dev)
    if lm_head is not None:
        logits = torch.empty((n, vocab), dtype=torch.float32, device=dev)
        x_out = None
    else:
        logits = None
        x_out = torch.empty((n, hidden), dtype=torch.bfloat16, device=dev)
    n_launch = ctypes.c_int(0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.cf_verify_stack(
        ptr(x), ptr(attn_norm), ptr(ffn_norm), ptr(cos_f), ptr(sin_f),
        ptr(weights["wqkv_f"]), ptr(weights["wo_f"]), ptr(weights["w13"]),
        ptr(weights["w2"]), ptr(kq), ptr(vq), ptr(final_norm),
        ptr(weights["lm_head"]), ptr(x_out), ptr(res_out), ptr(logits),
        ptr(scratch),
        n, L, hidden, kv_heads, hg, group, hd, cap, f_pad, vocab, pos,
        1 if rope_style == "neox" else 0, float(eps), kcfg.kv_split,
        kcfg.gemv_threads, ctypes.byref(n_launch),
        torch.cuda.current_stream(dev).cuda_stream,
        *(ptr(scales.get(k)) for k in ("wqkv_f_s", "wo_f_s", "w13_s", "w2_s",
                                       "lm_head_s")),
        wq_kind, ffn_block_size(f_pad), kv_kind, ptr(ksp), ptr(vsp), srow,
        window)
    _build.check(err, "fused_verify_stack")
    launches += 1
    int8_launches += int(w8)
    int4_launches += int(w4)
    if kv_kind != KV_BF16:
        kv8_launches[kv_kind] += 1
    last_step_kernels = n_launch.value
    if lm_head is not None:
        return logits, res_out, k_cache, v_cache
    return x_out, res_out, k_cache, v_cache
