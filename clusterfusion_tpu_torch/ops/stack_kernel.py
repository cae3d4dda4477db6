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

The caches are updated in place: the returned caches are the tensors that
were passed in.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.ops import _build
from clusterfusion_tpu_torch.ops._support import glu_act
from clusterfusion_tpu_torch.ops.rope import apply_rope_gptj, apply_rope_neox

_LOG2E = 1.4426950408889634
_NEG_INF = -1e30

#: Calls of :func:`fused_decoder_stack` that launched the kernels.
launches = 0
#: CUDA kernels the last such call launched (8 per layer + 1 or 2).
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
    """Rope on [..., hd] with full-dim [hd] tables."""
    if style == "neox":
        hd = x.shape[-1]
        return apply_rope_neox(x, cos[: hd // 2], sin[: hd // 2])
    if style == "gptj":
        return apply_rope_gptj(x, cos, sin)
    raise ValueError(f"unknown rope style {style!r}")


def _norm(h: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 RMSNorm of a float32 row, rounded to bf16."""
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps) * w.float()).to(torch.bfloat16)


def fused_decoder_stack_plain(x, attn_norm, ffn_norm, cos, sin, wqkv_f, wo_f,
                              w13, w2, k_cache, v_cache, pos, *, group: int,
                              head_dim: int, rope_style: str, eps: float,
                              final_norm=None, lm_head=None,
                              kv_split: int = KernelConfig().kv_split):
    """Plain PyTorch version of :func:`fused_decoder_stack` (same arguments,
    same results, caches appended in place).  ``kv_split`` is the kernel's
    split of the cached rows: bf16(p) is taken against each split's own
    max, as the kernel takes it, so the two round p alike."""
    pos = int(pos)
    L, G, hidden, _ = wqkv_f.shape
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
        qkv = torch.einsum("d,Gdc->Gc", xn.float(), wqkv_f[l].float())
        qkv = qkv.reshape(kv_heads, g + 2, hd)
        q = _rope(qkv[:, :g], cos_f, sin_f, rope_style) * scale   # [kv, g, hd]
        k_cur = _rope(qkv[:, g], cos_f, sin_f, rope_style)         # [kv, hd]
        v_cur = qkv[:, g + 1]
        # split-KV flash-decode over rows < pos: per split of kv_split rows
        # a max m_s, a sum l_s of exp2(s - m_s), and bf16(p) @ V
        ns = -(-pos // kv_split)
        pad = ns * kv_split - pos
        kc = F.pad(k_cache[l, :, :pos].float(), (0, 0, 0, pad))
        vc = F.pad(v_cache[l, :, :pos].float(), (0, 0, 0, pad))
        s = torch.einsum("kgd,ksd->kgs", q.to(bf16).float(), kc)
        s = F.pad(s[..., :pos], (0, pad), value=_NEG_INF)
        s = s.reshape(kv_heads, g, ns, kv_split)
        m_s = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m_s)
        l_s = p.sum(dim=-1)                                        # [kv, g, ns]
        pv_s = torch.einsum("kgns,knsd->kgnd", p.to(bf16).float(),
                            vc.reshape(kv_heads, ns, kv_split, hd))
        m_s = m_s[..., 0]
        # merge the splits and fold in the current token
        s_cur = (q * k_cur[:, None]).sum(dim=-1)                   # [kv, g]
        m_f = torch.maximum(s_cur, m_s.amax(dim=-1)) if ns else s_cur
        e_s = torch.exp2(m_s - m_f[..., None])
        p_cur = torch.exp2(s_cur - m_f)
        l_f = p_cur + (l_s * e_s).sum(dim=-1)
        acc = p_cur[..., None] * v_cur[:, None] + \
            (pv_s * e_s[..., None]).sum(dim=2)
        o = (acc / l_f[..., None]).to(bf16)
        k_cache[l, :, pos] = k_cur.to(k_cache.dtype)
        v_cache[l, :, pos] = v_cur.to(v_cache.dtype)
        aout = torch.einsum("Gc,Gco->o", o.reshape(G, -1).float(),
                            wo_f[l].float())
        res = aout + res
        xn2 = _norm(res, ffn_norm[l], eps)
        y = torch.einsum("d,udf->uf", xn2.float(), w13[l].float())
        act = glu_act(y[0], y[1]).to(bf16)
        hx = act.float() @ w2[l].float()
    if lm_head is not None:
        xn = _norm(hx + res, final_norm, eps)
        logits = (xn.float() @ lm_head.float())[None]
        return logits, res.to(bf16)[None], k_cache, v_cache
    return hx.to(bf16)[None], res.to(bf16)[None], k_cache, v_cache


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
    """
    global launches, last_step_kernels
    if reduce_axis is not None:
        raise NotImplementedError("fused_decoder_stack: reduce_axis (tp) is "
                                  "not ported yet")
    if window or softcap or bias_qkv is not None or ffn_act != "silu":
        raise NotImplementedError("fused_decoder_stack: window, softcap, QKV "
                                  "bias and GeGLU are not ported yet")
    if post_attn_norm is not None or post_ffn_norm is not None:
        raise NotImplementedError("fused_decoder_stack: sandwich norms are "
                                  "not ported yet")
    if head_dim % 128:
        raise NotImplementedError(
            f"fused_decoder_stack: head_dim {head_dim} < 128 (the TPU "
            "kernel's defer_append variant) is not ported yet")
    weights = (wqkv_f, wo_f, w13, w2, attn_norm, ffn_norm)
    if any(w.dtype != torch.bfloat16 for w in weights) or \
            (lm_head is not None and lm_head.dtype != torch.bfloat16):
        raise NotImplementedError("fused_decoder_stack: only bf16 weights "
                                  "are ported (quantized weights are not)")
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise NotImplementedError("fused_decoder_stack: only a bf16 KV cache "
                                  "is ported (int8/fp8 KV are not)")
    if (final_norm is None) != (lm_head is None):
        raise ValueError("final_norm and lm_head go together")
    pos = int(pos)
    L, G, hidden, C = wqkv_f.shape
    _, kv_heads, cap, hd = k_cache.shape
    hg = kv_heads // G
    f_pad = w2.shape[-2]
    if hd != head_dim or C != hg * (group + 2) * hd:
        raise ValueError(f"wqkv_f columns {C} != hg*(group+2)*hd "
                         f"= {hg}*{group + 2}*{hd}")
    if not 0 <= pos < cap:
        raise ValueError(f"pos {pos} outside the cache capacity {cap}")
    vocab = 0
    if lm_head is not None:
        vocab = lm_head.shape[-1]
        if _vocab_block(vocab) == 0:
            raise ValueError(f"vocab {vocab} has no 128-aligned block")
    if x.device.type == "cpu":
        return fused_decoder_stack_plain(
            x, attn_norm, ffn_norm, cos, sin, wqkv_f, wo_f, w13, w2, k_cache,
            v_cache, pos, group=group, head_dim=head_dim,
            rope_style=rope_style, eps=eps, final_norm=final_norm,
            lm_head=lm_head, kv_split=kcfg.kv_split)

    if rope_style not in ("neox", "gptj"):
        raise ValueError(f"unknown rope style {rope_style!r}")
    if group > 8:
        raise NotImplementedError(f"GQA group {group} > 8")
    if not 1 <= kcfg.kv_split <= 1024 or kcfg.gemv_threads % 32:
        raise ValueError(f"bad KernelConfig {kcfg}")
    dev = x.device
    tensors = dict(x=x, attn_norm=attn_norm, ffn_norm=ffn_norm, wqkv_f=wqkv_f,
                   wo_f=wo_f, w13=w13, w2=w2, k_cache=k_cache,
                   v_cache=v_cache)
    if lm_head is not None:
        tensors.update(final_norm=final_norm, lm_head=lm_head)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.dtype != torch.bfloat16 or x.numel() != hidden:
        raise ValueError("x must be bf16 [1, hidden]")
    for n in (C, hidden, f_pad, vocab):
        if n % 8:
            raise ValueError(f"GEMV width {n} is not a multiple of 8")
    cos_f = cos.to(device=dev, dtype=torch.float32).reshape(hd).contiguous()
    sin_f = sin.to(device=dev, dtype=torch.float32).reshape(hd).contiguous()

    lib = _build.lib()
    n_scratch = lib.cf_stack_scratch_floats(hidden, kv_heads, group, hd, cap,
                                            f_pad, kcfg.kv_split)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    res_out = torch.empty((1, hidden), dtype=torch.bfloat16, device=dev)
    if lm_head is not None:
        logits = torch.empty((1, vocab), dtype=torch.float32, device=dev)
        x_out = None
    else:
        logits = None
        x_out = torch.empty((1, hidden), dtype=torch.bfloat16, device=dev)
    n_launch = ctypes.c_int(0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.cf_decoder_stack(
        ptr(x), ptr(attn_norm), ptr(ffn_norm), ptr(cos_f), ptr(sin_f),
        ptr(wqkv_f), ptr(wo_f), ptr(w13), ptr(w2), ptr(k_cache),
        ptr(v_cache), ptr(final_norm), ptr(lm_head), ptr(x_out),
        ptr(res_out), ptr(logits), ptr(scratch),
        L, hidden, kv_heads, hg, group, hd, cap, f_pad, vocab, pos,
        1 if rope_style == "neox" else 0, float(eps), kcfg.kv_split,
        kcfg.gemv_threads, ctypes.byref(n_launch),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_decoder_stack")
    launches += 1
    last_step_kernels = n_launch.value
    if lm_head is not None:
        return logits, res_out, k_cache, v_cache
    return x_out, res_out, k_cache, v_cache
