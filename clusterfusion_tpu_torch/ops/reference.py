"""Plain float32 oracles (twin of ``clusterfusion_tpu/ops/reference.py``):
computed in float32 and cast back to the input dtype.  The norms, the
layer oracles of the public fused-layer ops (kernel 6's two variants and
kernel 9's sglang entry, in the reference's tensor layouts) and the MLA
layer's; the CPU ground truth the ops are held against."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from clusterfusion_tpu_torch.ops.rope import apply_rope_gptj, apply_rope_neox


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """y = x / sqrt(mean(x^2) + eps) * w."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def fused_add_rmsnorm_ref(x: torch.Tensor, residual: torch.Tensor,
                          weight: torch.Tensor, eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h = x + residual; returns (rmsnorm(h), h)."""
    h = x.float() + residual.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    y = h * torch.rsqrt(var + eps) * weight.float()
    return y.to(x.dtype), h.to(x.dtype)


def _attend_single(q, K, V, head_dim: int, window: int = 0):
    """q [heads, d]; K/V [seq, heads, d] (float32) -> [heads, d].  ``window``
    > 0: sliding-window attention (the query at position seq-1 attends to
    positions >= seq - window)."""
    scores = torch.einsum("hd,shd->hs", q, K) / math.sqrt(head_dim)
    if window:
        seq = K.shape[0]
        pos = torch.arange(seq, device=K.device)
        scores = torch.where(pos[None, :] >= seq - window, scores,
                             torch.tensor(-math.inf, device=K.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("hs,shd->hd", probs, V)


def _cached(cache, new, n_heads: int, head_dim: int):
    """[seq, hidden] cache rows and the new [heads, d] row, float32
    [seq + 1, heads, d]."""
    seq = cache.shape[0]
    return torch.cat([cache.float().reshape(seq, n_heads, head_dim),
                      new[None]], dim=0)


def llama_decoder_layer_sglang_ref(input, residual, weight_qkv, weight_o,
                                   k_cache, v_cache, rms_w, eps: float, cos,
                                   sin, *, n_heads: int, head_dim: int,
                                   window: int = 0):
    """Oracle of the sglang-variant fused layer (``reference.py:62-114`` of
    the JAX package): residual add + RMSNorm + QKV + NEOX rope + decode
    attention over every cached row and the token + O-projection, weights
    in torch.nn.Linear layout ([3*hidden, hidden], [hidden, hidden]),
    caches [seq, hidden], cos/sin [head_dim/2].  Returns (output,
    residual_out, k_new, v_new), each [1, hidden]."""
    hidden = input.shape[-1]
    h = input.float() + residual.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    x = h * torch.rsqrt(var + eps) * rms_w.float()
    q, k, v = (x @ weight_qkv.float().T)[0].chunk(3)
    q, k, v = (t.reshape(n_heads, head_dim) for t in (q, k, v))
    cos, sin = cos.float(), sin.float()
    q, k = apply_rope_neox(q, cos, sin), apply_rope_neox(k, cos, sin)
    o = _attend_single(q, _cached(k_cache, k, n_heads, head_dim),
                       _cached(v_cache, v, n_heads, head_dim), head_dim,
                       window=window)
    output = o.reshape(1, hidden) @ weight_o.float().T
    dt = input.dtype
    return (output.to(dt), h.to(dt), k.reshape(1, hidden).to(dt),
            v.reshape(1, hidden).to(dt))


def llama_decoder_layer_ref(input, weight_qkv, weight_o, k_cache, v_cache,
                            rms_w, cos, sin, *, n_heads: int, head_dim: int,
                            eps: float = 1e-6):
    """Oracle of the GPT-J-rope fused layer (``reference.py:117-169`` of the
    JAX package): no residual add, GPT-J interleaved rope with full-dim
    repeat-interleaved cos/sin [1, head_dim], weights in the transposed
    ([in, out]) layout (weight_qkv [3*hidden, hidden] of stacked W.T
    blocks, weight_o = wo.T).  Returns (output, k_new, v_new), each [1,
    hidden]."""
    hidden = input.shape[-1]
    xf = input.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    x = xf * torch.rsqrt(var + eps) * rms_w.float()
    w = weight_qkv.float().reshape(3, hidden, hidden)
    q, k, v = ((x @ w[i])[0].reshape(n_heads, head_dim) for i in range(3))
    cos = cos.reshape(1, head_dim).float()
    sin = sin.reshape(1, head_dim).float()
    q, k = apply_rope_gptj(q, cos, sin), apply_rope_gptj(k, cos, sin)
    o = _attend_single(q, _cached(k_cache, k, n_heads, head_dim),
                       _cached(v_cache, v, n_heads, head_dim), head_dim)
    output = o.reshape(1, hidden) @ weight_o.float()
    dt = input.dtype
    return (output.to(dt), k.reshape(1, hidden).to(dt),
            v.reshape(1, hidden).to(dt))


def llama_decoder_layer_batch_paged_ref(input, residual, weight_qkv,
                                        weight_o, paged_kv_indptr,
                                        paged_kv_indices, k_cache, v_cache,
                                        rms_w, eps: float, positions,
                                        cos_sin, *, n_heads: int,
                                        head_dim: int):
    """Oracle of the batched paged-KV decode layer (``reference.py:172-237``
    of the JAX package): page size one token row; request b's cached rows
    are pool rows ``indices[indptr[b]:indptr[b+1]-1]`` and its new k/v go
    to pool row ``indices[indptr[b+1]-1]``; NEOX rope from the fused
    per-position cos | sin table [max_pos, head_dim] at ``positions[b]``;
    weights in torch.nn.Linear layout.  Returns (output [batch, hidden],
    residual_out, k_cache', v_cache'), the caches updated copies."""
    batch, hidden = input.shape
    h = input.float() + residual.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    x = h * torch.rsqrt(var + eps) * rms_w.float()
    q, k, v = (x @ weight_qkv.float().T).chunk(3, dim=-1)
    q, k, v = (t.reshape(batch, n_heads, head_dim) for t in (q, k, v))
    cs = cos_sin.float()[positions.long()]                 # [batch, head_dim]
    cos, sin = cs[:, None, :head_dim // 2], cs[:, None, head_dim // 2:]
    q, k = apply_rope_neox(q, cos, sin), apply_rope_neox(k, cos, sin)
    indptr, indices = paged_kv_indptr.long(), paged_kv_indices.long()
    new_slots = indices[indptr[1:] - 1]
    kc, vc = k_cache.float().clone(), v_cache.float().clone()
    kc[new_slots] = k.reshape(batch, hidden)
    vc[new_slots] = v.reshape(batch, hidden)
    max_pages = indices.shape[0]
    j = torch.arange(max_pages, device=input.device)[None, :]
    starts = indptr[:-1, None]
    valid = j < (indptr[1:] - indptr[:-1])[:, None]
    rows = indices[torch.clamp(starts + j, 0, max_pages - 1)]
    Kb = kc[rows].reshape(batch, max_pages, n_heads, head_dim)
    Vb = vc[rows].reshape(batch, max_pages, n_heads, head_dim)
    scores = torch.einsum("bhd,bshd->bhs", q, Kb) / math.sqrt(head_dim)
    scores = torch.where(valid[:, None, :], scores,
                         torch.tensor(-1e30, device=input.device))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", probs, Vb)
    output = o.reshape(batch, hidden) @ weight_o.float().T
    dt = input.dtype
    return (output.to(dt), h.to(dt), kc.to(k_cache.dtype),
            vc.to(v_cache.dtype))


def deepseek_decoder_layer_ref(
    input, weight_q_nope, weight_q_pe, weight_uk, weight_kv_nope,
    weight_k_pe, weight_uv, weight_o, ckv_cache, rms_input_weight,
    rms_ckv_weight, cos, sin, *, n_heads: int, nope_dim: int, rope_dim: int,
    lora_rank: int, eps: float = 1e-6):
    """Oracle of the DeepSeek MLA layer (``reference.py:240-310`` of the JAX
    package): matrix-absorbed MLA decode over every row of ``ckv_cache``
    [seq, lora + rope] plus the current token, whose compressed row
    (RMSNorm'd ckv | roped k_pe) is returned.  Projections in torch.nn.Linear
    layout ([out, in]); cos/sin [rope/2].  Returns (output [1, hidden],
    ckv_new [1, lora + rope])."""
    f32 = torch.float32
    xf = input.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    x = xf * torch.rsqrt(var + eps) * rms_input_weight.float()
    q_nope = (x @ weight_q_nope.float().T).reshape(n_heads, nope_dim)
    q_pe = (x @ weight_q_pe.float().T).reshape(n_heads, rope_dim)
    ckv = (x @ weight_kv_nope.float().T)[0]
    k_pe = (x @ weight_k_pe.float().T)[0]
    cos, sin = cos.to(f32), sin.to(f32)
    q_pe = apply_rope_neox(q_pe, cos, sin)
    k_pe = apply_rope_neox(k_pe, cos, sin)
    cvar = torch.mean(ckv * ckv)
    ckv = ckv * torch.rsqrt(cvar + eps) * rms_ckv_weight.float()
    q_lora = torch.einsum("hd,hdr->hr", q_nope, weight_uk.float())
    ckv_new = torch.cat([ckv, k_pe])
    full = torch.cat([ckv_cache[:, :lora_rank + rope_dim].float(),
                      ckv_new[None]], dim=0)
    kn, kp = full[:, :lora_rank], full[:, lora_rank:]
    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    scores = (q_lora @ kn.T + q_pe @ kp.T) * scale
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("hr,hrd->hd", probs @ kn, weight_uv.float())
    output = o.reshape(1, n_heads * nope_dim) @ weight_o.float().T
    dt = input.dtype
    return output.to(dt), ckv_new[None].to(dt)
