"""Plain float32 oracles (twin of ``clusterfusion_tpu/ops/reference.py``):
computed in float32 and cast back to the input dtype."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from clusterfusion_tpu_torch.ops.rope import apply_rope_neox


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
