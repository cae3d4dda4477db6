"""Plain float32 oracles (twin of ``clusterfusion_tpu/ops/reference.py:25-45``):
computed in float32 and cast back to the input dtype."""

from __future__ import annotations

from typing import Tuple

import torch


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
