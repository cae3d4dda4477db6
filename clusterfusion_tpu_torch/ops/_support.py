"""Shared helpers for the op layer (twin of ``clusterfusion_tpu/ops/_support.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def glu_act(y_gate: torch.Tensor, y_up: torch.Tensor,
            act: str = "silu") -> torch.Tensor:
    """Gated-linear-unit activation ``act(gate) * up`` in the inputs' dtype
    (f32 on every caller).  "silu" = SwiGLU; "gelu_tanh" = GeGLU."""
    if act == "silu":
        g = F.silu(y_gate)
    elif act == "gelu_tanh":
        g = F.gelu(y_gate, approximate="tanh")
    else:
        raise ValueError(f"unknown ffn activation {act!r}")
    return g * y_up


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent,
    so a missing card is never silently replaced by the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "clusterfusion_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "path on the CPU")
    return dev
