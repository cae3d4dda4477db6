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


_SCRATCH: dict = {}
_SCRATCH_MAX = 64


def stream_scratch(key, floats, device: torch.device,
                   stream: int) -> torch.Tensor:
    """A float32 buffer kept per (device, stream, ``key``) and zeroed once,
    when it is made: the fold rows and ticket counters of a one-launch
    kernel (``csrc/decoder_layer.cu``, ``csrc/fused_ffn.cu``), which leaves
    its counters at 0.  ``floats`` is its size or a function giving it
    (called only then).  Calls on one stream take turns with a buffer;
    calls on other streams get their own."""
    k = (device.index, stream, key)
    buf = _SCRATCH.get(k)
    if buf is None:
        n = floats() if callable(floats) else floats
        if n < 0:
            raise RuntimeError(f"no launch geometry for {key}")
        if len(_SCRATCH) >= _SCRATCH_MAX:
            _SCRATCH.pop(next(iter(_SCRATCH)))
        buf = _SCRATCH[k] = torch.zeros(n, dtype=torch.float32,
                                        device=device)
    return buf
