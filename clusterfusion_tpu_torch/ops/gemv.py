"""bs=1 GEMV (twin of ``clusterfusion_tpu/ops/gemv.py``).

``gemv`` computes x [1, K] bf16 @ w [K, N] bf16 -> [1, N] float32.  CUDA
tensors launch the hand-written kernel of ``csrc/gemv.cu`` (the bs=1
stack's ring GEMV at one row, ``csrc/common.cuh``: weights bulk-copied through shared
memory, the K chunks of a column tile summed in a fixed order inside a
thread-block cluster, so every call gives the same bits); CPU tensors run
``gemv_plain``, the float32 product (bf16 products are exact in float32,
so the two differ only by the order of the sums).
"""

from __future__ import annotations

import torch

from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.ops import _build

#: Calls of :func:`gemv` that launched the kernel (CUDA tensors only).
launches = 0


def gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemv`."""
    return x.float() @ w.float()


def gemv(x: torch.Tensor, w: torch.Tensor,
         kcfg: KernelConfig = KernelConfig()) -> torch.Tensor:
    """x [1, K] @ w [K, N] -> [1, N] float32; N must be a multiple of 128
    (pad the weight: zero columns give zero outputs).  The TPU kernel's
    ``block_n`` has no counterpart: the kernel picks its own grid."""
    global launches
    if x.dim() != 2 or x.shape[0] != 1 or w.dim() != 2 or \
            x.shape[1] != w.shape[0]:
        raise ValueError(f"gemv: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "must be [1, K] and [K, N]")
    K, N = w.shape
    if N % 128:
        raise ValueError(f"gemv: N {N} is not a multiple of 128")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(f"gemv: only bf16 is ported (x {x.dtype}, "
                                  f"w {w.dtype})")
    if x.device.type == "cpu":
        return gemv_plain(x, w)
    if kcfg.gemv_threads % 32 or not 32 <= kcfg.gemv_threads <= 992:
        raise ValueError(f"gemv: gemv_threads {kcfg.gemv_threads} is not a "
                         "multiple of 32 in [32, 992]")
    dev = x.device
    for name, t in (("x", x), ("w", w)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"gemv: {name} must be a contiguous, 16-byte "
                             f"aligned tensor on {dev}")
    y = torch.empty((1, N), dtype=torch.float32, device=dev)
    err = _build.lib().cf_gemv(x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, K,
                               N, kcfg.gemv_threads,
                               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gemv")
    launches += 1
    return y
