"""Causal GQA flash-attention prefill (twin of ``clusterfusion_tpu/ops/flash_prefill.py``).

``flash_prefill_attention`` launches the hand-written CUDA kernel
``csrc/flash_prefill.cu`` for CUDA tensors and runs
``flash_prefill_attention_plain`` for CPU tensors.  Both take the TPU
kernel's layouts: q ``[kv_heads, T, group, hd]`` and k/v
``[kv_heads, S, hd]`` in bf16, and return ``[kv_heads, T, group, hd]``.
"""

from __future__ import annotations

import math

import torch

from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.ops import _build

#: Kernel launches made by :func:`flash_prefill_attention` (CUDA tensors only).
launches = 0


def flash_prefill_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *,
                                  q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version in float32 math: query i (position
    ``q_offset + i``) attends keys ``0 .. q_offset + i``."""
    kv_heads, T, group, hd = q.shape
    S = q_offset + T
    kf = k[:, :S].float()
    vf = v[:, :S].float()
    scores = torch.einsum("ktgd,ksd->ktgs", q.float(), kf) / math.sqrt(hd)
    qpos = q_offset + torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (kpos <= qpos)[None, :, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("ktgs,ksd->ktgd", probs, vf).to(q.dtype)


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, q_offset: int = 0, window: int = 0,
                            softcap: float = 0.0,
                            kcfg: KernelConfig = KernelConfig()
                            ) -> torch.Tensor:
    """Causal (chunk-offset) GQA attention over the K/V context.

    q [kv_heads, T, group, hd]; k/v [kv_heads, S, hd] with
    ``S >= q_offset + T`` (keys past ``q_offset + T - 1`` are never read).
    Returns [kv_heads, T, group, hd] in q's dtype.  CUDA tensors run the
    kernel; CPU tensors run :func:`flash_prefill_attention_plain`."""
    global launches
    if window or softcap:
        raise NotImplementedError(
            "flash_prefill_attention: window and softcap are not ported yet")
    kv_heads, T, group, hd = q.shape
    S = k.shape[1]
    if k.shape != (kv_heads, S, hd) or v.shape != (kv_heads, S, hd):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if S < q_offset + T:
        raise ValueError(f"S={S} < q_offset + T = {q_offset + T}")
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, q_offset=q_offset)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_prefill_attention: q, k, v must share one "
                         "CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hd not in (64, 128):
        raise NotImplementedError(f"head_dim {hd} (kernel takes 64 or 128)")
    if kcfg.prefill_block_rows not in (32, 64):
        raise ValueError("prefill_block_rows must be 32 or 64")
    out = torch.empty_like(q)
    lib = _build.lib()
    err = lib.cf_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kv_heads, T,
        group, S, hd, q_offset, kcfg.prefill_block_rows,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill_attention")
    launches += 1
    return out
