"""Causal GQA flash-attention prefill (twin of ``clusterfusion_tpu/ops/flash_prefill.py``).

``flash_prefill_attention`` launches the hand-written CUDA kernel
``csrc/flash_prefill.cu`` (wgmma tensor cores fed by TMA) for CUDA tensors
and runs ``flash_prefill_attention_plain`` for CPU tensors.  Both take the
TPU kernel's layouts: q ``[kv_heads, T, group, hd]`` and k/v
``[kv_heads, S, hd]`` in bf16, and return ``[kv_heads, T, group, hd]``.
K and V may be strided views (a layer of a KV cache, ``k_cache[l, :,
:pos0 + T]``): each row's ``hd`` elements are contiguous, rows are ``hd``
apart, and the head stride is free; the kernel reads them where they lie.
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
    ``S >= q_offset + T`` (keys past ``q_offset + T - 1`` are never read),
    rows of ``hd`` contiguous elements ``hd`` apart, any head stride.
    Returns [kv_heads, T, group, hd] in q's dtype.  CUDA tensors run the
    kernel; CPU tensors run :func:`flash_prefill_attention_plain`.  Raises
    on other K/V layouts and on ``kcfg.prefill_block_rows`` outside
    {64, 128}, on either device."""
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
    for name, t in (("k", k), ("v", v)):
        if t.stride(2) != 1 or t.stride(1) != hd:
            raise ValueError(f"{name} rows must be {hd} contiguous elements, "
                             f"{hd} apart; got strides {t.stride()}")
    if kcfg.prefill_block_rows not in (64, 128):
        raise ValueError("prefill_block_rows must be 64 or 128")
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, q_offset=q_offset)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_prefill_attention: q, k, v must share one "
                         "CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        # TMA: a 16-byte aligned base and 16-byte multiples as strides
        if t.data_ptr() % 16 or t.stride(0) % 8:
            raise ValueError(f"{name} needs a 16-byte aligned base and a "
                             f"head stride that is a multiple of 8 elements")
    if hd not in (64, 128):
        raise NotImplementedError(f"head_dim {hd} (kernel takes 64 or 128)")
    out = torch.empty_like(q)
    lib = _build.lib()
    err = lib.cf_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kv_heads, T,
        group, S, hd, q_offset, kcfg.prefill_block_rows, k.stride(0),
        v.stride(0), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill_attention")
    launches += 1
    return out
