"""Rotary position embedding helpers (twin of ``clusterfusion_tpu/ops/rope.py``).

- NEOX rotate-half: pairs (i, i+d/2), tables of d/2 entries per position.
- GPT-J interleaved: pairs (2i, 2i+1), tables repeat-interleaved to d
  entries per position.

Tables are float32 and built on the host with numpy, exactly as the JAX
package builds them, then moved to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch


def llama3_scaled_inv_freq(inv_freq: np.ndarray, factor: float,
                           low_freq_factor: float, high_freq_factor: float,
                           orig_max_pos: int) -> np.ndarray:
    """Llama-3.1 frequency rescale (HF ``rope_type: "llama3"``): short
    wavelengths keep their frequency, long ones divide by ``factor``, and
    the band between interpolates smoothly."""
    low_wl = orig_max_pos / low_freq_factor
    high_wl = orig_max_pos / high_freq_factor
    wavelen = 2.0 * np.pi / inv_freq
    smooth = (orig_max_pos / wavelen - low_freq_factor) \
        / (high_freq_factor - low_freq_factor)
    mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    out = np.where(wavelen > low_wl, inv_freq / factor,
                   np.where(wavelen < high_wl, inv_freq, mid))
    return out.astype(inv_freq.dtype)


def rope_inv_freq(head_dim: int, theta: float = 10000.0,
                  llama3_scaling=None) -> np.ndarray:
    """The head_dim // 2 rotary frequencies (float64)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2)[: head_dim // 2]
                                / head_dim))
    if llama3_scaling is not None and llama3_scaling[0] > 1.0:
        inv_freq = llama3_scaled_inv_freq(inv_freq, *llama3_scaling)
    return inv_freq


def rope_freqs(head_dim: int, max_pos: int, theta: float = 10000.0,
               llama3_scaling=None, device="cpu") -> torch.Tensor:
    """Per-(position, freq) angles [max_pos, head_dim // 2], float32."""
    inv_freq = rope_inv_freq(head_dim, theta, llama3_scaling)
    angles = np.outer(np.arange(max_pos), inv_freq).astype(np.float32)
    return torch.from_numpy(angles).to(device)


def rope_tables_neox(head_dim: int, max_pos: int, theta: float = 10000.0,
                     llama3_scaling=None, device="cpu"):
    """(cos, sin) of shape [max_pos, head_dim/2]."""
    a = rope_freqs(head_dim, max_pos, theta, llama3_scaling, device)
    return torch.cos(a), torch.sin(a)


def rope_tables_gptj(head_dim: int, max_pos: int, theta: float = 10000.0,
                     llama3_scaling=None, device="cpu"):
    """(cos, sin) of shape [max_pos, head_dim], repeat-interleaved."""
    a = rope_freqs(head_dim, max_pos, theta, llama3_scaling, device)
    c, s = torch.cos(a), torch.sin(a)
    return (torch.repeat_interleave(c, 2, dim=-1),
            torch.repeat_interleave(s, 2, dim=-1))


def apply_rope_neox(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """NEOX rotate-half: x [..., d]; cos/sin broadcastable [..., d/2].
    out[:d/2] = x1*cos - x2*sin ; out[d/2:] = x2*cos + x1*sin."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope_gptj(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """GPT-J interleaved: x [..., d]; cos/sin broadcastable [..., d]
    (repeat-interleaved).  out[2i] = x[2i]cos - x[2i+1]sin,
    out[2i+1] = x[2i+1]cos + x[2i]sin."""
    xp = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    rot = torch.stack([-xp[..., 1], xp[..., 0]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin
