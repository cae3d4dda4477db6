"""Rotary position embedding helpers (twin of ``clusterfusion_tpu/ops/rope.py``).

- NEOX rotate-half: pairs (i, i+d/2), tables of d/2 entries per position.
- GPT-J interleaved: pairs (2i, 2i+1), tables repeat-interleaved to d
  entries per position.
- YaRN (DeepSeek-V2): NEOX tables over blended frequencies, with the
  attention-entropy correction in the softmax scale.

Tables are float32 and built on the host with numpy, exactly as the JAX
package builds them, then moved to ``device``.
"""

from __future__ import annotations

import math

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


def rope_tables_yarn(head_dim: int, max_pos: int, theta: float, *,
                     factor: float, orig_max: int, beta_fast: float = 32.0,
                     beta_slow: float = 1.0, mscale: float = 1.0,
                     mscale_all_dim: float = 0.0, device="cpu"):
    """YaRN-scaled NEOX (cos, sin) tables [max_pos, head_dim/2], float32,
    as DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` builds them: the
    interpolated frequencies below the ``beta_fast`` correction dim, the
    original ones above ``beta_slow``, a linear ramp between, and cos/sin
    scaled by get_mscale(factor, mscale) / get_mscale(factor,
    mscale_all_dim).  The arithmetic is float32 step for step, as the JAX
    package computes it, so that the angles at large positions agree (the
    power is taken in float64 and rounded once: numpy's vectorized float32
    power is off by an ulp where the JAX package's is not)."""
    f32 = np.float32
    half = head_dim // 2
    i = np.arange(half, dtype=f32)
    expo = (f32(2.0) * i / f32(head_dim)).astype(np.float64)
    freq_extra = f32(1.0) / np.power(float(theta), expo).astype(f32)
    freq_inter = freq_extra / f32(factor)

    def corr_dim(n_rot):
        return (head_dim * math.log(orig_max / (n_rot * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), half - 1)
    ramp = np.clip((i - f32(low)) / f32(max(high - low, 1)), f32(0), f32(1))
    inv_freq = freq_inter * ramp + freq_extra * (f32(1) - ramp)
    a = np.arange(max_pos, dtype=f32)[:, None] * inv_freq[None, :]
    m = f32(_yarn_get_mscale(factor, mscale)
            / _yarn_get_mscale(factor, mscale_all_dim))
    return (torch.from_numpy(np.cos(a) * m).to(device),
            torch.from_numpy(np.sin(a) * m).to(device))


def _yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0 or mscale <= 0.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_softmax_scale_mult(factor: float, mscale_all_dim: float) -> float:
    """Multiplier on the attention softmax scale under YaRN:
    get_mscale(factor, mscale_all_dim)**2, as DeepSeek-V2's attention
    multiplies head_dim**-0.5 by it."""
    m = _yarn_get_mscale(factor, mscale_all_dim)
    return m * m


def apply_rope_gptj(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """GPT-J interleaved: x [..., d]; cos/sin broadcastable [..., d]
    (repeat-interleaved).  out[2i] = x[2i]cos - x[2i+1]sin,
    out[2i+1] = x[2i+1]cos + x[2i]sin."""
    xp = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    rot = torch.stack([-xp[..., 1], xp[..., 0]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin
