"""Fused SwiGLU FFN of one token (twin of ``clusterfusion_tpu/ops/ffn.py``).

``fused_ffn`` computes h = x (+ residual), then ffn(rmsnorm(h)): the
gate/up product, bf16(silu(gate) * up) and the down product, accumulated in
float32 and rounded to bf16 once.  CUDA tensors run the hand-written kernels
of ``csrc/fused_ffn.cu``; CPU tensors run ``fused_ffn_plain``, which rounds
where they round: h's norm to bf16, the activation to bf16, the output to
bf16.  Stacked weights ([L, ...]) are read in place at ``layer_id``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.ops import _build
from clusterfusion_tpu_torch.ops._support import glu_act, round_up

#: Calls of :func:`fused_ffn` that launched the kernels (4 each).
launches = 0


def ffn_block_size(ffn_dim: int, target: int = 1024) -> int:
    """Largest 128-aligned divisor of ``ffn_dim`` at most ``target`` (the
    TPU kernel's f-block; callers pad ffn to a multiple of 1024)."""
    if ffn_dim % 128:
        raise ValueError(f"ffn dim {ffn_dim} is not a multiple of 128")
    ks = ffn_dim // 128
    return 128 * max(k for k in range(1, ks + 1)
                     if ks % k == 0 and k * 128 <= target)


def pad_ffn_weights(w13, w2, block: int):
    """Zero-pad [2, h, f] / [f, h] so that ``block`` divides f (zero
    gate/up columns and zero w2 rows are exact no-ops)."""
    f = w2.shape[0]
    f_pad = round_up(f, block)
    if f_pad != f:
        w13 = F.pad(w13, (0, f_pad - f))
        w2 = F.pad(w2, (0, 0, 0, f_pad - f))
    return w13, w2


def _layer(w13, w2, norm_w, layer_id: int):
    """The one layer's (w13 [2, h, f], w2 [f, h], norm_w [h]) views."""
    if w2.ndim == 3:
        return w13[layer_id], w2[layer_id], norm_w.reshape(w2.shape[0], -1)[
            layer_id]
    return w13, w2, norm_w.reshape(-1)


def fused_ffn_plain(x, residual, norm_w, w13, w2, *, eps: float,
                    fuse_residual: bool = True, layer_id: int = 0):
    """Plain PyTorch version of :func:`fused_ffn` (same arguments and
    results)."""
    w13, w2, nw = _layer(w13, w2, norm_w, int(layer_id))
    h = x.float()
    if fuse_residual:
        h = h + residual.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    xn = (h * torch.rsqrt(var + eps) * nw.float()).to(torch.bfloat16)
    y = torch.einsum("td,udf->tuf", xn.float(), w13.float())
    act = glu_act(y[:, 0], y[:, 1]).to(torch.bfloat16)
    out = (act.float() @ w2.float()).to(x.dtype)
    return out, h.to(x.dtype)


def fused_ffn(x, residual, norm_w, w13, w2, *, eps: float,
              kcfg: KernelConfig = KernelConfig(), fuse_residual: bool = True,
              layer_id=0, ffn_act: str = "silu"):
    """h = x (+ residual); returns (ffn(rmsnorm(h) * norm_w), h), both bf16
    [1, hidden].

    x/residual: [1, hidden] bf16; w13 [2, hidden, f_pad] (gate, up) and w2
    [f_pad, hidden] with norm_w [hidden] or [1, hidden]; or the stacks
    w13 [L, 2, hidden, f_pad], w2 [L, f_pad, hidden], norm_w [L, hidden] or
    [L, 1, hidden] with ``layer_id`` picking the layer (no copy)."""
    global launches
    if ffn_act != "silu":
        raise NotImplementedError("fused_ffn: only the SiLU gate (SwiGLU) is "
                                  f"ported, not {ffn_act!r}")
    if any(w.dtype != torch.bfloat16 for w in (w13, w2, norm_w)):
        raise NotImplementedError("fused_ffn: only bf16 weights are ported "
                                  "(quantized weights are not)")
    layer_id = int(layer_id)
    hidden = x.shape[-1]
    stacked = w2.ndim == 3
    n_layers = w2.shape[0] if stacked else 1
    f_pad = w2.shape[-2]
    if (w13.shape[-3:] != (2, hidden, f_pad) or w2.shape[-1] != hidden
            or norm_w.numel() != n_layers * hidden):
        raise ValueError(f"fused_ffn: shapes x {tuple(x.shape)}, w13 "
                         f"{tuple(w13.shape)}, w2 {tuple(w2.shape)}, norm_w "
                         f"{tuple(norm_w.shape)} do not agree")
    if not 0 <= layer_id < n_layers:
        raise ValueError(f"layer_id {layer_id} outside {n_layers} layers")
    if x.device.type == "cpu":
        return fused_ffn_plain(x, residual, norm_w, w13, w2, eps=eps,
                               fuse_residual=fuse_residual, layer_id=layer_id)

    if x.dtype != torch.bfloat16 or x.numel() != hidden:
        raise ValueError("x must be bf16 [1, hidden]")
    if hidden % 8 or f_pad % 8:
        raise ValueError(f"hidden {hidden} and f_pad {f_pad} must be "
                         "multiples of 8")
    res = residual if fuse_residual else None
    dev = x.device
    for name, t in (("x", x), ("residual", res), ("norm_w", norm_w),
                    ("w13", w13), ("w2", w2)):
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_ffn: {name} must be a contiguous, "
                             f"16-byte aligned tensor on {dev}")
    if res is not None and (res.dtype != torch.bfloat16
                            or res.numel() != hidden):
        raise ValueError("residual must be bf16 [1, hidden]")
    xn_f = round_up(hidden // 2, 4)
    gu_f = round_up(2 * f_pad, 4)
    scratch = torch.empty(xn_f + gu_f + hidden, dtype=torch.float32,
                          device=dev)
    base = scratch.data_ptr()
    out = torch.empty((1, hidden), dtype=torch.bfloat16, device=dev)
    res_out = torch.empty((1, hidden), dtype=torch.bfloat16, device=dev)
    n_launch = ctypes.c_int(0)
    err = _build.lib().cf_fused_ffn(
        x.data_ptr(), None if res is None else res.data_ptr(),
        norm_w.data_ptr(), w13.data_ptr(), w2.data_ptr(), out.data_ptr(),
        res_out.data_ptr(), base, base + 4 * xn_f, base + 4 * (xn_f + gu_f),
        hidden, f_pad, layer_id, float(eps), kcfg.gemv_threads,
        ctypes.byref(n_launch), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_ffn")
    launches += 1
    return out, res_out
