"""Weight-only quantization and 8-bit KV formats (twin of
``clusterfusion_tpu/ops/quant.py``), in plain PyTorch.

- ``QuantizedTensor`` holds int8 codes ``q`` and float32 scales ``s`` with
  the JAX class's fields (``kind``, ``axis``, ``group_size``,
  ``pack_axis``; axes stored negative, so a layer slice of a stacked
  tensor keeps them valid).
- INT8 is symmetric per output channel: the scale is constant along the
  reduction axis, so ``x @ (q*s) == (x @ q) * s`` and the kernels scale
  the product, not the weight tile.  Kernel 7's int8 mode
  (``ops/stack_kernel.py``) streams ``q`` and applies ``s`` to its sums.
- INT4 is symmetric group-wise along the reduction axis (default group
  128), two codes a byte (row 2b in the low nibble, 2b+1 in the high), its
  scales rounded to bf16 before the codes are chosen.  Kernels 7, 8 and 9
  and the serving products take it in groups of 128 (the GEMVs' int4
  instances; ``ops/decoder_layer.py`` holds the plain products).
- KV formats: ``Int8KV`` (int8 rows with per-(head, position) scales in
  [L, H, R, 128] planes), the fp8 (e4m3) bit-twiddle decode, the one
  writer of both layouts, ``cache_fill_rows`` (``cache_write_layer`` for
  one layer), and ``cache_read_layer``, the eager paths' dequantized read.
  Kernels 7 and 8 (``ops/stack_kernel.py``, ``ops/stack_verify.py``) take
  both 8-bit formats, kernel 7's mode 5 too; kernel 6
  (``ops/decoder_layer.py``) takes fp8, as the TPU kernel does; kernels 9
  and 10 and the serving pools do not yet (``ROADMAP.md`` queue 2, item
  2.3).

Codes and scales are bit-equal to the JAX package's: both divide in
float32 and round half to even, in the same order of operations.  Unlike
the JAX package, ``cache_fill_rows`` writes in place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

__all__ = ["FP8_DECODE_FIX", "Int8KV", "QuantizedTensor", "cache_fill_rows",
           "cache_read_layer", "cache_write_layer", "expand_group_scales",
           "fp8_decode_scaled", "init_kv_int8", "kv_scales_flat",
           "maybe_dequantize", "quantize",
           "quantize_deepseek_params", "quantize_int4", "quantize_int8",
           "quantize_kv_rows", "quantize_llama_params", "unpack_int4",
           "unpack_int4_bitcast", "w4a8_int4_dot"]


class Int8KV(NamedTuple):
    """INT8 KV cache: q int8 [L, H, S, hd]; s float32 [L, H, R, 128] with
    R = max(ceil(S/128), 8), position p's scale at [l, h, p//128, p%128]."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def dtype(self):           # duck-types a tensor for cache callers
        return torch.int8

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self):
        return self.q.device


def init_kv_int8(n_layers: int, kv_heads: int, cap: int, head_dim: int,
                 device=None) -> Int8KV:
    rows = max(-(-cap // 128), 8)
    return Int8KV(
        torch.zeros((n_layers, kv_heads, cap, head_dim), dtype=torch.int8,
                    device=device),
        torch.ones((n_layers, kv_heads, rows, 128), dtype=torch.float32,
                   device=device))


def kv_scales_flat(s: torch.Tensor, cap: int) -> torch.Tensor:
    """[L, H, R, 128] -> [L, H, cap] per-position scales."""
    L, H, R, _ = s.shape
    return s.reshape(L, H, R * 128)[..., :cap]


def quantize_kv_rows(x: torch.Tensor):
    """Symmetric int8 row quantization over the trailing dim:
    x [..., hd] -> (q int8 [..., hd], s float32 [...])."""
    xa = x.float()
    s = torch.clamp_min(xa.abs().amax(dim=-1), 1e-8) * (1.0 / 127.0)
    q = torch.round(xa / s[..., None]).to(torch.int8)
    return q, s


def cache_fill_rows(cache, rows: torch.Tensor, pos0: int):
    """Write [L, kv, T, hd] rows at positions pos0..pos0+T-1 of a stacked
    cache, in place: a bf16/fp8 cache by a cast, an ``Int8KV`` by per-row
    quantization with each row's scale at [l, h, p // 128, p % 128].
    Returns the cache."""
    T = rows.shape[2]
    if isinstance(cache, Int8KV):
        q8, s = quantize_kv_rows(rows)                 # s [L, kv, T]
        cache.q[:, :, pos0:pos0 + T] = q8
        L, H, R, _ = cache.s.shape
        cache.s.view(L, H, R * 128)[:, :, pos0:pos0 + T] = s.to(cache.s.dtype)
        return cache
    cache[:, :, pos0:pos0 + T] = rows.to(cache.dtype)
    return cache


def cache_write_layer(cache, l: int, rows: torch.Tensor, pos0: int):
    """Write [kv, T, hd] rows at positions pos0..pos0+T-1 of layer ``l``, in
    place, as :func:`cache_fill_rows` writes them (the eager paths' append).
    Returns the cache."""
    T = rows.shape[1]
    if isinstance(cache, Int8KV):
        q8, s = quantize_kv_rows(rows)                 # s [kv, T]
        cache.q[l, :, pos0:pos0 + T] = q8
        H, R = cache.s.shape[1:3]
        cache.s[l].view(H, R * 128)[:, pos0:pos0 + T] = s.to(cache.s.dtype)
        return cache
    cache[l, :, pos0:pos0 + T] = rows.to(cache.dtype)
    return cache


def cache_read_layer(cache, l: int, n: int) -> torch.Tensor:
    """Rows 0..n-1 of layer ``l`` as float32 [kv, n, hd]: an ``Int8KV``
    dequantized (codes times scales), fp8 converted as XLA converts it
    (denormals kept).  The JAX package's eager read (``_cache_layer``)."""
    if isinstance(cache, Int8KV):
        H, R = cache.s.shape[1:3]
        s = cache.s[l].reshape(H, R * 128)[:, :n]
        return cache.q[l, :, :n].float() * s[:, :, None]
    return cache[l, :, :n].float()


# e4m3's 7 magnitude bits placed at bit 4 of a bf16 pattern, with 64 added
# to its exponent, give value * 2**-56 exactly for every normal e4m3 value;
# the factor is folded into the dot's result.  Denormals (|v| <= 0.0137)
# flush to zero.
FP8_DECODE_FIX = 2.0 ** 56


def fp8_decode_scaled(x: torch.Tensor) -> torch.Tensor:
    """float8_e4m3fn -> bf16 holding ``value * 2**-56`` (denormals to 0)."""
    i = x.view(torch.uint8).to(torch.int32)
    mag = i & 0x7F
    u16 = (mag << 4) + (64 << 7)
    u16 = torch.where(mag < 8, torch.zeros_like(u16), u16)
    u16 = u16 | ((i & 0x80) << 8)
    return u16.to(torch.int16).view(torch.bfloat16)


def _norm_axis(axis: int, ndim: int) -> int:
    """A negative index: a layer slice of a stacked tensor keeps it."""
    return axis if axis < 0 else axis - ndim


@dataclasses.dataclass
class QuantizedTensor:
    """Weight-only quantized tensor.

    q: int8 codes.  INT8: the original shape.  INT4: ``pack_axis`` halved,
       elements 2b / 2b+1 in byte b's low / high nibble.
    s: float32 scales.  INT8: the reduction axis collapsed to 1.  INT4: the
       reduction axis of size K / group_size.
    kind: "int8" | "int4"; axis: the reduction axis (negative);
    group_size: INT4's group along it; pack_axis: INT4's packing axis
    (negative).
    """

    q: torch.Tensor
    s: torch.Tensor
    kind: str
    axis: int
    group_size: int
    pack_axis: int = -1

    @property
    def shape(self) -> Tuple[int, ...]:
        shp = list(self.q.shape)
        if self.kind == "int4":
            shp[self.pack_axis] *= 2
        return tuple(shp)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def __getitem__(self, idx) -> "QuantizedTensor":
        """Index the leading (layer) axes of q and s alike."""
        return dataclasses.replace(self, q=self.q[idx], s=self.s[idx])

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(self, q=self.q.to(device),
                                   s=self.s.to(device))

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        if self.kind == "int8":
            return (self.q.float() * self.s).to(dtype)
        w = unpack_int4(self.q, self.pack_axis)
        s = expand_group_scales(self.s, self.axis, self.group_size)
        return (w.float() * s).to(dtype)


def _quantize_int8_2d(wf: torch.Tensor, axis: int):
    amax = wf.abs().amax(dim=axis, keepdim=True)
    s = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_int8(w: torch.Tensor, axis: int) -> QuantizedTensor:
    """Symmetric per-output-channel INT8 over reduction ``axis``.  A stacked
    tensor is quantized one leading slice at a time (the same codes: every
    column's scale is its own), so the float32 temporary is one slice."""
    axis = _norm_axis(axis, w.ndim)
    if w.ndim <= 2 or axis == -w.ndim:
        q, s = _quantize_int8_2d(w.float(), axis)
        return QuantizedTensor(q, s, "int8", axis, 0, axis)
    s_shape = list(w.shape)
    s_shape[axis] = 1
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(s_shape, dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], s[i] = _quantize_int8_2d(w[i].float(), axis)
    return QuantizedTensor(q, s, "int8", axis, 0, axis)


def quantize_int4(w: torch.Tensor, axis: int, group_size: int = 128,
                  pack_axis: int | None = None) -> QuantizedTensor:
    """Symmetric group-wise INT4 over reduction ``axis`` (codes in [-7, 7]),
    nibble-packed along ``pack_axis`` (default: the reduction axis).  The
    scales are rounded to bf16 before the codes are chosen, as the JAX
    package streams them.  A stacked tensor whose leading axis is neither
    is quantized one leading slice at a time (the same codes: every group
    lies in one slice), so the float32 temporaries are one slice's."""
    axis = _norm_axis(axis, w.ndim)
    pack_axis = axis if pack_axis is None else _norm_axis(pack_axis, w.ndim)
    if w.ndim > 2 and -w.ndim not in (axis, pack_axis):
        parts = [quantize_int4(w[i], axis, group_size, pack_axis)
                 for i in range(w.shape[0])]
        q = torch.empty((w.shape[0], *parts[0].q.shape), dtype=torch.int8,
                        device=w.device)
        s = torch.empty((w.shape[0], *parts[0].s.shape), dtype=torch.float32,
                        device=w.device)
        for i, t in enumerate(parts):
            q[i], s[i] = t.q, t.s
        return QuantizedTensor(q, s, "int4", axis, group_size, pack_axis)
    K = w.shape[axis]
    if K % group_size:
        raise ValueError(f"reduction size {K} is not a multiple of the group "
                         f"size {group_size}")
    if w.shape[pack_axis] % 2:
        raise ValueError(f"pack axis {pack_axis} of {tuple(w.shape)} is odd")
    wf = torch.movedim(w.float(), axis, 0)                  # [K, ...]
    grp = wf.reshape(K // group_size, group_size, *wf.shape[1:])
    amax = grp.abs().amax(dim=1)                            # [K/gs, ...]
    s = torch.clamp_min(amax, 1e-8) / 7.0
    s = s.to(torch.bfloat16).float()
    s_rep = torch.repeat_interleave(s, group_size, dim=0)   # [K, ...]
    q = torch.clamp(torch.round(wf / s_rep), -7, 7).to(torch.int32)
    q = torch.movedim(q, 0, axis)
    qp = torch.movedim(q, pack_axis, 0)
    lo, hi = qp[0::2], qp[1::2]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.int8)
    packed = torch.movedim(packed, 0, pack_axis).contiguous()
    s = torch.movedim(s, 0, axis).contiguous()
    return QuantizedTensor(packed, s, "int4", axis, group_size, pack_axis)


def unpack_int4(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """int8-packed nibbles [..K/2..] -> int32 codes [..K..] in natural
    order (byte b holds rows 2b (low) and 2b+1 (high))."""
    axis = _norm_axis(axis, packed.ndim)
    p = torch.movedim(packed, axis, 0).to(torch.int32)      # [K/2, ...]
    lo = ((p & 15) ^ 8) - 8
    hi = p >> 4
    out = torch.stack([lo, hi], dim=1).reshape((-1,) + tuple(p.shape[1:]))
    return torch.movedim(out, 0, axis)


def unpack_int4_bitcast(packed2d: torch.Tensor) -> torch.Tensor:
    """[K/2, N] packed along axis 0 -> [K, N] int8 codes: the plain version
    of the JAX package's in-kernel unpack (the same layout)."""
    if packed2d.ndim != 2:
        raise ValueError(f"a 2-D tile is expected, got {tuple(packed2d.shape)}")
    return unpack_int4(packed2d, 0).to(torch.int8)


def w4a8_int4_dot(x: torch.Tensor, packed: torch.Tensor, s: torch.Tensor,
                  gs: int) -> torch.Tensor:
    """W4A8 product, plain: x [M, K] quantized to int8 per row (absmax/127),
    times the int4 codes [K/2, N] (packed along K), each group's integer
    sum scaled by s [K/gs, N], the groups summed in float32, then the row
    scale: float32 [M, N]."""
    if gs % 128:
        raise ValueError(f"w4a8_int4_dot needs a group size that is a "
                         f"multiple of 128, got {gs}")
    w8 = unpack_int4_bitcast(packed)                        # [K, N]
    K, N = w8.shape
    ng = K // gs
    M = x.shape[0]
    xa = x.float()
    xs = torch.clamp_min(xa.abs().amax(dim=-1, keepdim=True), 1e-8) \
        * (1.0 / 127.0)                                     # [M, 1]
    x8 = torch.round(xa / xs).to(torch.int8)
    # integer group sums, exact in float64 (|sum| < 2**53)
    part = torch.einsum("mgk,gkn->gmn",
                        x8.double().reshape(M, ng, gs),
                        w8.double().reshape(ng, gs, N)).float()   # [ng, M, N]
    y = torch.sum(part * s.float()[:, None, :], dim=0)
    return y * xs


def expand_group_scales(s: torch.Tensor, axis: int,
                        group_size: int) -> torch.Tensor:
    """[..K/gs..] -> [..K..], each scale repeated ``gs`` times in a row."""
    axis = _norm_axis(axis, s.ndim)
    return torch.repeat_interleave(s, group_size, dim=axis)


def quantize(w: torch.Tensor, kind: str, axis: int, group_size: int = 128,
             pack_axis: int | None = None) -> QuantizedTensor:
    if kind == "int8":
        return quantize_int8(w, axis)
    if kind == "int4":
        return quantize_int4(w, axis, group_size, pack_axis)
    raise ValueError(f"unknown quantization kind {kind!r}")


# (reduction axis, int4 pack axis) of the fused-layout weights, negative so
# that stacked [L, ...] and single-layer trees both work
_WEIGHT_AXES = {"wqkv_f": (-2, -2), "wo_f": (-2, -2),
                "w13": (-2, -2), "w2": (-2, -2),
                # DeepSeek MLA stacks (models.deepseek layouts)
                "wproj": (-2, -2), "wuk": (-2, -2), "wuv": (-2, -2),
                "wo_t": (-2, -2),
                # routed-expert stacks
                "w13_e": (-2, -2), "w2_e": (-2, -2)}


def quantize_deepseek_params(params, kind: str = "int8",
                             group_size: int = 128, lm_head: bool = False):
    """Weight-only quantization of a DeepSeek MLA tree: the four attention
    projections, the dense/shared FFN and, when present, the routed
    experts.  The router, norms and embedding stay bf16."""
    targets = ["wproj", "wuk", "wuv", "wo_t", "w13", "w2"]
    if "w13_e" in params["layers"]:
        targets += ["w13_e", "w2_e"]
    return quantize_llama_params(params, kind, group_size,
                                 targets=tuple(targets), lm_head=lm_head)


def quantize_llama_params(params, kind: str = "int8", group_size: int = 128,
                          targets=("wqkv_f", "wo_f", "w13", "w2"),
                          lm_head: bool = False):
    """Quantize the projection weights of a Llama tree (embedding and norms
    stay bf16); stacked [L, ...] and single-layer trees alike.
    ``lm_head=True`` also quantizes the LM head per output column, INT8
    whatever ``kind`` is.  Returns a new tree; the leaves it does not
    quantize are the given tensors."""
    layers = dict(params["layers"])
    for name in targets:
        w = layers[name]
        if isinstance(w, QuantizedTensor):
            continue
        axis, pack_axis = _WEIGHT_AXES[name]
        layers[name] = quantize(w, kind, axis, group_size, pack_axis)
    out = dict(params)
    out["layers"] = layers
    if lm_head and not isinstance(out["lm_head"], QuantizedTensor):
        out["lm_head"] = quantize_int8(out["lm_head"], axis=-2)
    return out


def maybe_dequantize(w, dtype=torch.bfloat16):
    return w.dequantize(dtype) if isinstance(w, QuantizedTensor) else w
