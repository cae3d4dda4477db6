"""bs=1 GEMV (twin of ``clusterfusion_tpu/ops/gemv.py``).

``gemv`` computes x [1, K] bf16 @ w [K, N] bf16 -> [1, N] float32.  CUDA
tensors launch the hand-written kernel of ``csrc/gemv.cu`` (the bs=1
stack's ring GEMV at one row, ``csrc/common.cuh``: weights bulk-copied through shared
memory, the K chunks of a column tile summed in a fixed order inside a
thread-block cluster, so every call gives the same bits); CPU tensors run
``gemv_plain``, the float32 product (bf16 products are exact in float32,
so the two differ only by the order of the sums).

``_gemv_int8`` and ``_ffn_int8`` are the int8 serving step's M=B products
(no JAX counterpart of their own: the JAX package leaves them to XLA):
bf16 x against int8 codes with float32 per-column scales, on the card
through the GEMVs' int8 instances (``csrc/gemv.cu``'s ``cf_gemv_rows8``
and ``cf_ffn8``; the rows GEMV's from 2 rows), so that the codes stream
once a step and no bf16 copy of a weight is made; on the CPU through
their plain twins.  ``_gemv_int4`` and ``_ffn_int4`` are the int4 serving
step's (and kernel 9's test hooks'): the same products over int4 codes
packed two a byte along K with float32 group scales, in the exact mode
(x @ bf16(code * s), what the JAX package's XLA products compute over
``maybe_dequantize``; ``_gemv_int4`` also in W4A8 for the card tests),
through the GEMVs' int4 instances (``cf_gemv_rows4``, ``cf_ffn4``).  The
kernels take group size 128 only (``ROADMAP.md`` queue 2, mode 1.5); the
plain twins take any.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.ops import _build
from clusterfusion_tpu_torch.ops._support import glu_act
from clusterfusion_tpu_torch.ops.decoder_layer import _int4_dot
from clusterfusion_tpu_torch.ops.stack_kernel import check_int4_group

#: Calls of :func:`gemv` that launched the kernel (CUDA tensors only).
launches = 0
#: Calls of ``_gemv_int8`` that launched its kernel.
int8_launches = 0
#: Calls of ``_ffn_int8`` that launched its kernels.
ffn8_launches = 0
#: Calls of ``_gemv_int4`` that launched its kernel.
int4_launches = 0
#: Calls of ``_ffn_int4`` that launched its kernels.
ffn4_launches = 0


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


def _gemv_int8_plain(x, q, s, kg: int = 0):
    """Plain version of :func:`_gemv_int8` (float32 result)."""
    M, K = x.shape
    if kg:
        part = torch.einsum("mgk,gkn->mgn", x.float().reshape(M, K // kg, kg),
                            q.float().reshape(K // kg, kg, -1))
        return (part * s.float()).sum(dim=1)
    y = torch.einsum("mk,gkn->mgn", x.float(), q.float()) * s.float()
    return y.reshape(M, -1)


def _ffn_int8_plain(x, w13_q, w13_s, w2_q, w2_s):
    """Plain version of :func:`_ffn_int8`."""
    y = torch.einsum("md,udf->umf", x.float(), w13_q.float()) * w13_s.float()[:, None]
    act = (F.silu(y[0]) * y[1]).to(torch.bfloat16)
    return ((act.float() @ w2_q.float()) * w2_s.float()).to(torch.bfloat16)


def _check_codes(x, q, s, what: str = "int8 GEMV"):
    dev = x.device
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or \
            s.dtype != torch.float32:
        raise ValueError(f"{what}: bf16 x, int8 codes and float32 scales "
                         "are expected")
    for name, t in (("x", x), ("codes", q), ("scales", s)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous, "
                             f"16-byte aligned tensor on {dev}")
    if q.shape[-1] % 16:
        raise ValueError(f"{what} width {q.shape[-1]} is not a multiple "
                         "of 16")


def _gemv_int8(x, q, s, *, kg: int = 0, bf16_out: bool = False):
    """x [M, K] bf16 against int8 codes q [nmat, K, N] (or [K, N]) with
    float32 scales s [nmat, N]: [M, nmat*N], matrix m at columns m*N..,
    each column scaled after its sum.  kg > 0 (one matrix): s [K / kg, N],
    each group of kg rows' partial scaled before the groups are summed (the
    O projection over head groups).  Float32, or rounded to bf16 after the
    scale with ``bf16_out``."""
    global int8_launches
    q3 = q.reshape(-1, *q.shape[-2:])
    nmat, K, N = q3.shape
    if x.dim() != 2 or x.shape[1] != K or (kg and (nmat != 1 or K % kg)):
        raise ValueError(f"int8 GEMV: x {tuple(x.shape)}, codes "
                         f"{tuple(q.shape)}, kg {kg}")
    s2 = s.reshape(-1, N)
    if s2.shape[0] != (K // kg if kg else nmat):
        raise ValueError(f"int8 GEMV: scales {tuple(s.shape)} do not fit")
    if x.device.type == "cpu":
        y = _gemv_int8_plain(x, q3, s2, kg)
        return y.to(torch.bfloat16) if bf16_out else y
    _check_codes(x, q3, s2)
    M, dev = x.shape[0], x.device
    y = torch.empty((M, nmat * N), device=dev,
                    dtype=torch.bfloat16 if bf16_out else torch.float32)
    err = _build.lib().cf_gemv_rows8(
        x.data_ptr(), K, 0, q3.data_ptr(), s2.data_ptr(), kg,
        None if bf16_out else y.data_ptr(), y.data_ptr() if bf16_out else None,
        M, K, N, nmat, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "int8 GEMV")
    int8_launches += 1
    return y


def _ffn_int8(x, w13_q, w13_s, w2_q, w2_s):
    """The int8 SwiGLU FFN of x [M, hidden] bf16: gate and up = x @
    bf16(w13_q[i]) * w13_s[i] in float32 (w13_q [2, hidden, f], w13_s
    [2, f]), act = bf16(silu(gate) * up), out = bf16((act @ bf16(w2_q)) *
    w2_s) (w2_q [f, hidden], w2_s [hidden]): [M, hidden] bf16."""
    global ffn8_launches
    M, hidden = x.shape
    f = w13_q.shape[-1]
    w13_s, w2_s = w13_s.reshape(2, f), w2_s.reshape(hidden)
    if tuple(w13_q.shape) != (2, hidden, f) or \
            tuple(w2_q.shape) != (f, hidden):
        raise ValueError(f"int8 FFN: codes {tuple(w13_q.shape)} and "
                         f"{tuple(w2_q.shape)} for x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return _ffn_int8_plain(x, w13_q, w13_s, w2_q, w2_s)
    _check_codes(x, w13_q, w13_s)
    _check_codes(x, w2_q, w2_s)
    dev = x.device
    act = torch.empty((M, 2 * f), dtype=torch.float32, device=dev)
    out = torch.empty((M, hidden), dtype=torch.bfloat16, device=dev)
    err = _build.lib().cf_ffn8(
        x.data_ptr(), w13_q.data_ptr(), w13_s.data_ptr(), w2_q.data_ptr(),
        w2_s.data_ptr(), act.data_ptr(), out.data_ptr(), M, hidden, f,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "int8 FFN")
    ffn8_launches += 1
    return out


def _int4_operands(x, q, s):
    """(q [nmat, K/2, N], s [nmat, K/gs, N], K, gs) of x [M, K] against
    int4 codes q ([nmat, K/2, N] or [K/2, N], packed along K) and group
    scales s."""
    q3 = q.reshape(-1, *q.shape[-2:])
    nmat, K2, N = q3.shape
    K = 2 * K2
    s3 = s.reshape(nmat, -1, N)
    if x.dim() != 2 or x.shape[1] != K or K % s3.shape[1]:
        raise ValueError(f"int4 GEMV: x {tuple(x.shape)}, codes "
                         f"{tuple(q.shape)}, scales {tuple(s.shape)}")
    return q3, s3, K, K // s3.shape[1]


def _gemv_int4_plain(x, q, s, kg: int = 0, a8: bool = False):
    """Plain version of :func:`_gemv_int4` (float32 result)."""
    q3, s3, K, gs = _int4_operands(x, q, s)
    xb = kg if a8 and kg else K
    outs = []
    for m in range(q3.shape[0]):
        y = 0.0
        for b in range(0, K, xb):     # W4A8's activation blocks, in order
            y = y + _int4_dot(x[:, b:b + xb], q3[m, b // 2:(b + xb) // 2],
                              s3[m, b // gs:(b + xb) // gs], gs, a8)
        outs.append(y)
    return torch.cat(outs, dim=1)


def _ffn_int4_plain(x, w13_q, w13_s, w2_q, w2_s):
    """Plain version of :func:`_ffn_int4`."""
    hidden = x.shape[1]
    gs = hidden // w13_s.shape[-2]
    y = [_int4_dot(x, w13_q[i], w13_s[i], gs, False) for i in range(2)]
    act = glu_act(y[0], y[1]).to(torch.bfloat16)
    gs2 = act.shape[1] // w2_s.shape[-2]
    return _int4_dot(act, w2_q, w2_s, gs2, False).to(torch.bfloat16)


def _gemv_int4(x, q, s, *, kg: int = 0, a8: bool = False,
               bf16_out: bool = False):
    """x [M, K] bf16 against int4 codes q [nmat, K/2, N] (or [K/2, N];
    packed along K, two a byte) with float32 group scales s [nmat, K/gs,
    N] (or [K/gs, N]): [M, nmat*N], matrix m at columns m*N..  The exact
    product x @ bf16(code * s) in float32, or with ``a8`` the W4A8 one (x
    quantized to int8 per row and per activation block of ``kg`` columns,
    0 the whole row).  Float32, or rounded to bf16 with ``bf16_out``.  The
    O projection over head groups is one matrix of G*c rows: its scales
    vary along K and need no group of their own."""
    global int4_launches
    q3, s3, K, gs = _int4_operands(x, q, s)
    nmat, _, N = q3.shape
    if kg and (K % kg or kg % gs):
        raise ValueError(f"int4 GEMV: activation block {kg} of {K}")
    if x.device.type == "cpu":
        y = _gemv_int4_plain(x, q3, s3, kg, a8)
        return y.to(torch.bfloat16) if bf16_out else y
    check_int4_group(gs, "int4 GEMV")
    _check_codes(x, q3, s3, "int4 GEMV")
    M, dev = x.shape[0], x.device
    y = torch.empty((M, nmat * N), device=dev,
                    dtype=torch.bfloat16 if bf16_out else torch.float32)
    x8 = xs = None
    if a8 and M > 1:        # the rows GEMV's W4A8 quantizes x into scratch
        x8 = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
        xs = torch.empty((M, K // kg if kg else 1), dtype=torch.float32,
                         device=dev)
    err = _build.lib().cf_gemv_rows4(
        x.data_ptr(), K, 0, q3.data_ptr(), s3.data_ptr(), kg if a8 else 0,
        None if bf16_out else y.data_ptr(), y.data_ptr() if bf16_out else None,
        M, K, N, nmat, int(a8), None if x8 is None else x8.data_ptr(),
        None if xs is None else xs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "int4 GEMV")
    int4_launches += 1
    return y


def _ffn_int4(x, w13_q, w13_s, w2_q, w2_s):
    """The int4 SwiGLU FFN of x [M, hidden] bf16 in the exact mode: gate
    and up = x @ bf16(code * s) of w13 (codes [2, hidden/2, f], scales
    [2, hidden/gs, f]) in float32, act = bf16(silu(gate) * up), out =
    bf16(act @ bf16(code * s) of w2 (codes [f/2, hidden], scales [f/gs,
    hidden])): [M, hidden] bf16, no bf16 copy of a weight."""
    global ffn4_launches
    M, hidden = x.shape
    f = w13_q.shape[-1]
    if tuple(w13_q.shape) != (2, hidden // 2, f) or \
            tuple(w2_q.shape) != (f // 2, hidden) or \
            w13_s.shape[-1] != f or w2_s.shape[-1] != hidden:
        raise ValueError(f"int4 FFN: codes {tuple(w13_q.shape)} and "
                         f"{tuple(w2_q.shape)} for x {tuple(x.shape)}")
    w13_s = w13_s.reshape(2, -1, f)
    w2_s = w2_s.reshape(-1, hidden)
    if x.device.type == "cpu":
        return _ffn_int4_plain(x, w13_q, w13_s, w2_q, w2_s)
    check_int4_group(hidden // w13_s.shape[1], "int4 FFN")
    check_int4_group(f // w2_s.shape[0], "int4 FFN")
    _check_codes(x, w13_q, w13_s, "int4 FFN")
    _check_codes(x, w2_q, w2_s, "int4 FFN")
    dev = x.device
    act = torch.empty((M, 2 * f), dtype=torch.float32, device=dev)
    out = torch.empty((M, hidden), dtype=torch.bfloat16, device=dev)
    err = _build.lib().cf_ffn4(
        x.data_ptr(), w13_q.data_ptr(), w13_s.data_ptr(), w2_q.data_ptr(),
        w2_s.data_ptr(), act.data_ptr(), out.data_ptr(), M, hidden, f,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "int4 FFN")
    ffn4_launches += 1
    return out
