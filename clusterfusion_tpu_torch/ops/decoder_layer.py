"""The fused attention half of a Llama decoder layer, bs=1 (twin of
``clusterfusion_tpu/ops/decoder_layer.py``).

``_fused_decoder_layer`` computes residual add + RMSNorm + QKV projection +
RoPE + flash-decode over the cached rows + the current token + the
O-projection for one layer.  CUDA tensors launch the hand-written kernel
of ``csrc/decoder_layer.cu`` (one launch: a thread-block cluster per kv
head, sums in a fixed order, so a call repeats its bits); CPU tensors run
``_fused_decoder_layer_plain``, which repeats the kernel's arithmetic and
rounds where it rounds, as the TPU kernel does:

- h = x (+ residual) in float32, ``res_out`` its bf16; the norm's output is
  rounded to bf16 for the QKV product, which stays float32;
- q is roped in float32, pre-scaled by 1/sqrt(hd)*log2(e) and rounded to
  bf16 for the dots over cached rows; the softmax is exp2 and p is rounded
  to bf16 for the p.V products (per split of ``kcfg.kv_split`` rows, each
  against its own max);
- the current token joins from the float32 q, k and v, not from the bf16
  row that is appended;
- o is rounded to bf16 before the O-projection, whose sum over head groups
  is float32.

The modes follow the TPU kernel: ``fuse_residual``, ``append_kv`` (the new
row written in place at ``seq_len`` of layer ``layer_id``),
``emit_partials`` (no O-projection; the unnormalised acc and the (m, l)
rows in the log2 domain for a merge across sequence shards, with the empty
state m = -1e30, l = 0, acc = 0) and ``fold_current``.

The public ops ``llama_decoder_layer`` (GPT-J rope, no residual add) and
``llama_decoder_layer_sglang`` (NEOX rope, fused residual) take the
reference's tensor layouts and build the kernel layout on every call, as
the JAX package does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.ops import _build
from clusterfusion_tpu_torch.ops._support import stream_scratch
from clusterfusion_tpu_torch.ops.stack_kernel import (_norm, _rope,
                                                      split_attention_plain)

_LOG2E = 1.4426950408889634
#: Largest GQA group the kernels take (``ATT_MAX_GROUP`` in common.cuh).
MAX_GROUP = 8
#: KV heads per group of the public ops' weight layout (the JAX package's
#: default ``KernelConfig.head_group``).
HEAD_GROUP = 8

#: Calls of :func:`_fused_decoder_layer` that launched the kernels.
launches = 0
#: CUDA kernels the last such call launched.
last_call_kernels = 0
#: None, or a zeroed int64 CUDA tensor [16 * kv_heads, 8]: every call then
#: writes each block's %globaltimer (ns) at the kernel's phase boundaries
#: (start, norm, QKV, rope, split-KV, merge, O-projection, fold; rows past
#: the launch's blocks stay 0), for a readout of the time inside the launch.
phase_stamps: Optional[torch.Tensor] = None


def _pick_head_group(kv_heads: int, requested: int) -> int:
    """Largest divisor of ``kv_heads`` at most ``requested``."""
    hgv = min(requested, kv_heads)
    while kv_heads % hgv:
        hgv -= 1
    return max(hgv, 1)


def fuse_qkv_o_for_kernel(wqkv_per_head, wo_per_head, kv_heads: int,
                          group: int, head_dim: int, head_group: int):
    """[kv, hidden, (g+2)*hd] + [kv, g*hd, hidden] -> head-grouped layouts
    ([G, hidden, hg*(g+2)*hd], [G, hg*g*hd, hidden])."""
    hg = head_group
    G = kv_heads // hg
    _, hidden, cols = wqkv_per_head.shape
    wqkv_g = (wqkv_per_head.reshape(G, hg, hidden, cols)
              .permute(0, 2, 1, 3).reshape(G, hidden, hg * cols))
    wo_g = wo_per_head.reshape(G, hg * group * head_dim, hidden)
    return wqkv_g, wo_g


def _layer_views(rms_w, wqkv_f, wo_f, layer_id: int, hidden: int):
    """One layer's (rms_w [hidden], wqkv [G, hidden, C], wo [G, R, hidden]
    or None) from stacked ([L, ...]) or per-layer weights (views)."""
    w = rms_w.reshape(-1, hidden)
    w = w[layer_id] if w.shape[0] > 1 else w[0]
    if wqkv_f.dim() == 4:
        wqkv_f = wqkv_f[layer_id]
        wo_f = None if wo_f is None else wo_f[layer_id]
    return w, wqkv_f, wo_f


def _fused_decoder_layer_plain(
    x, residual, rms_w, cos_f, sin_f, wqkv_f, wo_f, k_cache, v_cache,
    seq_len, layer_id=0, *, group: int, head_dim: int, rope_style: str,
    fuse_residual: bool, eps: float, kcfg: KernelConfig = KernelConfig(),
    emit_partials: bool = False, fold_current=1, append_kv: bool = False,
):
    """Plain PyTorch version of :func:`_fused_decoder_layer` (same
    arguments, same results, the cache appended in place)."""
    seq, layer_id = int(seq_len), int(layer_id)
    hidden = x.shape[-1]
    rw, wqkv, wo = _layer_views(rms_w, wqkv_f, wo_f, layer_id, hidden)
    G = wqkv.shape[0]
    kv_heads = k_cache.shape[1]
    hd, g = head_dim, group
    dt = x.dtype
    h = x.float().reshape(hidden)
    if fuse_residual:
        h = h + residual.float().reshape(hidden)
    xn = _norm(h, rw, eps)
    qkv = torch.einsum("d,Gdc->Gc", xn.float(), wqkv.float())
    qkv = qkv.reshape(kv_heads, g + 2, hd)
    cos = cos_f.float().reshape(hd)
    sin = sin_f.float().reshape(hd)
    q = _rope(qkv[:, :g], cos, sin, rope_style) * (_LOG2E / math.sqrt(hd))
    k_cur = _rope(qkv[:, g], cos, sin, rope_style)
    v_cur = qkv[:, g + 1]
    acc, m, l_sum = split_attention_plain(
        q, k_cur, v_cur, k_cache[layer_id], v_cache[layer_id], seq,
        kcfg.kv_split, fold=bool(int(fold_current)))
    k_new, v_new = k_cur.to(dt), v_cur.to(dt)
    res_out = h.to(dt)[None] if fuse_residual else None
    if emit_partials:
        rows = kv_heads * g
        return (acc.reshape(rows, hd), torch.stack([m.reshape(rows),
                                                    l_sum.reshape(rows)]),
                res_out, k_new, v_new)
    o = (acc / l_sum[..., None]).to(torch.bfloat16)
    out = torch.einsum("Gc,Gco->o", o.reshape(G, -1).float(), wo.float())
    result = (out.to(dt)[None], res_out, k_new, v_new)
    if append_kv:
        k_cache[layer_id, :, seq] = k_new.to(k_cache.dtype)
        v_cache[layer_id, :, seq] = v_new.to(v_cache.dtype)
        return result + (k_cache, v_cache)
    return result


def launch_plan(hidden: int, kv_heads: int, group: int, head_dim: int,
                kv_split: int = KernelConfig().kv_split) -> dict:
    """The kernel's launch on the current card for this geometry: blocks
    per cluster (one cluster per kv head), blocks, ring stages, shared
    bytes per block, clusters of that size the card holds at once, and
    (``held_by_size``) the clusters the card holds at each size 1..16."""
    info = (ctypes.c_int * 21)()
    _build.check(_build.lib().cf_decoder_layer_plan(
        hidden, kv_heads, group, head_dim, kv_split, info),
        "_fused_decoder_layer plan")
    return dict(cluster=info[0], blocks=info[1], stages=info[2],
                smem_bytes=info[3], clusters_held=info[4],
                held_by_size=list(info[5:21]))


def _refuse(wqkv_f, wo_f, k_cache, v_cache, *, window, bias_qkv,
            softcap) -> None:
    if window or bias_qkv is not None or softcap:
        raise NotImplementedError("_fused_decoder_layer: sliding window, QKV "
                                  "bias and softcap are not ported yet")
    if any(not isinstance(w, torch.Tensor) or w.dtype != torch.bfloat16
           for w in (wqkv_f, wo_f) if w is not None):
        raise NotImplementedError("_fused_decoder_layer: only bf16 weights "
                                  "are ported (quantized weights are not)")
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise NotImplementedError("_fused_decoder_layer: only a bf16 KV "
                                  "cache is ported (int8/fp8 KV are not)")


def _fused_decoder_layer(
    x, residual, rms_w, cos_f, sin_f, wqkv_f, wo_f, k_cache, v_cache,
    seq_len, layer_id=0,
    *,
    group: int,
    head_dim: int,
    rope_style: str,
    fuse_residual: bool,
    eps: float,
    kcfg: KernelConfig = KernelConfig(),
    emit_partials: bool = False,
    fold_current=1,
    append_kv: bool = False,
    window: int = 0,
    bias_qkv=None,
    softcap: float = 0.0,
):
    """The attention half of one layer at ``seq_len`` cached rows.

    x, residual: [1, hidden] bf16 (residual unused unless
    ``fuse_residual``); rms_w [hidden], [1, hidden] or the stack [L, hidden]
    / [L, 1, hidden]; cos_f/sin_f [1, head_dim] full-dim at the token's
    position; wqkv_f [G, hidden, hg*(group+2)*hd] and wo_f
    [G, hg*group*hd, hidden], or their [L, ...] stacks; k_cache/v_cache
    [L, kv_heads, capacity, head_dim], layer ``layer_id`` read.

    Returns (out [1, hidden], res_out [1, hidden] or None without
    ``fuse_residual``, k_new [kv, hd], v_new [kv, hd]), plus (k_cache,
    v_cache) with ``append_kv`` (the new row written in place at
    ``seq_len``); with ``emit_partials`` (acc [kv*group, hd] f32,
    ml [2, kv*group] f32, res_out, k_new, v_new) and no O-projection.
    ``fold_current`` 0 leaves the current token out of the softmax.
    ``window``, ``bias_qkv`` and ``softcap`` (the TPU kernel's sliding
    window, QKV bias and logit softcap) raise NotImplementedError."""
    global launches, last_call_kernels
    _refuse(wqkv_f, wo_f, k_cache, v_cache, window=window, bias_qkv=bias_qkv,
            softcap=softcap)
    if append_kv and emit_partials:
        raise ValueError("_fused_decoder_layer: partials mode does not "
                         "append (the owner of the position appends)")
    seq, layer_id, fold = int(seq_len), int(layer_id), int(fold_current)
    hidden = x.shape[-1]
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("k_cache/v_cache must be [L, kv_heads, cap, hd]")
    L, kv_heads, cap, hd = k_cache.shape
    rw, wqkv, wo = _layer_views(rms_w, wqkv_f, wo_f, layer_id, hidden)
    G, hidden_w, C = wqkv.shape
    hg = kv_heads // G if G else 0
    if (hd != head_dim or hidden_w != hidden or G * hg != kv_heads
            or C != hg * (group + 2) * hd):
        raise ValueError(f"_fused_decoder_layer: wqkv {tuple(wqkv.shape)} "
                         f"does not fit kv {kv_heads}, group {group}, hd "
                         f"{head_dim}, hidden {hidden}")
    if not emit_partials and (wo is None or tuple(wo.shape) != (
            G, hg * group * hd, hidden)):
        raise ValueError("_fused_decoder_layer: wo must be "
                         f"[G, hg*group*hd, hidden] = [{G}, "
                         f"{hg * group * hd}, {hidden}]")
    if not 0 <= layer_id < L:
        raise ValueError(f"layer_id {layer_id} outside the cache's {L} "
                         "layers")
    if not 0 <= seq <= cap or (append_kv and seq >= cap):
        raise ValueError(f"seq_len {seq} outside the cache capacity {cap}")
    if fold not in (0, 1):
        raise ValueError(f"fold_current must be 0 or 1, not {fold}")
    if rope_style not in ("neox", "gptj"):
        raise ValueError(f"unknown rope style {rope_style!r}")
    common = dict(group=group, head_dim=head_dim, rope_style=rope_style,
                  fuse_residual=fuse_residual, eps=eps, kcfg=kcfg,
                  emit_partials=emit_partials, fold_current=fold,
                  append_kv=append_kv)
    if x.device.type == "cpu":
        return _fused_decoder_layer_plain(
            x, residual, rms_w, cos_f, sin_f, wqkv_f, wo_f, k_cache, v_cache,
            seq, layer_id, **common)

    dev = x.device
    if group > MAX_GROUP or hd % 32 or hd > 128:
        raise NotImplementedError(
            f"_fused_decoder_layer: group {group} (at most {MAX_GROUP}) or "
            f"head_dim {hd} (a multiple of 32 up to 128)")
    if not 1 <= kcfg.kv_split <= 1024:
        raise ValueError(f"bad KernelConfig {kcfg}")
    if hidden % 8 or C % 8:
        raise ValueError(f"hidden {hidden} and qkv width {C} must be "
                         "multiples of 8")
    if hidden > 8192:
        raise NotImplementedError(f"_fused_decoder_layer: hidden {hidden} "
                                  "(at most 8192)")
    res = residual if fuse_residual else None
    for name, t in (("x", x), ("residual", res)):
        if t is not None and (t.dtype != torch.bfloat16
                              or t.numel() != hidden):
            raise ValueError(f"{name} must be bf16 [1, hidden]")
    kc_l, vc_l = k_cache[layer_id], v_cache[layer_id]
    for name, t in (("x", x), ("residual", res), ("rms_w", rw),
                    ("wqkv_f", wqkv), ("wo_f", None if emit_partials else wo),
                    ("k_cache", kc_l), ("v_cache", vc_l)):
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"_fused_decoder_layer: {name} must be a "
                             f"contiguous, 16-byte aligned tensor on {dev}")
    if rw.dtype != torch.bfloat16:
        raise NotImplementedError("_fused_decoder_layer: rms_w must be bf16")
    cos = cos_f.to(device=dev, dtype=torch.float32).reshape(hd).contiguous()
    sin = sin_f.to(device=dev, dtype=torch.float32).reshape(hd).contiguous()
    bf16, f32 = torch.bfloat16, torch.float32
    rows = kv_heads * group
    res_out = torch.empty((1, hidden), dtype=bf16, device=dev) \
        if fuse_residual else None
    k_new = torch.empty((kv_heads, hd), dtype=bf16, device=dev)
    v_new = torch.empty((kv_heads, hd), dtype=bf16, device=dev)
    if emit_partials:
        out = None
        acc = torch.empty((rows, hd), dtype=f32, device=dev)
        ml = torch.empty((2, rows), dtype=f32, device=dev)
    else:
        out = torch.empty((1, hidden), dtype=bf16, device=dev)
        acc = ml = None
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = stream_scratch(
        ("decoder_layer", hidden, kv_heads),
        lambda: lib.cf_decoder_layer_scratch_floats(hidden, kv_heads), dev,
        stream)
    n_launch = ctypes.c_int(0)

    def ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    err = lib.cf_decoder_layer(
        ptr(x), ptr(res), ptr(rw), ptr(cos), ptr(sin), ptr(wqkv),
        None if emit_partials else ptr(wo), ptr(kc_l), ptr(vc_l), ptr(out),
        ptr(res_out), ptr(k_new), ptr(v_new), ptr(acc), ptr(ml),
        ptr(scratch), hidden, kv_heads, hg, group, hd, cap, seq, fold,
        int(append_kv), 1 if rope_style == "neox" else 0, float(eps),
        kcfg.kv_split, ptr(phase_stamps), ctypes.byref(n_launch), stream)
    if err:
        scratch.zero_()                 # the ticket counters start at 0
        _build.check(err, "_fused_decoder_layer")
    launches += 1
    last_call_kernels = n_launch.value
    if emit_partials:
        return acc, ml, res_out, k_new, v_new
    if append_kv:
        return out, res_out, k_new, v_new, k_cache, v_cache
    return out, res_out, k_new, v_new


# --------------------------------------------------------------------------
# Reference-parity public ops
# --------------------------------------------------------------------------


def _prep_mha(weight_qkv, weight_o, k_cache, v_cache, heads: int, hd: int,
              hg: int, transposed_blocks: bool):
    """Reference tensor layouts -> kernel layouts (MHA): (wqkv_g, wo_g,
    k [1, heads, seq, hd], v, seq).

    transposed_blocks=False: weight_qkv is torch-Linear [3*hidden, hidden]
    (sglang op).  True: stacked [in, out] blocks (the meta op).  Every cache
    row is past: capacity = seq and nothing is appended."""
    hidden = heads * hd
    seq = k_cache.shape[0]
    if transposed_blocks:
        per_head = (weight_qkv.reshape(3, hidden, heads, hd)
                    .permute(2, 1, 0, 3).reshape(heads, hidden, 3 * hd))
        wo_per_head = weight_o.reshape(heads, hd, hidden)
    else:
        per_head = (weight_qkv.reshape(3, heads, hd, hidden)
                    .permute(1, 3, 0, 2).reshape(heads, hidden, 3 * hd))
        wo_per_head = weight_o.t().reshape(heads, hd, hidden)
    wqkv_g, wo_g = fuse_qkv_o_for_kernel(per_head, wo_per_head, heads, 1, hd,
                                         hg)
    kc = k_cache.reshape(seq, heads, hd).transpose(0, 1)[None]
    vc = v_cache.reshape(seq, heads, hd).transpose(0, 1)[None]
    return (wqkv_g.contiguous(), wo_g.contiguous(), kc.contiguous(),
            vc.contiguous(), seq)


def llama_decoder_layer_sglang(input, residual, weight_qkv, weight_o, k_cache,
                               v_cache, rms_w, eps: float, cos, sin,
                               kernel_config: Optional[KernelConfig] = None,
                               window: int = 0):
    """Fused layer, sglang variant: NEOX rope + fused residual add + runtime
    eps, weights in torch.nn.Linear [out, in] layout (weight_qkv
    [3*hidden, hidden], weight_o [hidden, hidden]); caches [seq, hidden];
    cos/sin [head_dim/2].  Twin of the reference op
    ``clusterfusion.llama_decoder_layer_sglang``.

    Returns (output, residual_out, k_new, v_new), each [1, hidden]."""
    kcfg = kernel_config or KernelConfig()
    hidden = input.shape[-1]
    hd = 2 * cos.shape[-1]
    heads = hidden // hd
    hg = _pick_head_group(heads, HEAD_GROUP)
    wqkv_g, wo_g, kc, vc, seq = _prep_mha(
        weight_qkv, weight_o, k_cache, v_cache, heads, hd, hg, False)
    cos_f = torch.cat([cos, cos])[None]
    sin_f = torch.cat([sin, sin])[None]
    out, res_out, k_new, v_new = _fused_decoder_layer(
        input, residual, rms_w[None], cos_f, sin_f, wqkv_g, wo_g, kc, vc,
        seq, group=1, head_dim=hd, rope_style="neox", fuse_residual=True,
        eps=eps, kcfg=kcfg, window=window)
    return out, res_out, k_new.reshape(1, hidden), v_new.reshape(1, hidden)


def llama_decoder_layer(input, weight_qkv, weight_o, k_cache, v_cache, rms_w,
                        cos, sin, eps: float = 1e-6,
                        kernel_config: Optional[KernelConfig] = None):
    """Fused layer, meta-llama variant: GPT-J interleaved rope, no residual
    add (the caller adds), weights in the transposed [in, out] layout
    (weight_qkv [3*hidden, hidden] of stacked W.T blocks, weight_o = wo.T);
    caches [seq, hidden]; cos/sin [1, head_dim] repeat-interleaved.  Twin
    of the reference op ``clusterfusion.llama_decoder_layer``.

    Returns (output, k_new, v_new), each [1, hidden]."""
    kcfg = kernel_config or KernelConfig()
    hidden = input.shape[-1]
    hd = cos.shape[-1]
    heads = hidden // hd
    hg = _pick_head_group(heads, HEAD_GROUP)
    wqkv_g, wo_g, kc, vc, seq = _prep_mha(
        weight_qkv, weight_o, k_cache, v_cache, heads, hd, hg, True)
    out, _, k_new, v_new = _fused_decoder_layer(
        input, None, rms_w[None], cos.reshape(1, hd), sin.reshape(1, hd),
        wqkv_g, wo_g, kc, vc, seq, group=1, head_dim=hd, rope_style="gptj",
        fuse_residual=False, eps=eps, kcfg=kcfg)
    return out, k_new.reshape(1, hidden), v_new.reshape(1, hidden)
