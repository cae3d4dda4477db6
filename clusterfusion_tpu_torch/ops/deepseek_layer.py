"""DeepSeek-V2 MLA decode layer (twin of ``clusterfusion_tpu/ops/deepseek_layer.py``).

Matrix-absorbed MLA decode of one token: RMSNorm, the fused q_nope | q_pe |
ckv | k_pe projection, q_nope @ W_UK into the compressed space, attention
over the compressed cache (each row doubles as K and, in its first lora
columns, as V), @ W_UV and the O-projection.

- ``deepseek_decoder_layer``: the public op, torch.nn.Linear-layout
  projections, every cache row attended; it fuses the projections and calls
- ``deepseek_decoder_layer_fused``: pre-fused weights, rows < ``seq_len``
  attended, returns the current compressed row;
- ``deepseek_decoder_stack_layer``: the model's decode step, the [L, ...]
  weight stacks read in place at ``layer_id`` and the current row appended
  in place at row ``seq_len`` of the [L, cap, round_up(lora + rope, 128)]
  cache (pad columns written as zeros).

CUDA tensors run the hand-written kernels of ``csrc/mla_decode.cu`` (both
ops share them); CPU tensors run ``mla_decode_plain``, which rounds where
the kernels and the TPU kernel round: xn, q_nope before the absorption, q
for the cached-row dots (not for the current token, which joins in
float32), p (against the max of each split of ``MLA_SPLIT`` rows, as the
kernel takes it), o and each head's W_UV output.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from clusterfusion_tpu_torch.config import KernelConfig
from clusterfusion_tpu_torch.ops import _build
from clusterfusion_tpu_torch.ops._support import cdiv, round_up
from clusterfusion_tpu_torch.ops.rope import apply_rope_neox

_LOG2E = 1.4426950408889634
_NEG_INF = -1e30
#: Compressed cache rows per block of the kernels' split pass (16, 32 or
#: 64; one block takes every head, so seq_len 600 gives 19 blocks).  The
#: twin rounds p against the max of each such split, as the kernel does.
MLA_SPLIT = 32

#: Calls of each op that launched the kernels.
launches = {"deepseek_decoder_layer_fused": 0,
            "deepseek_decoder_stack_layer": 0}
#: CUDA kernels the last such call of each op launched: 5 (the normalising
#: projection, absorption, split pass, merge, O-projection), 4 at seq_len 0
#: (no split pass).
last_kernels = {"deepseek_decoder_layer_fused": 0,
                "deepseek_decoder_stack_layer": 0}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def mla_decode_plain(x, rms_in, rms_ckv, cos, sin, wproj, wuk, wuv, wo_t,
                     cache, seq: int, *, n_heads: int, nope_dim: int,
                     rope_dim: int, lora_rank: int, eps: float,
                     softmax_scale: float, split: int):
    """Plain PyTorch MLA decode of one layer.  x [1, hidden]; rms_in
    [hidden]; rms_ckv [lora]; cos/sin [rope/2] or [rope] (NEOX, full-dim
    tables repeat the half); wproj [hidden, n_proj]; wuk [H, nope, lora];
    wuv [H, lora, nope]; wo_t [H*nope, hidden]; cache [>= seq, >= lora +
    rope], rows < seq attended.  Returns (out bf16 [1, hidden], cur f32
    [lora + rope]: the current compressed row)."""
    h, nope, rope, lora = n_heads, nope_dim, rope_dim, lora_rank
    mla = lora + rope
    half = rope // 2
    cos = cos.float().reshape(-1)[:half]
    sin = sin.float().reshape(-1)[:half]
    xf = x.float().reshape(-1)
    xn = _bf16(xf * torch.rsqrt(torch.mean(xf * xf) + eps) * rms_in.float())
    proj = xn @ wproj.float()
    qp_off = h * nope
    ckv_off = qp_off + h * rope
    kpe_off = ckv_off + lora
    ckv = proj[ckv_off:kpe_off]
    ckv = ckv * torch.rsqrt(torch.mean(ckv * ckv) + eps) * rms_ckv.float()
    cur = torch.cat([ckv, apply_rope_neox(proj[kpe_off:kpe_off + rope], cos,
                                          sin)])
    q_lora = torch.einsum("hd,hdr->hr", _bf16(proj[:qp_off].reshape(h, nope)),
                          wuk.float())
    q_pe = apply_rope_neox(proj[qp_off:ckv_off].reshape(h, rope), cos, sin)
    q = torch.cat([q_lora, q_pe], dim=-1) * (softmax_scale * _LOG2E)
    # split pass over rows < seq: per split a max m_s, a sum l_s of
    # exp2(s - m_s) and bf16(p) @ rows[:, :lora]
    ns = cdiv(seq, split)
    pad = ns * split - seq
    rows = F.pad(cache[:seq, :mla].float(), (0, 0, 0, pad))
    s = F.pad(_bf16(q) @ rows[:seq].T, (0, pad), value=_NEG_INF)
    s = s.reshape(h, ns, split)
    m_s = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m_s)
    l_s = p.sum(dim=-1)
    pv = torch.einsum("hns,nsc->hnc", _bf16(p),
                      rows[:, :lora].reshape(ns, split, lora))
    m_s = m_s[..., 0]
    # merge the splits and fold in the current token in float32
    s_cur = (q * cur).sum(dim=-1)
    m_f = torch.maximum(s_cur, m_s.amax(dim=-1)) if ns else s_cur
    e_s = torch.exp2(m_s - m_f[:, None])
    p_cur = torch.exp2(s_cur - m_f)
    l_f = p_cur + (l_s * e_s).sum(dim=-1)
    acc = p_cur[:, None] * cur[:lora] + (pv * e_s[..., None]).sum(dim=1)
    o = _bf16(acc / l_f[:, None])
    o_nope = _bf16(torch.einsum("hr,hrd->hd", o, wuv.float()))
    out = (o_nope.reshape(1, h * nope) @ wo_t.float()).to(x.dtype)
    return out, cur


def _refuse(what: str, weights, cache) -> None:
    if any(w.dtype != torch.bfloat16 for w in weights):
        raise NotImplementedError(f"{what}: only bf16 weights are ported "
                                  "(quantized weights are not)")
    if cache.dtype != torch.bfloat16:
        raise NotImplementedError(f"{what}: only a bf16 compressed cache is "
                                  f"ported (not {cache.dtype})")


@functools.lru_cache(maxsize=16)
def _scratch_floats(hidden, h, nope, rope, lora, cap, split) -> int:
    """Floats of scratch ``cf_mla_decode`` needs for up to ``cap`` rows."""
    return _build.lib().cf_mla_scratch_floats(hidden, h, nope, rope, lora, cap,
                                              split)


def _launch(what, x, rms_in, rms_ckv, cos, sin, wproj, wuk, wuv, wo_t,
            cache, seq, layer, append, h, nope, rope, lora, eps,
            softmax_scale, kcfg):
    """Launch ``cf_mla_decode``; returns (out [1, hidden], ckv_new [1, mla]
    or None when appending)."""
    hidden = x.shape[-1]
    mla = lora + rope
    cap, stride = cache.shape[-2], cache.shape[-1]
    if x.dtype != torch.bfloat16 or x.numel() != hidden:
        raise ValueError(f"{what}: x must be bf16 [1, hidden]")
    if kcfg.gemv_threads % 32:
        raise ValueError(f"bad KernelConfig {kcfg}")
    dev = x.device
    ptrs = []
    for name, t in (("x", x), ("rms_in", rms_in), ("rms_ckv", rms_ckv),
                    ("wproj", wproj), ("wuk", wuk), ("wuv", wuv),
                    ("wo_t", wo_t), ("cache", cache)):
        ptr = t.data_ptr()
        if t.device != dev or not t.is_contiguous() or ptr % 16:
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte "
                             f"aligned tensor on {dev}")
        ptrs.append(ptr)
    if (h > 32 or nope % 8 or lora % 64 or rope % 8 or (lora + rope) % 16
            or hidden % 8 or stride % 8):
        raise NotImplementedError(
            f"{what}: the kernel takes at most 32 heads, a lora rank that is a "
            "multiple of 64, lora + rope a multiple of 16 and other widths "
            "that are multiples of 8")
    # the kernels read the first rope / 2 values: a half table, or a
    # full-dim one whose halves repeat (NEOX)
    cos = cos.to(device=dev, dtype=torch.float32).reshape(-1)
    sin = sin.to(device=dev, dtype=torch.float32).reshape(-1)
    if cos.numel() not in (rope // 2, rope) or sin.shape != cos.shape:
        raise ValueError(f"{what}: cos/sin must hold rope / 2 or rope values")
    scratch = torch.empty(
        _scratch_floats(hidden, h, nope, rope, lora, cap, MLA_SPLIT),
        dtype=torch.float32, device=dev)
    out = torch.empty((1, hidden), dtype=torch.bfloat16, device=dev)
    ckv_new = None if append else torch.empty((1, mla), dtype=torch.bfloat16,
                                              device=dev)
    n_launch = ctypes.c_int(0)
    p_x, p_rin, p_rckv, p_wproj, p_wuk, p_wuv, p_wo, p_cache = ptrs
    err = _build.lib().cf_mla_decode(
        p_x, p_rin, p_rckv, cos.data_ptr(), sin.data_ptr(), p_wproj, p_wuk,
        p_wuv, p_wo, p_cache, out.data_ptr(),
        None if ckv_new is None else ckv_new.data_ptr(), scratch.data_ptr(),
        hidden, h, nope, rope, lora, cap, stride, seq, layer, int(append),
        float(eps), float(softmax_scale), MLA_SPLIT, kcfg.gemv_threads,
        ctypes.byref(n_launch), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    launches[what] += 1
    last_kernels[what] = n_launch.value
    return out, ckv_new


def _check_dims(what, wproj, wuk, wuv, wo_t, cache, hidden, h, nope, rope,
                lora):
    n_proj = h * (nope + rope) + lora + rope
    if (wproj.shape[-2:] != (hidden, n_proj)
            or wuk.shape[-3:] != (h, nope, lora)
            or wuv.shape[-3:] != (h, lora, nope)
            or wo_t.shape[-2:] != (h * nope, hidden)
            or cache.shape[-1] < lora + rope):
        raise ValueError(
            f"{what}: wproj {tuple(wproj.shape)}, wuk {tuple(wuk.shape)}, wuv "
            f"{tuple(wuv.shape)}, wo_t {tuple(wo_t.shape)}, cache "
            f"{tuple(cache.shape)} do not fit hidden {hidden}, heads {h}, "
            f"nope {nope}, rope {rope}, lora {lora}")


def deepseek_decoder_layer(input, weight_q_nope, weight_q_pe, weight_uk,
                           weight_kv_nope, weight_k_pe, weight_uv, weight_o,
                           ckv_cache, rms_input_weight, rms_ckv_weight, cos,
                           sin, n_heads: int = 16, nope_dim: int = 128,
                           rope_dim: int = 64, lora_rank: int = 512,
                           eps: float = 1e-6, kernel_config=None):
    """The reference's public op: projections in torch.nn.Linear layout
    ([out, in]), every row of ``ckv_cache`` [seq, lora + rope] attended.
    Returns (output [1, hidden], ckv_new [1, lora + rope])."""
    wproj = torch.cat([weight_q_nope.T, weight_q_pe.T, weight_kv_nope.T,
                       weight_k_pe.T], dim=-1).contiguous()
    return deepseek_decoder_layer_fused(
        input, wproj, weight_uk, weight_uv, weight_o.T.contiguous(),
        ckv_cache, ckv_cache.shape[0], rms_input_weight, rms_ckv_weight, cos,
        sin, n_heads=n_heads, nope_dim=nope_dim, rope_dim=rope_dim,
        lora_rank=lora_rank, eps=eps, kernel_config=kernel_config)


def deepseek_decoder_layer_fused(input, wproj, weight_uk, weight_uv, wo_t,
                                 ckv_cache, seq_len, rms_input_weight,
                                 rms_ckv_weight, cos, sin, n_heads: int = 16,
                                 nope_dim: int = 128, rope_dim: int = 64,
                                 lora_rank: int = 512, eps: float = 1e-6,
                                 kernel_config=None, softmax_scale=None):
    """One MLA layer with pre-fused weights (wproj [hidden, n_proj], wo_t
    [H*nope, hidden]); rows < ``seq_len`` of ``ckv_cache`` [cap, lora +
    rope, or that padded] attended, nothing appended.  Returns (output
    [1, hidden], ckv_new [1, lora + rope])."""
    what = "deepseek_decoder_layer_fused"
    kcfg = kernel_config or KernelConfig()
    h, nope, rope, lora = n_heads, nope_dim, rope_dim, lora_rank
    _refuse(what, (wproj, weight_uk, weight_uv, wo_t, rms_input_weight,
                   rms_ckv_weight), ckv_cache)
    hidden = input.shape[-1]
    _check_dims(what, wproj, weight_uk, weight_uv, wo_t, ckv_cache, hidden, h,
                nope, rope, lora)
    seq = int(seq_len)
    if not 0 <= seq <= ckv_cache.shape[0]:
        raise ValueError(f"seq_len {seq} outside the cache's "
                         f"{ckv_cache.shape[0]} rows")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(nope + rope)
    if input.device.type == "cpu":
        out, cur = mla_decode_plain(
            input, rms_input_weight, rms_ckv_weight, cos, sin, wproj,
            weight_uk, weight_uv, wo_t, ckv_cache, seq, n_heads=h,
            nope_dim=nope, rope_dim=rope, lora_rank=lora, eps=eps,
            softmax_scale=softmax_scale, split=MLA_SPLIT)
        return out, cur.to(input.dtype)[None]
    return _launch(what, input, rms_input_weight, rms_ckv_weight, cos, sin,
                   wproj, weight_uk, weight_uv, wo_t, ckv_cache, seq, 0,
                   False, h, nope, rope, lora, eps, softmax_scale, kcfg)


def deepseek_decoder_stack_layer(input, wproj_s, wuk_s, wuv_s, wo_s,
                                 ckv_cache, seq_len, layer_id, rms_in_s,
                                 rms_ckv_s, cos, sin, n_heads: int = 16,
                                 nope_dim: int = 128, rope_dim: int = 64,
                                 lora_rank: int = 512, eps: float = 1e-6,
                                 kernel_config=None, softmax_scale=None):
    """Layer ``layer_id`` of the stacks (wproj_s [L, hidden, n_proj], wuk_s
    [L, H, nope, lora], wuv_s [L, H, lora, nope], wo_s [L, H*nope, hidden],
    rms_in_s [L, hidden], rms_ckv_s [L, lora]) over rows < ``seq_len`` of
    ``ckv_cache`` [L, cap, round_up(lora + rope, 128)]; the current
    compressed row is written in place at row ``seq_len`` of that layer,
    zero in the pad columns.  Returns (output [1, hidden], ckv_cache)."""
    what = "deepseek_decoder_stack_layer"
    kcfg = kernel_config or KernelConfig()
    h, nope, rope, lora = n_heads, nope_dim, rope_dim, lora_rank
    _refuse(what, (wproj_s, wuk_s, wuv_s, wo_s, rms_in_s, rms_ckv_s),
            ckv_cache)
    hidden = input.shape[-1]
    _check_dims(what, wproj_s, wuk_s, wuv_s, wo_s, ckv_cache, hidden, h,
                nope, rope, lora)
    n_layers, cap, width = ckv_cache.shape
    if width != round_up(lora + rope, 128):
        raise ValueError(f"{what}: the cache's rows must be round_up(lora + "
                         f"rope, 128) = {round_up(lora + rope, 128)} wide, "
                         f"not {width}")
    seq, layer = int(seq_len), int(layer_id)
    if not 0 <= seq < cap or not 0 <= layer < n_layers:
        raise ValueError(f"seq_len {seq} / layer_id {layer} outside the "
                         f"cache {tuple(ckv_cache.shape)}")
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(nope + rope)
    if input.device.type == "cpu":
        out, cur = mla_decode_plain(
            input, rms_in_s[layer], rms_ckv_s[layer], cos, sin,
            wproj_s[layer], wuk_s[layer], wuv_s[layer], wo_s[layer],
            ckv_cache[layer], seq, n_heads=h, nope_dim=nope, rope_dim=rope,
            lora_rank=lora, eps=eps, softmax_scale=softmax_scale,
            split=MLA_SPLIT)
        ckv_cache[layer, seq] = F.pad(cur, (0, width - cur.numel())).to(
            ckv_cache.dtype)
        return out, ckv_cache
    out, _ = _launch(what, input, rms_in_s, rms_ckv_s, cos, sin, wproj_s,
                     wuk_s, wuv_s, wo_s, ckv_cache, seq, layer, True, h, nope,
                     rope, lora, eps, softmax_scale, kcfg)
    return out, ckv_cache
