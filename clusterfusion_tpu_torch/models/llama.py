"""Functional PyTorch Llama (twin of ``clusterfusion_tpu/models/llama.py``).

Parameters are a plain dict in the JAX tree's keys and layouts: weights in
the fused, head-grouped kernel layout (``wqkv_f [L, G, hidden,
hg*(g+2)*hd]``, ``wo_f [L, G, hg*g*hd, hidden]``, ``w13 [L, 2, hidden,
f_pad]``, ``w2 [L, f_pad, hidden]``), stacked over layers, so that one
parameter tree drives both packages.

Prefill runs ``flash_prefill_attention`` once per layer (``flash=True``)
or the float32 eager oracle; the projections and the FFN around it are
plain matrix products.  The fused decode step is one
``fused_decoder_stack`` call per token with the final norm and LM head
inside it; the eager step follows the JAX package's eager layer.

Unlike the JAX package, whose functions return new caches, the caches are
updated in place here: every function that takes ``k_cache``/``v_cache``
writes the new rows into those tensors and returns the same tensors.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.ops._support import (glu_act, resolve_device,
                                                  round_up)
from clusterfusion_tpu_torch.ops.decoder_layer import fuse_qkv_o_for_kernel
from clusterfusion_tpu_torch.ops.flash_prefill import flash_prefill_attention
from clusterfusion_tpu_torch.ops.reference import (fused_add_rmsnorm_ref,
                                                   rmsnorm_ref)
from clusterfusion_tpu_torch.ops.rope import (apply_rope_gptj, apply_rope_neox,
                                              rope_inv_freq, rope_tables_gptj,
                                              rope_tables_neox)
from clusterfusion_tpu_torch.ops.stack_kernel import (_vocab_block,
                                                      fused_decoder_stack)

LlamaParams = Dict[str, Any]


# --------------------------------------------------------------------------
# Parameter construction
# --------------------------------------------------------------------------


def padded_ffn_dim(cfg: LlamaConfig) -> int:
    """FFN dim zero-padded to a multiple of 1024 (zero gate/up columns and
    zero w2 rows are exact no-ops)."""
    return round_up(cfg.ffn_dim, 1024)


def default_head_group(cfg: LlamaConfig) -> int:
    """KV heads per group in the fused bf16 weight layout (4, or the largest
    divisor of kv_heads below it), as the JAX package picks for bf16."""
    hg = min(4, cfg.kv_heads)
    while cfg.kv_heads % hg:
        hg -= 1
    return hg


def fuse_attention_weights(wq, wk, wv, wo, cfg: LlamaConfig,
                           head_group: Optional[int] = None):
    """torch.nn.Linear-layout projections ([out, in]: wq [heads*hd, hidden],
    wk/wv [kv*hd, hidden], wo [hidden, heads*hd]) -> (wqkv_f [G, hidden,
    hg*(g+2)*hd], wo_f [G, hg*g*hd, hidden])."""
    kv, g, hd, hidden = cfg.kv_heads, cfg.n_heads // cfg.kv_heads, \
        cfg.head_dim_, cfg.hidden_dim
    hg = head_group or default_head_group(cfg)
    q = wq.reshape(kv, g, hd, hidden).permute(0, 3, 1, 2).reshape(kv, hidden, g * hd)
    k = wk.reshape(kv, hd, hidden).permute(0, 2, 1)
    v = wv.reshape(kv, hd, hidden).permute(0, 2, 1)
    wqkv_per_head = torch.cat([q, k, v], dim=-1)
    wo_per_head = wo.t().reshape(kv, g * hd, hidden)
    return fuse_qkv_o_for_kernel(wqkv_per_head, wo_per_head, kv, g, hd, hg)


def init_params(cfg: LlamaConfig, seed: int = 0,
                head_group: Optional[int] = None, device=None) -> LlamaParams:
    """Random bf16 parameters in the fused layout, made on ``device``
    (CUDA by default) from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    kv, g, hd = cfg.kv_heads, cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    h, L, V = cfg.hidden_dim, cfg.n_layers, cfg.vocab_size
    f = padded_ffn_dim(cfg)
    hg = head_group or default_head_group(cfg)
    G = kv // hg
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf16 = torch.bfloat16

    def norm(shape, fan_in):
        # made directly in bf16 (an f32 intermediate would double the
        # device memory at 7B); the divisor is rounded to bf16 as in JAX
        t = torch.randn(shape, generator=gen, dtype=bf16, device=dev)
        return t.div_(torch.tensor(math.sqrt(fan_in), dtype=bf16).item())

    return {
        "embed": norm((V, h), h),
        "layers": {
            "wqkv_f": norm((L, G, h, hg * (g + 2) * hd), h),
            "wo_f": norm((L, G, hg * g * hd, h), g * hd),
            "w13": norm((L, 2, h, f), h),
            "w2": norm((L, f, h), f),
            "attn_norm": torch.ones((L, h), dtype=bf16, device=dev),
            "ffn_norm": torch.ones((L, h), dtype=bf16, device=dev),
        },
        "final_norm": torch.ones((h,), dtype=bf16, device=dev),
        "lm_head": norm((h, V), h),
    }


def _check_supported(cfg: LlamaConfig) -> None:
    if (cfg.sliding_window or cfg.qkv_bias or cfg.sandwich_norms
            or cfg.attn_logit_softcap or cfg.final_logit_softcap
            or cfg.ffn_act != "silu"):
        raise NotImplementedError(
            "sliding window, QKV bias, sandwich norms, softcaps and GeGLU "
            "are not ported yet")


def rope_table(cfg: LlamaConfig, max_pos: Optional[int] = None,
               device="cpu"):
    """Full-dim float32 (cos, sin) tables [max_pos, head_dim] in the layout
    the decode kernel takes for cfg.rope_style."""
    hd = cfg.head_dim_
    max_pos = max_pos or cfg.max_seq_len
    l3 = cfg.llama3_scaling
    if cfg.rope_style == "neox":
        c, s = rope_tables_neox(hd, max_pos, cfg.rope_theta, l3, device)
        return torch.cat([c, c], dim=-1), torch.cat([s, s], dim=-1)
    return rope_tables_gptj(hd, max_pos, cfg.rope_theta, l3, device)


def rope_rows(cfg: LlamaConfig, pos: int, n: int, device="cpu"):
    """Rows ``pos .. pos+n-1`` of :func:`rope_table` as ([n, hd], [n, hd]),
    computed alone (the same angles, without building the whole table)."""
    inv_freq = rope_inv_freq(cfg.head_dim_, cfg.rope_theta,
                             cfg.llama3_scaling)
    a = torch.from_numpy(
        np.outer(np.arange(pos, pos + n), inv_freq).astype(np.float32))
    c, s = torch.cos(a), torch.sin(a)
    if cfg.rope_style == "neox":
        c, s = torch.cat([c, c], dim=-1), torch.cat([s, s], dim=-1)
    else:
        c = torch.repeat_interleave(c, 2, dim=-1)
        s = torch.repeat_interleave(s, 2, dim=-1)
    return c.to(device), s.to(device)


def rope_row(cfg: LlamaConfig, pos: int, device="cpu"):
    """Row ``pos`` of :func:`rope_table` as ([1, hd], [1, hd])."""
    return rope_rows(cfg, pos, 1, device)


def init_cache(cfg: LlamaConfig, max_seq: Optional[int] = None, device=None):
    """Zero-filled bf16 caches [L, kv_heads, capacity, head_dim] x2."""
    dev = resolve_device(device)
    cap = max_seq or cfg.max_seq_len
    shape = (cfg.n_layers, cfg.kv_heads, cap, cfg.head_dim_)
    return (torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            torch.zeros(shape, dtype=torch.bfloat16, device=dev))


# --------------------------------------------------------------------------
# Shared pieces
# --------------------------------------------------------------------------


def _mm(x: torch.Tensor, w: torch.Tensor, out_f32: bool = False):
    """bf16 x @ w with float32 accumulation.  On the CPU the product runs in
    float32 (exact products, as XLA's preferred_element_type=f32); on CUDA
    it is cuBLAS's bf16 product, which accumulates in float32 and rounds
    the result to bf16."""
    if x.device.type == "cpu":
        y = x.float() @ w.float()
        return y if out_f32 else y.to(x.dtype)
    y = x @ w
    return y.float() if out_f32 else y


def _lm_logits(xn: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """LM-head logits in float32: the float32 product on the CPU, a bf16
    product with float32 output on the card (no float32 copy of the
    head)."""
    if xn.device.type == "cpu":
        return xn.float() @ lm.float()
    return torch.mm(xn.reshape(-1, xn.shape[-1]), lm,
                    out_dtype=torch.float32).reshape(*xn.shape[:-1], -1)


def _ffn(x, w13, w2, act: str = "silu"):
    """SwiGLU with float32 gate/up, bf16 activation and bf16 output."""
    y = torch.stack([_mm(x, w13[0], out_f32=True),
                     _mm(x, w13[1], out_f32=True)], dim=-2)
    a = glu_act(y[..., 0, :], y[..., 1, :], act).to(x.dtype)
    return _mm(a, w2)


def _qkv_eager(x, wqkv_f, cfg: LlamaConfig):
    """x [.., T, h] -> q [.., T, kv, g, hd], k/v [.., T, kv, hd] (bf16)
    from the head-grouped layout [G, h, hg*(g+2)*hd]."""
    g, hd, kv = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.kv_heads
    G, h, C = wqkv_f.shape
    y = _mm(x, wqkv_f.permute(1, 0, 2).reshape(h, G * C))
    y = y.reshape(*y.shape[:-1], kv, (g + 2) * hd)
    q = y[..., : g * hd].reshape(*y.shape[:-1], g, hd)
    return q, y[..., g * hd:(g + 1) * hd], y[..., (g + 1) * hd:]


def _apply_rope(x, cos, sin, style):
    if style == "neox":
        hd = x.shape[-1]
        return apply_rope_neox(x, cos[..., : hd // 2], sin[..., : hd // 2])
    return apply_rope_gptj(x, cos, sin)


def _oproj(o, wo_f):
    """o [.., kv*g*hd] (bf16, head-major) @ wo_f [G, hg*g*hd, hidden]."""
    G, R, hidden = wo_f.shape
    return _mm(o, wo_f.reshape(G * R, hidden))


# --------------------------------------------------------------------------
# Prefill
# --------------------------------------------------------------------------


@torch.no_grad()
def prefill_chunk(params: LlamaParams, k_cache, v_cache, tokens, cfg: LlamaConfig,
                  pos0: int = 0, flash: bool = True,
                  kcfg: KernelConfig = KernelConfig()):
    """Process tokens [T] at positions pos0..pos0+T-1, filling the caches in
    place (the first ``pos0`` positions must be filled).  Returns
    (logits [T, vocab] f32, k_cache, v_cache)."""
    _check_supported(cfg)
    dev = k_cache.device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    T = tokens.shape[0]
    kv, g, hd = cfg.kv_heads, cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    cos_t, sin_t = rope_table(cfg, max(pos0 + T, cfg.max_seq_len), dev)
    cos, sin = cos_t[pos0:pos0 + T][None], sin_t[pos0:pos0 + T][None]
    lw = params["layers"]
    h = params["embed"][tokens][None]                      # [1, T, hidden]
    for l in range(cfg.n_layers):
        xn = rmsnorm_ref(h, lw["attn_norm"][l], cfg.norm_eps)
        q, k, v = _qkv_eager(xn, lw["wqkv_f"][l], cfg)    # q [1,T,kv,g,hd]
        q = _apply_rope(q, cos[..., None, None, :], sin[..., None, None, :],
                        cfg.rope_style)                    # float32
        k = _apply_rope(k, cos[..., None, :], sin[..., None, :], cfg.rope_style)
        k_new = k[0].transpose(0, 1).to(k_cache.dtype)     # [kv, T, hd]
        v_new = v[0].transpose(0, 1).to(v_cache.dtype)
        k_cache[l, :, pos0:pos0 + T] = k_new
        v_cache[l, :, pos0:pos0 + T] = v_new
        if flash:
            q4 = q[0].permute(1, 0, 2, 3).to(torch.bfloat16).contiguous()
            # the cache's layer is read in place (rows hd apart)
            o4 = flash_prefill_attention(
                q4, k_cache[l, :, :pos0 + T], v_cache[l, :, :pos0 + T],
                q_offset=pos0, kcfg=kcfg)
            o = o4.permute(1, 0, 2, 3)[None]               # [1,T,kv,g,hd]
        else:
            # float32 oracle over the full score matrix; the chunk's own
            # keys enter unrounded, as in the JAX package
            k_ctx = torch.cat([k_cache[l, :, :pos0].float(),
                               k[0].transpose(0, 1).float()], dim=1)
            v_ctx = v_cache[l, :, :pos0 + T]
            scale = 1.0 / math.sqrt(hd)
            scores = torch.einsum("btkgd,ksd->bkgts", q.float(),
                                  k_ctx.float()) * scale
            qpos = pos0 + torch.arange(T, device=dev)[:, None]
            kpos = torch.arange(pos0 + T, device=dev)[None, :]
            scores = scores.masked_fill(~(kpos <= qpos), -1e30)
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum("bkgts,ksd->btkgd", probs,
                             v_ctx.float()).to(h.dtype)
        attn = _oproj(o.reshape(1, T, kv * g * hd).to(h.dtype), lw["wo_f"][l])
        h = h + attn
        xn2 = rmsnorm_ref(h, lw["ffn_norm"][l], cfg.norm_eps)
        h = h + _ffn(xn2, lw["w13"][l], lw["w2"][l], cfg.ffn_act)
    xn = rmsnorm_ref(h, params["final_norm"], cfg.norm_eps)
    return _lm_logits(xn[0], params["lm_head"]), k_cache, v_cache


def prefill(params: LlamaParams, k_cache, v_cache, tokens, cfg: LlamaConfig,
            flash: bool = True, kcfg: KernelConfig = KernelConfig()):
    """Process a whole prompt from position 0, filling the caches in place.
    Returns (logits [T, vocab], k_cache, v_cache)."""
    return prefill_chunk(params, k_cache, v_cache, tokens, cfg, pos0=0,
                         flash=flash, kcfg=kcfg)


# --------------------------------------------------------------------------
# Decode step
# --------------------------------------------------------------------------


def _eager_layer(x, residual, p, l, k_cache, v_cache, pos, cos, sin,
                 cfg: LlamaConfig):
    """One layer of the eager decode step (``llama.py:560-603`` of the JAX
    package): rounds the hidden pair to bf16 every layer."""
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    xn, residual = fused_add_rmsnorm_ref(x, residual, p["attn_norm"][l],
                                         cfg.norm_eps)
    q, k, v = _qkv_eager(xn[None], p["wqkv_f"][l], cfg)   # q [1,1,kv,g,hd]
    q = _apply_rope(q, cos[0], sin[0], cfg.rope_style)
    k = _apply_rope(k, cos[0], sin[0], cfg.rope_style)
    k_cache[l, :, pos] = k[0, 0].to(k_cache.dtype)
    v_cache[l, :, pos] = v[0, 0].to(v_cache.dtype)
    kl = k_cache[l, :, :pos + 1].float()          # rows > pos are masked out
    vl = v_cache[l, :, :pos + 1]
    scores = torch.einsum("kgd,ksd->kgs", q[0, 0].float(), kl) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("kgs,ksd->kgd", probs.float(), vl.float()).to(x.dtype)
    attn = _oproj(o.reshape(1, -1), p["wo_f"][l])
    xn2, residual = fused_add_rmsnorm_ref(attn, residual, p["ffn_norm"][l],
                                          cfg.norm_eps)
    return _ffn(xn2, p["w13"][l], p["w2"][l], cfg.ffn_act), residual


@torch.no_grad()
def decode_step(params: LlamaParams, k_cache, v_cache, token, pos: int,
                cfg: LlamaConfig, kcfg: KernelConfig = KernelConfig(),
                fused: bool = True):
    """One decode step at position ``pos`` (``pos`` tokens cached).  token:
    int or 0-d tensor.  Appends the token's K/V at ``pos`` in place and
    returns (logits [vocab] f32, k_cache, v_cache).

    fused=True: one ``fused_decoder_stack`` call (final norm and LM head
    inside it when the vocab has a 128-aligned block); fused=False: the
    eager layer loop."""
    _check_supported(cfg)
    pos = int(pos)
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    dev = k_cache.device
    cos, sin = rope_row(cfg, pos, dev)
    if not torch.is_tensor(token):
        token = torch.tensor(token, dtype=torch.long, device=dev)
    x = params["embed"][token.reshape(1)]                 # [1, hidden]
    lw = params["layers"]
    if fused:
        common = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                      eps=cfg.norm_eps, kcfg=kcfg)
        if _vocab_block(cfg.vocab_size) > 0:
            logits, _, k_cache, v_cache = fused_decoder_stack(
                x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
                lw["wo_f"], lw["w13"], lw["w2"], k_cache, v_cache, pos,
                final_norm=params["final_norm"], lm_head=params["lm_head"],
                **common)
            return logits[0], k_cache, v_cache
        x, residual, k_cache, v_cache = fused_decoder_stack(
            x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"], k_cache, v_cache, pos, **common)
    else:
        residual = torch.zeros_like(x)
        for l in range(cfg.n_layers):
            x, residual = _eager_layer(x, residual, lw, l, k_cache, v_cache,
                                       pos, cos, sin, cfg)
    xn, _ = fused_add_rmsnorm_ref(x, residual, params["final_norm"],
                                  cfg.norm_eps)
    return _lm_logits(xn[0], params["lm_head"]), k_cache, v_cache


@torch.no_grad()
def decode_loop(params: LlamaParams, k_cache, v_cache, first_token,
                start_pos: int, cfg: LlamaConfig,
                kcfg: KernelConfig = KernelConfig(), fused: bool = True,
                n_steps: int = 32):
    """Greedy-decode ``n_steps`` tokens.  The tokens stay on the device
    between steps, so the host never waits on the card inside the loop.
    Returns (tokens [n_steps] long: the inputs' successors, k_cache,
    v_cache)."""
    dev = k_cache.device
    tok = torch.as_tensor(first_token, dtype=torch.long, device=dev)
    out = []
    for i in range(n_steps):
        logits, k_cache, v_cache = decode_step(params, k_cache, v_cache, tok,
                                               start_pos + i, cfg, kcfg,
                                               fused)
        tok = torch.argmax(logits)
        out.append(tok)
    return torch.stack(out), k_cache, v_cache
