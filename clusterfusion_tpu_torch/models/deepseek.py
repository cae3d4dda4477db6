"""Functional PyTorch DeepSeek-V2 MLA model (twin of ``clusterfusion_tpu/models/deepseek.py``).

Parameters are a plain dict in the JAX tree's keys and layouts, stacked
over layers: ``wproj [L, hidden, n_proj]`` (q_nope | q_pe | ckv | k_pe
columns), ``wuk [L, H, nope, lora]``, ``wuv [L, H, lora, nope]``, ``wo_t
[L, H*nope, hidden]``, the dense (or shared-expert) SwiGLU ``w13 [L, 2,
hidden, f_pad]`` / ``w2 [L, f_pad, hidden]`` and, with ``n_experts > 0``,
``router [L, hidden, E]``, ``w13_e [L, E, 2, hidden, f_e]``, ``w2_e [L, E,
f_e, hidden]``.  The compressed cache is [L, capacity, round_up(lora +
rope, 128)], updated in place.

The fused decode step runs, per layer, ``deepseek_decoder_stack_layer``
(the MLA kernels, appending the row in place) and, for a dense FFN,
``fused_ffn`` with the residual add; with experts the FFN stays plain, as
in the JAX package.  The hidden state is carried in bf16 between layers.
The eager step (``fused=False``) and the prefill are plain float32 MLA.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from clusterfusion_tpu_torch.config import DeepSeekConfig, KernelConfig
from clusterfusion_tpu_torch.models.llama import _ffn
from clusterfusion_tpu_torch.ops._support import resolve_device, round_up
from clusterfusion_tpu_torch.ops.deepseek_layer import \
    deepseek_decoder_stack_layer
from clusterfusion_tpu_torch.ops.ffn import fused_ffn
from clusterfusion_tpu_torch.ops.moe import moe_ffn_decode, moe_ffn_dense
from clusterfusion_tpu_torch.ops.reference import rmsnorm_ref
from clusterfusion_tpu_torch.ops.rope import (apply_rope_neox,
                                              rope_tables_neox,
                                              rope_tables_yarn)

DeepSeekParams = Dict[str, Any]


def rope_table(cfg: DeepSeekConfig, max_pos: Optional[int] = None,
               device="cpu"):
    """Half-dim NEOX (cos, sin) tables [max_pos, rope_head_dim/2], float32
    (YaRN-scaled when cfg.yarn_factor > 1)."""
    mp = max_pos or cfg.max_seq_len
    if cfg.yarn_factor > 1.0:
        return rope_tables_yarn(
            cfg.rope_head_dim, mp, cfg.rope_theta, factor=cfg.yarn_factor,
            orig_max=cfg.yarn_orig_max, beta_fast=cfg.yarn_beta_fast,
            beta_slow=cfg.yarn_beta_slow, mscale=cfg.yarn_mscale,
            mscale_all_dim=cfg.yarn_mscale_all_dim, device=device)
    return rope_tables_neox(cfg.rope_head_dim, mp, cfg.rope_theta,
                            device=device)


def init_params(cfg: DeepSeekConfig, seed: int = 0,
                device=None) -> DeepSeekParams:
    """Random bf16 parameters, made on ``device`` (CUDA by default) from a
    ``torch.Generator`` seeded with ``seed``.  The dense FFN width is padded
    to a multiple of 1024, as the JAX package pads it."""
    dev = resolve_device(device)
    h, nope, lora = cfg.n_heads, cfg.nope_head_dim, cfg.kv_lora_rank
    hid, L, V = cfg.hidden_dim, cfg.n_layers, cfg.vocab_size
    f = round_up(cfg.ffn_dim, 1024)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf16 = torch.bfloat16

    def norm(shape, fan_in):
        t = torch.randn(shape, generator=gen, dtype=bf16, device=dev)
        return t.div_(torch.tensor(fan_in ** 0.5, dtype=bf16).item())

    def ones(*shape):
        return torch.ones(shape, dtype=bf16, device=dev)

    layers = {
        "wproj": norm((L, hid, cfg.n_proj), hid),
        "wuk": norm((L, h, nope, lora), nope),
        "wuv": norm((L, h, lora, nope), lora),
        "wo_t": norm((L, h * nope, hid), h * nope),
        "attn_norm": ones(L, hid),
        "ckv_norm": ones(L, lora),
        "w13": norm((L, 2, hid, f), hid),
        "w2": norm((L, f, hid), f),
        "ffn_norm": ones(L, hid),
    }
    if cfg.n_experts:
        E, fe = cfg.n_experts, cfg.moe_ffn_dim
        layers["router"] = norm((L, hid, E), hid)
        layers["w13_e"] = norm((L, E, 2, hid, fe), hid)
        layers["w2_e"] = norm((L, E, fe, hid), fe)
    return {
        "embed": norm((V, hid), hid),
        "layers": layers,
        "final_norm": ones(hid),
        "lm_head": norm((hid, V), hid),
    }


def init_cache(cfg: DeepSeekConfig, max_seq: Optional[int] = None,
               dtype=torch.bfloat16, device=None):
    """Zero compressed cache [L, capacity, round_up(lora + rope, 128)]: the
    JAX package's layout, so that caches compare column for column."""
    cap = max_seq or cfg.max_seq_len
    return torch.zeros((cfg.n_layers, cap, round_up(cfg.mla_head_dim, 128)),
                       dtype=dtype, device=resolve_device(device))


def _logits(xn: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """LM-head logits in float32: a bf16 product with float32 output on the
    card (no float32 copy of the head), the float32 product on the CPU."""
    if xn.device.type == "cpu":
        return xn.float() @ lm.float()
    return torch.mm(xn.reshape(-1, xn.shape[-1]), lm,
                    out_dtype=torch.float32).reshape(*xn.shape[:-1], -1)


def full_rope_table(cfg: DeepSeekConfig, device="cpu"):
    """Full-dim (cos|cos, sin|sin) tables [max_seq_len, rope_head_dim]: the
    form ``decode_step`` takes (its kernels read full-dim rows)."""
    c, s = rope_table(cfg, device=device)
    return torch.cat([c, c], dim=-1), torch.cat([s, s], dim=-1)


def _eager_mla(x, p, cache_l, pos: int, cos, sin, cfg: DeepSeekConfig):
    """Single-token float32 MLA over cache rows < pos plus the current one.
    x [1, hidden]; cache_l [cap, width]; cos/sin [rope/2].  Returns
    (attn_out [1, hidden], ckv_new [1, lora + rope]) in x.dtype."""
    h, nope, rope, lora = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, \
        cfg.kv_lora_rank
    xn = rmsnorm_ref(x, p["attn_norm"], cfg.norm_eps).float()
    proj = xn @ p["wproj"].float()
    qp_off = h * nope
    ckv_off = qp_off + h * rope
    kpe_off = ckv_off + lora
    q_nope = proj[0, :qp_off].reshape(h, nope)
    q_pe = apply_rope_neox(proj[0, qp_off:ckv_off].reshape(h, rope), cos, sin)
    ckv = proj[0, ckv_off:kpe_off]
    ckv = ckv * torch.rsqrt(torch.mean(ckv * ckv) + cfg.norm_eps) \
        * p["ckv_norm"].float()
    k_pe = apply_rope_neox(proj[0, kpe_off:], cos, sin)
    ckv_new = torch.cat([ckv, k_pe])[None]
    q = torch.cat([torch.einsum("hd,hdr->hr", q_nope, p["wuk"].float()), q_pe],
                  dim=-1)
    scale = cfg.softmax_scale
    cache_f = cache_l[:pos, :lora + rope].float()
    scores = q @ cache_f.T * scale
    s_cur = (q * ckv_new[0] * scale).sum(dim=-1, keepdim=True)
    probs = torch.softmax(torch.cat([scores, s_cur], dim=-1), dim=-1)
    o_lora = probs[:, :-1] @ cache_f[:, :lora] + probs[:, -1:] * ckv_new[0, :lora]
    o = torch.einsum("hr,hrd->hd", o_lora, p["wuv"].float())
    out = o.reshape(1, h * nope) @ p["wo_t"].float()
    return out.to(x.dtype), ckv_new.to(x.dtype)


def _moe(xn2, p, cfg: DeepSeekConfig, fn):
    return fn(xn2, p["router"], p["w13_e"], p["w2_e"], cfg.moe_top_k,
              norm_topk_prob=cfg.moe_norm_topk_prob,
              routed_scaling_factor=cfg.moe_routed_scaling)


@torch.no_grad()
def decode_step(params: DeepSeekParams, cache, token, pos: int,
                cfg: DeepSeekConfig, kcfg: KernelConfig = KernelConfig(),
                fused: bool = True, rope=None):
    """One decode step at position ``pos`` (``pos`` rows cached).  Appends
    the token's compressed row at ``pos`` in place and returns (logits
    [vocab] f32, cache).  ``rope``: the full-dim (cos, sin) tables
    [max_seq_len, rope_head_dim] on the cache's device, built here when not
    given (``decode_loop`` builds them once)."""
    pos = int(pos)
    dev = cache.device
    cos_t, sin_t = rope if rope is not None else full_rope_table(cfg, dev)
    cos, sin = cos_t[pos], sin_t[pos]
    half = cfg.rope_head_dim // 2
    if not torch.is_tensor(token):
        token = torch.tensor(token, dtype=torch.long, device=dev)
    x = params["embed"][token.reshape(1)]                 # [1, hidden]
    lw = params["layers"]
    mla = cfg.mla_head_dim
    for l in range(cfg.n_layers):
        if fused:
            attn, cache = deepseek_decoder_stack_layer(
                x, lw["wproj"], lw["wuk"], lw["wuv"], lw["wo_t"], cache, pos,
                l, lw["attn_norm"], lw["ckv_norm"], cos, sin,
                n_heads=cfg.n_heads, nope_dim=cfg.nope_head_dim,
                rope_dim=cfg.rope_head_dim, lora_rank=cfg.kv_lora_rank,
                eps=cfg.norm_eps, kernel_config=kcfg,
                softmax_scale=cfg.softmax_scale)
            if not cfg.n_experts and lw["w13"].shape[-1] % 128 == 0:
                y, h2 = fused_ffn(attn, x, lw["ffn_norm"], lw["w13"], lw["w2"],
                                  eps=cfg.norm_eps, kcfg=kcfg,
                                  fuse_residual=True, layer_id=l)
                x = h2 + y
                continue
        p = {k: v[l] for k, v in lw.items()}
        if not fused:
            attn, ckv_new = _eager_mla(x, p, cache[l], pos, cos[:half],
                                       sin[:half], cfg)
            cache[l, pos, :mla] = ckv_new[0].to(cache.dtype)
        x = x + attn
        xn2 = rmsnorm_ref(x, p["ffn_norm"], cfg.norm_eps)
        y = _ffn(xn2, p["w13"], p["w2"])                  # shared expert
        if cfg.n_experts:
            y = y + _moe(xn2, p, cfg, moe_ffn_decode)
        x = x + y
    xn = rmsnorm_ref(x, params["final_norm"], cfg.norm_eps)
    return _logits(xn[0], params["lm_head"]), cache


@torch.no_grad()
def prefill(params: DeepSeekParams, cache, tokens, cfg: DeepSeekConfig):
    """Plain batched prefill from position 0: fills cache rows 0..T-1 of
    every layer in place and returns (logits [T, vocab] f32, cache)."""
    dev = cache.device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    T = tokens.shape[0]
    h, nope, rope, lora = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, \
        cfg.kv_lora_rank
    cos_t, sin_t = rope_table(cfg, max(T, cfg.max_seq_len), dev)
    cos, sin = cos_t[:T], sin_t[:T]
    x = params["embed"][tokens]                            # [T, hidden]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
    lw = params["layers"]
    for l in range(cfg.n_layers):
        p = {k: v[l] for k, v in lw.items()}
        xn = rmsnorm_ref(x, p["attn_norm"], cfg.norm_eps).float()
        proj = xn @ p["wproj"].float()                     # [T, n_proj]
        qp_off = h * nope
        ckv_off = qp_off + h * rope
        kpe_off = ckv_off + lora
        q_nope = proj[:, :qp_off].reshape(T, h, nope)
        q_pe = apply_rope_neox(proj[:, qp_off:ckv_off].reshape(T, h, rope),
                               cos[:, None], sin[:, None])
        ckv = proj[:, ckv_off:kpe_off]
        ckv = ckv * torch.rsqrt(torch.mean(ckv * ckv, dim=-1, keepdim=True)
                                + cfg.norm_eps) * p["ckv_norm"].float()
        k_pe = apply_rope_neox(proj[:, kpe_off:], cos, sin)
        rows = torch.cat([ckv, k_pe], dim=-1)              # [T, mla]
        q = torch.cat([torch.einsum("thd,hdr->thr", q_nope, p["wuk"].float()),
                       q_pe], dim=-1)                      # [T, h, mla]
        scores = torch.einsum("thm,sm->hts", q, rows) * cfg.softmax_scale
        scores = scores.masked_fill(~mask[None], -1e30)
        probs = torch.softmax(scores, dim=-1)
        o_lora = torch.einsum("hts,sr->thr", probs, ckv)
        o = torch.einsum("thr,hrd->thd", o_lora, p["wuv"].float())
        x = x + (o.reshape(T, h * nope) @ p["wo_t"].float()).to(x.dtype)
        xn2 = rmsnorm_ref(x, p["ffn_norm"], cfg.norm_eps)
        y = _ffn(xn2, p["w13"], p["w2"])                  # shared expert
        if cfg.n_experts:
            y = y + _moe(xn2, p, cfg, moe_ffn_dense)
        x = x + y
        cache[l, :T, :lora + rope] = rows.to(cache.dtype)
        cache[l, :T, lora + rope:] = 0
    xn = rmsnorm_ref(x, params["final_norm"], cfg.norm_eps)
    return _logits(xn, params["lm_head"]), cache


@torch.no_grad()
def decode_loop(params: DeepSeekParams, cache, first_token, start_pos: int,
                cfg: DeepSeekConfig, n_steps: int, fused: bool = True,
                kcfg: KernelConfig = KernelConfig()):
    """Greedy-decode ``n_steps`` tokens; the tokens stay on the device
    between steps, so the host never waits on the card inside the loop.
    Returns (tokens [n_steps] long: the inputs' successors, cache)."""
    dev = cache.device
    rope = full_rope_table(cfg, dev)
    tok = torch.as_tensor(first_token, dtype=torch.long, device=dev)
    out = []
    for i in range(n_steps):
        logits, cache = decode_step(params, cache, tok, start_pos + i, cfg,
                                    kcfg, fused, rope)
        tok = torch.argmax(logits)
        out.append(tok)
    if not out:
        return torch.zeros(0, dtype=torch.long, device=dev), cache
    return torch.stack(out), cache


def generate_greedy(params: DeepSeekParams, cfg: DeepSeekConfig, prompt,
                    n_gen: int, fused: bool = True,
                    kcfg: KernelConfig = KernelConfig()):
    """Prefill + greedy decode on the parameters' device; returns the
    ``n_gen`` generated ids."""
    cache = init_cache(cfg, device=params["embed"].device)
    logits, cache = prefill(params, cache, prompt, cfg)
    first = torch.argmax(logits[-1])
    toks, _ = decode_loop(params, cache, first, len(prompt), cfg,
                          n_steps=n_gen - 1, fused=fused, kcfg=kcfg)
    return [int(first)] + toks.tolist()
