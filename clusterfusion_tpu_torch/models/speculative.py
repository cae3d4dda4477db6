"""Greedy speculative decoding (twin of
``clusterfusion_tpu/models/speculative.py``): a draft model proposes
``n_draft`` tokens, the target scores them all in one forward
(``verify_step``, an n-row decode at position ``pos``), and the longest
agreeing prefix plus one bonus token is emitted.

Cache discipline, and why there is no rollback: both caches are
append-by-position and attention reads only rows below each query's
position.  After accepting ``m`` of ``n`` drafts at base position ``pos``,
rows ``pos .. pos+m`` hold the emitted tokens' K/V; the rows of rejected
drafts sit above ``pos+m`` and are overwritten by the next round's writes
before any query reaches them.

Greedy acceptance means the emitted stream is the target's own greedy
decode under the verify step's numerics: each token is the argmax of the
target's logits given the true emitted prefix.

The JAX package scans the rounds on the device.  Here the rounds are a
host loop: the kernels take ``pos`` as a host int, so each round waits for
the card once, to read how many drafts were accepted.  Inside a round the
draft tokens stay on the device.
"""

from __future__ import annotations

import math

import torch

from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models.llama import (
    LlamaParams, _apply_rope, _check_supported, _ffn, _lm_logits, _oproj,
    _qkv_eager, decode_step, rope_rows)
from clusterfusion_tpu_torch.ops.quant import (cache_read_layer,
                                               cache_write_layer)
from clusterfusion_tpu_torch.ops.reference import fused_add_rmsnorm_ref
from clusterfusion_tpu_torch.ops.stack_kernel import _vocab_block
from clusterfusion_tpu_torch.ops.stack_verify import fused_verify_stack


def _eager_verify_layer(x, residual, p, l, k_cache, v_cache, pos, cos, sin,
                        cfg: LlamaConfig):
    """One layer of the eager n-row verify (``speculative.py:131-185`` of
    the JAX package).  Unlike the one-token eager layer, the softmax
    probabilities enter the p.V product in float32.  An 8-bit cache is
    appended and read as the one-token eager layer appends and reads it
    (the n rows attended as stored; JAX's eager verify takes fp8, and its
    update cannot take an ``Int8KV`` pair).  A sliding window masks each
    row t below its own bound ``pos + t + 1 - window``."""
    n = x.shape[0]
    hd = cfg.head_dim_
    xn, residual = fused_add_rmsnorm_ref(x, residual, p["attn_norm"][l],
                                         cfg.norm_eps)
    q, k, v = _qkv_eager(xn[None], p["wqkv_f"][l], cfg)   # q [1,n,kv,g,hd]
    q = _apply_rope(q, cos[..., None, None, :], sin[..., None, None, :],
                    cfg.rope_style)
    k = _apply_rope(k, cos[..., None, :], sin[..., None, :], cfg.rope_style)
    cache_write_layer(k_cache, l, k[0].transpose(0, 1), pos)
    cache_write_layer(v_cache, l, v[0].transpose(0, 1), pos)
    kl = cache_read_layer(k_cache, l, pos + n)  # later rows are masked out
    vl = cache_read_layer(v_cache, l, pos + n)
    scores = torch.einsum("tkgd,ksd->kgts", q[0].float(), kl) / math.sqrt(hd)
    qpos = pos + torch.arange(n, device=x.device)[:, None]
    kpos = torch.arange(pos + n, device=x.device)[None, :]
    live = kpos <= qpos
    if cfg.sliding_window:
        live = live & (kpos > qpos - cfg.sliding_window)
    scores = scores.masked_fill(~live, -1e30)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("kgts,ksd->tkgd", probs, vl).to(x.dtype)
    attn = _oproj(o.reshape(n, -1), p["wo_f"][l])
    xn2, residual = fused_add_rmsnorm_ref(attn, residual, p["ffn_norm"][l],
                                          cfg.norm_eps)
    return _ffn(xn2, p["w13"][l], p["w2"][l], cfg.ffn_act), residual


@torch.no_grad()
def verify_step(params: LlamaParams, k_cache, v_cache, tokens, pos: int,
                cfg: LlamaConfig, kcfg: KernelConfig = KernelConfig(),
                fused: bool = True):
    """Score ``n`` tokens at positions ``pos .. pos+n-1`` in one forward,
    appending their K/V in place.  tokens: [n] (the last emitted token
    followed by the draft proposals).  Returns (logits [n, vocab] f32,
    k_cache, v_cache).

    fused=True: one ``fused_verify_stack`` call (final norm and LM head
    inside it when the vocab has a 128-aligned block); fused=False: the
    eager oracle, n rows wide.  Head dims that are not a multiple of 128
    take the eager path, as in the JAX package.  A sliding window runs in
    both (kernel 8's window)."""
    _check_supported(cfg, "verify_step")
    pos = int(pos)
    dev = k_cache.device
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev).reshape(-1)
    n = tokens.shape[0]
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    if hd % 128:
        fused = False
    cos, sin = rope_rows(cfg, pos, n, dev)                       # [n, hd]
    x = params["embed"][tokens]                                  # [n, hidden]
    lw = params["layers"]
    if fused:
        common = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                      eps=cfg.norm_eps, kcfg=kcfg, window=cfg.sliding_window)
        if _vocab_block(cfg.vocab_size) > 0:
            logits, _, k_cache, v_cache = fused_verify_stack(
                x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
                lw["wo_f"], lw["w13"], lw["w2"], k_cache, v_cache, pos,
                final_norm=params["final_norm"], lm_head=params["lm_head"],
                **common)
            return logits, k_cache, v_cache
        x, residual, k_cache, v_cache = fused_verify_stack(
            x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"], k_cache, v_cache, pos, **common)
    else:
        if pos < 0 or pos + n > k_cache.shape[2]:
            raise ValueError(f"rows {pos}..{pos + n - 1} outside the cache "
                             f"capacity {k_cache.shape[2]}")
        residual = torch.zeros_like(x)
        for l in range(cfg.n_layers):
            x, residual = _eager_verify_layer(x, residual, lw, l, k_cache,
                                              v_cache, pos, cos, sin, cfg)
    xn, _ = fused_add_rmsnorm_ref(x, residual, params["final_norm"],
                                  cfg.norm_eps)
    return _lm_logits(xn, params["lm_head"]), k_cache, v_cache


def _spec_round(params, draft_params, tok, pos: int, kc_t, vc_t, kc_d, vc_d,
                cfg: LlamaConfig, draft_cfg: LlamaConfig, n_draft: int,
                kcfg: KernelConfig, draft_fused: bool, target_fused: bool):
    """One speculative round from the last emitted token ``tok`` (a 0-d
    device tensor) at ``pos``.  Returns (targets [n_draft+1] on the device,
    m: the drafts accepted, read back to the host)."""
    # n_draft + 1 draft steps: the extra one feeds the last proposal, so
    # that on full acceptance the draft cache holds its row at pos+n_draft
    t = tok
    drafts = []
    for i in range(n_draft + 1):
        lg, kc_d, vc_d = decode_step(draft_params, kc_d, vc_d, t, pos + i,
                                     draft_cfg, kcfg, draft_fused)
        t = torch.argmax(lg)
        drafts.append(t)
    drafts = torch.stack(drafts[:n_draft])
    # the target scores [tok, d1..dn] in one forward -> t1..t_{n+1}
    vtoks = torch.cat([tok.reshape(1), drafts])
    logits, kc_t, vc_t = verify_step(params, kc_t, vc_t, vtoks, pos, cfg,
                                     kcfg, target_fused)
    targets = torch.argmax(logits, dim=-1)
    # longest agreeing prefix: drafts[:m] == targets[:m]; emit targets[:m+1]
    eq = (drafts == targets[:-1]).long()
    m = int(torch.cumprod(eq, dim=0).sum())
    return targets, m


@torch.no_grad()
def spec_decode_loop(params, k_cache, v_cache, draft_params, kd_cache,
                     vd_cache, first_token, start_pos: int,
                     cfg: LlamaConfig, draft_cfg: LlamaConfig,
                     kcfg: KernelConfig = KernelConfig(), n_draft: int = 4,
                     n_rounds: int = 16, draft_fused: bool = True,
                     target_fused: bool = True):
    """``n_rounds`` rounds of draft + verify.  The draft's cache must be
    prefilled with the same prompt.  Returns (targets [n_rounds,
    n_draft+1] on the device, counts [n_rounds] on the host, target caches,
    draft caches); round r emits ``targets[r, :counts[r]]``."""
    tok = torch.as_tensor(first_token, dtype=torch.long,
                          device=k_cache.device).reshape(())
    pos = int(start_pos)
    all_targets, counts = [], []
    for _ in range(n_rounds):
        targets, m = _spec_round(params, draft_params, tok, pos, k_cache,
                                 v_cache, kd_cache, vd_cache, cfg, draft_cfg,
                                 n_draft, kcfg, draft_fused, target_fused)
        all_targets.append(targets)
        counts.append(m + 1)
        tok = targets[m]
        pos += m + 1
    return (torch.stack(all_targets), torch.tensor(counts), k_cache, v_cache,
            kd_cache, vd_cache)


def flatten_rounds(targets, counts, max_tokens=None):
    """[rounds, n+1] targets + per-round counts -> the emitted token list
    (optionally cut to ``max_tokens``)."""
    out = []
    for r in range(targets.shape[0]):
        out.extend(int(t) for t in targets[r, : int(counts[r])])
    return out[:max_tokens] if max_tokens is not None else out
