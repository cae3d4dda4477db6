"""Sequence-parallel (+ tensor-parallel) fused decode over
``torch.distributed`` (twin of ``clusterfusion_tpu/parallel/sp_decode.py``).

The KV cache is cut over ``sp`` on its capacity (each rank owns a
contiguous ``capacity/sp`` slice of positions) and over ``tp`` on its kv
heads.  Per layer each rank runs the fused attention half in partials mode
(``_fused_decoder_layer(emit_partials=True)``, kernel 6): the residual
add, norm, QKV and rope, and flash-decode over its own rows, giving the
unnormalised per-head (acc, m, l) in the log2 domain.  The current token
is folded in by exactly one rank, the owner of position ``pos``.  The
states merge across sp as the reference's split-KV merge does,

    m* = max over sp of m;  l* = sum l * 2^(m - m*);  acc* = sum acc * 2^(m - m*)

(an empty shard has m = -1e30, l = 0: its weight 2^(m - m*) is 0).  Then
the O-projection runs plain on the merged heads and is reduced over tp;
the owner appends the token's K/V row; ``fused_add_rmsnorm_ref``, the FFN
and a reduce over tp finish the layer, as in JAX.  With int8 or int4
weights kernel 6 streams the quantized QKV in partials mode (int4: W4A8
or exact, as ``kcfg.int4_w4a8`` says); the O projection and the FFN run
the GEMVs' int8 instances (each head group's O partial scaled, then
summed) or their int4 ones (exact, the group scales along the O rows),
where JAX dequantizes ``wo_f`` and the FFN's weights: the same function,
and no bf16 copy of a weight (``parallel.decode``'s note).

Mistral's sliding window (``cfg.sliding_window``, pattern ``"all"``): the
window is defined on global positions, ``[pos + 1 - window, pos]``, and
each shard hands kernel 6 its bound in its own rows,
``shard_window_lo(pos, window, start)`` = ``pos + 1 - window - start`` (JAX's
``win_lo``).  Below 0 the whole slice lies in the window; at or above the
shard's ``seq_local`` none of it does: kernel 6 then walks no split and,
unless the shard owns ``pos`` and folds the token, gives the empty state,
which the merge weighs 0.  So a shard may be wholly below the window,
cut by it, inside it, the owner, or empty, and the merge is the one above.

An fp8 e4m3 cache (each rank's ``capacity/sp`` slice a plain tensor):
kernel 6's fp8 mode reads the rows, and the owner appends the bf16
``k_new``/``v_new`` cast to e4m3, as JAX's sp step casts its bf16 row (a
double rounding: the tp steps store e4m3 of the float32 row, so the two
kinds of step may store different bits for the same row).  An ``Int8KV``
pair raises kernel 6's refusal: JAX's sp step runs none.
"""

from __future__ import annotations

import torch

from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as model
from clusterfusion_tpu_torch.ops.decoder_layer import _fused_decoder_layer
from clusterfusion_tpu_torch.ops.reference import fused_add_rmsnorm_ref
from clusterfusion_tpu_torch.parallel.collective import (Stage,
                                                         cluster_reduce, pmax,
                                                         psum)
from clusterfusion_tpu_torch.parallel.decode import embed_and_rope, lm_logits
from clusterfusion_tpu_torch.parallel.mesh import Mesh
from clusterfusion_tpu_torch.parallel.sharding import Spec
from clusterfusion_tpu_torch.ops.quant import QuantizedTensor
from clusterfusion_tpu_torch.runtime.serving import batched_ffn, batched_o_dot


def cache_pspec_2d() -> Spec:
    """[L, kv_heads, capacity, head_dim]: heads on tp, sequence on sp."""
    return (None, "tp", "sp", None)


def shard_window_lo(pos: int, window: int, start: int):
    """The sliding window's bound in the rows of a sequence shard that
    starts at global position ``start``, for the token at ``pos``: ``pos +
    1 - window - start`` (negative: the whole shard lies in the window; at
    or above the shard's cached rows: none of it), or None without a
    window."""
    return pos + 1 - window - start if window else None


def make_sp_sharded_decode_step(cfg: LlamaConfig, mesh: Mesh,
                                kcfg: KernelConfig = KernelConfig()):
    """Build a (tp, sp)-sharded fused decode step:

    ``step(params, k_cache, v_cache, token, pos) ->
    (logits [vocab] f32, k_cache, v_cache)``

    with this rank's ``shard_params`` slices and caches cut by
    ``shard_cache(cache, mesh, cache_pspec_2d())`` ([L, kv_heads/tp,
    capacity/sp, hd], bf16 or fp8; the capacity must divide by sp);
    ``pos`` is the global number of cached tokens."""
    model._check_supported(cfg, "make_sp_sharded_decode_step")
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_

    @torch.no_grad()
    def step(params, k_cache, v_cache, token, pos):
        pos = int(pos)
        cap_l = k_cache.shape[2]                      # local slice length
        start = mesh.coords["sp"] * cap_l
        # tokens 0..pos-1 are cached; this rank holds [start, start+cap_l)
        seq_local = min(max(pos - start, 0), cap_l)
        fold = int(start <= pos < start + cap_l)
        pos_local = min(max(pos - start, 0), cap_l - 1)
        win_lo = shard_window_lo(pos, cfg.sliding_window, start)
        x, cos, sin = embed_and_rope(params, cfg, token, pos, k_cache.device)
        res = torch.zeros_like(x)
        lw = params["layers"]
        for l in range(cfg.n_layers):
            acc, ml, res, k_new, v_new = _fused_decoder_layer(
                x, res, lw["attn_norm"], cos, sin, lw["wqkv_f"], lw["wo_f"],
                k_cache, v_cache, seq_local, l, group=g, head_dim=hd,
                rope_style=cfg.rope_style, fuse_residual=True,
                eps=cfg.norm_eps, kcfg=kcfg, emit_partials=True,
                fold_current=fold, window=cfg.sliding_window,
                window_lo=win_lo)
            # the merge over sp, in the log2 domain as the kernel keeps it
            m, lsum = ml[0], ml[1]
            m_g = pmax(m, "sp", mesh=mesh)
            alpha = torch.exp2(m - m_g)
            l_g = psum(lsum * alpha, "sp", mesh=mesh)
            acc_g = psum(acc * alpha[:, None], "sp", mesh=mesh)
            o = (acc_g / l_g[:, None]).to(torch.bfloat16)
            wo = lw["wo_f"][l]
            if isinstance(wo, QuantizedTensor):
                attn = batched_o_dot(o.reshape(1, wo.shape[0], -1), wo)
            else:
                attn = model._oproj(o.reshape(1, -1), wo)
            attn = cluster_reduce(attn.to(x.dtype), "tp", Stage.ATTN,
                                  mesh=mesh)
            if fold:        # the owner appends the bf16 row (fp8: cast, as JAX)
                k_cache[l, :, pos_local] = k_new.to(k_cache.dtype)
                v_cache[l, :, pos_local] = v_new.to(v_cache.dtype)
            ffn_in, res = fused_add_rmsnorm_ref(attn, res, lw["ffn_norm"][l],
                                                cfg.norm_eps)
            h = batched_ffn(ffn_in, lw["w13"][l], lw["w2"][l], cfg.ffn_act)
            x = cluster_reduce(h.to(x.dtype), "tp", Stage.LINEAR, mesh=mesh)
        return lm_logits(params, x, res, cfg, mesh), k_cache, v_cache

    return step
