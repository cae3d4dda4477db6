"""Tensor-parallel fused decode over ``torch.distributed`` (twin of
``clusterfusion_tpu/parallel/decode.py``).

Per rank: ``kv_heads/tp`` heads of every attention weight and of the
caches, ``f_pad/tp`` FFN columns and ``vocab/tp`` LM-head columns
(``parallel.sharding``); the residual stream and the norms are replicated.
Per layer: the fused attention half (``_fused_decoder_layer``, kernel 6,
with the append in place), one all-reduce of the row-parallel O-projection
(``Stage.ATTN``), ``fused_add_rmsnorm`` (kernel 2), the FFN as plain
products (XLA's in JAX) and one all-reduce of the down projection
(``Stage.LINEAR``).  Then the final norm and the vocab-sharded LM head run
plain and the logits are gathered over tp.

``fused_collectives=True`` (twin of JAX's
``_make_fused_collective_decode_step``) runs the whole step as one call of
kernel 7 per rank with ``reduce_axis="tp"``: the two all-reduces of each
layer run inside its launch sequence (kernel 13), and so does its tail:
the final norm over the float32 hidden pair, the product of the rank's
LM-head columns, which pushes them to every rank, and kernel 14's wait,
which copies the ranks' shards out in rank order (8L+3 kernels a rank and
step, no plain call after them).  JAX runs the final norm and the LM head
outside its kernel; the logits are the same function.  No NCCL call runs
in that step.

Int8 and int4 weights (``ops.quant.QuantizedTensor`` leaves, sharded by
``shard_params``): kernel 6 takes the layer's quantized QKV and O (its
int8 mode, or its int4 modes, W4A8 or exact as ``kcfg.int4_w4a8`` says);
the FFN runs the GEMVs' int8 instances (``ops.gemv._ffn_int8``, the
serving step's) or their int4 ones (``_ffn_int4``, exact: JAX dequantizes
the FFN's int4 weights), and an int8 LM-head shard ``_gemv_int8`` (JAX
makes no int4 head), so the codes stream as they are and no bf16 copy of
a weight is made per call (JAX leaves these products to XLA; on the CPU
they run their plain twins).  The fused step hands the int8 or int4
stacks to kernel 7's mode 5.

8-bit KV caches, where JAX's steps run them: an fp8 e4m3 pair in both
kinds of step (kernel 6's fp8 mode appends e4m3 of the float32 row;
kernel 7's mode 5 the same), and an ``Int8KV`` pair (``shard_cache`` cuts
its rows and scale planes on the kv axis) only with
``fused_collectives=True``: kernel 7's mode 5 reads it and appends int8
codes and scales of the float32 row.  The step without it raises kernel
6's refusal before any launch, as JAX's kernel 6 takes no ``Int8KV``.

Mistral's sliding window (``cfg.sliding_window``, pattern ``"all"``): both
kinds of step pass it to their kernel, kernel 6 with its default bound
``pos + 1 - window`` (each rank holds every position of its kv heads) and
kernel 7's mode 5 through ``_fused_decoder_stack_gathered``; the rows below
the window are not read, and window 1 drops the split pass from mode 5's
sequence (7L+3 kernels a rank and step).

Each rank's caches are updated in place; the step returns the same
tensors (an ``Int8KV`` pair as the same pair).
"""

from __future__ import annotations

import torch

from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as model
from clusterfusion_tpu_torch.ops.decoder_layer import _fused_decoder_layer
from clusterfusion_tpu_torch.ops.gemv import _gemv_int8
from clusterfusion_tpu_torch.ops.quant import QuantizedTensor
from clusterfusion_tpu_torch.ops.reference import fused_add_rmsnorm_ref
from clusterfusion_tpu_torch.ops.rmsnorm import fused_add_rmsnorm
from clusterfusion_tpu_torch.ops.stack_kernel import \
    _fused_decoder_stack_gathered
from clusterfusion_tpu_torch.parallel.collective import (Stage,
                                                         cluster_gather,
                                                         cluster_reduce)
from clusterfusion_tpu_torch.parallel.mesh import Mesh
from clusterfusion_tpu_torch.runtime.serving import batched_ffn


def embed_and_rope(params, cfg: LlamaConfig, token, pos: int, dev):
    """(x [1, hidden], cos, sin [1, hd]) of ``token`` at ``pos``."""
    if not torch.is_tensor(token):
        token = torch.tensor(token, dtype=torch.long, device=dev)
    x = params["embed"][token.reshape(1).to(dev)]
    cos, sin = model.rope_row(cfg, pos, dev)
    return x, cos, sin


def lm_logits(params, x, residual, cfg: LlamaConfig, mesh: Mesh):
    """Final norm over x + residual, this rank's LM-head columns (an int8
    shard through ``_gemv_int8``), gathered over tp: logits [vocab]
    float32."""
    xn, _ = fused_add_rmsnorm_ref(x, residual, params["final_norm"],
                                  cfg.norm_eps)
    lm = params["lm_head"]
    if isinstance(lm, QuantizedTensor):
        logits = _gemv_int8(xn, lm.q, lm.s)[0]
    else:
        logits = model._lm_logits(xn[0], lm)
    return cluster_gather(logits, "tp", mesh=mesh)


def make_sharded_decode_step(cfg: LlamaConfig, mesh: Mesh,
                             kcfg: KernelConfig = KernelConfig(),
                             fused_collectives: bool = False):
    """Build a tp-sharded fused decode step:

    ``step(params, k_cache, v_cache, token, pos) ->
    (logits [vocab] f32, k_cache, v_cache)``

    with this rank's ``shard_params`` slices and ``shard_cache`` caches
    ([L, kv_heads/tp, capacity, hd]; bf16, fp8, or with
    ``fused_collectives`` an ``Int8KV`` pair); ``pos`` is the number of
    cached tokens.  ``fused_collectives=True``: the whole stack as one
    kernel sequence per rank with the all-reduces inside it (see
    above)."""
    model._check_supported(cfg, "make_sharded_decode_step")
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    if fused_collectives:
        return _make_fused_collective_decode_step(cfg, mesh, kcfg)

    @torch.no_grad()
    def step(params, k_cache, v_cache, token, pos):
        pos = int(pos)
        x, cos, sin = embed_and_rope(params, cfg, token, pos, k_cache.device)
        residual = torch.zeros_like(x)
        lw = params["layers"]
        for l in range(cfg.n_layers):
            # the residual add and the norm run inside the kernel on the
            # full (replicated) residual; the attention output is partial
            attn, residual, _, _, _, _ = _fused_decoder_layer(
                x, residual, lw["attn_norm"], cos, sin, lw["wqkv_f"],
                lw["wo_f"], k_cache, v_cache, pos, l, group=g, head_dim=hd,
                rope_style=cfg.rope_style, fuse_residual=True,
                eps=cfg.norm_eps, kcfg=kcfg, append_kv=True,
                window=cfg.sliding_window)
            attn = cluster_reduce(attn, "tp", Stage.ATTN, mesh=mesh)
            ffn_in, residual = fused_add_rmsnorm(attn, residual,
                                                 lw["ffn_norm"][l],
                                                 cfg.norm_eps)
            h = batched_ffn(ffn_in, lw["w13"][l], lw["w2"][l], cfg.ffn_act)
            x = cluster_reduce(h, "tp", Stage.LINEAR, mesh=mesh)
        return lm_logits(params, x, residual, cfg, mesh), k_cache, v_cache

    return step


def _make_fused_collective_decode_step(cfg: LlamaConfig, mesh: Mesh,
                                       kcfg: KernelConfig):
    """``make_sharded_decode_step(fused_collectives=True)``: one call of
    kernel 7 per rank per token with the tp reduces and the logits' gather
    inside it."""
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_

    @torch.no_grad()
    def step(params, k_cache, v_cache, token, pos):
        pos = int(pos)
        x, cos, sin = embed_and_rope(params, cfg, token, pos, k_cache.device)
        lw = params["layers"]
        # the hidden pair comes out of the last reduce the same on every
        # rank, so the final norm and the vocab-sharded LM head need no
        # collective before the logits' gather
        logits, _, k_cache, v_cache = _fused_decoder_stack_gathered(
            x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"], k_cache, v_cache, pos, group=g,
            head_dim=hd, rope_style=cfg.rope_style, eps=cfg.norm_eps,
            final_norm=params["final_norm"], lm_head=params["lm_head"],
            reduce_axis="tp", mesh=mesh, kcfg=kcfg,
            window=cfg.sliding_window)
        return logits[0], k_cache, v_cache

    return step
