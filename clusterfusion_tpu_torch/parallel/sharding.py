"""Which axis of each parameter and cache is cut over which mesh axis
(twin of ``clusterfusion_tpu/parallel/sharding.py``).

Megatron-style tensor parallelism on the fused layouts, as in JAX:

- ``wqkv_f [L, G, hidden, hg*(g+2)*hd]`` and ``wo_f [L, G, hg*g*hd,
  hidden]`` are cut on their head-group axis G over tp: each rank computes
  its heads end to end (column-parallel QKV) and its partial O-projection
  (row-parallel, summed by one all-reduce);
- ``w13 [L, 2, hidden, f_pad]`` on its last axis and ``w2 [L, f_pad,
  hidden]`` on its rows: the gate and up columns of one rank match, and the
  zero columns of the padded FFN land on the last rank as exact no-ops;
- ``lm_head [hidden, vocab]`` on its columns (vocab-sharded logits);
- the KV caches ``[L, kv_heads, capacity, hd]`` on their kv heads over tp
  and, for the sequence-parallel step, on their capacity over sp.

A spec is a tuple with one entry per tensor axis: the mesh axis that cuts
it, or None.  ``shard_params`` and ``shard_cache`` return this rank's
slices.  A slice that is the whole tensor is the tensor itself (a view, no
copy); any other slice is made contiguous, a copy this rank owns.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from clusterfusion_tpu_torch.config import LlamaConfig
from clusterfusion_tpu_torch.models import llama as model
from clusterfusion_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]


def param_pspecs(cfg: LlamaConfig, tp: int) -> Dict[str, Any]:
    """The spec tree matching the parameter tree of ``models.llama``."""
    if cfg.kv_heads % tp:
        raise ValueError(f"tp={tp} must divide kv_heads={cfg.kv_heads}")
    if cfg.ffn_dim % tp:
        raise ValueError(f"tp={tp} must divide ffn_dim={cfg.ffn_dim}")
    return {
        "embed": (None, None),
        "layers": {
            "wqkv_f": (None, "tp", None, None),
            "wo_f": (None, "tp", None, None),
            "w13": (None, None, None, "tp"),
            "w2": (None, "tp", None),
            "attn_norm": (None, None),
            "ffn_norm": (None, None),
        },
        "final_norm": (None,),
        "lm_head": (None, "tp"),
    }


def cache_pspec() -> Spec:
    """[L, kv_heads, capacity, head_dim]: heads on tp."""
    return (None, "tp", None, None)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} does not fit a {t.dim()}-d tensor")
    out = t
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = mesh.shape[axis]
        if t.shape[dim] % n:
            raise ValueError(f"axis {dim} of {tuple(t.shape)} does not "
                             f"divide over {axis}={n}")
        step = t.shape[dim] // n
        out = out.narrow(dim, mesh.coords[axis] * step, step)
    return out if out is t else out.contiguous()


def _tree_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_params(params, cfg: LlamaConfig, mesh: Mesh):
    """This rank's slices of a full parameter tree (``models.llama``
    layout).  The head-group axis G of ``wqkv_f``/``wo_f`` must divide by
    tp: ``init_params(head_group=1)`` makes G = kv_heads.  A quantized
    tree raises: no tp or sp step takes one yet."""
    model.refuse_quantized(params, "shard_params")
    specs = param_pspecs(cfg, mesh.shape["tp"])
    return _tree_map(lambda t, s: shard_tensor(t, s, mesh), params, specs)


def shard_cache(cache: torch.Tensor, mesh: Mesh,
                spec: Spec = cache_pspec()) -> torch.Tensor:
    """This rank's slice of a full [L, kv_heads, capacity, hd] cache
    (``cache_pspec()`` for the tp step, ``cache_pspec_2d()`` for the sp
    step)."""
    return shard_tensor(cache, spec, mesh)
