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
  and, for the sequence-parallel step, on their capacity over sp.  An fp8
  cache is a tensor like any other; an ``Int8KV`` pair (``ops.quant``) is
  cut on its kv axis alone, its rows ``[L, kv, S, hd]`` and its scale
  planes ``[L, kv, R, 128]`` alike, as JAX's ``device_put`` of the pair
  cuts both (no JAX step cuts one over sp).

A spec is a tuple with one entry per tensor axis: the mesh axis that cuts
it, or None.  ``shard_params`` and ``shard_cache`` return this rank's
slices.  A slice that is the whole tensor is the tensor itself (a view, no
copy); any other slice is made contiguous, a copy this rank owns.

A ``QuantizedTensor`` leaf (``ops.quant``) gets a spec node of the same
class: its codes take the weight's spec, and so do its scales, as in JAX.
An int8 leaf's per-column scales collapse the reduction axis to 1, which
replicates even where the weight cuts it (``w2``'s rows): every rank
scales its partial sums by the same scale, which commutes with their sum
over tp.  An int4 leaf's group-scale rows are cut with the weight (two
codes a byte along the reduction axis, one scale row per group of k
rows), so a cut falls on a group boundary wherever the scale rows divide
over the axis, and ``shard_params`` raises, naming the leaf, where they do
not (``w2``'s rows at tp 4 at 7B are 2816 = 22 groups of 128).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from clusterfusion_tpu_torch.config import LlamaConfig
from clusterfusion_tpu_torch.ops.quant import Int8KV, QuantizedTensor
from clusterfusion_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]


def _qt_spec(spec: Spec, qt: QuantizedTensor) -> QuantizedTensor:
    """The spec node of a quantized leaf: a ``QuantizedTensor`` of specs
    (codes, scales) with the leaf's own fields.  The codes keep the
    weight's spec; the scales too, but for an int8 leaf's collapsed
    reduction axis, which replicates."""
    sspec = list(spec) + [None] * (qt.s.dim() - len(spec))
    if qt.kind == "int8":
        sspec[qt.axis] = None
    return QuantizedTensor(tuple(spec), tuple(sspec), qt.kind, qt.axis,
                           qt.group_size, qt.pack_axis)


def param_pspecs(cfg: LlamaConfig, tp: int, params=None) -> Dict[str, Any]:
    """The spec tree matching the parameter tree of ``models.llama``; with
    ``params``, each of its ``QuantizedTensor`` leaves gets a quantized
    spec node (``_qt_spec``), so the two trees keep one shape."""
    if cfg.kv_heads % tp:
        raise ValueError(f"tp={tp} must divide kv_heads={cfg.kv_heads}")
    if cfg.ffn_dim % tp:
        raise ValueError(f"tp={tp} must divide ffn_dim={cfg.ffn_dim}")
    specs = {
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
    if params is not None:
        for name, w in params["layers"].items():
            if isinstance(w, QuantizedTensor):
                specs["layers"][name] = _qt_spec(specs["layers"][name], w)
        if isinstance(params["lm_head"], QuantizedTensor):
            specs["lm_head"] = _qt_spec(specs["lm_head"], params["lm_head"])
    return specs


def cache_pspec() -> Spec:
    """[L, kv_heads, capacity, head_dim]: heads on tp."""
    return (None, "tp", None, None)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh,
                 what: str = "tensor") -> torch.Tensor:
    """This rank's slice of ``t`` (named ``what`` in errors) under
    ``spec``."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} does not fit a {t.dim()}-d tensor")
    out = t
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = mesh.shape[axis]
        if t.shape[dim] % n:
            raise ValueError(f"{what}: axis {dim} of {tuple(t.shape)} does "
                             f"not divide over {axis}={n}")
        step = t.shape[dim] // n
        out = out.narrow(dim, mesh.coords[axis] * step, step)
    return out if out is t else out.contiguous()


def _tree_map(fn, tree, specs, name=""):
    """fn(leaf, spec, name) over the tree; a quantized leaf's codes and
    scales are named ``name.q`` and ``name.s``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, specs[k], k) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, q=fn(tree.q, specs.q, name + ".q"),
                                   s=fn(tree.s, specs.s, name + ".s"))
    return fn(tree, specs, name)


def shard_params(params, cfg: LlamaConfig, mesh: Mesh):
    """This rank's slices of a full parameter tree (``models.llama``
    layout), bf16 or with int8 or int4 ``QuantizedTensor`` weights (codes
    and scales cut by ``param_pspecs(cfg, tp, params)``; an int4 leaf's
    cuts on whole scale groups, or a ValueError naming it).  The head-group
    axis G of
    ``wqkv_f``/``wo_f`` must divide by tp: ``init_params(head_group=1)``
    makes G = kv_heads."""
    specs = param_pspecs(cfg, mesh.shape["tp"], params)
    return _tree_map(lambda t, s, name: shard_tensor(t, s, mesh, name),
                     params, specs)


def shard_cache(cache, mesh: Mesh, spec: Spec = cache_pspec()):
    """This rank's slice of a full [L, kv_heads, capacity, hd] cache, bf16
    or fp8 (``cache_pspec()`` for the tp step, ``cache_pspec_2d()`` for the
    sp step), or of an ``Int8KV`` pair under a spec that keeps the
    sequence whole: its rows and scale planes cut on the kv axis, an
    ``Int8KV`` returned."""
    if not isinstance(cache, Int8KV):
        return shard_tensor(cache, spec, mesh)
    if len(spec) != 4 or spec[2] is not None or spec[3] is not None:
        raise NotImplementedError(
            f"shard_cache: an Int8KV pair under {spec}: it is cut on its kv "
            "axis only (no JAX step runs an Int8KV cut over sp, and its "
            "scale planes do not follow the positions' axis)")
    return Int8KV(shard_tensor(cache.q, spec, mesh, "Int8KV rows"),
                  shard_tensor(cache.s, spec, mesh, "Int8KV scales"))
