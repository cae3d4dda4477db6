"""Bridge from the JAX package's parameter tree (no JAX counterpart).

``params_from_numpy`` takes that tree as numpy arrays (``np.asarray`` of
each leaf) and returns the port's dict with the same keys and layouts.
JAX bf16 leaves come out of ``np.asarray`` as ml_dtypes ``bfloat16``, which
``torch.from_numpy`` refuses; they cross as their int16 bit patterns and
are viewed back as ``torch.bfloat16``, which is bit-exact.  A quantized
leaf (any object with the fields ``q``, ``s``, ``kind``, ``axis``,
``group_size`` and ``pack_axis``, as the JAX package's ``QuantizedTensor``
has) becomes the port's ``ops.quant.QuantizedTensor``, its int8 codes and
its scales (float32, or bf16 where they arrive so) crossing bit-exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from clusterfusion_tpu_torch.ops._support import resolve_device
from clusterfusion_tpu_torch.ops.quant import QuantizedTensor

_QUANT_FIELDS = ("q", "s", "kind", "axis", "group_size", "pack_axis")


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """One numpy array (bf16 from ml_dtypes included) -> torch tensor on
    ``device`` (CUDA by default; raises when there is none)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(resolve_device(device))


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays -> the same dict of torch tensors on
    ``device`` (CUDA by default; raises when there is none)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if all(hasattr(tree, f) for f in _QUANT_FIELDS):
        return QuantizedTensor(tensor_from_numpy(tree.q, device),
                               tensor_from_numpy(tree.s, device), tree.kind,
                               int(tree.axis), int(tree.group_size),
                               int(tree.pack_axis))
    return tensor_from_numpy(tree, device)
