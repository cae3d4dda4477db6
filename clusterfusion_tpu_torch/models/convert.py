"""Bridge from the JAX package's parameter tree (no JAX counterpart).

``params_from_numpy`` takes that tree as numpy arrays (``np.asarray`` of
each leaf) and returns the port's dict with the same keys and layouts.
JAX bf16 leaves come out of ``np.asarray`` as ml_dtypes ``bfloat16``, which
``torch.from_numpy`` refuses; they cross as their int16 bit patterns and
are viewed back as ``torch.bfloat16``, which is bit-exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """One numpy array (bf16 from ml_dtypes included) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dict of numpy arrays -> the same dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
