"""Serving runtime (twin of ``clusterfusion_tpu/runtime``): the C++ page
scheduler behind ``PagedKVScheduler`` and the continuous-batching
``ServingEngine`` that drives the paged kernels with it."""

from clusterfusion_tpu_torch.runtime.native import PagedKVScheduler
from clusterfusion_tpu_torch.runtime.serving import (EngineHealthError,
                                                     ServingEngine)

__all__ = ["EngineHealthError", "PagedKVScheduler", "ServingEngine"]
