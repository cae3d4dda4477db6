"""ClusterFusion on PyTorch and CUDA for NVIDIA Hopper (sm_90a).

The port of :mod:`clusterfusion_tpu`: the same module tree and parameter
layouts, with every Pallas kernel on the ported path replaced by a CUDA C++
kernel written by hand (``csrc/``), built with ``nvcc`` at first use and
bound through ``ctypes`` (:mod:`clusterfusion_tpu_torch.ops._build`).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on CPU tensors each kernel wrapper runs its plain PyTorch
twin instead.
"""

from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig

__all__ = ["KernelConfig", "LlamaConfig"]
