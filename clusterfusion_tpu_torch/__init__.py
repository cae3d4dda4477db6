"""ClusterFusion on PyTorch and CUDA for NVIDIA Hopper (sm_90a).

The port of :mod:`clusterfusion_tpu`: the same module tree and parameter
layouts, with every Pallas kernel on the ported path replaced by a CUDA C++
kernel written by hand (``csrc/``), built with ``nvcc`` at first use and
bound through ``ctypes`` (:mod:`clusterfusion_tpu_torch.ops._build`).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on CPU tensors each kernel wrapper runs its plain PyTorch
twin instead.  Importing the package builds nothing: the kernels and the
C++ page scheduler are built at first use.
"""

from clusterfusion_tpu_torch.config import (DeepSeekConfig, KernelConfig,
                                            LlamaConfig, MeshConfig)
from clusterfusion_tpu_torch.ops import (
    QuantizedTensor, deepseek_decoder_layer, fused_add_rmsnorm, fused_ffn,
    gemv, llama_decoder_layer, llama_decoder_layer_batch_decode_sglang,
    llama_decoder_layer_paged, llama_decoder_layer_sglang,
    quantize_llama_params, rmsnorm)
from clusterfusion_tpu_torch.runtime import PagedKVScheduler, ServingEngine

__version__ = "0.1.0"

__all__ = ["DeepSeekConfig", "KernelConfig", "LlamaConfig", "MeshConfig",
           "PagedKVScheduler", "QuantizedTensor", "ServingEngine",
           "deepseek_decoder_layer", "fused_add_rmsnorm", "fused_ffn", "gemv",
           "llama_decoder_layer", "llama_decoder_layer_batch_decode_sglang",
           "llama_decoder_layer_paged", "llama_decoder_layer_sglang",
           "quantize_llama_params", "rmsnorm"]
