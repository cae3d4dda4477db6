"""Op layer: the hand-written Hopper kernels with their plain PyTorch twins,
and the small plain helpers around them."""

from clusterfusion_tpu_torch.ops.decoder_layer import (
    llama_decoder_layer, llama_decoder_layer_sglang)
from clusterfusion_tpu_torch.ops.deepseek_layer import (
    deepseek_decoder_layer, deepseek_decoder_layer_fused)
from clusterfusion_tpu_torch.ops.ffn import fused_ffn
from clusterfusion_tpu_torch.ops.gemv import gemv
from clusterfusion_tpu_torch.ops.paged_decoder_layer import (
    llama_decoder_layer_batch_decode_sglang, llama_decoder_layer_paged)
from clusterfusion_tpu_torch.ops.quant import (QuantizedTensor,
                                               maybe_dequantize, quantize,
                                               quantize_int4, quantize_int8,
                                               quantize_llama_params)
from clusterfusion_tpu_torch.ops.rmsnorm import fused_add_rmsnorm, rmsnorm
from clusterfusion_tpu_torch.ops.stack_kernel import fused_decoder_stack

__all__ = ["QuantizedTensor", "deepseek_decoder_layer",
           "deepseek_decoder_layer_fused", "fused_add_rmsnorm",
           "fused_decoder_stack", "fused_ffn", "gemv", "llama_decoder_layer",
           "llama_decoder_layer_batch_decode_sglang",
           "llama_decoder_layer_paged", "llama_decoder_layer_sglang",
           "maybe_dequantize", "quantize", "quantize_int4", "quantize_int8",
           "quantize_llama_params", "rmsnorm"]
