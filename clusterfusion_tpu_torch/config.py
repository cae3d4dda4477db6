"""Configuration dataclasses (twin of ``clusterfusion_tpu/config.py``).

``LlamaConfig`` and ``DeepSeekConfig`` are the JAX package's model
geometries, field for field with their presets, and ``MeshConfig`` its
mesh shape.  ``KernelConfig`` holds the port's own Hopper knobs; none of
the TPU tiling knobs carries over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-family model geometry (``clusterfusion_tpu/config.py:26-171``)."""

    hidden_dim: int = 4096
    n_heads: int = 32
    n_kv_heads: Optional[int] = None  # GQA; None -> MHA (= n_heads)
    head_dim: Optional[int] = None
    ffn_dim: int = 11008              # SwiGLU intermediate size
    n_layers: int = 32
    vocab_size: int = 32000
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 2048
    # "neox" (rotate-half) or "gptj" (interleaved, meta llama)
    rope_style: str = "gptj"
    # Sliding-window attention (Mistral semantics); 0 = full context.
    sliding_window: int = 0
    # "all" (mistral) or "even" (gemma-2 interleaved local/global)
    window_pattern: str = "all"
    # QKV projection bias (Qwen2 family)
    qkv_bias: bool = False
    # Gated-FFN activation: "silu" (SwiGLU) or "gelu_tanh" (GeGLU)
    ffn_act: str = "silu"
    # Gemma-2 post-attention / post-FFN RMSNorms
    sandwich_norms: bool = False
    # Gemma-2 logit softcaps; 0.0 = off
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # Llama-3.1 rope frequency rescale; factor > 1 enables
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_orig_max_pos: int = 8192

    @property
    def llama3_scaling(self):
        """(factor, low, high, orig_max) for ops.rope, or None."""
        if self.rope_scaling_factor > 1.0:
            return (self.rope_scaling_factor, self.rope_low_freq_factor,
                    self.rope_high_freq_factor, self.rope_orig_max_pos)
        return None

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.hidden_dim // self.n_heads

    @property
    def qkv_dim(self) -> int:
        return (self.n_heads + 2 * self.kv_heads) * self.head_dim_

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=5120, n_heads=40, ffn_dim=13824,
                           n_layers=40)

    @staticmethod
    def llama2_70b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=8192, n_heads=64, n_kv_heads=8,
                           ffn_dim=28672, n_layers=80)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=4096, n_heads=32, n_kv_heads=8,
                           ffn_dim=14336, n_layers=32, vocab_size=128256,
                           rope_theta=500000.0, norm_eps=1e-5,
                           rope_style="neox")

    @staticmethod
    def llama31_8b() -> "LlamaConfig":
        return dataclasses.replace(LlamaConfig.llama3_8b(),
                                   rope_scaling_factor=8.0,
                                   rope_low_freq_factor=1.0,
                                   rope_high_freq_factor=4.0,
                                   rope_orig_max_pos=8192)

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=4096, n_heads=32, n_kv_heads=8,
                           ffn_dim=14336, n_layers=32, vocab_size=32000,
                           rope_theta=10000.0, rope_style="neox",
                           sliding_window=4096)

    @staticmethod
    def qwen2_7b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=3584, n_heads=28, n_kv_heads=4,
                           ffn_dim=18944, n_layers=28, vocab_size=152064,
                           rope_theta=1000000.0, norm_eps=1e-6,
                           rope_style="neox", qkv_bias=True)

    @staticmethod
    def gemma2_9b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=3584, n_heads=16, n_kv_heads=8,
                           head_dim=256, ffn_dim=14336, n_layers=42,
                           vocab_size=256000, norm_eps=1e-6,
                           rope_theta=10000.0, rope_style="neox",
                           sliding_window=4096, window_pattern="even",
                           ffn_act="gelu_tanh", sandwich_norms=True,
                           attn_logit_softcap=50.0,
                           final_logit_softcap=30.0)

    @staticmethod
    def tinyllama_1b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=2048, n_heads=32, n_kv_heads=4,
                           head_dim=64, ffn_dim=5632, n_layers=22,
                           vocab_size=32000, rope_style="neox")

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Small geometry for tests (head_dim 128)."""
        defaults = dict(hidden_dim=512, n_heads=4, ffn_dim=1024, n_layers=2,
                        vocab_size=384, max_seq_len=256)
        defaults.update(kw)
        return LlamaConfig(**defaults)


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig:
    """DeepSeek-V2(-Lite) MLA geometry (``clusterfusion_tpu/config.py:174-246``):
    the defaults are DeepSeek-V2-Lite's attention widths with a dense FFN.
    ``n_experts > 0`` turns the FFN into a shared expert of ``ffn_dim``
    columns plus ``n_experts`` routed experts of ``moe_ffn_dim`` columns;
    ``yarn_factor > 1`` turns on YaRN rope scaling."""

    hidden_dim: int = 2048
    n_heads: int = 16
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    kv_lora_rank: int = 512
    norm_eps: float = 1e-6
    n_layers: int = 27
    ffn_dim: int = 10944
    vocab_size: int = 102400
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    n_experts: int = 0
    moe_top_k: int = 2
    moe_ffn_dim: int = 1408
    # V2/V2-Lite set norm_topk_prob=false with a routed_scaling_factor
    # (16.0 / 1.0); V3 renormalizes the top-k probabilities
    moe_norm_topk_prob: bool = True
    moe_routed_scaling: float = 1.0
    yarn_factor: float = 1.0
    yarn_orig_max: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.nope_head_dim + self.rope_head_dim

    @property
    def softmax_scale(self) -> float:
        """1/sqrt(head_dim), times YaRN's get_mscale(factor,
        mscale_all_dim)**2 when YaRN is on."""
        base = 1.0 / math.sqrt(self.head_dim)
        if self.yarn_factor > 1.0:
            from clusterfusion_tpu_torch.ops.rope import \
                yarn_softmax_scale_mult
            base *= yarn_softmax_scale_mult(self.yarn_factor,
                                            self.yarn_mscale_all_dim)
        return base

    @property
    def mla_head_dim(self) -> int:
        return self.kv_lora_rank + self.rope_head_dim

    @property
    def n_proj(self) -> int:
        """Fused projection width: q_nope | q_pe | ckv | k_pe."""
        return (self.n_heads * self.head_dim
                + self.kv_lora_rank + self.rope_head_dim)

    @staticmethod
    def tiny(**kw) -> "DeepSeekConfig":
        """Small geometry for tests (lora 128, rope 64)."""
        defaults = dict(hidden_dim=512, n_heads=4, nope_head_dim=128,
                        rope_head_dim=64, kv_lora_rank=128, n_layers=2,
                        ffn_dim=1024, vocab_size=384, max_seq_len=256)
        defaults.update(kw)
        return DeepSeekConfig(**defaults)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Launch knobs of the port's Hopper kernels.

    ``kv_split``: cache rows per block of the split-KV flash-decode pass in
    ``fused_decoder_stack`` (one partial (m, l, acc) per split, merged by a
    second pass; 1 to 1024; any other value raises).  64 keeps about two
    blocks per SM at Llama-2-7B's 32 kv heads and pos 600, and measured the
    fastest split pass of 32, 64 and 128 on the H100 (PERF.md).
    ``prefill_block_rows``: panel rows (query x group) per block of
    ``flash_prefill_attention``: 64 or 128, i.e. one or two consumer
    warpgroups of 64 rows (the wgmma M); any other value raises.  Its key
    tile is 64 rows.  ``gemv_threads``: threads per block of the decode
    GEMVs, a multiple of 32 (the ring GEMV of ``fused_decoder_stack``,
    ``fused_verify_stack`` and ``gemv``: its consumer threads, 32 to 992,
    beside one producer warp).  ``_fused_decoder_layer`` and ``fused_ffn``
    read neither ``gemv_threads`` nor any other knob but ``kv_split``: each
    is one launch whose block size, ring stages and cluster size are
    constants or follow from the geometry and the card's SM count.
    ``int4_w4a8``: the int4 product of kernels 7 and 8, as in the JAX
    package (``clusterfusion_tpu/config.py:278-282``): True (the default)
    quantizes each activation block to int8 per row (absmax / 127) and
    sums each scale group's integer dot, scaled by its group scale (W4A8);
    False takes the exact product over bf16(code * scale) (W4A16).  The
    paged layer and the serving products always take the exact one, as
    JAX's do.  ``serving_w8a8``: the JAX package's int8-activation serving
    products; not ported, so ``ServingEngine`` raises on it (``ROADMAP.md``
    queue 2, mode 6)."""

    kv_split: int = 64
    prefill_block_rows: int = 128
    gemv_threads: int = 256
    int4_w4a8: bool = True
    serving_w8a8: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process-mesh shape for multi-card runs
    (``clusterfusion_tpu/config.py:310-349``), one process per card.

    Axes, outermost first: ``dcn`` (across hosts: data parallelism only),
    ``pp`` (pipeline stages), ``dp`` (data), ``tp`` (tensor: attention
    heads and FFN columns), ``ep`` (experts) and ``sp`` (sequence: the
    decode KV cache).  ``parallel.mesh.build_mesh`` lays the ranks of the
    default process group out in this order."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    dcn: int = 1
    pp: int = 1
    ep: int = 1

    @property
    def shape(self):
        return {"dcn": self.dcn, "pp": self.pp, "dp": self.dp,
                "tp": self.tp, "ep": self.ep, "sp": self.sp}

    @property
    def n_devices(self) -> int:
        return self.dcn * self.pp * self.dp * self.tp * self.ep * self.sp
