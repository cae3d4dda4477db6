"""Generation engine (twin of ``clusterfusion_tpu/models/generation.py:34-158``).

``Llama`` wraps the functional model: ``synthetic`` builds a random-weight
engine with the byte tokenizer, and ``stream_generate`` yields tokens one
at a time, prefilling the prompt and then running one decode step per
token.  The fused-vs-eager switch is an argument, and the
``USE_CLUSTER_FUSION`` environment variable is honoured when it is not
given, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Generator, Optional, Sequence

import torch

from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as model
from clusterfusion_tpu_torch.models.sampling import sample
from clusterfusion_tpu_torch.models.tokenizer import load_tokenizer
from clusterfusion_tpu_torch.ops._support import resolve_device


@dataclasses.dataclass
class GenStats:
    prompt_tokens: int = 0
    gen_tokens: int = 0
    total_s: float = 0.0
    # time from the start of prefill until the first token is on the host
    prefill_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.gen_tokens / self.total_s if self.total_s else 0.0


class Llama:
    """Decode engine around the functional model."""

    def __init__(self, params, cfg: LlamaConfig, tokenizer,
                 kcfg: Optional[KernelConfig] = None,
                 fused: Optional[bool] = None):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.kcfg = kcfg or KernelConfig()
        self.device = params["embed"].device
        if fused is None:
            fused = os.getenv("USE_CLUSTER_FUSION", "true").lower() == "true"
        self.fused = fused
        self.stats = GenStats()

    @staticmethod
    def synthetic(cfg: LlamaConfig, seed: int = 0,
                  fused: Optional[bool] = None, device=None) -> "Llama":
        """Random-weight engine with a byte tokenizer, made on ``device``
        (CUDA by default; raises when there is none)."""
        dev = resolve_device(device)
        params = model.init_params(cfg, seed, device=dev)
        return Llama(params, cfg, load_tokenizer("bytes"), fused=fused)

    def stream_generate(self, prompt_tokens: Sequence[int],
                        max_gen_len: int, temperature: float = 0.6,
                        top_p: float = 0.9, seed: int = 0,
                        echo: bool = False) -> Generator[int, None, None]:
        """Yield tokens one at a time."""
        cfg = self.cfg
        toks = list(prompt_tokens)
        if len(toks) + max_gen_len > cfg.max_seq_len:
            raise ValueError(f"{len(toks)} prompt + {max_gen_len} new tokens "
                             f"exceed max_seq_len {cfg.max_seq_len}")
        k_cache, v_cache = model.init_cache(cfg, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)

        t0 = time.perf_counter()
        logits, k_cache, v_cache = model.prefill(
            self.params, k_cache, v_cache, toks, cfg, kcfg=self.kcfg)
        tok = sample(logits[-1], temperature, top_p, gen)
        prefill_s = 0.0
        if echo:
            yield from toks
        pos = len(toks)
        n_gen = 0
        for _ in range(max_gen_len):
            t = int(tok)
            if not n_gen:
                prefill_s = time.perf_counter() - t0
            yield t
            n_gen += 1
            if t == self.tokenizer.eos_id:
                break
            logits, k_cache, v_cache = model.decode_step(
                self.params, k_cache, v_cache, tok, pos, cfg, self.kcfg,
                self.fused)
            tok = sample(logits, temperature, top_p, gen)
            pos += 1
        self.stats = GenStats(len(toks), n_gen, time.perf_counter() - t0,
                              prefill_s)
