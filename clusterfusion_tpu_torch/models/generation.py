"""Generation engine (twin of ``clusterfusion_tpu/models/generation.py``).

``Llama`` wraps the functional model: ``synthetic`` builds a random-weight
engine with the byte tokenizer; ``stream_generate`` yields tokens one at a
time, prefilling the prompt and then running one decode step per token;
``spec_generate`` decodes greedily with a draft model proposing tokens
that one verify step scores (``models.speculative``); ``generate``
decodes a batch of prompts together through the
continuous-batching ``ServingEngine``, and ``text_completion`` /
``chat_completion`` (llama-2 ``[INST]`` templating) sit on it.  The
fused-vs-eager switch is an argument, and the ``USE_CLUSTER_FUSION``
environment variable is honoured when it is not given, as in the JAX
package.  ``quant="int8"`` or ``"int4"`` quantizes the projection
weights (``ops.quant.quantize_llama_params``, int4 in groups of 128);
``stream_generate`` then runs kernel 7's int8 or int4 mode (int4: W4A8
unless ``kcfg.int4_w4a8`` is False), ``spec_generate`` kernel 8's, and
``generate`` and the completions the serving engine's quantized steps
(int4: the fused step, exact).  The prefill dequantizes, as the JAX
package's does.  ``kv_dtype="int8"`` (an ``Int8KV`` cache) or
``torch.float8_e4m3fn`` gives ``stream_generate`` and ``spec_generate`` an
8-bit KV cache (kernels 7 and 8 in their 8-bit modes; the draft keeps its
own ``kv_dtype``); ``generate`` and the completions hand it to the serving
engine, whose pools take fp8 (kernels 9 and 10 on e4m3 pools) and refuse
"int8" (JAX's int8 pools are unscaled; ``ROADMAP.md`` section 3).  A
config with Mistral's sliding window (pattern ``"all"``) runs every entry:
``stream_generate`` and ``spec_generate`` on kernels 4, 7 and 8's window,
``generate`` and the completions on the engine's windowed kernels 9 and 10
and its rolling page buffer (``generate`` still sizes the pool for the
full context, which the rolling buffer never needs).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Generator, List, Optional, Sequence, Tuple

import torch

from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as model
from clusterfusion_tpu_torch.models import speculative
from clusterfusion_tpu_torch.models.sampling import sample
from clusterfusion_tpu_torch.models.tokenizer import load_tokenizer
from clusterfusion_tpu_torch.ops._support import resolve_device
from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
from clusterfusion_tpu_torch.runtime.serving import ServingEngine

# llama-2 chat templating tokens
B_INST, E_INST = "[INST]", "[/INST]"
B_SYS, E_SYS = "<<SYS>>\n", "\n<</SYS>>\n\n"


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
                 fused: Optional[bool] = None,
                 quant: Optional[str] = None,
                 kv_dtype=torch.bfloat16):
        """quant: None | "int8" | "int4", weight-only quantization of the
        four projections (the LM head stays bf16), as in the JAX package;
        kv_dtype: the KV cache's, bf16, "int8" (``Int8KV``) or
        ``torch.float8_e4m3fn``."""
        if quant:
            params = quantize_llama_params(params, quant)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.kcfg = kcfg or KernelConfig()
        self.kv_dtype = kv_dtype
        self.device = params["embed"].device
        if fused is None:
            fused = os.getenv("USE_CLUSTER_FUSION", "true").lower() == "true"
        self.fused = fused
        self.stats = GenStats()

    @staticmethod
    def synthetic(cfg: LlamaConfig, seed: int = 0,
                  fused: Optional[bool] = None, quant: Optional[str] = None,
                  device=None, kv_dtype=torch.bfloat16) -> "Llama":
        """Random-weight engine with a byte tokenizer, made on ``device``
        (CUDA by default; raises when there is none); ``quant`` picks the
        quantized engines' wider head grouping, then quantizes."""
        dev = resolve_device(device)
        params = model.init_params(
            cfg, seed, head_group=model.default_head_group(cfg, quant),
            device=dev)
        return Llama(params, cfg, load_tokenizer("bytes"), fused=fused,
                     quant=quant, kv_dtype=kv_dtype)

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
        k_cache, v_cache = model.init_cache(cfg, device=self.device,
                                            dtype=self.kv_dtype)
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

    def spec_generate(self, prompt_tokens: Sequence[int], max_gen_len: int,
                      draft: "Llama", n_draft: int = 4,
                      rounds_per_dispatch: int = 1) -> List[int]:
        """Greedy speculative decode with ``draft`` as the proposal model.

        Emits the greedy stream of this (target) model; the draft only
        changes how many target forwards it takes (see
        ``models.speculative``).  ``rounds_per_dispatch`` rounds run before
        their tokens return to the emit loop.  Sets ``self.spec_stats``:
        rounds, drafts accepted, tokens, and the tokens each round
        emitted."""
        for eng in (self, draft):
            # kernels 7 and 8 in their int8 or int4 modes
            model.refuse_quantized(eng.params, "spec_generate",
                                   allow=("int8", "int4"))
        cfg = self.cfg
        toks = list(prompt_tokens)
        span = n_draft + 1
        t0 = time.perf_counter()
        k_cache, v_cache = model.init_cache(cfg, device=self.device,
                                            dtype=self.kv_dtype)
        logits, k_cache, v_cache = model.prefill(
            self.params, k_cache, v_cache, toks, cfg, kcfg=self.kcfg)
        kd, vd = model.init_cache(draft.cfg, device=draft.device,
                                  dtype=draft.kv_dtype)
        model.prefill(draft.params, kd, vd, toks, draft.cfg, kcfg=draft.kcfg)
        tok = torch.argmax(logits[-1])
        out = [int(tok)]
        pos = len(toks)
        rounds = accepted = 0
        round_counts: List[int] = []
        eos = self.tokenizer.eos_id
        while len(out) < max_gen_len and out[-1] != eos:
            # cache budget: round r writes rows up to pos + (r-1)*span + n_draft
            cap_rounds = (cfg.max_seq_len - 1 - n_draft - pos) // span + 1
            r = min(rounds_per_dispatch, cap_rounds)
            if r < 1:
                break
            targets, counts, k_cache, v_cache, kd, vd = \
                speculative.spec_decode_loop(
                    self.params, k_cache, v_cache, draft.params, kd, vd, tok,
                    pos, cfg, draft.cfg, kcfg=self.kcfg, n_draft=n_draft,
                    n_rounds=r, draft_fused=draft.fused,
                    target_fused=self.fused)
            emitted = speculative.flatten_rounds(targets.cpu(), counts)
            rounds += r
            round_counts += counts.tolist()
            accepted += int(counts.sum()) - r     # drafts accepted (no bonus)
            pos += int(counts.sum())
            tok = torch.tensor(emitted[-1], dtype=torch.long,
                               device=self.device)
            if eos in emitted:
                out.extend(emitted[: emitted.index(eos) + 1])
                break
            out.extend(emitted)
        out = out[:max_gen_len]
        self.stats = GenStats(len(toks), len(out), time.perf_counter() - t0)
        self.spec_stats = {"rounds": rounds, "accepted_drafts": accepted,
                           "tokens": len(out), "round_counts": round_counts}
        return out

    def generate(self, prompt_tokens: Sequence[Sequence[int]],
                 max_gen_len: int, temperature: float = 0.6,
                 top_p: float = 0.9, seed: int = 0,
                 logprobs: bool = False, echo: bool = False,
                 ) -> Tuple[List[List[int]], Optional[List[List[float]]]]:
        """Batched generation: all rows decode together through the
        continuous-batching engine, one step for the whole batch, with
        per-row eos stopping and, with ``logprobs=True``, the natural-log
        probability of every kept token (the prompt's too under ``echo``).

        Each request owns its pages, so rows with shorter prompts never see
        other rows' padding, and sampling draws from the engine's generator
        seeded by ``seed``."""
        # the serving steps' int8 or int4 products (kernel 9's int8 or int4
        # mode for the fused step, the default step for int4)
        model.refuse_quantized(self.params, "generate",
                               allow=("int8", "int4"))
        cfg = self.cfg
        prompts = [list(t) for t in prompt_tokens]
        if not prompts or not all(prompts):
            raise ValueError("empty prompt")
        if max(len(t) for t in prompts) > cfg.max_seq_len:
            raise ValueError(f"a prompt exceeds max_seq_len {cfg.max_seq_len}")
        B = len(prompts)
        page = 16
        mb = 4
        while mb < B:
            mb *= 2
        need = sum(-(-min(len(t) + max_gen_len, cfg.max_seq_len) // page)
                   for t in prompts)
        eng = ServingEngine(
            self.params, cfg, page_size=page, num_pages=need + 1,
            max_batch=mb, kcfg=self.kcfg, eos_id=self.tokenizer.eos_id,
            kv_dtype=self.kv_dtype, seed=seed,
            step_impl="fused" if (self.fused and B == 1) else None)
        t0 = time.perf_counter()
        for i, toks in enumerate(prompts):
            eng.submit(i, toks, min(max_gen_len, cfg.max_seq_len - len(toks)),
                       temperature, top_p, logprobs=logprobs)
        eng.run()
        out_tokens, out_logprobs = [], []
        for i, prompt in enumerate(prompts):
            req = eng.last_results[i]
            toks = list(req.generated[:max_gen_len])
            probs = list(req.logprobs[:max_gen_len]) if logprobs else None
            if echo:
                toks = prompt + toks
                if logprobs:
                    probs = list(req.prompt_logprobs) + probs
            if self.tokenizer.eos_id in toks:
                eos_idx = toks.index(self.tokenizer.eos_id)
                toks = toks[:eos_idx]
                probs = probs[:eos_idx] if logprobs else None
            out_tokens.append(toks)
            out_logprobs.append(probs)
        self.stats = GenStats(sum(len(p) for p in prompts),
                              sum(len(r.generated)
                                  for r in eng.last_results.values()),
                              time.perf_counter() - t0)
        return out_tokens, out_logprobs if logprobs else None

    def text_completion(self, prompts: List[str], temperature: float = 0.6,
                        top_p: float = 0.9, max_gen_len: Optional[int] = None,
                        logprobs: bool = False,
                        echo: bool = False) -> List[dict]:
        """Batched completion of strings; with ``logprobs=True`` each
        prediction carries its tokens' strings and logprobs."""
        if max_gen_len is None:
            max_gen_len = self.cfg.max_seq_len - 1
        prompt_tokens = [self.tokenizer.encode(p, bos=True, eos=False)
                         for p in prompts]
        toks, lps = self.generate(prompt_tokens, max_gen_len, temperature,
                                  top_p, logprobs=logprobs, echo=echo)
        if logprobs:
            return [{"generation": self.tokenizer.decode(t),
                     "tokens": [self.tokenizer.decode([x]) for x in t],
                     "logprobs": lp}
                    for t, lp in zip(toks, lps)]
        return [{"generation": self.tokenizer.decode(t)} for t in toks]

    def chat_completion(self, dialogs: List[List[dict]],
                        temperature: float = 0.6, top_p: float = 0.9,
                        max_gen_len: Optional[int] = None,
                        logprobs: bool = False) -> List[dict]:
        """Completion of llama-2 chat dialogs (``[INST]`` templating)."""
        if max_gen_len is None:
            max_gen_len = self.cfg.max_seq_len - 1
        prompt_tokens = [self._encode_dialog(d) for d in dialogs]
        toks, lps = self.generate(prompt_tokens, max_gen_len, temperature,
                                  top_p, logprobs=logprobs)
        results = []
        for i, t in enumerate(toks):
            r = {"generation": {"role": "assistant",
                                "content": self.tokenizer.decode(t)}}
            if logprobs:
                r["tokens"] = [self.tokenizer.decode([x]) for x in t]
                r["logprobs"] = lps[i]
            results.append(r)
        return results

    def _encode_dialog(self, dialog: List[dict]) -> List[int]:
        """Fold an optional system prompt into the first user turn, then
        alternate ``[INST] user [/INST] assistant`` turns, each closed by
        eos, and end with the last user turn."""
        if dialog and dialog[0]["role"] == "system":
            rest = list(dialog[1:])
            rest[0] = {"role": rest[0]["role"],
                       "content": B_SYS + dialog[0]["content"] + E_SYS
                       + rest[0]["content"]}
            dialog = rest
        if not dialog or dialog[-1]["role"] != "user" or not all(
                m["role"] == ("user" if i % 2 == 0 else "assistant")
                for i, m in enumerate(dialog)):
            raise ValueError("dialog must alternate user/assistant and end "
                             "with user")
        toks: List[int] = []
        for i in range(0, len(dialog) - 1, 2):
            user, ans = dialog[i], dialog[i + 1]
            toks += self.tokenizer.encode(
                f"{B_INST} {user['content'].strip()} {E_INST} "
                f"{ans['content'].strip()} ", bos=True, eos=True)
        toks += self.tokenizer.encode(
            f"{B_INST} {dialog[-1]['content'].strip()} {E_INST}",
            bos=True, eos=False)
        return toks
