"""Continuous-batching serving engine on the paged kernels (twin of
``clusterfusion_tpu/runtime/serving.py``).

- page bookkeeping and admission live in the native C++ scheduler
  (``runtime.native.PagedKVScheduler``);
- a decode step takes the whole batch through every layer.  The default
  ``"batched"`` step runs the projections, O-projection, FFN and LM head
  as M=B matrix products and ``paged_attention`` per layer; the
  ``"fused"`` step runs ``llama_decoder_layer_paged`` per layer and the
  FFN around it (chosen for head_dim < 128, and by ``Llama.generate`` for
  a single prompt);
- batch rows are padded to ``max_batch``; padding rows carry the NULL page
  0 and seq_len 0, so their appends land in a page no request owns;
- prompts are prefilled by ``models.llama.prefill`` (flash prefill per
  layer, in chunks of ``prefill_chunk`` tokens past that length) into a
  temporary contiguous cache whose pages are then copied into the pool;
- int8 weights (``ops.quant``, per output column) run both steps: the
  batched step's M=B products on the GEMVs' int8 instances (``ops.gemv``'s
  ``_gemv_int8``/``_ffn_int8``; their plain twins on the CPU), the fused
  step on ``llama_decoder_layer_paged``'s int8 mode and the same int8 FFN;
  the default step stays ``"batched"``, as in the JAX engine;
- int4 weights (group size 128; ``ROADMAP.md`` queue 2, mode 1.5) run
  both steps in the exact mode the JAX engine computes (x @ bf16(code *
  s)): the fused step, the default for an int4 tree as in the JAX engine
  (JAX ``runtime/serving.py:445-453``), on ``llama_decoder_layer_paged``'s
  int4 mode and ``ops.gemv._ffn_int4``; the batched step on
  ``_gemv_int4``/``_ffn_int4`` around ``paged_attention``.  Both stream
  the packed codes; no bf16 copy of a weight is made;
- ``kv_dtype=torch.float8_e4m3fn`` gives e4m3 pools, as in the JAX
  engine, on both steps and every weight kind: the kernels read the past
  rows with e4m3 denormals flushed (the TPU kernels' decode) and append
  each step's row by their own rules (``ops.paged_decoder_layer``'s
  note); the prefill cache is made in the pool's dtype, as JAX makes it;
- a sliding window (Mistral's, ``cfg.sliding_window`` with pattern
  ``"all"``) runs both steps: the kernels walk only each request's rows in
  the window, and the scheduler keeps its rolling page buffer, as the JAX
  engine does (JAX ``runtime/serving.py:434-441``), so a request owns at
  most ``ceil(window / page) + 1`` real pages whatever its context length;
  table slots below the window hold the NULL page 0, which no kernel reads
  and no prefill writes.  Gemma-2's ``"even"`` pattern is refused;
- ``kcfg.serving_w8a8`` raises ``NotImplementedError`` (``ROADMAP.md``
  queue 2, mode 6), and so does an int8 pool (JAX's are unscaled;
  ``ROADMAP.md`` section 3) or any pool dtype but bf16 and fp8.

The pools ``[L, num_pages, kv_heads, page, hd]`` (bf16 or e4m3) live on
the parameters' device and are updated in place by the kernels and the
prefill copy: ``engine.k_pool``/``v_pool`` stay the same tensors for the
engine's life.  PyTorch compiles nothing, so the JAX engine's per-shape
step cache has no counterpart here; the power-of-two page-walk width and
prefill cache capacity are kept, so that both packages walk and write the
same pages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
from clusterfusion_tpu_torch.models import llama as model
from clusterfusion_tpu_torch.models.sampling import sample_batch
from clusterfusion_tpu_torch.ops.gemv import (_ffn_int4, _ffn_int8, _gemv_int4,
                                              _gemv_int8)
from clusterfusion_tpu_torch.ops.paged_decoder_layer import (
    _bytes_of, llama_decoder_layer_paged, paged_attention)
from clusterfusion_tpu_torch.ops.quant import QuantizedTensor
from clusterfusion_tpu_torch.ops.reference import fused_add_rmsnorm_ref
from clusterfusion_tpu_torch.ops.stack_kernel import check_int4_group
from clusterfusion_tpu_torch.runtime.native import PagedKVScheduler


class EngineHealthError(RuntimeError):
    """The decode step itself is broken (every live row failing the numeric
    watchdog for several consecutive steps), not a single request: raised
    so the caller can fail over or restart instead of emitting garbage."""


@dataclasses.dataclass
class _Req:
    id: int
    prompt: List[int]
    max_gen_len: int
    temperature: float
    top_p: float
    cur_token: int = -1            # token to feed at the next step
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # set when the request was killed by the failure detector (numeric
    # watchdog / prefill exception); partial output stays readable
    error: Optional[str] = None
    want_logprobs: bool = False
    # logprob of generated[i] (natural log)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # logprob of prompt[i] given prompt[:i]; index 0 (bos) stays 0.0
    prompt_logprobs: List[float] = dataclasses.field(default_factory=list)


def _chosen_logprob(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Natural-log probability of each row's chosen token: logits [B, V],
    chosen [B] -> [B] float32."""
    lw = torch.log_softmax(logits.float(), dim=-1)
    return lw.gather(-1, chosen.long()[:, None])[:, 0]


def _prompt_logprobs(logits: torch.Tensor, targets) -> torch.Tensor:
    """logprob of ``targets[t]`` under ``logits[t]`` (the prefill row that
    predicts it).  [T, vocab], [T] -> [T]."""
    return _chosen_logprob(logits, torch.as_tensor(targets,
                                                   device=logits.device))


# -- batched projections around the paged walk (M=B products) ----------------


def _int8(w) -> bool:
    return isinstance(w, QuantizedTensor) and w.kind == "int8"


def _int4(w) -> bool:
    return isinstance(w, QuantizedTensor) and w.kind == "int4"


def batched_qkv_dot(xn: torch.Tensor, w) -> torch.Tensor:
    """[B, h] @ [G, h, c] -> [B, G, c] bf16, float32 accumulation; int8:
    each column's scale after the sum, then bf16 (JAX ``serving.py:164``);
    int4: the exact product over bf16(code * s)."""
    if _int8(w) or _int4(w):
        G, _, c = w.shape
        gemv = _gemv_int8 if _int8(w) else _gemv_int4
        return gemv(xn, w.q, w.s, bf16_out=True).reshape(-1, G, c)
    return model._mm(xn[None], w).transpose(0, 1)


def batched_o_dot(o3: torch.Tensor, w) -> torch.Tensor:
    """[B, G, c] @ [G, c, hidden] summed over G -> [B, hidden] float32;
    int8: each group's partial scaled before the sum over G; int4: one
    product over the G*c rows, the group scales along them."""
    B, G, c = o3.shape
    if _int8(w):
        return _gemv_int8(o3.reshape(B, G * c), w.q.reshape(G * c, -1),
                          w.s.reshape(G, -1), kg=c)
    if _int4(w):
        hidden = w.shape[-1]
        return _gemv_int4(o3.reshape(B, G * c), w.q.reshape(-1, hidden),
                          w.s.reshape(-1, hidden))
    return model._mm(o3.reshape(B, G * c), w.reshape(G * c, -1), out_f32=True)


def batched_ffn(xn2: torch.Tensor, w13, w2, ffn_act: str) -> torch.Tensor:
    """Gated FFN of the batch: bf16 weights, the model's own FFN; int8
    SwiGLU, gate and up scaled before it and down after its sum, on the
    GEMVs' int8 instances; int4 on their int4 instances, exact."""
    if _int8(w13):          # the engine admits only silu (_check_supported)
        return _ffn_int8(xn2, w13.q, w13.s, w2.q, w2.s)
    if _int4(w13):
        return _ffn_int4(xn2, w13.q, w13.s, w2.q, w2.s)
    return model._ffn(xn2, w13, w2, ffn_act)


def _logits_and_sample(params, x, residual, generator, temperatures, top_ps,
                       cfg: LlamaConfig):
    xn, _ = fused_add_rmsnorm_ref(x, residual, params["final_norm"],
                                  cfg.norm_eps)
    logits = model._lm_logits(xn, params["lm_head"])          # [B, V] f32
    nxt = sample_batch(logits, temperatures, top_ps, generator)
    return nxt, _chosen_logprob(logits, nxt)


@torch.no_grad()
def _paged_decode_step(params, k_pool, v_pool, tokens, positions, block_table,
                       seq_lens, generator, temperatures, top_ps,
                       cfg: LlamaConfig, rope):
    """One decode step of the batch through ``llama_decoder_layer_paged``.
    tokens/positions/seq_lens [B] and block_table [B, P] on the pools'
    device, temperatures/top_ps [B] on the host, rope = (cos_t, sin_t).
    Appends every row's K/V in place; returns (next tokens [B], their
    logprobs [B])."""
    g = cfg.n_heads // cfg.kv_heads
    cos_t, sin_t = rope
    lw = params["layers"]
    x = params["embed"][tokens.long()]                   # [B, hidden]
    residual = torch.zeros_like(x)
    for l in range(cfg.n_layers):
        # the whole weight stacks go in; the kernel picks layer l by offset
        attn, residual, _, _ = llama_decoder_layer_paged(
            x, residual, lw["wqkv_f"], lw["wo_f"], block_table, seq_lens,
            positions, k_pool, v_pool, l, lw["attn_norm"][l], cfg.norm_eps,
            cos_t, sin_t, group=g, rope_style=cfg.rope_style,
            window=cfg.sliding_window)
        xn2, residual = fused_add_rmsnorm_ref(attn, residual,
                                              lw["ffn_norm"][l], cfg.norm_eps)
        x = batched_ffn(xn2, lw["w13"][l], lw["w2"][l], cfg.ffn_act)
    return _logits_and_sample(params, x, residual, generator, temperatures,
                              top_ps, cfg)


@torch.no_grad()
def _paged_decode_step_batched(params, k_pool, v_pool, tokens, positions,
                               block_table, seq_lens, generator, temperatures,
                               top_ps, cfg: LlamaConfig, rope):
    """The batched-matmul step (same arguments and results as
    :func:`_paged_decode_step`): the projections, O-projection, FFN and LM
    head are M=B products that read each weight once per step, and only
    the per-request page walk is a kernel (``paged_attention``, which also
    appends the current K/V)."""
    B = tokens.shape[0]
    g, kv, hd = cfg.n_heads // cfg.kv_heads, cfg.kv_heads, cfg.head_dim_
    cos_t, sin_t = rope
    pos = positions.long()
    cos, sin = cos_t[pos], sin_t[pos]                     # [B, hd]
    lw = params["layers"]
    G = lw["wo_f"].shape[1]
    x = params["embed"][tokens.long()]
    residual = torch.zeros_like(x)
    for l in range(cfg.n_layers):
        xn, residual = fused_add_rmsnorm_ref(x, residual, lw["attn_norm"][l],
                                             cfg.norm_eps)
        y = batched_qkv_dot(xn, lw["wqkv_f"][l]).reshape(B, kv, (g + 2) * hd)
        q = y[..., : g * hd].reshape(B, kv, g, hd)
        k = y[..., g * hd:(g + 1) * hd]
        v = y[..., (g + 1) * hd:]
        q = model._apply_rope(q, cos[:, None, None], sin[:, None, None],
                              cfg.rope_style)
        k = model._apply_rope(k, cos[:, None], sin[:, None], cfg.rope_style)
        o, _, _ = paged_attention(q, k, v, k_pool, v_pool, block_table,
                                  seq_lens, l, window=cfg.sliding_window)
        attn = batched_o_dot(o.reshape(B, G, -1), lw["wo_f"][l]).to(x.dtype)
        xn2, residual = fused_add_rmsnorm_ref(attn, residual,
                                              lw["ffn_norm"][l], cfg.norm_eps)
        x = batched_ffn(xn2, lw["w13"][l], lw["w2"][l], cfg.ffn_act)
    return _logits_and_sample(params, x, residual, generator, temperatures,
                              top_ps, cfg)


class ServingEngine:
    """Continuous-batching decode over a paged KV pool.

    >>> eng = ServingEngine(params, cfg, page_size=16, num_pages=512)
    >>> eng.submit(0, prompt_tokens, max_gen_len=64)
    >>> outputs = eng.run()     # {req_id: [generated tokens]}
    """

    def __init__(self, params, cfg: LlamaConfig, *,
                 page_size: int = 16, num_pages: int = 256,
                 max_batch: int = 8, max_pages_per_req: Optional[int] = None,
                 kcfg: KernelConfig = KernelConfig(),
                 eos_id: Optional[int] = None,
                 kv_dtype=torch.bfloat16, seed: int = 0,
                 prefill_chunk: Optional[int] = 1024,
                 step_impl: Optional[str] = None):
        model._check_supported(cfg, "ServingEngine")
        if kv_dtype not in (torch.bfloat16, torch.float8_e4m3fn):
            raise NotImplementedError(f"kv_dtype {kv_dtype}: the serving "
                                      "pools are bf16 or float8_e4m3fn (JAX's "
                                      "int8 pools are unscaled and stay "
                                      "refused: ROADMAP.md section 3)")
        lw = params["layers"]
        weights = [lw[k] for k in ("wqkv_f", "wo_f", "w13", "w2")]
        if _int4(params["lm_head"]):
            raise NotImplementedError("ServingEngine: an int4 LM head (no JAX "
                                      "path makes one) is not ported "
                                      "(ROADMAP.md queue 2, mode 1.5)")
        for w in weights:
            if _int4(w):
                check_int4_group(w.group_size, "ServingEngine")
        if any(not isinstance(w, QuantizedTensor)
               and w.dtype != torch.bfloat16
               for w in weights + [params["lm_head"]]):
            raise NotImplementedError("ServingEngine: only bf16, int8 and "
                                      "int4 weights are ported")
        if kcfg.serving_w8a8:
            raise NotImplementedError("ServingEngine: serving_w8a8 (int8 "
                                      "activations) is not ported yet "
                                      "(ROADMAP.md queue 2, mode 6)")
        if prefill_chunk is not None and prefill_chunk & (prefill_chunk - 1):
            # the chunk must divide every power-of-two capacity it splits
            raise ValueError(f"prefill_chunk {prefill_chunk} is not a power "
                             "of two")
        if cfg.head_dim_ % 128 != 0 and step_impl != "fused":
            # the same routing as the JAX engine (its batched step's page
            # gather needs 128-lane head rows), so both packages run the
            # same step on the same inputs
            step_impl = "fused"
        if step_impl is None:
            # int4: the fused step, as in the JAX engine, whose batched
            # step would dequantize the weights per layer
            step_impl = "fused" if _int4(lw["wqkv_f"]) else "batched"
        if step_impl not in ("batched", "fused"):
            raise ValueError(f"unknown step_impl {step_impl!r}")
        if max_pages_per_req is None:
            max_pages_per_req = -(-cfg.max_seq_len // page_size)
        self.params = params
        self.cfg = cfg
        self.kcfg = kcfg
        self.eos_id = eos_id
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.sched = PagedKVScheduler(num_pages, page_size, max_pages_per_req)
        if cfg.sliding_window:
            # the rolling page buffer: ceil(window/page) + 1 real pages a
            # request at most (set_window checks the recycle-safety bound)
            self.sched.set_window(cfg.sliding_window)
        self.max_batch = max_batch
        self.step_impl = step_impl
        self._step = (_paged_decode_step_batched if step_impl == "batched"
                      else _paged_decode_step)
        dev = params["embed"].device
        shape = (cfg.n_layers, num_pages, cfg.kv_heads, page_size,
                 cfg.head_dim_)
        self.k_pool = torch.zeros(shape, dtype=kv_dtype, device=dev)
        self.v_pool = torch.zeros(shape, dtype=kv_dtype, device=dev)
        self._rope = model.rope_table(cfg, device=dev)
        self._reqs: Dict[int, _Req] = {}
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        # consecutive fully-failed steps before the engine declares itself
        # unhealthy
        self._bad_steps = 0
        self.max_bad_steps = 3
        self.last_results: Dict[int, _Req] = {}

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req_id: int, prompt_tokens: Sequence[int],
               max_gen_len: int, temperature: float = 0.0,
               top_p: float = 0.9, logprobs: bool = False) -> None:
        prompt = [int(t) for t in prompt_tokens]
        if not prompt:
            raise ValueError("empty prompt")
        self.sched.add(req_id, len(prompt))
        self._reqs[req_id] = _Req(req_id, prompt, max_gen_len, temperature,
                                  top_p, want_logprobs=logprobs)

    @torch.no_grad()
    def _prefill_into_pool(self, req: _Req) -> None:
        """Prefill the request's cached tokens, copy their pages into the
        pool and, on a first admission, sample the first token from the
        prompt logits.

        On re-admission after a recompute preemption (``req.generated`` not
        empty) the scheduler freed the pages but kept ``len`` = prompt +
        generated[:-1]; those tokens are prefilled again and decode resumes
        at ``cur_token`` without sampling a new token.

        The cache holds a power-of-two number of pages and only the real
        tokens are prefilled: the pages copied into the pool are those the
        JAX engine writes from its padded run, and rows past the tokens are
        never read.  Runs longer than ``prefill_chunk`` go in chunks of
        that many tokens (``model.prefill_chunk``).  Under the rolling page
        buffer the table slots below the window hold the NULL page 0: only
        the real pages are written."""
        cfg, page = self.cfg, self.page_size
        readmit = bool(req.generated)
        cached = req.prompt + (req.generated[:-1] if readmit else [])
        T = len(cached)
        n_bucket = 1
        while n_bucket * page < T:
            n_bucket *= 2
        cap = n_bucket * page
        dev = self.k_pool.device
        kc = torch.zeros((cfg.n_layers, cfg.kv_heads, cap, cfg.head_dim_),
                         dtype=self.k_pool.dtype, device=dev)
        vc = torch.zeros_like(kc)
        want_plp = req.want_logprobs and not readmit
        plp: List[float] = []
        chunk = self.prefill_chunk
        run = chunk if chunk and cap > chunk else T
        for p0 in range(0, T, run):
            toks = cached[p0:p0 + run]
            if p0:
                logits, kc, vc = model.prefill_chunk(
                    self.params, kc, vc, toks, cfg, pos0=p0, kcfg=self.kcfg)
            else:
                logits, kc, vc = model.prefill(self.params, kc, vc, toks, cfg,
                                               kcfg=self.kcfg)
            if want_plp:
                # logits row t predicts cached[p0 + t + 1]
                tgt = cached[p0 + 1:p0 + 1 + len(toks)]
                plp += _prompt_logprobs(logits[:len(tgt)], tgt).tolist()
        last_logits = logits[-1]
        if want_plp:
            req.prompt_logprobs = [0.0] + plp
        owned = self.sched.request_pages(req.id)
        n_used = min(len(owned), cap // page)
        real = np.flatnonzero(owned[:n_used])          # slots of real pages
        pages = torch.as_tensor(owned[real].astype(np.int64), device=dev)
        slots = torch.as_tensor(real, device=dev)
        L, kvh, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim_
        for pool, c in ((self.k_pool, kc), (self.v_pool, vc)):
            _bytes_of(pool)[:, pages] = _bytes_of(
                c[:, :, :n_used * page].reshape(L, kvh, n_used, page, hd)
                .transpose(1, 2))[:, slots]
        if readmit:
            # resume mid-generation: the next step feeds the last generated
            # token; sampling again would duplicate a token in the output
            req.cur_token = req.generated[-1]
            return
        tok = int(sample_batch(last_logits[None], [req.temperature],
                               [req.top_p], self._gen)[0])
        req.cur_token = tok
        req.generated.append(tok)
        if req.want_logprobs:
            req.logprobs.append(float(_prompt_logprobs(last_logits[None],
                                                       [tok])[0]))
        self._maybe_finish(req)

    def _fail(self, req: _Req, msg: str) -> None:
        """Kill one request (numeric fault / prefill exception): evict it,
        keep its partial output and error readable, keep serving."""
        req.error = msg
        if not req.done:
            req.done = True
            self.sched.release(req.id)

    def _maybe_finish(self, req: _Req) -> None:
        hit_eos = self.eos_id is not None and req.generated \
            and req.generated[-1] == self.eos_id
        total = len(req.prompt) + len(req.generated)
        if (hit_eos or len(req.generated) >= req.max_gen_len
                or total > self.sched.max_tokens):
            req.done = True
            self.sched.release(req.id)

    # -- decode loop -----------------------------------------------------------

    def step(self) -> bool:
        """One continuous-batching iteration: admit/grow/preempt through the
        scheduler, prefill fresh rows, run one decode step for the whole
        batch, sample, commit.  Returns False when idle."""
        ids, table, lens, poss, fresh = self.sched.prepare_batch(
            self.max_batch)
        B = len(ids)
        if B == 0:
            return False
        for b in range(B):
            if fresh[b]:
                req = self._reqs[int(ids[b])]
                try:
                    self._prefill_into_pool(req)
                except Exception as e:
                    # per-request fault isolation: a failing prefill kills
                    # only this request; the rebuild below drops it
                    self._fail(req, f"prefill: {type(e).__name__}: {e}")
        # prefill may have finished a fresh request (eos / max_gen_len=1 at
        # the first sampled token) and released its pages: the prepared
        # batch is stale; discard it (no lengths advance) and rebuild
        if any(self._reqs[int(i)].done for i in ids):
            self.sched.discard_batch()
            return self.step() if self.sched.num_requests else False

        P = self.sched.max_pages_per_req
        mb = self.max_batch
        tokens = np.zeros(mb, np.int64)
        temps = np.zeros(mb, np.float32)
        tops = np.full(mb, 0.9, np.float32)
        for b in range(B):
            r = self._reqs[int(ids[b])]
            tokens[b] = r.cur_token
            temps[b] = r.temperature
            tops[b] = r.top_p
        # the page-walk width is the live max length's page count rounded
        # up to a power of two, as in the JAX engine
        need_pages = int(max(lens)) // self.page_size + 1
        w = 1
        while w < need_pages:
            w *= 2
        w = min(w, P)
        table_p = np.zeros((mb, w), np.int32)
        table_p[:B] = table[:, :w]
        lens_p = np.zeros(mb, np.int32)
        lens_p[:B] = lens
        poss_p = np.zeros(mb, np.int32)
        poss_p[:B] = poss
        dev = self.k_pool.device

        def dev_t(a):
            return torch.from_numpy(a).to(dev)

        nxt, lp = self._step(
            self.params, self.k_pool, self.v_pool, dev_t(tokens),
            dev_t(poss_p), dev_t(table_p), dev_t(lens_p), self._gen, temps,
            tops, self.cfg, self._rope)
        nxt = nxt.cpu().numpy()
        lp = lp.cpu().numpy()
        self.sched.commit_batch()

        bad = 0
        for b in range(B):
            req = self._reqs[int(ids[b])]
            tok = int(nxt[b])
            lpb = float(lp[b])
            # numeric watchdog: an out-of-range token or a non-finite
            # logprob means this row's logits were NaN/inf; evict the
            # request instead of committing garbage into its output
            if not (0 <= tok < self.cfg.vocab_size) or not np.isfinite(lpb):
                self._fail(req, f"numeric watchdog: token={tok} "
                                f"logprob={lpb}")
                bad += 1
                continue
            req.cur_token = tok
            req.generated.append(tok)
            if req.want_logprobs:
                req.logprobs.append(lpb)
            self._maybe_finish(req)
        # engine breaker: every live row failing for several consecutive
        # steps is a fault of the step (bad params / broken kernel)
        if bad == B:
            self._bad_steps += 1
            if self._bad_steps >= self.max_bad_steps:
                raise EngineHealthError(
                    f"all {B} rows failed the numeric watchdog for "
                    f"{self._bad_steps} consecutive steps")
        else:
            self._bad_steps = 0
        return True

    def cancel(self, req_id: int) -> List[int]:
        """Abort a request (frees its pages at once); returns whatever was
        generated so far."""
        req = self._reqs.pop(req_id, None)
        if req is None:
            raise KeyError(req_id)
        if not req.done:
            self.sched.release(req_id)
        return req.generated

    def stats(self) -> Dict[str, int]:
        """Pool / queue occupancy for schedulers and dashboards."""
        return {
            "free_pages": self.sched.free_pages,
            "total_pages": self.sched.num_pages - 1,   # page 0 reserved
            "requests": self.sched.num_requests,
            "active": sum(1 for r in self._reqs.values() if not r.done),
            "failed": sum(1 for r in self._reqs.values()
                          if r.error is not None),
        }

    def run(self) -> Dict[int, List[int]]:
        """Decode until every submitted request finishes.  Per-request
        detail (logprobs, prompt logprobs) of the drained batch stays
        readable on ``self.last_results`` until the next ``run``."""
        while self.step():
            pass
        out = {rid: r.generated for rid, r in self._reqs.items()}
        self.last_results = dict(self._reqs)
        self._reqs = {r.id: r for r in self._reqs.values() if not r.done}
        return out
