"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Kernels are numbered as in ``PERF.md`` and ``ROADMAP.md`` (the table of
the JAX package's Pallas kernels).  Phases, in order; any failure ends the
run with a non-zero exit code:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: ``nvcc`` build of ``clusterfusion_tpu_torch/csrc`` for sm_90a;
3. kernel 4, ``flash_prefill_attention`` (wgmma fed by TMA), against its
   plain twin at ``FLASH_SHAPES``: the Llama-2-7B prefill at T 512, 2048
   and 4096, a GQA shape, a chunk (q_offset 256), TinyLlama's hd-64 GQA
   (kv 4, group 8, T 1024), and the chunk read from a strided view of a
   [kv, 2048, hd] buffer with NaN in every row past the chunk (output
   finite); call times (CUDA events) of the kernel, its plain twin and one
   PyTorch SDPA call, the bound, TFLOP/s and the share of the bf16 peak.
   Their device times (``torch.profiler``) come after phase 5, whose wall
   clocks a profiler session would slow;
4. kernel 7, ``fused_decoder_stack``, against its plain twin at full
   Llama-2-7B geometry (one step at pos 600 over a random-filled cache,
   NaN in every row above pos): logits, the appended K/V row, every other
   row unchanged (bit for bit); times and bound, and the step at kv_split
   32, 64 and 128.  After phase 5, kernel 7's device time by pass (split,
   GEMV, norms, merge; ``torch.profiler``, each kernel charged from the end
   of those before it) and the split pass at each kv_split;
5. end to end: ``Llama.synthetic(llama2_7b)`` streams 64 greedy tokens
   after a 512-token prompt through ``stream_generate``; prefill ms (warm,
   beside the process's first prefill), decode tokens/s, both kernels'
   launch counts on that run, and the first 8 tokens against the plain
   path (eager prefill and decode) on the card; then the warm prefill of a
   2048-token prompt (the config's whole cache), and both prefills' device
   time by kind (kernel 4, the projections, the elementwise rest);
6. kernel 10, ``paged_attention`` (a split pass over blocks of
   ``SPLIT`` rows and a merge), against its plain twin at the 7B serving
   shape (B 8, 32 kv heads, page 16, lens up to 2047 over shuffled pages),
   a GQA shape and a lone 4095-row request, with NaN in every pool row no
   request owns (the tails of the last pages too): output (each head's
   row within 2e-2 of its own largest value), appended rows, every other
   pool row unchanged, a repeat bit-identical; device busy time
   (``torch.profiler``, the split and merge apart) beside the wall time of
   a call, the plain twin's time and the bound (an SDPA over the same rows
   gathered beforehand is printed as context only);
7. kernel 9, ``llama_decoder_layer_paged``, against its plain twin on one
   layer of the 7B weights at B 4 (the shape ``Llama.generate`` gives it
   for one prompt: one live row, three padding rows on the NULL page), B 8
   and B 1, with the same NaN rows and a bit-identical repeat, and its
   page-1 sglang entry at 7B width;
8. serving end to end: ``ServingEngine`` (page 16, max_batch 8) serves 8
   greedy requests of 32..512 prompt tokens, 32 new tokens each, through
   the batched step (``paged_attention``); then ``Llama.generate`` on one
   prompt with ``fused=True`` runs the fused step
   (``llama_decoder_layer_paged``).  Aggregate decode tokens/s, ms per
   step, warm prefill ms per request, launch counts, and each request's
   first 8 tokens against the plain path on the card;
9. speculative decoding: kernel 8, ``fused_verify_stack``, against its
   plain twin at 7B, pos 600, n 5 and n 9, over a random-filled cache with
   large stale rows above pos (logits, the n appended rows, every other row
   unchanged, a repeat bit-identical), its time beside the stack's at the same pos, the plain
   twin's and the bound; then ``spec_generate`` (n_draft 4, 32 tokens after
   a 128-token prompt) with a self-draft (a second engine on the same
   weights: every draft accepted but where the target's top-2 gap is
   <= 0.1, one verify launch per round) and with an unrelated small draft
   (4 layers, hidden 1024, seed 1), each stream against
   ``stream_generate`` and the plain path under the top-2-gap rule, rounds,
   accepted drafts and tokens/s beside ``stream_generate``'s;
10. DeepSeek kernels at DeepSeek-V2-Lite geometry (the Llama engine freed
   first): kernel 12, ``deepseek_decoder_stack_layer``, at capacity 4096
   and pos 600, 0 and 4095 over random rows with large garbage at and
   above pos (output, the appended row with its zero pad, every other row
   unchanged, a repeat bit-identical, 5 kernels a call, 4 at pos 0);
   kernel 11 through the public op ``deepseek_decoder_layer`` over a
   4096-row cache, against its twin and the float32 oracle, a repeat
   bit-identical; kernel 5, ``fused_ffn``, stacked at 2048 x 11264; each
   with its time (CUDA events and ``torch.profiler``; kernels 11 and 12 as
   device busy time, by pass), the plain twin's and the bound;
11. DeepSeek end to end: ``DeepSeekConfig(max_seq_len=4096)`` (the JAX
   benchmark's configuration, dense FFN, 27 layers) through
   ``generate_greedy``, 64 tokens after a 128-token prompt: prefill ms,
   decode ms per step and tokens/s, device busy share and the step's
   kernels by device time, launches of kernels 12 and 5 (27 per step each;
   5 CUDA kernels a call of kernel 12),
   the first 8 tokens against the plain path under the top-2-gap rule;
   then V2-Lite's published MoE + YaRN config at 4 layers, a fused step
   against the eager one and 16 greedy steps.

Phases 12-14 run after phase 9, while the Llama-2-7B engine is alive (its
weights are used in place), and before the DeepSeek phases free it:

12. kernels 1 and 2, ``rmsnorm`` and ``fused_add_rmsnorm``, at (1, 4096) and
   (64, 8192) in bf16 and float32, and kernel 3, ``gemv``, over the 7B LM
   head (4096 x 32000), against their plain twins, with their device times
   (``torch.profiler``) beside the time of a call (CUDA events), the
   twins', one PyTorch call's (``rms_norm``; ``torch.mm`` with a float32
   output) and the bounds; kernel 3 gives the same bits on every call, and
   it and ``torch.mm`` are timed with L2 cold (each call reads one of 8
   copies of the head) and warm;
13. kernel 6, ``_fused_decoder_layer``, at 7B geometry (layer 1, a 4096-row
   cache, pos 600, large garbage at and above pos): full mode with the
   append (output, residual, the appended rows, every other row unchanged);
   partials mode on the halves [0, 300) and [300, 600), the second folding
   the current token, merged with the sequence-parallel formula against one
   partials call over [0, 600) and, O-projected, against the full output;
   both public ops (``llama_decoder_layer``, ``llama_decoder_layer_sglang``)
   at 32 heads of 128 over 600 rows; device time and call time, the
   twin's and the bound;
14. the tensor- and sequence-parallel steps end to end in a one-rank NCCL
   group: ``build_mesh(MeshConfig())``, ``shard_params`` (views of the
   engine's weights), a 512-token ``prefill`` (kernel 4), 32 greedy steps
   through ``make_sharded_decode_step`` and 8 through
   ``make_sp_sharded_decode_step``; each stream against kernel 7's step
   (teacher-forced) and the plain path under the top-2-gap rule, ms per
   step, tokens/s, launches of kernels 6 and 2 per step (32 and 32 in the
   tp step; 32 and 0 in the sp step, which normalises plain as JAX's
   does), and the tp step's kernels by device time;
15. kernels 13 and 14 and the fused-collective tp step on this one card
   (run after 14, while the engine is alive): (a) the all-reduce
   (``all_reduce``) and all-gather (``all_gather``) in loopback, N virtual
   ranks in one launch at N 2 and 4, at the tp step's shapes ([1, 4096]
   float32 at Stage.ATTN and Stage.FFN; the 7B logits' [32000 / N]
   shards), 64 calls with fresh inputs, each bit-equal to its twin's
   rank-order sum on every rank, the error word 0; device time, call time,
   twin time and bound; (b) mode 5 of kernel 7 (``reduce_axis``) at tp 2:
   the engine's weights and a random cache in two tp shards, one virtual
   rank per CUDA stream, against kernel 7's unsharded step at phase 4's
   limits, both ranks' x_out and residual bit-identical; (c) this slice's
   path: ``make_sharded_decode_step(fused_collectives=True)`` at tp 2, two
   virtual ranks on their streams, a 512-token prefill and 16 greedy steps,
   kernel 7 once, kernel 13 twice per layer and kernel 14 once per step and
   rank, the ranks' logits bit-identical, the tokens kernel 7's under the
   top-2-gap rule.

Then, where the machine has two cards or more:

16. one rank per card (``torch.multiprocessing``, a ``file://`` store,
   NCCL): kernels 13 and 14 over NVLink at the tp step's shapes against
   their plain versions (bit-equal, every rank identical) and NCCL, each
   timed beside NCCL on the same bytes; then the seeded 7B weights, a
   512-token prefill and 32 greedy steps of the fused-collective tp step
   and of the NCCL tp step, ms per step before any profiler, both streams
   against kernel 7 teacher-forced on rank 0.  On one card it prints
   ``[multicard] skipped cards=1``: nothing ran.  The collectives' times
   are the slowest rank's median of 5 batches of 100 back-to-back calls,
   each batch started after ``synchronize`` and ``dist.barrier``.
   ``python3 chip_smoke.py multicard`` runs phases 1, 2 and 16 alone.

Then one JSON line per kernel table, the card line, and last
``{"ok": true, "device": {...}}``.  Weights are random, from a seed.
"""

from __future__ import annotations

import functools
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

LIMITS_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 output rounding + sum order
# paged_attention's twin rounds where the kernel rounds, so each head's
# output row must agree to about two bf16 ulps of its own largest value
ROW_REL_TOL = 2e-2


def card_rates(name: str):
    """(HBM bytes/s, dense bf16 FLOP/s) of the card's variant (NVIDIA data
    sheets)."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12, 989e12
    if "H100" in n and "PCIE" in n:
        return 2.0e12, 756e12
    return 3.35e12, 989e12                    # H100 SXM


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


MARKER = "spin_kernel"     # torch.cuda._sleep's kernel


def _profiled_calls(fn, reps: int) -> None:
    """``reps`` calls of ``fn`` inside a profiler session, between two
    marker kernels (left out of every sum): a profile loses its first or
    last device event now and then, and so loses a marker's, not a call's."""
    torch.cuda._sleep(1000)
    for _ in range(reps):
        fn()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def device_ms(fn, reps: int = 20, attempts: int = 3) -> float:
    """Mean device time in ms of all kernels one call of ``fn`` launches,
    from ``torch.profiler`` (the host's time between launches excluded).
    A profile now and then comes back without its device events, or
    without some of them; such a profile is taken again, up to
    ``attempts`` times in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _profiled_calls(fn, reps)
        total, count = 0.0, 0
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            if t and e.device_type == torch.autograd.DeviceType.CUDA \
                    and MARKER not in e.key:
                total += t
                count += e.count
        # a profile that lost some of its kernels' events (not a whole
        # number of kernels per call) would under-report: take it again,
        # and keep the last one with a note
        if total > 0 and (count % reps == 0 or attempt == attempts):
            if count % reps:
                say("profiler", events_not_whole_per_call=count, reps=reps)
            if attempt > 1:
                say("profiler", device_events_on_attempt=attempt)
            return total / 1e3 / reps
    raise AssertionError(f"the profiler saw no device time in {attempts} "
                         "profiles")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    say("card", smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())
    return smi


def phase_build():
    from clusterfusion_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    say("build", lib=path.name, seconds=f"{time.perf_counter() - t0:.1f}",
        flags=repr(" ".join(_build.NVCC_FLAGS)))


FLASH_SHAPES = (            # label, kv, group, T, q_offset, hd, view
    ("7b", 32, 1, 512, 0, 128, False),
    ("gqa", 8, 4, 300, 0, 128, False),
    ("chunk", 32, 1, 256, 256, 128, False),
    ("7b_2048", 32, 1, 2048, 0, 128, False),
    ("7b_4096", 32, 1, 4096, 0, 128, False),
    ("hd64_gqa", 4, 8, 1024, 0, 64, False),   # TinyLlama-1.1B's heads
    ("chunk_view", 32, 1, 256, 256, 128, True),
)


def phase_flash(dev, hbm, peak):
    """Kernel 4 against its plain twin at every FLASH_SHAPES entry; ms,
    plain_ms and library_ms are call times (CUDA events around one call,
    the host's launch included).  Returns the cases for
    phase_flash_device."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for label, kv, g, T, q_off, hd, view in FLASH_SHAPES:
        keys = q_off + T
        q = torch.randn((kv, T, g, hd), generator=gen, device=dev).bfloat16()
        if view:
            # a [kv, 2048, hd] buffer, NaN in every row past the chunk; the
            # kernel reads its first keys + 64 rows where they lie
            kbuf = torch.full((kv, 2048, hd), float("nan"),
                              dtype=torch.bfloat16, device=dev)
            vbuf = kbuf.clone()
            kbuf[:, :keys] = torch.randn((kv, keys, hd), generator=gen,
                                         device=dev).bfloat16()
            vbuf[:, :keys] = torch.randn((kv, keys, hd), generator=gen,
                                         device=dev).bfloat16()
            k, v = kbuf[:, :keys + 64], vbuf[:, :keys + 64]
        else:
            k = torch.randn((kv, keys, hd), generator=gen, device=dev).bfloat16()
            v = torch.randn((kv, keys, hd), generator=gen, device=dev).bfloat16()
        out = fp.flash_prefill_attention(q, k, v, q_offset=q_off)
        ref = fp.flash_prefill_attention_plain(q, k, v, q_offset=q_off)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all())
        diff = (out.float() - ref.float()).abs()
        max_abs = diff.max().item()
        max_rel = (diff / ref.float().abs().clamp_min(1e-3)).max().item()
        call = functools.partial(fp.flash_prefill_attention, q, k, v,
                                 q_offset=q_off)
        ms = time_ms(call, 20)
        plain_ms = time_ms(lambda: fp.flash_prefill_attention_plain(
            q, k, v, q_offset=q_off), 5 if T < 4096 else 3)
        # one PyTorch call computing the same function, timed only
        qs = q.permute(0, 2, 1, 3).reshape(1, kv * g, T, hd).contiguous()
        ks, vs = k[None, :, :keys], v[None, :, :keys]
        if q_off:
            mask = (torch.arange(keys, device=dev)[None, :]
                    <= q_off + torch.arange(T, device=dev)[:, None])
            lib_fn = functools.partial(F.scaled_dot_product_attention, qs,
                                       ks, vs, attn_mask=mask,
                                       enable_gqa=g > 1)
        else:
            lib_fn = functools.partial(F.scaled_dot_product_attention, qs,
                                       ks, vs, is_causal=True,
                                       enable_gqa=g > 1)
        lib_ms = time_ms(lib_fn, 20)
        pairs = kv * g * sum(q_off + i + 1 for i in range(T))
        flops = 4 * hd * pairs
        # each input read once (the K/V rows the chunk attends), out written
        nbytes = 2 * (2 * q.numel() + 2 * kv * keys * hd)
        bound = max(flops / peak, nbytes / hbm) * 1e3
        bound_by = "operations" if flops / peak > nbytes / hbm else "bytes"
        say("flash_prefill", kernel=4, shape=label, kv=kv, group=g, T=T,
            hd=hd, q_offset=q_off, strided_view_nan_past_chunk=view,
            finite=finite, max_abs_err=f"{max_abs:.3g}",
            max_rel_err=f"{max_rel:.3g}", tol="atol=2e-2,rtol=2e-2",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}",
            bound_by=bound_by, tflops=f"{flops / ms / 1e9:.1f}",
            share_of_peak=f"{flops / ms / 1e9 / (peak / 1e12):.3f}")
        if not finite:
            raise AssertionError(f"flash_prefill {label}: non-finite output")
        torch.testing.assert_close(out.float(), ref.float(), **LIMITS_TOL)
        call64 = functools.partial(
            fp.flash_prefill_attention, q, k, v, q_offset=q_off,
            kcfg=KernelConfig(prefill_block_rows=64))
        cases.append(dict(label=label, call=call, call64=call64, lib=lib_fn,
                          flops=flops,
                          row=dict(max_abs_err=max_abs, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=bound_by, library_ms=lib_ms)))
    return cases


def phase_flash_device(cases, peak):
    """Device time (``torch.profiler``) of kernel 4 (128-row blocks, the
    default, and 64-row blocks) and of SDPA at every phase-3 shape; run
    after phase 5, whose wall clocks a profiler session
    would slow.  Returns the T 512 7B row for the kernels line, its ms and
    library_ms the device times."""
    for c in cases:
        ms = device_ms(c["call"])
        ms64 = device_ms(c["call64"])
        lib_ms = device_ms(c["lib"])
        tf = c["flops"] / ms / 1e9
        say("flash_prefill_device", kernel=4, shape=c["label"],
            device_ms=f"{ms:.4f}", device_ms_block_rows_64=f"{ms64:.4f}",
            library_device_ms=f"{lib_ms:.4f}",
            bound_ms=f"{c['row']['bound_ms']:.4f}",
            bound_by=c["row"]["bound_by"], tflops=f"{tf:.1f}",
            share_of_peak=f"{tf / (peak / 1e12):.3f}",
            library_tflops=f"{c['flops'] / lib_ms / 1e9:.1f}",
            over_library=f"{ms / lib_ms:.3f}")
        c["row"].update(ms=ms, library_ms=lib_ms)
    return next(c["row"] for c in cases if c["label"] == "7b")


def _same_bits(a, b) -> bool:
    """Bit equality of two bf16 tensors (NaN rows compare equal)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int16),
                                              b.view(torch.int16))


STACK_KV_SPLITS = (32, 64, 128)


def phase_stack(eng, dev, hbm, peak, pos=600):
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    cfg, p = eng.cfg, eng.params
    lw = p["layers"]
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    gen = torch.Generator(device=dev).manual_seed(2)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    # rows above pos hold NaN: the kernel writes row pos and reads rows
    # < pos only, as its plain twin does
    kc[:, :, pos + 1:] = float("nan")
    vc[:, :, pos + 1:] = float("nan")
    x = p["embed"][torch.tensor([7], device=dev)]
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
              eps=cfg.norm_eps, final_norm=p["final_norm"],
              lm_head=p["lm_head"])
    args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"])
    kk, vk = kc.clone(), vc.clone()
    out = sk.fused_decoder_stack(*args, kk, vk, pos, **kw)
    ref = sk.fused_decoder_stack_plain(*args, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    lg_err = (out[0] - ref[0]).abs().max().item()
    lg_rel = lg_err / ref[0].abs().max().item()
    # appended rows, per layer: [L] max abs error and max |row|
    row_err = torch.maximum(
        (kk[:, :, pos].float() - kc[:, :, pos].float()).abs().amax(dim=(1, 2)),
        (vk[:, :, pos].float() - vc[:, :, pos].float()).abs().amax(dim=(1, 2)))
    row_mag = torch.maximum(kc[:, :, pos].float().abs().amax(dim=(1, 2)),
                            vc[:, :, pos].float().abs().amax(dim=(1, 2)))
    # Layer 0's row comes from the same input in both: atol 0.05, the JAX
    # suite's bf16 tolerance.  Deeper rows inherit f32 summation-order noise
    # that flips bf16 roundings and compounds layer by layer (about one bf16
    # ulp per 8-10 layers at this geometry): atol 0.05 + rtol 1e-2 of |row|.
    row_tol = 0.05 + 1e-2 * row_mag
    rows_ok = bool(row_err[0] <= 0.05) and bool((row_err <= row_tol).all())
    others = torch.ones(kc.shape[2], dtype=torch.bool, device=dev)
    others[pos] = False
    unchanged = (_same_bits(kk[:, :, others], kc[:, :, others])
                 and _same_bits(vk[:, :, others], vc[:, :, others]))
    finite = bool(torch.isfinite(out[0]).all()) and bool(
        torch.isfinite(out[1].float()).all())
    say("stack", kernel=7, pos=pos, layers=cfg.n_layers, logits_max_abs_err=f"{lg_err:.4g}",
        logits_err_over_max=f"{lg_rel:.4g}", tol_logits=2e-2,
        kv_row_err_layer0=f"{row_err[0].item():.3g}", tol_layer0=0.05,
        kv_row_err_max=f"{row_err.max().item():.4g}",
        kv_row_err_by_layer=[round(e, 4) for e in row_err[::4].tolist()],
        kv_row_max_abs=f"{row_mag.max().item():.3g}",
        tol_rows="atol=0.05+rtol=1e-2", other_rows_unchanged=unchanged,
        nan_above_pos=True, finite=finite,
        kernels_per_step=sk.last_step_kernels)
    if not (lg_rel <= 2e-2 and rows_ok and unchanged and finite):
        raise AssertionError("fused_decoder_stack disagrees with its plain twin")
    step = functools.partial(sk.fused_decoder_stack, *args, kk, vk, pos, **kw)
    ms = time_ms(step, 20)
    plain_ms = time_ms(lambda: sk.fused_decoder_stack_plain(
        *args, kc, vc, pos, **kw), 3, warmup=1)
    wbytes = sum(t.numel() * t.element_size() for t in
                 (lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], lw["attn_norm"],
                  lw["ffn_norm"], p["final_norm"], p["lm_head"]))
    L, kvh = cfg.n_layers, cfg.kv_heads
    kv_read = 2 * L * kvh * pos * hd * 2          # rows < pos, K and V
    kv_write = 2 * L * kvh * hd * 2
    nbytes = wbytes + kv_read + kv_write + 4 * cfg.vocab_size + 2 * 2 * cfg.hidden_dim
    weights = sum(t.numel() for t in (lw["wqkv_f"], lw["wo_f"], lw["w13"],
                                      lw["w2"], p["lm_head"]))
    flops = 2 * weights + 4 * L * cfg.n_heads * (pos + 1) * hd
    bound = max(nbytes / hbm, flops / peak) * 1e3
    say("stack", ms_per_step=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound:.4f}", bound_by="bytes",
        weight_bytes=wbytes, kv_bytes_read=kv_read,
        kv_split=KernelConfig().kv_split)
    # the step at each candidate kv_split (CUDA events), the default's too
    steps = {ks: functools.partial(sk.fused_decoder_stack, *args, kk, vk, pos,
                                   kcfg=KernelConfig(kv_split=ks), **kw)
             for ks in STACK_KV_SPLITS}
    say("stack_kv_split", pos=pos, **{f"ms_{ks}": f"{time_ms(f, 20):.4f}"
                                      for ks, f in steps.items()})
    row = dict(max_abs_err=lg_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by="bytes" if nbytes / hbm >= flops / peak
               else "operations", library_ms=None)
    return row, dict(step=step, steps=steps, pos=pos, kv_read=kv_read,
                     hbm=hbm)


STACK_PASSES = (("split", "attn_split_kernel"), ("gemv", "ring_gemv_kernel"),
                ("norms", "resnorm_kernel"), ("merge", "attn_merge_kernel"))


def timeline_by_pass(fn, passes, reps: int = 8):
    """``torch.profiler`` over ``reps`` calls of ``fn``, per call: the
    device's busy time, the span from the first kernel's start to the last
    one's end, the sum of the kernels' own durations, and the busy time by
    pass.  Kernels launched with programmatic dependent launch start while
    the one before them runs and wait inside, so their own durations
    overlap; each kernel is charged here only from the end of the kernels
    before it to its own end (the time the step advanced while it was the
    last to finish), so the passes add up to the busy time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):     # a profile now and then lacks device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _profiled_calls(fn, reps)
        kern = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and MARKER not in e.name)
        whole = kern and len(kern) % reps == 0  # none of the calls' kernels lost
        if whole or (kern and attempt == 3):
            if attempt > 1:
                say("profiler", device_events_on_attempt=attempt,
                    whole_per_call=bool(whole))
            break
    else:
        raise AssertionError("the profiler saw no device time in 3 profiles")
    out = {k: 0.0 for k, _ in passes}
    out["other"] = 0.0
    counts = {k: 0 for k in out}
    end, own = kern[0][0], 0.0
    for start, stop, name in kern:
        own += stop - start
        k = next((k for k, key in passes if key in name), "other")
        counts[k] += 1
        if stop > end:
            out[k] += stop - max(start, end)
            end = stop
    span = kern[-1][1] - kern[0][0]
    per = 1e3 * reps            # µs over reps -> ms per call
    return (sum(out.values()) / per, span / per, own / per,
            {k: v / per for k, v in out.items()},
            {k: v / reps for k, v in counts.items()})


def phase_stack_device(case):
    """Kernel 7's device time by pass (``torch.profiler``), at the default
    kv_split and the split pass at each candidate; run after phase 5, whose
    wall clocks a profiler session would slow."""
    busy, span, own, out, n = timeline_by_pass(case["step"], STACK_PASSES)
    split_tbps = case["kv_read"] / (out["split"] * 1e-3) / 1e12 \
        if out["split"] else 0.0
    say("stack_device", kernel=7, pos=case["pos"], busy_ms=f"{busy:.4f}",
        span_ms=f"{span:.4f}", kernels_own_sum_ms=f"{own:.4f}",
        **{f"{k}_ms": f"{v:.4f}" for k, v in out.items()},
        **{f"{k}_launches": f"{v:g}" for k, v in n.items()},
        split_TBps=f"{split_tbps:.3f}",
        split_bound_ms=f"{case['kv_read'] / case['hbm'] * 1e3:.4f}",
        note="each kernel charged from the end of those before it to its "
             "own end")
    split = {ks: timeline_by_pass(f, STACK_PASSES)[3]["split"]
             for ks, f in case["steps"].items()}
    say("stack_device_kv_split", pos=case["pos"],
        **{f"split_ms_{ks}": f"{v:.4f}" for ks, v in split.items()})


def phase_e2e(eng, dev):
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    cfg = eng.cfg
    text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
    prompt = eng.tokenizer.encode(text, bos=True, eos=False)
    n_new = 64
    # the process's first prefill pays cuBLAS's and the allocator's set-up;
    # the timed run below is warm
    kc, vc = model.init_cache(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(eng.params, kc, vc, prompt, cfg)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    del kc, vc
    fp.launches = 0
    sk.launches = 0
    stamps, toks = [], []
    for t in eng.stream_generate(prompt, n_new, temperature=0.0):
        stamps.append(time.perf_counter())
        toks.append(t)
    flash_launches, stack_launches = fp.launches, sk.launches
    st = eng.stats
    decode_s = stamps[-1] - stamps[0]
    tok_s = (len(toks) - 1) / decode_s
    say("e2e", prompt_tokens=len(prompt), new_tokens=len(toks),
        prefill_ms=f"{st.prefill_s * 1e3:.2f}",
        prefill_first_call_ms=f"{first_ms:.2f}",
        decode_tokens_per_s=f"{tok_s:.2f}",
        decode_ms_per_step=f"{decode_s * 1e3 / (len(toks) - 1):.3f}",
        flash_prefill_launches=flash_launches,
        stack_launches=stack_launches)
    if flash_launches != cfg.n_layers or stack_launches < len(toks) - 1:
        raise AssertionError("the main path did not run both kernels")
    if len(toks) != n_new or not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"bad tokens {toks}")
    plain, gaps, bad = check_against_plain(eng, dev, prompt, toks)
    agree = sum(a == b for a, b in zip(plain, toks[:8]))
    say("e2e", kernel_tokens=toks[:8], plain_tokens=plain, agree=f"{agree}/8",
        top2_gaps=[round(x, 3) for x in gaps], disagree_where_gap_gt_0_1=bad)
    if bad:
        raise AssertionError(f"kernel and plain paths disagree at steps {bad}")
    # a 2048-token prompt fills the 7B config's whole cache
    long_text = ("The quick brown fox jumps over the lazy dog. " * 60)[:2047]
    prompt_2k = eng.tokenizer.encode(long_text, bos=True, eos=False)
    kc, vc = model.init_cache(cfg, device=dev)
    run_2k = lambda: model.prefill(eng.params, kc, vc, prompt_2k, cfg)  # noqa: E731
    t0 = time.perf_counter()
    logits_2k, _, _ = run_2k()
    torch.cuda.synchronize()
    first_2k = (time.perf_counter() - t0) * 1e3
    warm_2k = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_2k()
        torch.cuda.synchronize()
        warm_2k.append((time.perf_counter() - t0) * 1e3)
    finite_2k = bool(torch.isfinite(logits_2k).all())
    say("e2e_prefill", prompt_tokens=len(prompt_2k),
        warm_ms=f"{statistics.median(warm_2k):.2f}",
        first_call_ms=f"{first_2k:.2f}", finite=finite_2k)
    if len(prompt_2k) != cfg.max_seq_len or not finite_2k:
        raise AssertionError("the 2048-token prefill failed")
    # device time of both prefills by kind, after every wall clock above
    for pr in (prompt, prompt_2k):
        dev_ms, prof_wall, rows = profile_by_kernel(
            lambda: model.prefill(eng.params, kc, vc, pr, cfg), reps=3,
            top=10 ** 6)
        split = prefill_split(rows)
        say("e2e_prefill_profile", prompt_tokens=len(pr),
            device_ms=f"{dev_ms:.3f}", profiled_wall_ms=f"{prof_wall:.3f}",
            kernel4_ms=f"{split['kernel4'][0]:.3f}",
            kernel4_launches=f"{split['kernel4'][1]:g}",
            projections_ms=f"{split['projections'][0]:.3f}",
            elementwise_ms=f"{split['elementwise'][0]:.3f}",
            elementwise_launches=f"{split['elementwise'][1]:g}",
            top=[(n[:40], round(t, 3), c) for n, t, c in rows[:8]])
        if split["kernel4"][1] != cfg.n_layers:
            raise AssertionError("the profiled prefill did not run kernel 4 "
                                 "once per layer")
    del kc, vc
    return flash_launches, stack_launches


def prefill_split(rows):
    """{kind: (device ms, launches)} of ``profile_by_kernel`` rows, by kind:
    kernel 4, the projections (cuBLAS/CUTLASS products) and the rest
    (elementwise work, casts, copies)."""
    out = {"kernel4": [0.0, 0.0], "projections": [0.0, 0.0],
           "elementwise": [0.0, 0.0]}
    for name, ms, count in rows:
        low = name.lower()
        if "flash_prefill" in low:
            kind = "kernel4"
        elif any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass",
                                    "gemv", "matmul")):
            kind = "projections"
        else:
            kind = "elementwise"
        out[kind][0] += ms
        out[kind][1] += count
    return out


SERVE_LENS = [0, 1, 15, 16, 255, 511, 1000, 2047]


def paged_pools(dev, L, kv, hd, page, lens, seed):
    """Random bf16 pools and a block table over pages shuffled by a seeded
    permutation; request b owns lens[b] // page + 1 pages, page 0 none."""
    need = [n // page + 1 for n in lens]
    n_pages = 1 + sum(need)
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    table = torch.zeros((len(lens), max(need)), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at:at + n]
        at += n
    shape = (L, n_pages, kv, page, hd)
    kp = torch.randn(shape, generator=gen).bfloat16().to(dev)
    vp = torch.randn(shape, generator=gen).bfloat16().to(dev)
    return kp, vp, table.to(dev), torch.tensor(lens, dtype=torch.int32,
                                                device=dev)


def nan_unowned(kp, vp, table, lens):
    """NaN in every pool row no request owns: pages no request holds and,
    in each request's pages, the rows at and past lens[b] (the row the
    call appends among them), in every layer."""
    page = kp.shape[3]
    owned = torch.zeros(kp.shape[1:2] + (page,), dtype=torch.bool,
                        device=kp.device)
    for b, n in enumerate(lens.tolist()):
        j = torch.arange(n, device=kp.device)
        owned[table[b, j // page].long(), j % page] = True
    free = ~owned[None, :, None, :, None].expand(kp.shape)
    kp[free] = float("nan")
    vp[free] = float("nan")


def busy_ms(fn, passes=()):
    """Device busy ms per call of ``fn`` (``timeline_by_pass``: kernels
    launched with programmatic dependent launch overlap, so each is charged
    from the end of those before it) and the busy ms by pass."""
    busy, _, _, by_pass, _ = timeline_by_pass(fn, passes)
    return busy, by_pass


K6_PHASES = ("norm", "qkv", "rope", "split_kv", "merge", "oproj", "fold")
K5_PHASES = ("norm", "gate_up", "act", "down", "cluster_sum", "fold", "end")


def launch_phases(mod, fn, rows, names):
    """The phases inside one launch of kernel 5 or 6 (one call of ``fn``
    with the wrapper's ``phase_stamps``: each block's %globaltimer at the
    kernel's phase boundaries): the mean µs of each phase over the blocks,
    the launch's span, and how far its last block ends after the mean."""
    st = torch.zeros((rows, 8), dtype=torch.int64, device="cuda")
    mod.phase_stamps = st
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        mod.phase_stamps = None
    s = st[st[:, 0] != 0].double()
    out = {}
    for k, name in enumerate(names):
        ok = (s[:, k + 1] != 0) & (s[:, k] != 0)
        out[f"{name}_us"] = (f"{(s[ok, k + 1] - s[ok, k]).mean().item() / 1e3:.2f}"
                             if ok.any() else "none")
    out["span_us"] = f"{(s[:, 7].max() - s[:, 0].min()).item() / 1e3:.2f}"
    out["last_block_after_mean_us"] = \
        f"{(s[:, 7].max() - s[:, 7].mean()).item() / 1e3:.2f}"
    out["stamped_blocks"] = s.shape[0]
    return out


def row_rel_err(out, ref, hd):
    """Largest |out - ref| in one head's row of ``hd`` values, over that
    row's largest |ref|, the worst row."""
    o, r = out.float().reshape(-1, hd), ref.float().reshape(-1, hd)
    return ((o - r).abs().amax(-1)
            / r.abs().amax(-1).clamp_min(1e-6)).max().item()


def append_mask(kp, table, lens, layer):
    """True at every pool element the appends of ``layer`` write."""
    page = kp.shape[3]
    mask = torch.zeros(kp.shape[:2] + (page,), dtype=torch.bool,
                       device=kp.device)
    for b, n in enumerate(lens.tolist()):
        mask[layer, int(table[b, n // page]), n % page] = True
    return mask[:, :, None, :, None].expand(kp.shape)


PAGED_PASSES = (("split", "paged_split_kernel"),
                ("merge", "paged_merge_kernel"))


def phase_paged_attention(dev, hbm, peak):
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    for label, kv, g, lens_l in (("7b", 32, 1, SERVE_LENS),
                                 ("gqa", 8, 4, SERVE_LENS),
                                 ("long", 32, 1, [4095])):
        hd, page, L, layer, B = 128, 16, 2, 1, len(lens_l)
        kp, vp, table, lens = paged_pools(dev, L, kv, hd, page, lens_l, 4)
        nan_unowned(kp, vp, table, lens)
        q = torch.randn((B, kv, g, hd), generator=gen, device=dev).bfloat16()
        k_new = torch.randn((B, kv, hd), generator=gen, device=dev).bfloat16()
        v_new = torch.randn((B, kv, hd), generator=gen, device=dev).bfloat16()
        k0, v0 = kp.clone(), vp.clone()
        kr, vr = kp.clone(), vp.clone()
        out, _, _ = pd.paged_attention(q, k_new, v_new, kp, vp, table, lens,
                                       layer)
        again, _, _ = pd.paged_attention(q, k_new, v_new, kp, vp, table,
                                         lens, layer)
        ref, _, _ = pd.paged_attention_plain(q, k_new, v_new, kr, vr, table,
                                             lens, layer)
        torch.cuda.synchronize()
        repeat = _same_bits(out, again)
        if not (repeat and bool(torch.isfinite(out.float()).all())):
            raise AssertionError("paged_attention: a repeat differs or the "
                                 "output is not finite")
        max_abs = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), **LIMITS_TOL)
        row_rel = row_rel_err(out, ref, hd)
        if not row_rel <= ROW_REL_TOL:
            raise AssertionError(f"paged_attention: a head's row differs by "
                                 f"{row_rel:.3g} of its largest value")
        app = append_mask(kp, table, lens, layer)
        rows_b = torch.arange(B, device=dev)
        pg = table[rows_b, lens.long() // page].long()
        appended_exact = (
            torch.equal(kp[layer][pg, :, lens.long() % page], k_new)
            and torch.equal(vp[layer][pg, :, lens.long() % page], v_new))
        untouched = (_same_bits(kp[~app], k0[~app])
                     and _same_bits(vp[~app], v0[~app]))
        if not (appended_exact and untouched and _same_bits(kp, kr)
                and _same_bits(vp, vr)):
            raise AssertionError("paged_attention: appended or untouched "
                                 "pool rows differ")
        call = lambda: pd.paged_attention(  # noqa: E731
            q, k_new, v_new, kp, vp, table, lens, layer)
        call_ms = time_ms(call, 20)           # the host's time included
        ms, by_pass = busy_ms(call, PAGED_PASSES)
        plain_ms = time_ms(lambda: pd.paged_attention_plain(
            q, k_new, v_new, kr, vr, table, lens, layer), 5)
        # context only: SDPA over the same rows gathered into contiguous
        # [B, heads, S, hd] tensors beforehand (no paging, no append)
        S = max(lens_l) + 1
        pos = torch.arange(S, device=dev)
        pgs = table.long()[:, (pos // page).clamp(max=table.shape[1] - 1)]
        kg = kp[layer][pgs, :, pos % page].permute(0, 2, 1, 3)
        vg = vp[layer][pgs, :, pos % page].permute(0, 2, 1, 3)
        mask = (pos[None] <= lens.long()[:, None])[:, None, None, :]
        qs = q.reshape(B, kv * g, 1, hd)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, enable_gqa=g > 1), 20)
        n_rows = sum(lens_l)
        nbytes = 2 * (2 * n_rows * kv * hd          # K and V rows read
                      + 2 * q.numel()                # q in, o out
                      + 4 * B * kv * hd)             # k/v_new in, appended
        flops = 4 * kv * g * hd * (n_rows + B)
        bound = max(nbytes / hbm, flops / peak) * 1e3
        bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
        say("paged_attention", kernel=10, shape=label, B=B, kv=kv, group=g, page=page,
            lens=lens_l, split=pd.SPLIT, max_abs_err=f"{max_abs:.3g}",
            tol="atol=2e-2,rtol=2e-2", row_rel_err=f"{row_rel:.3g}",
            tol_row_rel=ROW_REL_TOL, appended_rows_exact=appended_exact,
            other_rows_unchanged=untouched, nan_unowned_rows=True,
            repeat_bit_identical=repeat, ms=f"{ms:.4f}",
            split_ms=f"{by_pass['split']:.4f}",
            merge_ms=f"{by_pass['merge']:.4f}",
            TBps=f"{nbytes / (ms * 1e-3) / 1e12:.3f}",
            call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by,
            kv_bytes_read=2 * 2 * n_rows * kv * hd,
            sdpa_pregathered_context_ms=f"{sdpa_ms:.4f}")
        rows[label] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by,
                           library_ms=None)
    return rows["7b"]


LAYER9_PASSES = (("gemv", "ring_gemv_kernel"), ("norm", "resnorm_kernel"),
                 ("split", "paged_split_kernel"),
                 ("merge", "paged_merge_kernel"))


def phase_paged_layer(eng, dev, hbm, peak):
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    cfg, p = eng.cfg, eng.params
    lw = p["layers"]
    g, hd, kv, hidden = (cfg.n_heads // cfg.kv_heads, cfg.head_dim_,
                         cfg.kv_heads, cfg.hidden_dim)
    cos_t, sin_t = model.rope_table(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    layer, page = 1, 16
    rows = {}
    for B, lens_l in ((4, [128, 0, 0, 0]), (8, SERVE_LENS),
                      (1, SERVE_LENS[-1:])):
        kp, vp, table, lens = paged_pools(dev, 2, kv, hd, page, lens_l, 6)
        x = torch.randn((B, hidden), generator=gen, device=dev).bfloat16()
        res = torch.randn((B, hidden), generator=gen, device=dev).bfloat16()
        if B == 4:
            # padding rows as the engine pads: the same token, the NULL
            # page, so all three append the same row into page 0
            table[1:] = 0
            x[2:], res[2:] = x[1], res[1]
        nan_unowned(kp, vp, table, lens)
        k0, v0 = kp.clone(), vp.clone()
        kr, vr = kp.clone(), vp.clone()
        args = (lw["wqkv_f"], lw["wo_f"], table, lens, lens)
        tail = (layer, lw["attn_norm"][layer], cfg.norm_eps, cos_t, sin_t)
        kw = dict(group=g, rope_style=cfg.rope_style)
        out = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, *tail, **kw)
        again = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, *tail,
                                             **kw)
        ref = pd.llama_decoder_layer_paged_plain(x, res, *args, kr, vr, *tail,
                                                 **kw)
        torch.cuda.synchronize()
        repeat = _same_bits(out[0], again[0]) and _same_bits(out[1], again[1])
        if not (repeat and bool(torch.isfinite(out[0].float()).all())):
            raise AssertionError("llama_decoder_layer_paged: a repeat differs "
                                 "or the output is not finite")
        max_abs = max((out[i].float() - ref[i].float()).abs().max().item()
                      for i in (0, 1))
        for i in (0, 1):
            torch.testing.assert_close(out[i].float(), ref[i].float(),
                                       **LIMITS_TOL)
        app = append_mask(kp, table, lens, layer)
        # each side rounds its own float32 k/v to bf16: one ulp may differ
        row_err = max((kp[app].float() - kr[app].float()).abs().max().item(),
                      (vp[app].float() - vr[app].float()).abs().max().item())
        untouched = (_same_bits(kp[~app], k0[~app])
                     and _same_bits(vp[~app], v0[~app]))
        if not (row_err <= 0.05 and untouched):
            raise AssertionError("llama_decoder_layer_paged: pool rows differ")
        call = lambda: pd.llama_decoder_layer_paged(  # noqa: E731
            x, res, *args, kp, vp, *tail, **kw)
        call_ms = time_ms(call, 20)           # the host's time included
        ms, by_pass = busy_ms(call, LAYER9_PASSES)
        plain_ms = time_ms(lambda: pd.llama_decoder_layer_paged_plain(
            x, res, *args, kr, vr, *tail, **kw), 3, warmup=1)
        w_elems = lw["wqkv_f"][layer].numel() + lw["wo_f"][layer].numel()
        n_rows = sum(lens_l)
        nbytes = 2 * (w_elems + 2 * n_rows * kv * hd + 4 * B * hidden
                      + hidden + 2 * B * kv * hd)
        flops = 2 * B * w_elems + 4 * kv * g * hd * (n_rows + B)
        bound = max(nbytes / hbm, flops / peak) * 1e3
        bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
        say("paged_layer", kernel=9, B=B, lens=lens_l, max_abs_err=f"{max_abs:.3g}",
            tol="atol=2e-2,rtol=2e-2", appended_row_err=f"{row_err:.3g}",
            tol_rows=0.05, other_rows_unchanged=untouched,
            nan_unowned_rows=True, repeat_bit_identical=repeat,
            ms=f"{ms:.4f}",
            **{f"{k}_ms": f"{v:.4f}" for k, v in by_pass.items()},
            call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound:.4f}",
            bound_by=bound_by, weight_bytes=2 * w_elems)
        rows[B] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=bound_by, library_ms=None)
    phase_sglang(dev, hbm, peak)
    return rows[4]


def phase_sglang(dev, hbm, peak, heads=32, hd=128):
    """The page-1 sglang entry at 7B width (B 8, the serving lens), against
    the plain twin on the arguments the entry passes the kernel, on the
    card.  The entry re-lays its [out, in] weights into the kernel layout on
    every call, so both times include that copy."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    hidden, L, layer, B = heads * hd, 2, 1, len(SERVE_LENS)
    gen = torch.Generator(device=dev).manual_seed(7)
    total = sum(SERVE_LENS) + B
    num_pages = total + 16
    perm = torch.randperm(num_pages, generator=torch.Generator().manual_seed(8))
    indices = perm[:total].to(torch.int32).to(dev)
    indptr = torch.tensor([0] + [n + 1 for n in SERVE_LENS],
                          dtype=torch.int32).cumsum(0).to(torch.int32).to(dev)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).bfloat16()

    x, res = rnd((B, hidden)), rnd((B, hidden))
    wqkv, wo = rnd((3 * hidden, hidden), hidden ** -0.5), \
        rnd((hidden, hidden), hidden ** -0.5)
    kc, vc = rnd((L, num_pages, hidden)), rnd((L, num_pages, hidden))
    rms = torch.ones(hidden, dtype=torch.bfloat16, device=dev)
    ang = torch.outer(torch.arange(2048, device=dev).float(),
                      10000.0 ** (-torch.arange(hd // 2, device=dev) / (hd // 2)))
    cos_sin = torch.cat([ang.cos(), ang.sin()], dim=-1)
    pos = torch.tensor(SERVE_LENS, dtype=torch.int32, device=dev)
    kr, vr = kc.clone(), vc.clone()

    call = (x, res, wqkv, wo, indptr, indices)
    tail = (layer, rms, 1e-5, pos, cos_sin, heads, hd)

    def entry(k, v):
        return pd.llama_decoder_layer_batch_decode_sglang(*call, k, v, *tail)

    def plain(k, v):
        args, kw = pd.sglang_layer_args(*call, k, v, *tail)
        return pd.llama_decoder_layer_paged_plain(*args, **kw)

    out = entry(kc, vc)
    ref = plain(kr, vr)
    plain_ms = time_ms(lambda: plain(kr, vr), 3, warmup=1)
    torch.cuda.synchronize()
    max_abs = max((out[i].float() - ref[i].float()).abs().max().item()
                  for i in (0, 1))
    for i in (0, 1):
        torch.testing.assert_close(out[i].float(), ref[i].float(),
                                   **LIMITS_TOL)
    new_rows = indices[indptr[1:].long() - 1].long()
    row_err = (kc[layer, new_rows].float()
               - kr[layer, new_rows].float()).abs().max().item()
    if row_err > 0.05:
        raise AssertionError("sglang entry: appended rows differ")
    call_ms = time_ms(lambda: entry(kc, vc), 20)
    ms, _ = busy_ms(lambda: entry(kc, vc))
    n_rows = sum(SERVE_LENS)
    nbytes = 2 * (4 * hidden * hidden + 2 * n_rows * hidden + 4 * B * hidden
                  + 2 * B * hidden)
    flops = 2 * B * 4 * hidden * hidden + 4 * hidden * (n_rows + B)
    bound = max(nbytes / hbm, flops / peak) * 1e3
    say("sglang", kernel=9, B=B, page=1, lens=SERVE_LENS, max_abs_err=f"{max_abs:.3g}",
        tol="atol=2e-2,rtol=2e-2", appended_row_err=f"{row_err:.3g}",
        ms=f"{ms:.4f}", call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound:.4f}",
        bound_by="bytes" if nbytes / hbm >= flops / peak else "operations")


def check_against_plain(eng, dev, prompt, toks, n=8):
    """Greedy tokens must match the plain path (eager prefill and decode on
    the card, teacher-forced on ``toks``) wherever its top-2 gap > 0.1.
    Returns (plain tokens, gaps, steps that disagree)."""
    from clusterfusion_tpu_torch.models import llama as model
    cfg = eng.cfg
    kc, vc = model.init_cache(cfg, device=dev)
    lg, kc, vc = model.prefill(eng.params, kc, vc, prompt, cfg, flash=False)
    lg = lg[-1]
    plain, gaps = [], []
    for i in range(n):
        top = torch.topk(lg, 2).values
        gaps.append((top[0] - top[1]).item())
        plain.append(int(torch.argmax(lg)))
        lg, kc, vc = model.decode_step(eng.params, kc, vc, toks[i],
                                       len(prompt) + i, cfg, fused=False)
    bad = [i for i in range(n) if gaps[i] > 0.1 and plain[i] != toks[i]]
    return plain, gaps, bad


def phase_serving(eng, dev):
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.runtime import ServingEngine
    cfg = eng.cfg
    text = "Serving many users at once on one card, page by page. " * 12
    prompts = [eng.tokenizer.encode(text[:n - 1], bos=True, eos=False)
               for n in (32, 64, 128, 200, 256, 300, 400, 512)]
    n_new = 32
    # warm-up: one short request through both steps' code paths
    warm = ServingEngine(eng.params, cfg, page_size=16, num_pages=8,
                         max_batch=8)
    warm.submit(0, prompts[0], 2)
    warm.run()
    del warm
    srv = ServingEngine(eng.params, cfg, page_size=16, num_pages=136,
                        max_batch=8)
    pre_ms, step_s = [], []
    real_prefill, real_step = srv._prefill_into_pool, srv._step

    def timed_prefill(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_prefill(req)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)

    def timed_step(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(*a)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    srv._prefill_into_pool, srv._step = timed_prefill, timed_step
    for i, pr in enumerate(prompts):
        srv.submit(i, pr, n_new, temperature=0.0)
    fp.launches = 0
    pd.launches.update(dict.fromkeys(pd.launches, 0))
    t0 = time.perf_counter()
    out = srv.run()
    wall = time.perf_counter() - t0
    pa_launches, flash_launches = pd.launches["paged_attention"], fp.launches
    layer_launches_serving = pd.launches["llama_decoder_layer_paged"]
    steps = len(step_s)
    decode_tokens = sum(len(t) for t in out.values()) - len(prompts)
    say("serving", requests=len(prompts), prompt_tokens=[len(p) for p in
                                                          prompts],
        new_tokens=n_new, decode_steps=steps,
        decode_tokens_per_s=f"{decode_tokens / sum(step_s):.2f}",
        ms_per_step=f"{sum(step_s) * 1e3 / steps:.3f}",
        prefill_ms_per_request=[round(x, 2) for x in pre_ms],
        wall_s=f"{wall:.3f}", pool_pages=136,
        pool_bytes=2 * srv.k_pool.numel() * 2,
        paged_attention_launches=pa_launches,
        flash_prefill_launches=flash_launches)
    if pa_launches != cfg.n_layers * steps or layer_launches_serving:
        raise AssertionError("the batched serving step did not launch "
                             "paged_attention once per layer and step")
    if flash_launches != cfg.n_layers * len(prompts):
        raise AssertionError("serving prefill did not run flash prefill")
    if any(len(t) != n_new or not all(0 <= x < cfg.vocab_size for x in t)
           for t in out.values()):
        raise AssertionError(f"bad serving output {out}")
    bad_all = {}
    for i, pr in enumerate(prompts):
        plain, gaps, bad = check_against_plain(eng, dev, pr, out[i])
        say("serving", request=i, kernel_tokens=out[i][:8],
            plain_tokens=plain, top2_gaps=[round(x, 3) for x in gaps],
            disagree_where_gap_gt_0_1=bad)
        if bad:
            bad_all[i] = bad
    if bad_all:
        raise AssertionError(f"serving and plain paths disagree: {bad_all}")

    # the fused step: Llama.generate on one prompt
    pd.launches.update(dict.fromkeys(pd.launches, 0))
    t0 = time.perf_counter()
    (gen_toks,), _ = eng.generate([prompts[2]], 16, temperature=0.0)
    gen_s = time.perf_counter() - t0
    layer_launches = pd.launches["llama_decoder_layer_paged"]
    gen_steps = eng.stats.gen_tokens - 1
    say("generate", fused=eng.fused, prompt_tokens=len(prompts[2]),
        tokens=gen_toks, decode_steps=gen_steps, wall_s=f"{gen_s:.3f}",
        layer_launches=layer_launches,
        paged_attention_launches=pd.launches["paged_attention"])
    if gen_steps < 1 or layer_launches != cfg.n_layers * gen_steps or \
            pd.launches["paged_attention"]:
        raise AssertionError("generate(B=1, fused) did not launch "
                             "llama_decoder_layer_paged once per layer and "
                             "step")
    plain, gaps, bad = check_against_plain(eng, dev, prompts[2],
                                           gen_toks, min(8, len(gen_toks)))
    say("generate", plain_tokens=plain, top2_gaps=[round(x, 3) for x in gaps],
        disagree_where_gap_gt_0_1=bad)
    if bad:
        raise AssertionError(f"fused generate and plain disagree at {bad}")
    return pa_launches, layer_launches


def phase_verify(eng, dev, hbm, peak, stack_ms, pos=600):
    """Kernel 8 against its plain twin at n 5 (the default n_draft 4) and
    n 9 (n_draft 8), pos 600 of a 1024-row cache.  Returns n 5's row of the
    kernel table."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    cfg, p = eng.cfg, eng.params
    lw = p["layers"]
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    L, kvh = cfg.n_layers, cfg.kv_heads
    gen = torch.Generator(device=dev).manual_seed(9)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc.copy_(torch.randn(kc.shape, generator=gen, device=dev))
    vc.copy_(torch.randn(vc.shape, generator=gen, device=dev))
    # rows at and above pos stand for stale rows of rejected drafts: large,
    # so that a kernel reading them could not pass the check
    kc[:, :, pos:] *= 8
    vc[:, :, pos:] *= 8
    kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
              eps=cfg.norm_eps, final_norm=p["final_norm"],
              lm_head=p["lm_head"])
    wbytes = sum(t.numel() * t.element_size() for t in
                 (lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], lw["attn_norm"],
                  lw["ffn_norm"], p["final_norm"], p["lm_head"]))
    weights = sum(t.numel() for t in (lw["wqkv_f"], lw["wo_f"], lw["w13"],
                                      lw["w2"], p["lm_head"]))
    rows = {}
    for n in (5, 9):
        x = p["embed"][torch.arange(n, device=dev) * 37 + 11]
        cos, sin = model.rope_rows(cfg, pos, n, dev)
        args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
                lw["wo_f"], lw["w13"], lw["w2"])
        kk, vk = kc.clone(), vc.clone()
        kr, vr = kc.clone(), vc.clone()
        out = sv.fused_verify_stack(*args, kk, vk, pos, **kw)
        ref = sv.fused_verify_stack_plain(*args, kr, vr, pos, **kw)
        torch.cuda.synchronize()
        lg_err = (out[0] - ref[0]).abs().max().item()
        lg_rel = lg_err / ref[0].abs().max().item()
        new = slice(pos, pos + n)
        # the n appended rows, per layer: [L] max abs error and max |row|
        row_err = torch.maximum(
            (kk[:, :, new].float() - kr[:, :, new].float()).abs().amax(dim=(1, 2, 3)),
            (vk[:, :, new].float() - vr[:, :, new].float()).abs().amax(dim=(1, 2, 3)))
        row_mag = torch.maximum(kr[:, :, new].float().abs().amax(dim=(1, 2, 3)),
                                vr[:, :, new].float().abs().amax(dim=(1, 2, 3)))
        # the limits of phase 4: layer 0 at atol 0.05, deeper layers
        # atol 0.05 + rtol 1e-2 of |row| (f32 sum order compounding)
        rows_ok = bool(row_err[0] <= 0.05) and \
            bool((row_err <= 0.05 + 1e-2 * row_mag).all())
        others = torch.ones(kc.shape[2], dtype=torch.bool, device=dev)
        others[new] = False
        unchanged = (torch.equal(kk[:, :, others], kc[:, :, others])
                     and torch.equal(vk[:, :, others], vc[:, :, others]))
        finite = bool(torch.isfinite(out[0]).all())
        # kernel 8's GEMVs sum in a fixed order: a repeat gives the same bits
        k2, v2 = kc.clone(), vc.clone()
        again = sv.fused_verify_stack(*args, k2, v2, pos, **kw)
        repeat_same = (torch.equal(again[0], out[0]) and torch.equal(k2, kk)
                       and torch.equal(v2, vk))
        del again, k2, v2
        say("verify", kernel=8, n=n, pos=pos, layers=L,
            logits_max_abs_err=f"{lg_err:.4g}",
            logits_err_over_max=f"{lg_rel:.4g}", tol_logits=2e-2,
            kv_rows_err_layer0=f"{row_err[0].item():.3g}", tol_layer0=0.05,
            kv_rows_err_max=f"{row_err.max().item():.4g}",
            kv_rows_max_abs=f"{row_mag.max().item():.3g}",
            tol_rows="atol=0.05+rtol=1e-2", other_rows_unchanged=unchanged,
            finite=finite, repeat_bit_identical=repeat_same,
            kernels_per_call=sv.last_step_kernels)
        if not (lg_rel <= 2e-2 and rows_ok and unchanged and finite
                and repeat_same):
            raise AssertionError(f"fused_verify_stack (n {n}) disagrees with "
                                 "its plain twin")
        del kr, vr
        ms = time_ms(lambda: sv.fused_verify_stack(*args, kk, vk, pos, **kw),
                     20)
        plain_ms = time_ms(lambda: sv.fused_verify_stack_plain(
            *args, kk, vk, pos, **kw), 3, warmup=1)
        kv_read = 2 * L * kvh * pos * hd * 2          # rows < pos, K and V
        kv_write = 2 * L * kvh * n * hd * 2
        io = n * cfg.hidden_dim * 2 * 2 + n * cfg.vocab_size * 4 + 2 * n * hd * 4
        nbytes = wbytes + kv_read + kv_write + io
        flops = 2 * n * weights + \
            4 * L * cfg.n_heads * hd * (n * pos + n * (n + 1) // 2)
        bound = max(nbytes / hbm, flops / peak) * 1e3
        bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
        say("verify", n=n, ms_per_call=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by,
            stack_ms_same_pos=f"{stack_ms:.4f}",
            verify_over_stack=f"{ms / stack_ms:.3f}",
            weight_bytes=wbytes, kv_bytes_read=kv_read)
        rows[n] = dict(max_abs_err=lg_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=bound_by, library_ms=None)
        del kk, vk
    return rows[5]


SPEC_NEW = 32
SPEC_DRAFT = 4


def spec_run(eng, dev, prompt, draft, ref, label):
    """``spec_generate`` with ``draft``; checks its stream against
    ``stream_generate``'s (``ref``) and the plain path under the top-2-gap
    rule, and one verify launch per round.  Returns (verify launches,
    rounds where a draft was rejected at a top-2 gap > 0.1)."""
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    fp.launches = sk.launches = sv.launches = 0
    toks = eng.spec_generate(prompt, SPEC_NEW, draft, n_draft=SPEC_DRAFT)
    verify_launches, stack_launches, flash_launches = \
        sv.launches, sk.launches, fp.launches
    st, gs = dict(eng.spec_stats), eng.stats
    eos = eng.tokenizer.eos_id
    if not all(0 <= t < eng.cfg.vocab_size for t in toks) or \
            (len(toks) != SPEC_NEW and eos not in toks):
        raise AssertionError(f"{label}: bad tokens {toks}")
    if verify_launches != st["rounds"] or \
            stack_launches != st["rounds"] * (SPEC_DRAFT + 1):
        raise AssertionError(f"{label}: {verify_launches} verify and "
                             f"{stack_launches} stack launches for "
                             f"{st['rounds']} rounds")
    plain, gaps, bad = check_against_plain(eng, dev, prompt, toks, len(toks))
    # where a round rejected a draft, the target's own token stands at the
    # round's last emitted place
    rejected, at = [], 1                       # toks[0] is the prefill's
    for c in st["round_counts"]:
        if c < SPEC_DRAFT + 1 and at + c - 1 < len(toks):
            rejected.append(at + c - 1)
        at += c
    div = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b),
               None)
    say("spec", draft=label, prompt_tokens=len(prompt), tokens=len(toks),
        rounds=st["rounds"], accepted_drafts=st["accepted_drafts"],
        round_counts=st["round_counts"],
        tokens_per_s=f"{gs.tokens_per_s:.2f}", wall_s=f"{gs.total_s:.3f}",
        verify_launches=verify_launches, stack_launches=stack_launches,
        flash_prefill_launches=flash_launches,
        rejected_at=rejected,
        top2_gaps_at_rejections=[round(gaps[i], 3) for i in rejected],
        first_difference_from_stream_generate=div,
        disagree_with_plain_where_gap_gt_0_1=bad)
    if bad:
        raise AssertionError(f"{label}: spec and plain disagree at {bad}")
    if div is not None and gaps[div] > 0.1:
        raise AssertionError(f"{label}: spec and stream_generate differ at "
                             f"{div}, top-2 gap {gaps[div]:.3f}")
    return verify_launches, [i for i in rejected if gaps[i] > 0.1]


def phase_spec(eng, dev):
    """``spec_generate`` at 7B: a self-draft and an unrelated small draft.
    Returns the verify launches of the self-draft run."""
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.generation import Llama
    text = ("Speculative decoding drafts a few tokens and one verify step "
            "scores them all. " * 3)[:127]
    prompt = eng.tokenizer.encode(text, bos=True, eos=False)
    ref = list(eng.stream_generate(prompt, SPEC_NEW, temperature=0.0))
    say("spec", baseline="stream_generate", tokens=len(ref),
        tokens_per_s=f"{eng.stats.tokens_per_s:.2f}",
        wall_s=f"{eng.stats.total_s:.3f}")
    # a second engine on the same weights, with its own cache
    self_draft = Llama(eng.params, eng.cfg, eng.tokenizer, fused=True)
    launches, bad = spec_run(eng, dev, prompt, self_draft, ref, "self")
    if bad:
        raise AssertionError(f"self-draft: drafts rejected at {bad} where "
                             "the target's top-2 gap exceeds 0.1")
    small = Llama.synthetic(
        LlamaConfig.tiny(hidden_dim=1024, n_heads=8, ffn_dim=2816, n_layers=4,
                         vocab_size=32000, max_seq_len=2048),
        seed=1, fused=True, device=dev)
    spec_run(eng, dev, prompt, small, ref, "small")
    return launches


def profile_by_kernel(fn, reps: int = 8, top: int = 12):
    """``torch.profiler`` over ``reps`` calls of ``fn``: (device ms per call,
    profiled wall ms per call, [(kernel, ms per call, launches per call)]
    of the ``top`` kernels by device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)         # markers: see _profiled_calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t and e.device_type == torch.autograd.DeviceType.CUDA \
                and MARKER not in e.key:
            rows.append((e.key[:60], t / 1e3 / reps, e.count / reps))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), wall, rows[:top]


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


GEMV_HEAD_COPIES = 8


def phase_norms_gemv(eng, dev, hbm, peak):
    """Kernels 1 and 2 (``rmsnorm``, ``fused_add_rmsnorm``) at (1, 4096) and
    (64, 8192) in bf16 and float32, and kernel 3 (``gemv``) over the 7B LM
    head (4096 x 32000), against their plain twins on the card, with their
    times (CUDA events), the twins', one PyTorch call's and the bounds.
    Returns the rows of the kernel table: the norms at (1, 4096) bf16, the
    shape the tp step gives kernel 2."""
    gv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    from clusterfusion_tpu_torch.ops import reference as ref
    rn = importlib.import_module("clusterfusion_tpu_torch.ops.rmsnorm")
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = {}
    # launches of each op's own run (its first call per shape), not of the
    # timing loops
    launches = {"rmsnorm": 0, "fused_add_rmsnorm": 0}
    for B, hidden in ((1, 4096), (64, 8192)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((B, hidden), generator=gen, device=dev).to(dtype)
            r = torch.randn((B, hidden), generator=gen, device=dev).to(dtype)
            w = (1 + 0.1 * torch.randn(hidden, generator=gen,
                                       device=dev)).to(dtype)
            tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
            for name in ("rmsnorm", "fused_add_rmsnorm"):
                if name == "rmsnorm":
                    fn = lambda: rn.rmsnorm(x, w)              # noqa: E731
                    plain = lambda: ref.rmsnorm_ref(x, w)      # noqa: E731
                    lib = lambda: F.rms_norm(x, (hidden,), w,  # noqa: E731
                                             1e-6)
                    nbytes = _bytes(x, w) + _bytes(x)
                else:
                    fn = lambda: rn.fused_add_rmsnorm(          # noqa: E731
                        x, r, w, 1e-5)
                    plain = lambda: ref.fused_add_rmsnorm_ref(  # noqa: E731
                        x, r, w, 1e-5)
                    lib = None
                    nbytes = _bytes(x, r, w) + 2 * _bytes(x)
                before = rn.launches[name]
                got = fn()
                launches[name] += rn.launches[name] - before
                want = plain()
                if name == "rmsnorm":
                    got, want = (got,), (want,)
                torch.cuda.synchronize()
                err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, want))
                for a, b in zip(got, want):
                    torch.testing.assert_close(a.float(), b.float(), atol=tol,
                                               rtol=tol)
                # device time (the wrapper's host time excluded), and the
                # time of a call between CUDA events beside it
                ms = device_ms(fn)
                call_ms = time_ms(fn, 50)
                plain_ms = time_ms(plain, 20)
                lib_ms = device_ms(lib) if lib is not None else None
                flops = 4 * B * hidden
                bound = max(nbytes / hbm, flops / peak) * 1e3
                bound_by = "bytes" if nbytes / hbm >= flops / peak \
                    else "operations"
                say("norm", kernel=1 if name == "rmsnorm" else 2, op=name,
                    B=B, hidden=hidden, dtype=str(dtype).split(".")[-1],
                    max_abs_err=f"{err:.3g}", tol=f"atol=rtol={tol}",
                    ms=f"{ms:.4f}", call_ms=f"{call_ms:.4f}",
                    plain_ms=f"{plain_ms:.4f}",
                    library_ms="null" if lib_ms is None else f"{lib_ms:.4f}",
                    bound_ms=f"{bound:.5f}", bound_by=bound_by)
                if (B, hidden, dtype) == (1, 4096, torch.bfloat16):
                    rows[name] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound,
                                      bound_by=bound_by, library_ms=lib_ms)
    # kernel 3 over the 7B LM head, the TPU kernel's own use case
    lm = eng.params["lm_head"]
    K, N = lm.shape
    x = torch.randn((1, K), generator=gen, device=dev).bfloat16()
    gv.launches = 0
    y = gv.gemv(x, lm)
    want = gv.gemv_plain(x, lm)
    torch.cuda.synchronize()
    gemv_launches = gv.launches
    err = (y - want).abs().max().item()
    scale = want.abs().max().item()
    if not err <= 1e-3 * max(scale, 1.0):
        raise AssertionError(f"gemv disagrees with its plain twin: {err}")
    # its K chunks meet in a fixed order: every call gives the same bits
    repeats_same = all(torch.equal(gv.gemv(x, lm), y) for _ in range(3))
    if not repeats_same:
        raise AssertionError("gemv differs from itself")
    # each timed call reads its own copy of the head (8 copies, 2.1 GB, far
    # over the 50 MB L2), so no call finds the last one's reads in L2
    heads = [lm] + [lm.clone() for _ in range(GEMV_HEAD_COPIES - 1)]

    def rotating(fn):
        it = iter(range(1 << 62))
        return lambda: fn(heads[next(it) % len(heads)])
    ms = device_ms(rotating(lambda w: gv.gemv(x, w)))
    lib_ms = device_ms(rotating(
        lambda w: torch.mm(x, w, out_dtype=torch.float32)))
    warm_ms = device_ms(lambda: gv.gemv(x, lm))
    warm_lib_ms = device_ms(lambda: torch.mm(x, lm, out_dtype=torch.float32))
    call_ms = time_ms(lambda: gv.gemv(x, lm), 50)
    plain_ms = time_ms(lambda: gv.gemv_plain(x, lm), 10)
    del heads
    nbytes = _bytes(lm, x) + N * 4
    flops = 2 * K * N
    bound = max(nbytes / hbm, flops / peak) * 1e3
    bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
    say("gemv", kernel=3, K=K, N=N, max_abs_err=f"{err:.3g}",
        tol="1e-3 of max |y|", max_abs_y=f"{scale:.3g}",
        repeats_bit_identical=repeats_same, ms=f"{ms:.4f}",
        library_ms=f"{lib_ms:.4f}", over_library=f"{ms / lib_ms:.4f}",
        timing=f"device, L2 cold ({GEMV_HEAD_COPIES} rotating copies)",
        warm_ms=f"{warm_ms:.4f}", warm_library_ms=f"{warm_lib_ms:.4f}",
        call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library="torch.mm(bf16, out_dtype=float32)", bound_ms=f"{bound:.4f}",
        bound_by=bound_by, rate_TBps=f"{nbytes / ms / 1e9:.3f}")
    rows["gemv"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)
    launches["gemv"] = gemv_launches
    return rows, launches


def _layer_bound(hbm, peak, wbytes, weights, kvh, heads, rows, hd, io_bytes):
    """Bound of one attention half: the weights and the K/V rows < seq read
    once, the inputs and outputs once; two operations per weight and four
    per (head, row, element) of the attention."""
    nbytes = wbytes + 2 * kvh * rows * hd * 2 + io_bytes
    flops = 2 * weights + 4 * heads * (rows + 1) * hd
    bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
    return max(nbytes / hbm, flops / peak) * 1e3, bound_by, nbytes


def phase_layer(eng, dev, hbm, peak, pos=600, cap=4096, layer=1):
    """Kernel 6, ``_fused_decoder_layer``, at Llama-2-7B geometry (layer 1 of
    the engine's weights, in place), against its plain twin on the card:
    full mode with the append at pos 600 of a 4096-row cache with large
    garbage at and above pos; partials mode on the halves [0, 300) and
    [300, 600) (the second folding the current token) merged with the sp
    formula against one partials call over [0, 600) and, O-projected,
    against the full mode's output; then both public ops at 7B width over
    a 600-row cache.  Returns the kernel table's row (the full mode)."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    cfg, p = eng.cfg, eng.params
    lw = p["layers"]
    g, hd, hidden = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.hidden_dim
    kvh = cfg.kv_heads
    gen = torch.Generator(device=dev).manual_seed(13)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

    kc, vc = rnd((2, kvh, cap, hd)), rnd((2, kvh, cap, hd))
    kc[:, :, pos:] *= 8                  # garbage the kernel must not read
    vc[:, :, pos:] *= 8
    x, res = rnd((1, hidden)), rnd((1, hidden))
    norm = 1 + 0.1 * rnd((hidden,))
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
              fuse_residual=True, eps=cfg.norm_eps)
    args = (x, res, norm, cos, sin, lw["wqkv_f"][layer], lw["wo_f"][layer])
    kk, vk = kc.clone(), vc.clone()
    kr, vr = kc.clone(), vc.clone()
    out = dl._fused_decoder_layer(*args, kk, vk, pos, 1, append_kv=True, **kw)
    kernels = dl.last_call_kernels
    kk2, vk2 = kc.clone(), vc.clone()
    again = dl._fused_decoder_layer(*args, kk2, vk2, pos, 1, append_kv=True,
                                    **kw)
    ref = dl._fused_decoder_layer_plain(*args, kr, vr, pos, 1, append_kv=True,
                                        **kw)
    torch.cuda.synchronize()
    repeat = all(_same_bits(out[i], again[i]) for i in range(4)) and \
        _same_bits(kk, kk2) and _same_bits(vk, vk2)
    del kk2, vk2, again
    err = max((out[i].float() - ref[i].float()).abs().max().item()
              for i in (0, 1))
    for i in (0, 1):
        torch.testing.assert_close(out[i].float(), ref[i].float(),
                                   **LIMITS_TOL)
    row_err = max((a[1, :, pos].float() - b[1, :, pos].float()).abs().max()
                  .item() for a, b in ((kk, kr), (vk, vr)))
    new_err = max((out[i].float() - ref[i].float()).abs().max().item()
                  for i in (2, 3))
    others = torch.ones(cap, dtype=torch.bool, device=dev)
    others[pos] = False
    unchanged = (torch.equal(kk[:, :, others], kc[:, :, others])
                 and torch.equal(vk[:, :, others], vc[:, :, others])
                 and torch.equal(kk[0], kc[0]) and torch.equal(vk[0], vc[0]))
    say("layer", kernel=6, mode="full+append", pos=pos, cap=cap,
        max_abs_err=f"{err:.3g}", tol="atol=2e-2,rtol=2e-2",
        appended_row_err=f"{row_err:.3g}", k_new_v_new_err=f"{new_err:.3g}",
        tol_rows=0.05, other_rows_unchanged=unchanged,
        repeat_bit_identical=repeat, kernels_per_call=kernels)
    if not (row_err <= 0.05 and new_err <= 0.05 and unchanged and repeat
            and kernels == 1):
        raise AssertionError("_fused_decoder_layer: appended rows disagree, "
                             "other rows changed, a repeat differs or the "
                             f"call took {kernels} kernels")

    # partials: two shards merged in the log2 domain vs one shard
    pkw = dict(kw, emit_partials=True)
    halves = [(kc[:, :, :300].contiguous(), vc[:, :, :300].contiguous(), 300,
               0), (kc[:, :, 300:].contiguous(), vc[:, :, 300:].contiguous(),
                    pos - 300, 1)]
    parts = [dl._fused_decoder_layer(*args, k, v, n, 1, fold_current=f, **pkw)
             for k, v, n, f in halves]
    whole = dl._fused_decoder_layer(*args, kc, vc, pos, 1, fold_current=1,
                                    **pkw)
    m = torch.stack([q[1][0] for q in parts])
    m_g = m.amax(dim=0)
    alpha = torch.exp2(m - m_g)
    l_g = sum(q[1][1] * a for q, a in zip(parts, alpha))
    acc_g = sum(q[0] * a[:, None] for q, a in zip(parts, alpha))
    o_merged = acc_g / l_g[:, None]
    o_whole = whole[0] / whole[1][1][:, None]
    merge_err = (o_merged - o_whole).abs().max().item()
    wo = lw["wo_f"][layer]
    proj = torch.mm(o_merged.bfloat16().reshape(1, -1),
                    wo.reshape(-1, hidden), out_dtype=torch.float32)
    proj_err = (proj - out[0].float()).abs().max().item()
    torch.cuda.synchronize()
    say("layer", kernel=6, mode="partials [0,300)+[300,600) merged",
        o_err_vs_one_shard=f"{merge_err:.3g}", tol_o=2e-2,
        oproj_err_vs_full=f"{proj_err:.3g}", tol_out="atol=2e-2,rtol=2e-2",
        m_shard0_max=f"{parts[0][1][0].max().item():.4g}",
        m_shard1_max=f"{parts[1][1][0].max().item():.4g}")
    torch.testing.assert_close(o_merged, o_whole, atol=2e-2, rtol=0)
    torch.testing.assert_close(proj, out[0].float(), **LIMITS_TOL)
    del parts, whole, halves

    call = lambda: dl._fused_decoder_layer(  # noqa: E731
        *args, kk, vk, pos, 1, append_kv=True, **kw)
    ms, _ = busy_ms(call)
    call_ms = time_ms(call, 50)
    say("layer_launch", kernel=6, **dl.launch_plan(hidden, kvh, g, hd),
        **launch_phases(dl, call, 16 * kvh, K6_PHASES),
        note="phases from %globaltimer stamps inside the one launch")
    plain_ms = time_ms(lambda: dl._fused_decoder_layer_plain(
        *args, kr, vr, pos, 1, append_kv=True, **kw), 5)
    wq, wol = lw["wqkv_f"][layer], lw["wo_f"][layer]
    bound, bound_by, nbytes = _layer_bound(
        hbm, peak, _bytes(wq, wol), wq.numel() + wol.numel(), kvh,
        cfg.n_heads, pos, hd, 5 * hidden * 2 + 4 * kvh * hd * 2)
    say("layer", kernel=6, ms=f"{ms:.4f}", busy_ms=f"{ms:.4f}",
        kernels_per_call=kernels, call_ms=f"{call_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound:.4f}", bound_by=bound_by, bytes=nbytes,
        rate_TBps=f"{nbytes / ms / 1e9:.3f}", library_ms="null")
    del kk, vk, kr, vr, kc, vc
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by=bound_by, library_ms=None)

    # the public ops at 7B width over a 600-row cache
    heads, seq = cfg.n_heads, pos
    d = dict(x=x, res=res, wqkv=rnd((3 * hidden, hidden), hidden ** -0.5),
             wo=rnd((hidden, hidden), hidden ** -0.5),
             k=rnd((seq, hidden)), v=rnd((seq, hidden)), rms=norm)
    ang = torch.outer(torch.tensor([float(seq)], device=dev),
                      10000.0 ** (-torch.arange(hd // 2, device=dev)
                                  / (hd // 2)))[0]
    for op in ("sglang", "meta"):
        if op == "sglang":
            cs, sn = ang.cos(), ang.sin()
            call = lambda: dl.llama_decoder_layer_sglang(  # noqa: E731
                d["x"], d["res"], d["wqkv"], d["wo"], d["k"], d["v"],
                d["rms"], 1e-5, cs, sn)
            prep = dl._prep_mha(d["wqkv"], d["wo"], d["k"], d["v"], heads,
                                hd, dl._pick_head_group(heads, dl.HEAD_GROUP),
                                False)
            pargs = (d["x"], d["res"], d["rms"][None],
                     torch.cat([cs, cs])[None], torch.cat([sn, sn])[None])
            pkw2 = dict(rope_style="neox", fuse_residual=True, eps=1e-5)
            outs = (0, 1, 2, 3)
        else:
            cs = ang.repeat_interleave(2).cos()[None]
            sn = ang.repeat_interleave(2).sin()[None]
            call = lambda: dl.llama_decoder_layer(  # noqa: E731
                d["x"], d["wqkv"], d["wo"], d["k"], d["v"], d["rms"], cs, sn)
            prep = dl._prep_mha(d["wqkv"], d["wo"], d["k"], d["v"], heads,
                                hd, dl._pick_head_group(heads, dl.HEAD_GROUP),
                                True)
            pargs = (d["x"], None, d["rms"][None], cs, sn)
            pkw2 = dict(rope_style="gptj", fuse_residual=False, eps=1e-6)
            outs = (0, 2, 3)
        got = call()
        want = dl._fused_decoder_layer_plain(*pargs, *prep, group=1,
                                             head_dim=hd, **pkw2)
        torch.cuda.synchronize()
        want = [want[i].reshape(1, -1) for i in outs]
        op_err = max((a.float() - b.float()).abs().max().item()
                     for a, b in zip(got, want))
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), atol=5e-2,
                                       rtol=2e-2)
        call_ms = time_ms(call, 20)
        say("layer_public_op", kernel=6, op=op, heads=heads, seq=seq,
            max_abs_err=f"{op_err:.3g}", tol="atol=5e-2,rtol=2e-2",
            call_ms=f"{call_ms:.4f}")
    return row


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_against_stack(params, cfg, k0, v0, pos0, first, toks):
    """Teacher-force kernel 7's step (``decode_step(fused=True)``) on the
    whole weights ``params`` along a sharded step's stream from copies of
    the same prefilled caches: every token must be kernel 7's wherever its
    top-2 gap exceeds 0.1.  Returns (kernel 7's tokens, gaps, steps that
    disagree)."""
    from clusterfusion_tpu_torch.models import llama as model
    kc, vc = k0.clone(), v0.clone()
    inputs = [first] + list(toks[:-1])
    ref, gaps = [], []
    for i, t in enumerate(inputs):
        lg, kc, vc = model.decode_step(params, kc, vc, t, pos0 + i, cfg,
                                       fused=True)
        top = torch.topk(lg, 2).values
        gaps.append((top[0] - top[1]).item())
        ref.append(int(torch.argmax(lg)))
    bad = [i for i in range(len(toks)) if gaps[i] > 0.1 and ref[i] != toks[i]]
    return ref, gaps, bad


def phase_sharded(eng, dev):
    """The tp and sp fused decode steps end to end in a one-rank NCCL
    group: ``build_mesh(MeshConfig())``, ``shard_params`` (views of the
    engine's weights), a 512-token prefill through ``prefill`` (kernel 4),
    then 32 greedy steps through ``make_sharded_decode_step`` and 8 through
    ``make_sp_sharded_decode_step``, each stream against kernel 7's step and
    the plain path under the top-2-gap rule, with ms per step, tokens/s,
    launches of kernels 6 and 2 per step and the tp step's kernels by
    device time.  Returns the launches of kernels 6 (both steps) and 2."""
    import torch.distributed as dist
    from clusterfusion_tpu_torch.config import MeshConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    rn = importlib.import_module("clusterfusion_tpu_torch.ops.rmsnorm")
    from clusterfusion_tpu_torch import parallel as par
    cfg = eng.cfg
    L = cfg.n_layers
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = par.build_mesh(MeshConfig())
        params = par.shard_params(eng.params, cfg, mesh)
        views = all(params["layers"][k] is eng.params["layers"][k]
                    for k in params["layers"])
        text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
        prompt = eng.tokenizer.encode(text, bos=True, eos=False)
        k0, v0 = model.init_cache(cfg, device=dev)
        fp.launches = 0
        lg, k0, v0 = model.prefill(eng.params, k0, v0, prompt, cfg)
        first = int(torch.argmax(lg[-1]))
        flash = fp.launches
        pos0 = len(prompt)
        results = {}
        for name, n, make, spec in (
                ("tp", 32, par.make_sharded_decode_step, par.cache_pspec()),
                ("sp", 8, par.make_sp_sharded_decode_step,
                 par.cache_pspec_2d())):
            step = make(cfg, mesh)
            kc = par.shard_cache(k0.clone(), mesh, spec)
            vc = par.shard_cache(v0.clone(), mesh, spec)
            tok = torch.tensor(first, device=dev)
            dl.launches = 0
            for k in rn.launches:
                rn.launches[k] = 0
            out = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                lg, kc, vc = step(params, kc, vc, tok, pos0 + i)
                tok = torch.argmax(lg)
                out.append(tok)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            k6, k2 = dl.launches, rn.launches["fused_add_rmsnorm"]
            toks = [int(t) for t in out]
            finite = bool(torch.isfinite(lg).all())
            ref, gaps, bad = check_against_stack(eng.params, cfg, k0, v0,
                                                 pos0, first, toks)
            say("sharded", step=name, mesh="tp=1,sp=1 (one rank, nccl)",
                prompt_tokens=pos0, new_tokens=n, params_are_views=views,
                flash_prefill_launches=flash,
                ms_per_step=f"{dt * 1e3 / n:.3f}",
                tokens_per_s=f"{n / dt:.2f}",
                kernel6_launches=k6, kernel2_launches=k2,
                per_step=f"{k6 / n:g}/{k2 / n:g}", finite=finite,
                tokens=toks[:8], kernel7_tokens=ref[:8],
                agree=f"{sum(a == b for a, b in zip(ref, toks))}/{n}",
                disagree_where_gap_gt_0_1=bad,
                min_top2_gap=f"{min(gaps):.3g}")
            want2 = L * n if name == "tp" else 0
            if k6 != L * n or k2 != want2 or not finite or bad \
                    or flash != L or not views:
                raise AssertionError(f"the {name} step: launches, tokens or "
                                     "kernel 7 agreement wrong")
            plain, pgaps, pbad = check_against_plain(eng, dev, prompt,
                                                     [first] + toks)
            say("sharded", step=name, plain_tokens=plain,
                top2_gaps=[round(x, 3) for x in pgaps],
                disagree_where_gap_gt_0_1=pbad)
            if pbad:
                raise AssertionError(f"the {name} step and the plain path "
                                     f"disagree at {pbad}")
            results[name] = (k6, k2, step, kc, vc)
        # each step's device busy time, and the tp step's kernels by device
        # time (one position, repeated)
        busy = {}
        for name in ("tp", "sp"):
            _, _, st_, kc_, vc_ = results[name]
            busy[name], _ = busy_ms(
                lambda: st_(params, kc_, vc_, first, pos0))  # noqa: B023
        _, _, step, kc, vc = results["tp"]
        dev_ms, prof_wall, top = profile_by_kernel(
            lambda: step(params, kc, vc, first, pos0))
        say("sharded_busy", tp_device_busy_ms_per_step=f"{busy['tp']:.4f}",
            sp_device_busy_ms_per_step=f"{busy['sp']:.4f}")
        say("sharded_profile", step="tp", device_ms_per_step=f"{dev_ms:.4f}",
            profiled_wall_ms_per_step=f"{prof_wall:.4f}",
            device_busy_share_profiled=f"{dev_ms / prof_wall:.3f}")
        for kname, kms, cnt in top:
            say("sharded_profile", kernel=repr(kname), ms_per_step=f"{kms:.4f}",
                launches_per_step=f"{cnt:g}")
    finally:
        dist.destroy_process_group()
    return results["tp"][0] + results["sp"][0], results["tp"][1]


F32_PEAK = 67e12        # float32 FLOP/s outside the tensor cores (data sheet)
COLL_LIB_NULL = ("NCCL needs one process per card; phase 16 times "
                 "dist.all_reduce / dist.all_gather on the same bytes where "
                 "the machine has two cards or more")


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def phase_collectives(dev, hbm):
    """Phase 15, first part: kernels 13 and 14 in loopback (N virtual ranks
    on this card, one launch) at N 2 and 4: the tp step's all-reduce of
    [1, 4096] float32 per rank at Stage.ATTN and Stage.FFN (alternating) and
    the 7B logits' all-gather ([32000 / N] float32 per rank -> [32000]), 64
    calls with fresh inputs each, each against its loopback twin: every
    rank's bits equal the twin's rank-order sum (max_abs_err 0), all ranks
    identical, the error word 0.  Then device time per call
    (``torch.profiler``), call time (CUDA events), the twin's time and the
    bound.  Returns the kernel-table rows at N 2 (the tp step's)."""
    from clusterfusion_tpu_torch.parallel import collective as col
    gen = torch.Generator(device=dev).manual_seed(15)
    rows = {}
    for n in (2, 4):
        lb = col.LoopbackComm(n, dev)
        try:
            red_err = gat_err = 0.0
            identical = True
            for call in range(64):
                relu = call % 2 == 1
                xs = [torch.randn((1, 4096), generator=gen, device=dev)
                      for _ in range(n)]
                got = lb.all_reduce(xs, relu=relu)
                want = col.all_reduce_loopback_plain(xs, relu)[0]
                red_err = max(red_err, max((g - want).abs().max().item()
                                           for g in got))
                identical &= all(_bits_equal(g, want) for g in got)
                shards = [torch.randn(32000 // n, generator=gen, device=dev)
                          for _ in range(n)]
                got = lb.all_gather(shards)
                want = col.all_gather_loopback_plain(shards)[0]
                gat_err = max(gat_err, max((g - want).abs().max().item()
                                           for g in got))
                identical &= all(_bits_equal(g, want) for g in got)
            lb.check()
            word = lb.ranks[0].error()
            say("collective", kernels="13,14", ranks=n, loopback=True,
                calls=64, reduce_max_abs_err=red_err,
                gather_max_abs_err=gat_err, bits_equal_twin_all_ranks=identical,
                error_word=word, tol="bit-equal")
            if red_err or gat_err or not identical or word:
                raise AssertionError(f"kernels 13/14 at {n} ranks disagree "
                                     "with their twins")
            for name, fn, plain, nbytes, flops, err in (
                    ("all_reduce", lambda: lb.all_reduce(xs),
                     lambda: col.all_reduce_loopback_plain(xs),
                     2 * n * 4096 * 4, n * (n - 1) * 4096, red_err),
                    ("all_gather", lambda: lb.all_gather(shards),
                     lambda: col.all_gather_loopback_plain(shards),
                     n * 32000 * 4 // n + n * 32000 * 4, 0, gat_err)):
                dev_ms = device_ms(fn, reps=50)
                call_ms = time_ms(fn, 50)
                plain_ms = time_ms(plain, 50)
                bound = max(nbytes / hbm, flops / F32_PEAK) * 1e3
                lb.check()
                say("collective", kernel=13 if name == "all_reduce" else 14,
                    op=name, ranks=n, loopback=True, ms=f"{dev_ms:.5f}",
                    call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                    bound_ms=f"{bound:.6f}", bound_by="bytes",
                    note="a flag round trip, not bytes, is the real floor")
                if n == 2:
                    rows[name] = dict(max_abs_err=err, ms=dev_ms,
                                      plain_ms=plain_ms, bound_ms=bound,
                                      bound_by="bytes", library_ms=None,
                                      library_note=COLL_LIB_NULL)
        finally:
            lb.close()
    return rows


def phase_mode5(eng, dev, pos=600):
    """Phase 15, second part: mode 5 of kernel 7 (``reduce_axis``) at tp 2
    on this card.  The engine's 7B weights and a cache filled at random as
    in phase 4 are cut into two tp shards (``shard_params`` /
    ``shard_cache`` on a loopback communicator's meshes); each virtual rank
    runs ``fused_decoder_stack(reduce_axis="tp")`` without the LM head on
    its own stream, against kernel 7's unsharded step (also without it):
    x_out and the residual within 0.05 + 1e-2 of the largest value, the
    appended rows at phase 4's limits, every other row unchanged, and the
    two ranks' x_out and residual bit-identical.  The unsharded step is run
    three times on the same inputs and must give the same bits each time
    (its GEMVs sum their K chunks in a fixed order)."""
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    cfg, p = eng.cfg, eng.params
    lw, L, tp = p["layers"], cfg.n_layers, 2
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    gen = torch.Generator(device=dev).manual_seed(2)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    x = p["embed"][torch.tensor([7], device=dev)]
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
              eps=cfg.norm_eps)
    refs = []
    for _ in range(3):
        kr, vr = kc.clone(), vc.clone()
        refs.append(sk.fused_decoder_stack(
            x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"], kr, vr, pos, **kw))
    ref = refs[0]
    repeatable = all(torch.equal(a, b) for r in refs[1:]
                     for a, b in zip(r, ref))
    lb = col.LoopbackComm(tp, dev)
    meshes = [lb.mesh(r) for r in range(tp)]
    shards = [par.shard_params(p, cfg, m) for m in meshes]
    streams = [torch.cuda.Stream(dev) for _ in range(tp)]
    try:
        caches = [(par.shard_cache(kc, m), par.shard_cache(vc, m))
                  for m in meshes]

        def both():
            outs = []
            for r in range(tp):
                streams[r].wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(streams[r]):
                    sl = shards[r]["layers"]
                    outs.append(sk.fused_decoder_stack(
                        x, sl["attn_norm"], sl["ffn_norm"], cos, sin,
                        sl["wqkv_f"], sl["wo_f"], sl["w13"], sl["w2"],
                        *caches[r], pos, reduce_axis="tp", mesh=meshes[r],
                        **kw))
            for s in streams:
                torch.cuda.current_stream(dev).wait_stream(s)
            return outs

        k7, k13 = sk.launches, col.launches["all_reduce"]
        outs = both()
        torch.cuda.synchronize()
        lb.check()
        per_step = sk.last_step_kernels
        k7, k13 = sk.launches - k7, col.launches["all_reduce"] - k13
        same = all(torch.equal(o[0], outs[0][0]) and
                   torch.equal(o[1], outs[0][1]) for o in outs)
        errs, rows_ok, unchanged = [], True, True
        others = torch.ones(kc.shape[2], dtype=torch.bool, device=dev)
        others[pos] = False
        for r, (xo, ro, k, v) in enumerate(outs):
            for got, want in ((xo, ref[0]), (ro, ref[1])):
                e = (got.float() - want.float()).abs().max().item()
                errs.append(e)
                rows_ok &= e <= 0.05 + 1e-2 * want.float().abs().max().item()
            heads = slice(r * cfg.kv_heads // tp, (r + 1) * cfg.kv_heads // tp)
            row_err = torch.maximum(
                (k[:, :, pos].float() - kr[:, heads, pos].float()).abs()
                .amax(dim=(1, 2)),
                (v[:, :, pos].float() - vr[:, heads, pos].float()).abs()
                .amax(dim=(1, 2)))
            row_mag = torch.maximum(
                kr[:, heads, pos].float().abs().amax(dim=(1, 2)),
                vr[:, heads, pos].float().abs().amax(dim=(1, 2)))
            rows_ok &= bool(row_err[0] <= 0.05) and \
                bool((row_err <= 0.05 + 1e-2 * row_mag).all())
            errs.append(row_err.max().item())
            unchanged &= torch.equal(k[:, :, others], kc[:, heads][:, :, others])
            unchanged &= torch.equal(v[:, :, others], vc[:, heads][:, :, others])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            both()
        torch.cuda.synchronize()
        pair_ms = (time.perf_counter() - t0) * 1e2
        lb.check()
        say("mode5", kernel=7, reduce_axis="tp", tp=tp, loopback=True,
            pos=pos, x_out_err=f"{errs[0]:.4g}", residual_err=f"{errs[1]:.4g}",
            kv_row_err_max=f"{max(errs[2::3]):.4g}",
            tol="x/res 0.05+1e-2*max|ref|; rows layer 0 atol=0.05, "
                "deeper atol=0.05+rtol=1e-2",
            ranks_bit_identical=same, other_rows_unchanged=unchanged,
            kernel7_repeats_bit_identical=repeatable,
            kernels_per_step=per_step, stack_launches=k7,
            all_reduce_launches=k13,
            both_ranks_ms_per_step=f"{pair_ms:.3f}",
            error_word=lb.ranks[0].error())
        if not (same and rows_ok and unchanged and repeatable and k7 == tp
                and k13 == 2 * L * tp and per_step == 10 * L + 1):
            raise AssertionError("mode 5 disagrees with kernel 7's "
                                 "unsharded step")
    finally:
        lb.close()
    return shards


def phase_fused_step(eng, dev, shards, n=16):
    """Phase 15, third part, this slice's path: ``make_sharded_decode_step(
    fused_collectives=True)`` at tp 2 on this card, two virtual ranks on
    their own streams over a loopback communicator: a 512-token prefill
    (kernel 4) on the whole weights, then ``n`` greedy steps per rank, each
    one kernel 7 sequence with kernel 13 twice per layer, and kernel 14 for
    the logits.  Counts are set to 0 just before and read just after.  The
    ranks' logits are bit-identical and their tokens kernel 7's (teacher
    forced) wherever the top-2 gap exceeds 0.1.  Returns the launches of
    kernels 13 and 14."""
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    from clusterfusion_tpu_torch.parallel.decode import lm_logits
    from clusterfusion_tpu_torch.parallel.mesh import AXES
    cfg, L, tp = eng.cfg, eng.cfg.n_layers, len(shards)
    text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
    prompt = eng.tokenizer.encode(text, bos=True, eos=False)
    k0, v0 = model.init_cache(cfg, device=dev)
    lg, k0, v0 = model.prefill(eng.params, k0, v0, prompt, cfg)
    first, pos0 = int(torch.argmax(lg[-1])), len(prompt)
    # one step at tp 1 first, so that every kernel of the path is loaded
    # before a virtual rank spins on the card (see ``LoopbackComm``); the
    # row it writes at pos0 is rewritten by the first step below
    alone = par.Mesh(shape={a: 1 for a in AXES}, coords={a: 0 for a in AXES},
                     groups={a: None for a in AXES})
    par.make_sharded_decode_step(cfg, alone, fused_collectives=True)(
        eng.params, k0, v0, first, pos0)
    x0 = torch.zeros((1, cfg.hidden_dim), dtype=torch.bfloat16, device=dev)
    for sh in shards:               # the LM head's product at a shard's width
        lm_logits(sh, x0, x0, cfg, alone)
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        steps = [par.make_sharded_decode_step(cfg, m, fused_collectives=True)
                 for m in meshes]
        caches = [[par.shard_cache(k0, m), par.shard_cache(v0, m)]
                  for m in meshes]
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        toks = [torch.tensor(first, device=dev) for _ in range(tp)]
        outs = [[] for _ in range(tp)]
        torch.cuda.synchronize()
        for k in col.launches:
            col.launches[k] = 0
        sk.launches = 0
        t0 = time.perf_counter()
        for i in range(n):
            for r in range(tp):
                with torch.cuda.stream(streams[r]):
                    lg, kc, vc = steps[r](shards[r], *caches[r], toks[r],
                                          pos0 + i)
                    caches[r] = [kc, vc]
                    toks[r] = torch.argmax(lg)
                    outs[r].append((toks[r], lg))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k13, k14, k7 = (col.launches["all_reduce"], col.launches["all_gather"],
                        sk.launches)
        lb.check()
        same = all(torch.equal(a[1], b[1]) for o in outs[1:]
                   for a, b in zip(outs[0], o))
        tok_lists = [[int(t) for t, _ in o] for o in outs]
        ref, gaps, bad = check_against_stack(eng.params, cfg, k0, v0, pos0,
                                             first, tok_lists[0])
        say("fused_step", step="make_sharded_decode_step(fused_collectives"
            "=True)", tp=tp, loopback=True, prompt_tokens=pos0,
            new_tokens=n, ms_per_step_both_ranks=f"{dt * 1e3 / n:.3f}",
            kernel7_launches=k7, kernel13_launches=k13, kernel14_launches=k14,
            per_step_per_rank=f"{k7 / n / tp:g}/{k13 / n / tp:g}/"
                              f"{k14 / n / tp:g}",
            ranks_logits_bit_identical=same, tokens=tok_lists[0][:8],
            kernel7_tokens=ref[:8],
            agree=f"{sum(a == b for a, b in zip(ref, tok_lists[0]))}/{n}",
            disagree_where_gap_gt_0_1=bad, min_top2_gap=f"{min(gaps):.3g}")
        if (k7 != n * tp or k13 != 2 * L * n * tp or k14 != n * tp or not same
                or bad or any(t != tok_lists[0] for t in tok_lists)):
            raise AssertionError("the fused-collective tp step: launches, "
                                 "rank agreement or kernel 7 agreement wrong")
    finally:
        lb.close()
    return k13, k14


DS_LIB_NULL = ("no single PyTorch call computes the normalised, absorbed, "
               "appended MLA layer or the norm + SwiGLU FFN")


def deepseek_layer_weights(dev, n_layers=2, seed=10):
    """DeepSeek-V2-Lite layer stacks (random, from ``seed``) with norm
    weights 1 + 0.1 N(0, 1)."""
    import dataclasses
    from clusterfusion_tpu_torch.config import DeepSeekConfig
    from clusterfusion_tpu_torch.models import deepseek as ds
    cfg = dataclasses.replace(DeepSeekConfig(), n_layers=n_layers,
                              vocab_size=1024)
    p = ds.init_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for k in ("attn_norm", "ckv_norm", "ffn_norm"):
        t = p["layers"][k]
        t.add_(0.1 * torch.randn(t.shape, generator=gen, device=dev).bfloat16())
    return cfg, p["layers"]


MLA_PASSES = (("gemv", "ring_gemv_kernel"), ("absorb", "mla_absorb_kernel"),
              ("split", "mla_split_kernel"), ("merge", "mla_merge_kernel"))


def phase_deepseek_kernels(dev, hbm, peak, pos=600, cap=4096, seq11=4096):
    """Kernels 12, 11 and 5 at DeepSeek-V2-Lite geometry against their
    plain twins; returns their rows of the kernel table (kernel 11's with
    the launches of its own path, the public op)."""
    from clusterfusion_tpu_torch.models import deepseek as ds
    from clusterfusion_tpu_torch.ops import deepseek_layer as dl
    from clusterfusion_tpu_torch.ops import ffn
    from clusterfusion_tpu_torch.ops.reference import \
        deepseek_decoder_layer_ref
    cfg, lw = deepseek_layer_weights(dev)
    H, nope, rope, lora = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                           cfg.kv_lora_rank)
    hid, mla, layer = cfg.hidden_dim, cfg.mla_head_dim, 1
    split = dl.MLA_SPLIT
    dims = dict(n_heads=H, nope_dim=nope, rope_dim=rope, lora_rank=lora,
                eps=cfg.norm_eps)
    cos_t, sin_t = ds.rope_table(cfg, max_pos=cap, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((1, hid), generator=gen, device=dev).bfloat16()
    w = [lw[k][layer] for k in ("wproj", "wuk", "wuv", "wo_t")]
    w_bytes = sum(t.numel() * 2 for t in w) + 2 * (hid + lora)
    w_flops = 2 * (hid * cfg.n_proj + 2 * H * nope * lora + H * nope * hid)
    rows = {}

    def plain(cache_l, seq, cos, sin):
        return dl.mla_decode_plain(
            x, lw["attn_norm"][layer], lw["ckv_norm"][layer], cos, sin, *w,
            cache_l, seq, softmax_scale=cfg.softmax_scale, split=split,
            **dims)

    def bound(seq, extra_bytes):
        nbytes = w_bytes + seq * mla * 2 + 4 * hid + extra_bytes
        flops = w_flops + 2 * H * seq * (mla + lora)
        b = max(nbytes / hbm, flops / peak) * 1e3
        return b, "bytes" if nbytes / hbm >= flops / peak else "operations"

    # kernel 12: the stack entry at capacity 4096, garbage at and above
    # the position; pos first (the timed cell), then 0 and cap - 1
    cache = ds.init_cache(cfg, max_seq=cap, device=dev)
    kw12 = dict(softmax_scale=cfg.softmax_scale, **dims)
    for at in (pos, 0, cap - 1):
        cache.copy_(torch.randn(cache.shape, generator=gen, device=dev))
        cache[:, at:] *= 8
        before = cache.clone()
        cos, sin = cos_t[at], sin_t[at]
        stack_args = (x, lw["wproj"], lw["wuk"], lw["wuv"], lw["wo_t"], cache,
                      at, layer, lw["attn_norm"], lw["ckv_norm"], cos, sin)
        out, _ = dl.deepseek_decoder_stack_layer(*stack_args, **kw12)
        kernels = dl.last_kernels["deepseek_decoder_stack_layer"]
        again, _ = dl.deepseek_decoder_stack_layer(*stack_args, **kw12)
        want, cur = plain(before[layer], at, cos, sin)
        torch.cuda.synchronize()
        repeat = _same_bits(out, again)
        err = (out.float() - want.float()).abs().max().item()
        torch.testing.assert_close(out.float(), want.float(), **LIMITS_TOL)
        row_err = (cache[layer, at, :mla].float() - cur).abs().max().item()
        pad_zero = not cache[layer, at, mla:].any()
        others = torch.ones(cache.shape[:2], dtype=torch.bool, device=dev)
        others[layer, at] = False
        unchanged = torch.equal(cache[others], before[others])
        if not (row_err <= 0.05 and pad_zero and unchanged and repeat
                and kernels == (4 if at == 0 else 5)):
            raise AssertionError(
                f"deepseek_decoder_stack_layer at pos {at}: the appended row, "
                f"the untouched rows, a repeat or the {kernels} kernels "
                "differ")
        if at != pos:
            say("mla_stack", kernel=12, pos=at, capacity=cap,
                max_abs_err=f"{err:.3g}", appended_row_err=f"{row_err:.3g}",
                pad_columns_zero=pad_zero, other_rows_unchanged=unchanged,
                repeat_bit_identical=repeat, kernels_per_call=kernels)
            continue
        call = lambda: dl.deepseek_decoder_stack_layer(  # noqa: E731
            *stack_args, **kw12)
        call_ms = time_ms(call, 50)
        ms, by_pass = busy_ms(call, MLA_PASSES)
        plain_ms = time_ms(lambda: plain(before[layer], at, cos, sin), 5)
        b, by = bound(at, 2 * cache.shape[-1])
        say("mla_stack", kernel=12, pos=at, capacity=cap, heads=H, lora=lora,
            split=split, max_abs_err=f"{err:.3g}", tol="atol=2e-2,rtol=2e-2",
            appended_row_err=f"{row_err:.3g}", tol_row=0.05,
            pad_columns_zero=pad_zero, other_rows_unchanged=unchanged,
            repeat_bit_identical=repeat, kernels_per_call=kernels,
            ms=f"{ms:.4f}",
            **{f"{k}_ms": f"{v:.4f}" for k, v in by_pass.items()},
            call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b:.4f}", bound_by=by, weight_bytes=w_bytes,
            library_ms=None, library_null_because=repr(DS_LIB_NULL))
        rows[12] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                        bound_by=by, library_ms=None)
    del cache, before

    # kernel 11: the public op over a 576-column cache of seq11 rows
    c576 = torch.randn((seq11, mla), generator=gen, device=dev).bfloat16()
    wproj = lw["wproj"][layer]
    op_args = dict(
        input=x, weight_q_nope=wproj[:, :H * nope].T.contiguous(),
        weight_q_pe=wproj[:, H * nope:H * (nope + rope)].T.contiguous(),
        weight_uk=w[1], weight_kv_nope=wproj[:, H * (nope + rope):
                                            H * (nope + rope) + lora].T.contiguous(),
        weight_k_pe=wproj[:, H * (nope + rope) + lora:].T.contiguous(),
        weight_uv=w[2], weight_o=w[3].T.contiguous(), ckv_cache=c576,
        rms_input_weight=lw["attn_norm"][layer],
        rms_ckv_weight=lw["ckv_norm"][layer],
        cos=cos_t[seq11 - 1], sin=sin_t[seq11 - 1])
    for k in dl.launches:
        dl.launches[k] = 0
    out, ckv_new = dl.deepseek_decoder_layer(**op_args, **dims)
    launches11 = dl.launches["deepseek_decoder_layer_fused"]
    again, _ = dl.deepseek_decoder_layer(**op_args, **dims)
    repeat = _same_bits(out, again)
    want, cur = plain(c576, seq11, op_args["cos"], op_args["sin"])
    o_ref, c_ref = deepseek_decoder_layer_ref(**op_args, **dims)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), **LIMITS_TOL)
    ckv_err = (ckv_new[0].float() - cur).abs().max().item()
    oracle_err = (out.float() - o_ref.float()).abs()
    oracle_ckv = (ckv_new.float() - c_ref.float()).abs().max().item()
    if not (launches11 == 1 and repeat and ckv_err <= 0.05 and oracle_ckv < 5e-2
            and oracle_err.max().item() < 1e-1
            and oracle_err.mean().item() < 1e-2):
        raise AssertionError("deepseek_decoder_layer disagrees with its "
                             "twin or the float32 oracle")
    fused_args = (x, lw["wproj"][layer], w[1], w[2], w[3], c576, seq11,
                  lw["attn_norm"][layer], lw["ckv_norm"][layer],
                  op_args["cos"], op_args["sin"])
    call = lambda: dl.deepseek_decoder_layer_fused(  # noqa: E731
        *fused_args, **dims)
    call_ms = time_ms(call, 50)
    ms, by_pass = busy_ms(call, MLA_PASSES)
    op_ms = time_ms(lambda: dl.deepseek_decoder_layer(**op_args, **dims),
                    20)
    plain_ms = time_ms(lambda: plain(c576, seq11, op_args["cos"],
                                     op_args["sin"]), 5)
    b, by = bound(seq11, 2 * mla)
    say("mla_layer", kernel=11, seq=seq11, max_abs_err=f"{err:.3g}",
        tol="atol=2e-2,rtol=2e-2", ckv_new_err=f"{ckv_err:.3g}",
        oracle_out_max_err=f"{oracle_err.max().item():.3g}",
        oracle_out_mean_err=f"{oracle_err.mean().item():.3g}",
        oracle_ckv_err=f"{oracle_ckv:.3g}",
        tol_oracle="ckv 5e-2, out max 1e-1, mean 1e-2",
        public_op_launches=launches11, repeat_bit_identical=repeat,
        ms=f"{ms:.4f}", **{f"{k}_ms": f"{v:.4f}" for k, v in by_pass.items()},
        call_ms=f"{call_ms:.4f}", public_op_call_ms=f"{op_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b:.4f}", bound_by=by,
        library_ms=None)
    rows[11] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                    bound_by=by, library_ms=None, launches=launches11)
    del c576, op_args

    # kernel 5: the stacked FFN at layer 1, 2048 x 11264
    res = torch.randn((1, hid), generator=gen, device=dev).bfloat16()
    ffn_args = (x, res, lw["ffn_norm"], lw["w13"], lw["w2"])
    kw5 = dict(eps=cfg.norm_eps, fuse_residual=True, layer_id=layer)
    out, h = ffn.fused_ffn(*ffn_args, **kw5)
    kernels5 = ffn.last_call_kernels
    again, h2 = ffn.fused_ffn(*ffn_args, **kw5)
    want, want_h = ffn.fused_ffn_plain(*ffn_args, **kw5)
    torch.cuda.synchronize()
    repeat5 = _same_bits(out, again) and _same_bits(h, h2)
    err = (out.float() - want.float()).abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), **LIMITS_TOL)
    if not torch.equal(h, want_h):
        raise AssertionError("fused_ffn: the residual sum differs")
    if not (repeat5 and kernels5 == 1):
        raise AssertionError(f"fused_ffn: a repeat differs or the call took "
                             f"{kernels5} kernels")
    call = lambda: ffn.fused_ffn(*ffn_args, **kw5)  # noqa: E731
    call_ms = time_ms(call, 50)
    ms, _ = busy_ms(call)
    plain_ms = time_ms(lambda: ffn.fused_ffn_plain(*ffn_args, **kw5), 5)
    f_pad = lw["w2"].shape[-2]
    nbytes = 3 * hid * f_pad * 2 + 2 * hid + 4 * 2 * hid
    flops = 6 * hid * f_pad
    b = max(nbytes / hbm, flops / peak) * 1e3
    by = "bytes" if nbytes / hbm >= flops / peak else "operations"
    say("fused_ffn_launch", kernel=5, **ffn.launch_plan(hid, f_pad),
        **launch_phases(ffn, call, f_pad // 8 + 8, K5_PHASES),
        note="phases from %globaltimer stamps inside the one launch")
    say("fused_ffn", kernel=5, hidden=hid, f_pad=f_pad,
        max_abs_err=f"{err:.3g}", tol="atol=2e-2,rtol=2e-2",
        residual_sum_exact=True, repeat_bit_identical=repeat5,
        kernels_per_call=kernels5, ms=f"{ms:.4f}", busy_ms=f"{ms:.4f}",
        call_ms=f"{call_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b:.4f}", bound_by=by,
        weight_bytes=3 * hid * f_pad * 2, library_ms=None)
    rows[5] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                   bound_by=by, library_ms=None)
    return rows


def deepseek_plain_check(params, cfg, prompt, toks, n=8):
    """The first n greedy tokens against the plain path on the card
    (``fused=False``, teacher-forced on ``toks``) wherever its top-2 gap
    exceeds 0.1.  Returns (plain tokens, gaps, steps that disagree)."""
    from clusterfusion_tpu_torch.models import deepseek as ds
    cache = ds.init_cache(cfg, device=params["embed"].device)
    lg, cache = ds.prefill(params, cache, prompt, cfg)
    lg = lg[-1]
    plain, gaps = [], []
    for i in range(n):
        top = torch.topk(lg, 2).values
        gaps.append((top[0] - top[1]).item())
        plain.append(int(torch.argmax(lg)))
        lg, cache = ds.decode_step(params, cache, toks[i], len(prompt) + i,
                                   cfg, fused=False)
    bad = [i for i in range(n) if gaps[i] > 0.1 and plain[i] != toks[i]]
    return plain, gaps, bad


def phase_deepseek_e2e(dev):
    """DeepSeek end to end: the JAX benchmark's dense configuration at full
    width and depth through ``generate_greedy``, then the V2-Lite MoE + YaRN
    reading at 4 layers, fused against eager.  Returns the launches of
    kernels 12 and 5 on the dense run."""
    from clusterfusion_tpu_torch.config import DeepSeekConfig
    from clusterfusion_tpu_torch.models import deepseek as ds
    from clusterfusion_tpu_torch.ops import deepseek_layer as dl
    from clusterfusion_tpu_torch.ops import ffn
    cfg = DeepSeekConfig(max_seq_len=4096)
    t0 = time.perf_counter()
    params = ds.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    say("deepseek_init", config="DeepSeekConfig(max_seq_len=4096)",
        layers=cfg.n_layers, seconds=f"{time.perf_counter() - t0:.1f}",
        param_bytes=sum(t.numel() * 2 for t in [
            params["embed"], params["lm_head"],
            *params["layers"].values()]))
    prompt = [(i * 37 + 11) % cfg.vocab_size for i in range(128)]
    n_new = 64

    def prefill_ms():
        cache = ds.init_cache(cfg, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ds.prefill(params, cache, prompt, cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, cache

    first_ms, _ = prefill_ms()
    ffn.launches = 0
    for k in dl.launches:
        dl.launches[k] = 0
    t0 = time.perf_counter()
    toks = ds.generate_greedy(params, cfg, prompt, n_new)
    gen_s = time.perf_counter() - t0
    k12, k5 = dl.launches["deepseek_decoder_stack_layer"], ffn.launches
    steps = n_new - 1
    warm_ms, cache = prefill_ms()
    first = int(toks[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds.decode_loop(params, cache, first, len(prompt), cfg, n_steps=steps)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    rope = ds.full_rope_table(cfg, dev)
    step = lambda: ds.decode_step(  # noqa: E731
        params, cache, first, len(prompt), cfg, rope=rope)
    dev_ms, prof_wall, top = profile_by_kernel(step)
    step_busy, _ = busy_ms(step)
    say("deepseek_e2e", prompt_tokens=len(prompt), new_tokens=len(toks),
        prefill_ms=f"{warm_ms:.2f}", prefill_first_call_ms=f"{first_ms:.2f}",
        decode_ms_per_step=f"{dec_s * 1e3 / steps:.3f}",
        decode_tokens_per_s=f"{steps / dec_s:.2f}",
        generate_greedy_wall_s=f"{gen_s:.3f}",
        mla_stack_launches=k12, fused_ffn_launches=k5,
        per_step=f"{k12 / steps:g}/{k5 / steps:g}",
        kernel12_cuda_kernels=dl.last_kernels["deepseek_decoder_stack_layer"])
    say("deepseek_profile", device_busy_ms_per_step=f"{step_busy:.4f}",
        device_ms_per_step=f"{dev_ms:.4f}",
        profiled_wall_ms_per_step=f"{prof_wall:.4f}",
        device_busy_share=f"{dev_ms / (dec_s * 1e3 / steps):.3f}",
        device_busy_share_profiled=f"{dev_ms / prof_wall:.3f}")
    for name, ms, n in top:
        say("deepseek_profile", kernel=repr(name), ms_per_step=f"{ms:.4f}",
            launches_per_step=f"{n:g}")
    if k12 != cfg.n_layers * steps or k5 != cfg.n_layers * steps or \
            dl.last_kernels["deepseek_decoder_stack_layer"] != 5:
        raise AssertionError("the DeepSeek decode did not launch kernels 12 "
                             "and 5 once per layer and step, or kernel 12 "
                             "not as its 5 CUDA kernels")
    if len(toks) != n_new or not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"bad DeepSeek tokens {toks}")
    plain, gaps, bad = deepseek_plain_check(params, cfg, prompt, toks)
    say("deepseek_e2e", kernel_tokens=toks[:8], plain_tokens=plain,
        top2_gaps=[round(g, 3) for g in gaps], disagree_where_gap_gt_0_1=bad)
    if bad:
        raise AssertionError(f"DeepSeek kernel and plain paths disagree at "
                             f"{bad}")
    del params, cache, rope
    torch.cuda.empty_cache()

    # DeepSeek-V2-Lite's published config.json as the JAX package reads it,
    # at 4 layers: 64 routed experts (top 6, 1408 wide) beside the shared
    # FFN, unnormalised gates at scale 1.0, YaRN factor 40
    moe = DeepSeekConfig(max_seq_len=4096, n_layers=4, n_experts=64,
                         moe_top_k=6, moe_ffn_dim=1408, ffn_dim=10944,
                         moe_norm_topk_prob=False, moe_routed_scaling=1.0,
                         yarn_factor=40.0, yarn_orig_max=4096,
                         yarn_mscale=0.707, yarn_mscale_all_dim=0.707)
    mp = ds.init_params(moe, seed=1, device=dev)
    mprompt = prompt[:32]
    cache = ds.init_cache(moe, device=dev)
    ds.prefill(mp, cache, mprompt, moe)
    ce = cache.clone()
    pos = len(mprompt)
    for k in dl.launches:
        dl.launches[k] = 0
    ffn.launches = 0
    lf, _ = ds.decode_step(mp, cache, 7, pos, moe, fused=True)
    k12_moe, k5_moe = dl.launches["deepseek_decoder_stack_layer"], \
        ffn.launches
    le, _ = ds.decode_step(mp, ce, 7, pos, moe, fused=False)
    torch.cuda.synchronize()
    scale = max(le.abs().max().item(), 1.0)
    lg_err = (lf - le).abs().max().item()
    # the appended rows, per layer: layer 0 at atol 0.05 (the JAX suite's
    # limit), the deeper layers at atol 0.05 + rtol 1e-2 of |row|, as in
    # phase 4 (bf16 roundings of the two paths compound layer by layer)
    mla = moe.mla_head_dim
    row_err_l = (cache[:, pos, :mla].float()
                 - ce[:, pos, :mla].float()).abs().amax(dim=-1)
    row_mag = ce[:, pos, :mla].float().abs().amax(dim=-1)
    rows_ok = bool(row_err_l[0] <= 0.05) and \
        bool((row_err_l <= 0.05 + 1e-2 * row_mag).all())
    t0 = time.perf_counter()
    mtoks, _ = ds.decode_loop(mp, cache, 7, pos + 1, moe, n_steps=16)
    torch.cuda.synchronize()
    moe_ms = (time.perf_counter() - t0) * 1e3 / 16
    say("deepseek_moe", layers=moe.n_layers, experts=moe.n_experts,
        top_k=moe.moe_top_k, yarn_factor=moe.yarn_factor,
        softmax_scale=f"{moe.softmax_scale:.6f}",
        logits_max_abs_err=f"{lg_err:.4g}",
        logits_err_over_max=f"{lg_err / scale:.4g}", tol_logits=0.05,
        appended_row_err_by_layer=[round(e, 4) for e in row_err_l.tolist()],
        row_max_abs=f"{row_mag.max().item():.3g}",
        tol_rows="layer 0 atol=0.05, deeper atol=0.05+rtol=1e-2",
        mla_stack_launches=k12_moe, fused_ffn_launches=k5_moe,
        decode_ms_per_step=f"{moe_ms:.3f}", tokens=mtoks.tolist()[:8])
    if not (lg_err < 0.05 * scale and rows_ok
            and k12_moe == moe.n_layers and k5_moe == 0):
        raise AssertionError("the DeepSeek MoE step: fused and eager "
                             "disagree, or kernel 12 did not run per layer")
    del mp, cache, ce
    torch.cuda.empty_cache()
    return k12, k5


def _multicard_world(count: int) -> int:
    """Ranks of phase 16: the most cards that divide the 32 kv heads."""
    for w in (8, 4, 2):
        if count >= w:
            return w
    return 1


def _timed_ms(fn, reps: int = 100, batches: int = 5) -> float:
    """ms per call of ``fn`` on this rank: the median over ``batches`` of
    CUDA events around ``reps`` back-to-back calls, each batch started with
    the card idle and the ranks met (``synchronize``, ``dist.barrier``), so
    a rank's host lag shows at most once per batch."""
    import torch.distributed as dist
    for _ in range(5):
        fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _multicard_collectives(rank, world, dev, mesh, hbm):
    """Phase 16, first part (every rank): kernels 13 and 14 over NVLink at
    the tp step's shapes, 64 calls with fresh inputs, against their plain
    versions (bit-equal) and NCCL (``dist.all_reduce`` /
    ``all_gather_into_tensor``), then the time of each."""
    import torch.distributed as dist
    from clusterfusion_tpu_torch.parallel import collective as col
    group = mesh.groups["tp"]
    comm = col.communicator(mesh, "tp")
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    red_err = nccl_err = gat_err = 0.0
    bits = same = True
    for call in range(64):
        relu = call % 2 == 1
        x = torch.randn((1, 4096), generator=gen, device=dev)
        got = comm.all_reduce(x, relu)
        plain = col.all_reduce_plain(x, group, relu)
        nccl = x.clone()
        dist.all_reduce(nccl, group=group)
        nccl = torch.relu(nccl) if relu else nccl
        red_err = max(red_err, (got - plain).abs().max().item())
        nccl_err = max(nccl_err, (got - nccl).abs().max().item())
        bits &= _bits_equal(got, plain)
        every = col.all_gather_plain(got, group)
        same &= all(_bits_equal(every[r:r + 1], every[:1])
                    for r in range(world))
        shard = torch.randn(32000 // world, generator=gen, device=dev)
        g = comm.all_gather(shard)
        g_nccl = torch.empty(32000 // world * world, device=dev)
        dist.all_gather_into_tensor(g_nccl, shard, group=group)
        gat_err = max(gat_err,
                      (g - col.all_gather_plain(shard, group)).abs().max()
                      .item(), (g - g_nccl).abs().max().item())
    comm.check()
    if rank == 0:
        say("multicard", kernels="13,14", ranks=world, calls=64,
            reduce_vs_plain_max_abs_err=red_err, bits_equal_plain=bits,
            ranks_bit_identical=same,
            reduce_vs_nccl_max_abs_err=f"{nccl_err:.3g}",
            gather_max_abs_err=gat_err, error_word=comm.error())
    if red_err or gat_err or not bits or not same or comm.error():
        raise AssertionError(f"rank {rank}: kernels 13/14 disagree with "
                             "their plain versions or across ranks")
    x = torch.randn((1, 4096), generator=gen, device=dev)
    y = torch.zeros((1, 4096), device=dev)
    shard = torch.randn(32000 // world, generator=gen, device=dev)
    buf = torch.empty(32000 // world * world, device=dev)
    out = dict(
        all_reduce_ms=_timed_ms(lambda: comm.all_reduce(x)),
        all_reduce_nccl_ms=_timed_ms(lambda: dist.all_reduce(y, group=group)),
        all_reduce_plain_ms=_timed_ms(lambda: col.all_reduce_plain(x, group)),
        all_gather_ms=_timed_ms(lambda: comm.all_gather(shard)),
        all_gather_nccl_ms=_timed_ms(
            lambda: dist.all_gather_into_tensor(buf, shard, group=group)),
        all_gather_plain_ms=_timed_ms(
            lambda: col.all_gather_plain(shard, group)),
        all_reduce_bound_ms=2 * 4096 * 4 / hbm * 1e3,
        all_gather_bound_ms=(32000 // world + 32000) * 4 / hbm * 1e3)
    comm.check()
    # the slowest rank's time of each
    slow = torch.tensor(list(out.values()), dtype=torch.float64, device=dev)
    dist.all_reduce(slow, op=dist.ReduceOp.MAX, group=group)
    out = dict(zip(out, slow.tolist()))
    if rank == 0:
        say("multicard", ranks=world, **{k: f"{v:.5f}" for k, v in out.items()},
            reduce_over_nccl=f"{out['all_reduce_ms'] / out['all_reduce_nccl_ms']:.3f}",
            gather_over_nccl=f"{out['all_gather_ms'] / out['all_gather_nccl_ms']:.3f}",
            note="per call, the slowest rank; median of 5 batches of CUDA "
                 "events over 100 back-to-back calls, each batch after "
                 "synchronize and barrier; bound: HBM bytes, a flag round "
                 "trip over NVLink is the floor")
    return out


def _multicard_steps(rank, world, dev, mesh, n=32):
    """Phase 16, second part: the seeded 7B weights (head group 1) on every
    rank, a 512-token prefill (kernel 4), then ``n`` greedy steps of
    ``make_sharded_decode_step(fused_collectives=True)`` and of the NCCL
    step, timed before any profiler; rank 0 holds both streams against
    kernel 7 teacher-forced on the whole weights."""
    import torch.distributed as dist
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    cfg = LlamaConfig.llama2_7b()
    L = cfg.n_layers
    full = model.init_params(cfg, seed=0, head_group=1, device=dev)
    params = par.shard_params(full, cfg, mesh)
    prompt = [(i * 37 + 11) % cfg.vocab_size for i in range(512)]
    k0, v0 = model.init_cache(cfg, max_seq=1024, device=dev)
    lg, k0, v0 = model.prefill(full, k0, v0, prompt, cfg)
    first, pos0 = int(torch.argmax(lg[-1])), len(prompt)
    out = {}
    for name, fused in (("fused", True), ("nccl", False)):
        step = par.make_sharded_decode_step(cfg, mesh,
                                            fused_collectives=fused)
        kc, vc = par.shard_cache(k0, mesh), par.shard_cache(v0, mesh)
        for i in range(2):                       # warm-up, rows rewritten
            step(params, kc, vc, first, pos0 + i)
        dist.barrier()
        torch.cuda.synchronize()
        for k in col.launches:
            col.launches[k] = 0
        sk.launches = dl.launches = 0
        tok, toks = torch.tensor(first, device=dev), []
        t0 = time.perf_counter()
        for i in range(n):
            lg, kc, vc = step(params, kc, vc, tok, pos0 + i)
            tok = torch.argmax(lg)
            toks.append(tok)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = dict(kernel7=sk.launches, kernel6=dl.launches,
                        kernel13=col.launches["all_reduce"],
                        kernel14=col.launches["all_gather"])
        want = (dict(kernel7=n, kernel6=0, kernel13=2 * L * n, kernel14=n)
                if fused else
                dict(kernel7=0, kernel6=L * n, kernel13=0, kernel14=0))
        toks = [int(t) for t in toks]
        bad = []
        if rank == 0:
            ref, gaps, bad = check_against_stack(full, cfg, k0, v0, pos0,
                                                 first, toks)
            say("multicard", step=name, tp=world, prompt_tokens=pos0,
                new_tokens=n, ms_per_step=f"{dt * 1e3 / n:.3f}",
                tokens_per_s=f"{n / dt:.2f}", **launched, tokens=toks[:8],
                kernel7_tokens=ref[:8],
                agree=f"{sum(a == b for a, b in zip(ref, toks))}/{n}",
                disagree_where_gap_gt_0_1=bad,
                min_top2_gap=f"{min(gaps):.3g}")
        dist.barrier()
        if launched != want or bad:
            raise AssertionError(f"rank {rank}, the {name} step: launches "
                                 f"{launched} (want {want}) or tokens {bad}")
        out[f"{name}_ms_per_step"] = dt * 1e3 / n
    return out


def _multicard_rank(rank, world, tmp, hbm):
    """One rank of phase 16 (``torch.multiprocessing`` target)."""
    import torch.distributed as dist
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import MeshConfig
    from clusterfusion_tpu_torch.parallel import collective as col
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    try:
        mesh = par.build_mesh(MeshConfig(tp=world))
        out = _multicard_collectives(rank, world, dev, mesh, hbm)
        out.update(_multicard_steps(rank, world, dev, mesh))
        dist.barrier()
    finally:
        col.release_communicators()
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "rank0.json"), "w") as f:
            json.dump(out, f)


def phase_multicard(hbm):
    """Phase 16, where the machine has two cards or more: one rank per card
    (``torch.multiprocessing``, a ``file://`` store, NCCL); kernels 13 and
    14 over NVLink against their plain versions and NCCL, then the fused
    and the NCCL tp steps end to end.  A failure in any rank fails the run.
    On one card it prints that it did not run."""
    import tempfile

    import torch.multiprocessing as mp
    count = torch.cuda.device_count()
    world = _multicard_world(count)
    if world < 2:
        print(f"[multicard] skipped cards={count}", flush=True)
        return None
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_multicard_rank, args=(world, tmp, hbm), nprocs=world,
                 join=True)
        with open(os.path.join(tmp, "rank0.json")) as f:
            return json.load(f)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["multicard"]:
        # phases 1, 2 and 16 alone (two cards or more), no kernels line
        phase_card()
        phase_build()
        phase_multicard(card_rates(torch.cuda.get_device_name(0))[0])
        return 0
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.generation import Llama
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_card()
    name = torch.cuda.get_device_name(0)
    hbm, peak = card_rates(name)
    phase_build()
    flash_cases = phase_flash(dev, hbm, peak)
    t0 = time.perf_counter()
    eng = Llama.synthetic(LlamaConfig.llama2_7b(), seed=0, fused=True,
                          device=dev)
    torch.cuda.synchronize()
    say("init", model="llama2_7b", seconds=f"{time.perf_counter() - t0:.1f}",
        param_bytes=sum(t.numel() * 2 for t in
                        [eng.params["embed"], eng.params["lm_head"],
                         *eng.params["layers"].values()]))
    stack, stack_case = phase_stack(eng, dev, hbm, peak)
    flash_launches, stack_launches = phase_e2e(eng, dev)
    flash = phase_flash_device(flash_cases, peak)
    phase_stack_device(stack_case)
    del stack_case
    paged = phase_paged_attention(dev, hbm, peak)
    layer = phase_paged_layer(eng, dev, hbm, peak)
    pa_launches, layer_launches = phase_serving(eng, dev)
    verify = phase_verify(eng, dev, hbm, peak, stack["ms"])
    verify_launches = phase_spec(eng, dev)
    norm_rows, norm_launches = phase_norms_gemv(eng, dev, hbm, peak)
    layer_row = phase_layer(eng, dev, hbm, peak)
    layer_launches_tp_sp, fadd_launches = phase_sharded(eng, dev)
    coll_rows = phase_collectives(dev, hbm)
    shards = phase_mode5(eng, dev)
    k13_launches, k14_launches = phase_fused_step(eng, dev, shards)
    del eng, shards
    torch.cuda.empty_cache()
    ds_rows = phase_deepseek_kernels(dev, hbm, peak)
    mla_launches, ffn_launches = phase_deepseek_e2e(dev)
    torch.cuda.empty_cache()
    phase_multicard(hbm)
    kernels = [
        dict(name="flash_prefill_attention", route="cuda",
             source="clusterfusion_tpu_torch/csrc/flash_prefill.cu",
             replaces="clusterfusion_tpu/ops/flash_prefill.py:131",
             launches=flash_launches, **flash),
        dict(name="fused_decoder_stack", route="cuda",
             source="clusterfusion_tpu_torch/csrc/stack_kernel.cu",
             replaces="clusterfusion_tpu/ops/stack_kernel.py:524",
             launches=stack_launches, **stack),
        dict(name="paged_attention", route="cuda",
             source="clusterfusion_tpu_torch/csrc/paged_attention.cu",
             replaces="clusterfusion_tpu/ops/paged_decoder_layer.py:932",
             launches=pa_launches, **paged),
        dict(name="llama_decoder_layer_paged", route="cuda",
             source="clusterfusion_tpu_torch/csrc/paged_decoder_layer.cu",
             replaces="clusterfusion_tpu/ops/paged_decoder_layer.py:399",
             launches=layer_launches, **layer),
        dict(name="fused_verify_stack", route="cuda",
             source="clusterfusion_tpu_torch/csrc/stack_verify.cu",
             replaces="clusterfusion_tpu/ops/stack_verify.py:432",
             launches=verify_launches, **verify),
        dict(name="fused_ffn", route="cuda",
             source="clusterfusion_tpu_torch/csrc/fused_ffn.cu",
             replaces="clusterfusion_tpu/ops/ffn.py:138",
             launches=ffn_launches, **ds_rows[5]),
        dict(name="deepseek_decoder_layer_fused", route="cuda",
             source="clusterfusion_tpu_torch/csrc/mla_decode.cu",
             replaces="clusterfusion_tpu/ops/deepseek_layer.py:279",
             **ds_rows[11]),
        dict(name="deepseek_decoder_stack_layer", route="cuda",
             source="clusterfusion_tpu_torch/csrc/mla_decode.cu",
             replaces="clusterfusion_tpu/ops/deepseek_layer.py:398",
             launches=mla_launches, **ds_rows[12]),
        dict(name="rmsnorm", route="cuda",
             source="clusterfusion_tpu_torch/csrc/rmsnorm.cu",
             replaces="clusterfusion_tpu/ops/rmsnorm.py:45",
             launches=norm_launches["rmsnorm"], **norm_rows["rmsnorm"]),
        dict(name="fused_add_rmsnorm", route="cuda",
             source="clusterfusion_tpu_torch/csrc/rmsnorm.cu",
             replaces="clusterfusion_tpu/ops/rmsnorm.py:67",
             launches=fadd_launches, **norm_rows["fused_add_rmsnorm"]),
        dict(name="gemv", route="cuda",
             source="clusterfusion_tpu_torch/csrc/gemv.cu",
             replaces="clusterfusion_tpu/ops/gemv.py:26",
             launches=norm_launches["gemv"], **norm_rows["gemv"]),
        dict(name="_fused_decoder_layer", route="cuda",
             source="clusterfusion_tpu_torch/csrc/decoder_layer.cu",
             replaces="clusterfusion_tpu/ops/decoder_layer.py:421",
             launches=layer_launches_tp_sp, **layer_row),
        dict(name="all_reduce", route="cuda",
             source="clusterfusion_tpu_torch/csrc/collective.cu",
             replaces="clusterfusion_tpu/parallel/collective.py:208",
             launches=k13_launches, **coll_rows["all_reduce"]),
        dict(name="all_gather", route="cuda",
             source="clusterfusion_tpu_torch/csrc/collective.cu",
             replaces="clusterfusion_tpu/parallel/collective.py:230",
             launches=k14_launches, **coll_rows["all_gather"]),
    ]
    for k in kernels:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms"):
            if k[key] is not None and not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} is {k[key]}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
