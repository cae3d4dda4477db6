"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Kernels are numbered as in ``PERF.md`` and ``ROADMAP.md`` (the table of
the JAX package's Pallas kernels).  Phases, in order; any failure ends the
run with a non-zero exit code:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: ``nvcc`` build of ``clusterfusion_tpu_torch/csrc`` for sm_90a;
3. kernel 4, ``flash_prefill_attention``, against its plain twin at the
   Llama-2-7B prefill shape, a GQA shape and a chunk (q_offset 256), with
   its time, the plain twin's, one PyTorch SDPA call's and the bound;
4. kernel 7, ``fused_decoder_stack``, against its plain twin at full
   Llama-2-7B geometry (one step at pos 600 over a random-filled cache):
   logits, the appended K/V row, every other row unchanged; times and bound;
5. end to end: ``Llama.synthetic(llama2_7b)`` streams 64 greedy tokens
   after a 512-token prompt through ``stream_generate``; prefill ms (warm,
   beside the process's first prefill), decode tokens/s, both kernels'
   launch counts on that run, and the first 8 tokens against the plain
   path (eager prefill and decode) on the card;
6. kernel 10, ``paged_attention``, against its plain twin at the 7B
   serving shape (B 8, 32 kv heads, page 16, lens up to 2047 over shuffled
   pages) and a GQA shape: output (each head's row within 2e-2 of its own
   largest value), appended rows, every other pool row unchanged;
   device time (``torch.profiler``) beside the wall time of a call, the
   plain twin's time and the bound (an SDPA over the same rows gathered
   beforehand is printed as context only);
7. kernel 9, ``llama_decoder_layer_paged``, against its plain twin on one
   layer of the 7B weights at B 4 (the shape ``Llama.generate`` gives it
   for one prompt: one live row, three padding rows on the NULL page), B 8
   and B 1, and its page-1 sglang entry at 7B width;
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
   unchanged), its time beside the stack's at the same pos, the plain
   twin's and the bound; then ``spec_generate`` (n_draft 4, 32 tokens after
   a 128-token prompt) with a self-draft (a second engine on the same
   weights: every draft accepted but where the target's top-2 gap is
   <= 0.1, one verify launch per round) and with an unrelated small draft
   (4 layers, hidden 1024, seed 1), each stream against
   ``stream_generate`` and the plain path under the top-2-gap rule, rounds,
   accepted drafts and tokens/s beside ``stream_generate``'s;
10. DeepSeek kernels at DeepSeek-V2-Lite geometry (the Llama engine freed
   first): kernel 12, ``deepseek_decoder_stack_layer``, at capacity 4096
   and pos 600 over random rows with large garbage at and above pos
   (output, the appended row with its zero pad, every other row
   unchanged); kernel 11 through the public op ``deepseek_decoder_layer``
   over a 4096-row cache, against its twin and the float32 oracle; kernel
   5, ``fused_ffn``, stacked at 2048 x 11264; each with its time (CUDA
   events and ``torch.profiler``), the plain twin's and the bound;
11. DeepSeek end to end: ``DeepSeekConfig(max_seq_len=4096)`` (the JAX
   benchmark's configuration, dense FFN, 27 layers) through
   ``generate_greedy``, 64 tokens after a 128-token prompt: prefill ms,
   decode ms per step and tokens/s, device busy share and the step's
   kernels by device time, launches of kernels 12 and 5 (27 per step each),
   the first 8 tokens against the plain path under the top-2-gap rule;
   then V2-Lite's published MoE + YaRN config at 4 layers, a fused step
   against the eager one and 16 greedy steps.

Then one JSON line per kernel table, the card line, and last
``{"ok": true, "device": {...}}``.  Weights are random, from a seed.
"""

from __future__ import annotations

import json
import math
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


def device_ms(fn, reps: int = 20, attempts: int = 3) -> float:
    """Mean device time in ms of all kernels one call of ``fn`` launches,
    from ``torch.profiler`` (the host's time between launches excluded).
    A profile now and then comes back without its device events; such a
    profile is taken again, up to ``attempts`` times in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            if t and e.device_type == torch.autograd.DeviceType.CUDA:
                total += t
        if total > 0:
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


def phase_flash(dev, hbm, peak):
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    for label, kv, g, T, q_off in (("7b", 32, 1, 512, 0),
                                   ("gqa", 8, 4, 300, 0),
                                   ("chunk", 32, 1, 256, 256)):
        hd = 128
        S = q_off + T
        q = torch.randn((kv, T, g, hd), generator=gen, device=dev).bfloat16()
        k = torch.randn((kv, S, hd), generator=gen, device=dev).bfloat16()
        v = torch.randn((kv, S, hd), generator=gen, device=dev).bfloat16()
        out = fp.flash_prefill_attention(q, k, v, q_offset=q_off)
        ref = fp.flash_prefill_attention_plain(q, k, v, q_offset=q_off)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        max_abs = diff.max().item()
        max_rel = (diff / ref.float().abs().clamp_min(1e-3)).max().item()
        torch.testing.assert_close(out.float(), ref.float(), **LIMITS_TOL)
        ms = time_ms(lambda: fp.flash_prefill_attention(q, k, v,
                                                        q_offset=q_off), 20)
        plain_ms = time_ms(lambda: fp.flash_prefill_attention_plain(
            q, k, v, q_offset=q_off), 5)
        # one PyTorch call computing the same function, timed only
        qs = q.permute(0, 2, 1, 3).reshape(1, kv * g, T, hd).contiguous()
        ks, vs = k[None], v[None]
        if q_off:
            mask = (torch.arange(S, device=dev)[None, :]
                    <= q_off + torch.arange(T, device=dev)[:, None])
            lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs, ks, vs, attn_mask=mask, enable_gqa=g > 1)
        else:
            lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs, ks, vs, is_causal=True, enable_gqa=g > 1)
        lib_ms = time_ms(lib_fn, 20)
        pairs = kv * g * sum(q_off + i + 1 for i in range(T))
        flops = 4 * hd * pairs
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
        bound = max(flops / peak, nbytes / hbm) * 1e3
        bound_by = "operations" if flops / peak > nbytes / hbm else "bytes"
        say("flash_prefill", kernel=4, shape=label, kv=kv, group=g, T=T,
            q_offset=q_off, max_abs_err=f"{max_abs:.3g}",
            max_rel_err=f"{max_rel:.3g}", tol="atol=2e-2,rtol=2e-2",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.4f}",
            bound_by=bound_by)
        rows[label] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by,
                           library_ms=lib_ms)
    return rows["7b"]


def phase_stack(eng, dev, hbm, peak, pos=600):
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
    unchanged = (torch.equal(kk[:, :, others], kc[:, :, others])
                 and torch.equal(vk[:, :, others], vc[:, :, others]))
    finite = bool(torch.isfinite(out[0]).all())
    say("stack", kernel=7, pos=pos, layers=cfg.n_layers, logits_max_abs_err=f"{lg_err:.4g}",
        logits_err_over_max=f"{lg_rel:.4g}", tol_logits=2e-2,
        kv_row_err_layer0=f"{row_err[0].item():.3g}", tol_layer0=0.05,
        kv_row_err_max=f"{row_err.max().item():.4g}",
        kv_row_err_by_layer=[round(e, 4) for e in row_err[::4].tolist()],
        kv_row_max_abs=f"{row_mag.max().item():.3g}",
        tol_rows="atol=0.05+rtol=1e-2", other_rows_unchanged=unchanged,
        finite=finite, kernels_per_step=sk.last_step_kernels)
    if not (lg_rel <= 2e-2 and rows_ok and unchanged and finite):
        raise AssertionError("fused_decoder_stack disagrees with its plain twin")
    ms = time_ms(lambda: sk.fused_decoder_stack(*args, kk, vk, pos, **kw), 20)
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
        weight_bytes=wbytes, kv_bytes_read=kv_read)
    return dict(max_abs_err=lg_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / hbm >= flops / peak
                else "operations", library_ms=None)


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
    return flash_launches, stack_launches


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


def phase_paged_attention(dev, hbm, peak):
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    for label, kv, g in (("7b", 32, 1), ("gqa", 8, 4)):
        hd, page, L, layer, B = 128, 16, 2, 1, len(SERVE_LENS)
        kp, vp, table, lens = paged_pools(dev, L, kv, hd, page, SERVE_LENS, 4)
        q = torch.randn((B, kv, g, hd), generator=gen, device=dev).bfloat16()
        k_new = torch.randn((B, kv, hd), generator=gen, device=dev).bfloat16()
        v_new = torch.randn((B, kv, hd), generator=gen, device=dev).bfloat16()
        k0, v0 = kp.clone(), vp.clone()
        kr, vr = kp.clone(), vp.clone()
        out, _, _ = pd.paged_attention(q, k_new, v_new, kp, vp, table, lens,
                                       layer)
        ref, _, _ = pd.paged_attention_plain(q, k_new, v_new, kr, vr, table,
                                             lens, layer)
        torch.cuda.synchronize()
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
        untouched = (torch.equal(kp[~app], k0[~app])
                     and torch.equal(vp[~app], v0[~app]))
        if not (appended_exact and untouched and torch.equal(kp, kr)):
            raise AssertionError("paged_attention: appended or untouched "
                                 "pool rows differ")
        call = lambda: pd.paged_attention(  # noqa: E731
            q, k_new, v_new, kp, vp, table, lens, layer)
        call_ms = time_ms(call, 20)           # the host's time included
        ms = device_ms(call)
        plain_ms = time_ms(lambda: pd.paged_attention_plain(
            q, k_new, v_new, kr, vr, table, lens, layer), 5)
        # context only: SDPA over the same rows gathered into contiguous
        # [B, heads, S, hd] tensors beforehand (no paging, no append)
        S = max(SERVE_LENS) + 1
        pos = torch.arange(S, device=dev)
        pgs = table.long()[:, (pos // page).clamp(max=table.shape[1] - 1)]
        kg = kp[layer][pgs, :, pos % page].permute(0, 2, 1, 3)
        vg = vp[layer][pgs, :, pos % page].permute(0, 2, 1, 3)
        mask = (pos[None] <= lens.long()[:, None])[:, None, None, :]
        qs = q.reshape(B, kv * g, 1, hd)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, enable_gqa=g > 1), 20)
        n_rows = sum(SERVE_LENS)
        nbytes = 2 * (2 * n_rows * kv * hd          # K and V rows read
                      + 2 * q.numel()                # q in, o out
                      + 4 * B * kv * hd)             # k/v_new in, appended
        flops = 4 * kv * g * hd * (n_rows + B)
        bound = max(nbytes / hbm, flops / peak) * 1e3
        bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
        say("paged_attention", kernel=10, shape=label, B=B, kv=kv, group=g, page=page,
            lens=SERVE_LENS, max_abs_err=f"{max_abs:.3g}",
            tol="atol=2e-2,rtol=2e-2", row_rel_err=f"{row_rel:.3g}",
            tol_row_rel=ROW_REL_TOL, appended_rows_exact=appended_exact,
            other_rows_unchanged=untouched, ms=f"{ms:.4f}",
            call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by,
            kv_bytes_read=2 * 2 * n_rows * kv * hd,
            sdpa_pregathered_context_ms=f"{sdpa_ms:.4f}")
        rows[label] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by,
                           library_ms=None)
    return rows["7b"]


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
        k0, v0 = kp.clone(), vp.clone()
        kr, vr = kp.clone(), vp.clone()
        args = (lw["wqkv_f"], lw["wo_f"], table, lens, lens)
        tail = (layer, lw["attn_norm"][layer], cfg.norm_eps, cos_t, sin_t)
        kw = dict(group=g, rope_style=cfg.rope_style)
        out = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, *tail, **kw)
        ref = pd.llama_decoder_layer_paged_plain(x, res, *args, kr, vr, *tail,
                                                 **kw)
        torch.cuda.synchronize()
        max_abs = max((out[i].float() - ref[i].float()).abs().max().item()
                      for i in (0, 1))
        for i in (0, 1):
            torch.testing.assert_close(out[i].float(), ref[i].float(),
                                       **LIMITS_TOL)
        app = append_mask(kp, table, lens, layer)
        # each side rounds its own float32 k/v to bf16: one ulp may differ
        row_err = max((kp[app].float() - kr[app].float()).abs().max().item(),
                      (vp[app].float() - vr[app].float()).abs().max().item())
        untouched = (torch.equal(kp[~app], k0[~app])
                     and torch.equal(vp[~app], v0[~app]))
        if not (row_err <= 0.05 and untouched):
            raise AssertionError("llama_decoder_layer_paged: pool rows differ")
        call = lambda: pd.llama_decoder_layer_paged(  # noqa: E731
            x, res, *args, kp, vp, *tail, **kw)
        call_ms = time_ms(call, 20)           # the host's time included
        ms = device_ms(call)
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
            tol_rows=0.05, other_rows_unchanged=untouched, ms=f"{ms:.4f}",
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
    ms = device_ms(lambda: entry(kc, vc))
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
        say("verify", kernel=8, n=n, pos=pos, layers=L,
            logits_max_abs_err=f"{lg_err:.4g}",
            logits_err_over_max=f"{lg_rel:.4g}", tol_logits=2e-2,
            kv_rows_err_layer0=f"{row_err[0].item():.3g}", tol_layer0=0.05,
            kv_rows_err_max=f"{row_err.max().item():.4g}",
            kv_rows_max_abs=f"{row_mag.max().item():.3g}",
            tol_rows="atol=0.05+rtol=1e-2", other_rows_unchanged=unchanged,
            finite=finite, kernels_per_call=sv.last_step_kernels)
        if not (lg_rel <= 2e-2 and rows_ok and unchanged and finite):
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
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key[:60], t / 1e3 / reps, e.count / reps))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), wall, rows[:top]


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

    # kernel 12: the stack entry at pos, capacity 4096, garbage above pos
    cache = ds.init_cache(cfg, max_seq=cap, device=dev)
    cache.copy_(torch.randn(cache.shape, generator=gen, device=dev))
    cache[:, pos:] *= 8
    before = cache.clone()
    cos, sin = cos_t[pos], sin_t[pos]
    stack_args = (x, lw["wproj"], lw["wuk"], lw["wuv"], lw["wo_t"], cache,
                  pos, layer, lw["attn_norm"], lw["ckv_norm"], cos, sin)
    kw12 = dict(softmax_scale=cfg.softmax_scale, **dims)
    out, _ = dl.deepseek_decoder_stack_layer(*stack_args, **kw12)
    want, cur = plain(before[layer], pos, cos, sin)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), **LIMITS_TOL)
    row_err = (cache[layer, pos, :mla].float() - cur).abs().max().item()
    pad_zero = not cache[layer, pos, mla:].any()
    others = torch.ones(cache.shape[:2], dtype=torch.bool, device=dev)
    others[layer, pos] = False
    unchanged = torch.equal(cache[others], before[others])
    if not (row_err <= 0.05 and pad_zero and unchanged):
        raise AssertionError("deepseek_decoder_stack_layer: the appended "
                             "row or the untouched rows differ")
    call = lambda: dl.deepseek_decoder_stack_layer(  # noqa: E731
        *stack_args, **kw12)
    call_ms = time_ms(call, 50)
    ms = device_ms(call)
    plain_ms = time_ms(lambda: plain(before[layer], pos, cos, sin), 5)
    b, by = bound(pos, 2 * cache.shape[-1])
    say("mla_stack", kernel=12, pos=pos, capacity=cap, heads=H, lora=lora,
        max_abs_err=f"{err:.3g}", tol="atol=2e-2,rtol=2e-2",
        appended_row_err=f"{row_err:.3g}", tol_row=0.05,
        pad_columns_zero=pad_zero, other_rows_unchanged=unchanged,
        ms=f"{ms:.4f}", call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
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
    want, cur = plain(c576, seq11, op_args["cos"], op_args["sin"])
    o_ref, c_ref = deepseek_decoder_layer_ref(**op_args, **dims)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), **LIMITS_TOL)
    ckv_err = (ckv_new[0].float() - cur).abs().max().item()
    oracle_err = (out.float() - o_ref.float()).abs()
    oracle_ckv = (ckv_new.float() - c_ref.float()).abs().max().item()
    if not (launches11 == 1 and ckv_err <= 0.05 and oracle_ckv < 5e-2
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
    ms = device_ms(call)
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
        public_op_launches=launches11, ms=f"{ms:.4f}",
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
    want, want_h = ffn.fused_ffn_plain(*ffn_args, **kw5)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), **LIMITS_TOL)
    if not torch.equal(h, want_h):
        raise AssertionError("fused_ffn: the residual sum differs")
    call = lambda: ffn.fused_ffn(*ffn_args, **kw5)  # noqa: E731
    call_ms = time_ms(call, 50)
    ms = device_ms(call)
    plain_ms = time_ms(lambda: ffn.fused_ffn_plain(*ffn_args, **kw5), 5)
    f_pad = lw["w2"].shape[-2]
    nbytes = 3 * hid * f_pad * 2 + 2 * hid + 4 * 2 * hid
    flops = 6 * hid * f_pad
    b = max(nbytes / hbm, flops / peak) * 1e3
    by = "bytes" if nbytes / hbm >= flops / peak else "operations"
    say("fused_ffn", kernel=5, hidden=hid, f_pad=f_pad,
        max_abs_err=f"{err:.3g}", tol="atol=2e-2,rtol=2e-2",
        residual_sum_exact=True, ms=f"{ms:.4f}", call_ms=f"{call_ms:.4f}",
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
    say("deepseek_e2e", prompt_tokens=len(prompt), new_tokens=len(toks),
        prefill_ms=f"{warm_ms:.2f}", prefill_first_call_ms=f"{first_ms:.2f}",
        decode_ms_per_step=f"{dec_s * 1e3 / steps:.3f}",
        decode_tokens_per_s=f"{steps / dec_s:.2f}",
        generate_greedy_wall_s=f"{gen_s:.3f}",
        mla_stack_launches=k12, fused_ffn_launches=k5,
        per_step=f"{k12 / steps:g}/{k5 / steps:g}")
    say("deepseek_profile", device_ms_per_step=f"{dev_ms:.4f}",
        profiled_wall_ms_per_step=f"{prof_wall:.4f}",
        device_busy_share=f"{dev_ms / (dec_s * 1e3 / steps):.3f}",
        device_busy_share_profiled=f"{dev_ms / prof_wall:.3f}")
    for name, ms, n in top:
        say("deepseek_profile", kernel=repr(name), ms_per_step=f"{ms:.4f}",
            launches_per_step=f"{n:g}")
    if k12 != cfg.n_layers * steps or k5 != cfg.n_layers * steps:
        raise AssertionError("the DeepSeek decode did not launch kernels 12 "
                             "and 5 once per layer and step")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.generation import Llama
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_card()
    name = torch.cuda.get_device_name(0)
    hbm, peak = card_rates(name)
    phase_build()
    flash = phase_flash(dev, hbm, peak)
    t0 = time.perf_counter()
    eng = Llama.synthetic(LlamaConfig.llama2_7b(), seed=0, fused=True,
                          device=dev)
    torch.cuda.synchronize()
    say("init", model="llama2_7b", seconds=f"{time.perf_counter() - t0:.1f}",
        param_bytes=sum(t.numel() * 2 for t in
                        [eng.params["embed"], eng.params["lm_head"],
                         *eng.params["layers"].values()]))
    stack = phase_stack(eng, dev, hbm, peak)
    flash_launches, stack_launches = phase_e2e(eng, dev)
    paged = phase_paged_attention(dev, hbm, peak)
    layer = phase_paged_layer(eng, dev, hbm, peak)
    pa_launches, layer_launches = phase_serving(eng, dev)
    verify = phase_verify(eng, dev, hbm, peak, stack["ms"])
    verify_launches = phase_spec(eng, dev)
    del eng
    torch.cuda.empty_cache()
    ds_rows = phase_deepseek_kernels(dev, hbm, peak)
    mla_launches, ffn_launches = phase_deepseek_e2e(dev)
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
