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
   pool row unchanged, a repeat bit-identical; device time (``queued_ms``:
   calls back to back between CUDA events; ``torch.profiler``'s busy time
   of the split and merge apart beside it) beside the wall time of
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
   accepted drafts and tokens/s beside ``stream_generate``'s; after it
   (a profiler session slows the launches that follow it), kernel 8's
   device time by pass at n 5 and 9 (its GEMVs' TB/s, the split pass's)
   and the phase stamps of its four products in layer 1, inside a call;
10. DeepSeek kernels at DeepSeek-V2-Lite geometry (the Llama engine freed
   first): kernel 12, ``deepseek_decoder_stack_layer``, at capacity 4096
   and pos 600, 0 and 4095 over random rows with large garbage at and
   above pos (output, the appended row with its zero pad, every other row
   unchanged, a repeat bit-identical, 5 kernels a call, 4 at pos 0);
   kernel 11 through the public op ``deepseek_decoder_layer`` over a
   4096-row cache, against its twin and the float32 oracle, a repeat
   bit-identical; kernel 5, ``fused_ffn``, stacked at 2048 x 11264; each
   with its time (CUDA events: ``queued_ms``, and ``torch.profiler``'s
   busy time by pass beside it), the plain twin's and the bound;
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
   limits, both ranks' x_out and residual bit-identical, and kernel 14
   inside the stack (each rank's 16000-column LM-head shard gathered)
   against the ranks' own shards concatenated; (c) the tp
   path: ``make_sharded_decode_step(fused_collectives=True)`` at tp 2, two
   virtual ranks on their streams, a 512-token prefill and 16 greedy steps,
   kernel 7 once per step and rank with 8L+3 kernels (kernel 13's two
   reduces a layer run inside its products and norms, kernel 14's gather of
   the logits inside its LM product and one wait), no standalone launch of
   kernel 13 or 14, the ranks' logits bit-identical, the tokens kernel 7's
   under the top-2-gap rule; then the pair step's device time by pass (the
   tail's LM product and gather wait beside kernel 7's passes) and its last
   kernels (``[fused_step_tail]``).

Phases 17-22 run after 15, while the Llama-2-7B engine is alive, and
before the DeepSeek phases, in the order 17, 19, 18, 20, 21, 22 (phase 19
reuses phase 17's int8 weights, phases 20-22 phase 18's int8 engine):

17. kernel 7's int8 mode (``fused_decoder_stack`` on int8
   ``QuantizedTensor``s): the engine's seeded weights regrouped to the
   quantized engines' head grouping (hg 8, G 4) and quantized per output
   column layer by layer, at pos 600 over a random cache with NaN above
   pos, with the bf16 and with the int8 LM head: against its plain twin at
   phase 4's limits (logits, the appended K/V rows, every other row
   unchanged bit for bit), a repeat bit-identical; its time (CUDA events)
   beside its byte bound (int8 codes, float32 scales, the LM head, the K/V
   rows) and the bf16 step's time in the same run, the twin's time; then
   its device time by pass (``torch.profiler``: the int8 GEMVs with their
   TB/s, the bf16 LM head's GEMV, split, merge, norms) and layer 1's
   kernels in launch order beside the bf16 step's (``[stack_int8_layer]``);
18. the int8 path end to end: ``Llama.synthetic(llama2_7b, quant="int8")``
   streams 64 greedy tokens after a 512-token prompt through
   ``stream_generate``: every projection held as int8 codes, prefill ms
   (warm), decode tokens/s, the launches of kernel 4 and of kernel 7's
   int8 mode on that run (counts set to 0 just before), and the first 8
   tokens against the int8 plain path on the card (eager prefill and
   decode) under the top-2-gap rule;
19. kernel 8's int8 mode (``fused_verify_stack`` on phase 17's int8
   weights) at pos 600 over a random cache with NaN at and above pos, n 5
   and 9, the bf16 and the int8 LM head: against its plain twin at phase
   9's limits, a repeat bit-identical, one int8 launch a call; its time
   (CUDA events) beside its byte bound, the bf16 kernel 8 on the engine's
   weights in the same phase and the twin's; then its device time by pass
   (``[verify_int8_device]``: the int8 GEMVs with their TB/s, the bf16 LM
   head's GEMV, split, merge, norms);
20. ``spec_generate`` on the int8 engine (phase 9's run on phase 18's
   engine, ``[spec_int8]``): 32 tokens after a 128-token prompt, n_draft 4,
   once as its own draft (kernel 7's int8 mode drafts, kernel 8's int8
   mode verifies) and once with the small bf16 draft; each stream against
   the engine's own int8 ``stream_generate`` and the int8 plain path under
   the top-2-gap rule, tokens/s beside ``stream_generate``'s, rounds,
   accepted drafts, and every verify launch in kernel 8's int8 mode;
21. kernel 9's int8 mode (``llama_decoder_layer_paged`` on layer 1 of the
   int8 tree) at B 4, 8 and 1, NaN in every pool row no request owns:
   against its plain twin, the appended rows, every other row unchanged,
   a repeat bit-identical; device busy time by pass beside the bound, the
   bf16 kernel 9 on the same inputs and the twin's;
23. the int8 serving step's M=B products alone (``ops.gemv``'s
   ``_gemv_int8`` and ``_ffn_int8``) on layer 1 of the 7B int8 tree at the
   shapes serving gives them (the QKV product with bf16 out, the O product
   with one scale per head group, the SwiGLU FFN) at B 8, 4 and 1: against
   their plain twins within 1e-2 of the largest output, a repeat
   bit-identical, the device ms beside the bound and the twin's;
22. int8 serving: one step of each kind at B 8 over random pools (NaN in
   every unowned row, distinct tokens) against the same step on the plain
   twins, on 4 layers (logits within 2e-2 of the largest, appended rows at
   phase 9's limits, every other row unchanged; the requests' logits differ
   by more than that limit) and on all 32 (the logits' drift at most 1.25
   times the bf16 step's from its own twin); phase 8's B=8 mix on the int8 engine through the
   batched step (the M=B int8 products on the GEMVs' int8 instances and
   kernel 10) and through the fused step (kernel 9's int8 mode and the
   int8 FFN): tokens/s and ms a step beside phase 8's bf16 figures, the
   launches once per layer and step, each request alone giving the tokens
   it gives in the batch; then ``Llama.generate`` at B 1 (fused) and B 4
   (batched) against the int8 plain path under the top-2-gap rule.

Phases 24-26 run after 22, on phase 18's int8 engine (hg 8, G 4), while
the bf16 engine is alive:

24. kernel 6's int8 mode (``_fused_decoder_layer`` on an int8
   ``QuantizedTensor`` pair), as phase 13 runs the bf16 mode: layer 1, a
   4096-row cache, pos 600, large garbage at and above pos, on the whole
   tree and on the first tp-2 shard's slices (16 kv heads, G 2): full mode
   with the append and partials mode on [0, 300) and [300, 600) merged
   against one partials call and, O-projected over the codes and scales,
   against the full output, each against the int8 plain twin at phase 13's
   limits, a repeat bit-identical, one launch a call; device time (20
   calls queued behind a spin kernel between two events) and call time
   beside the bf16 kernel 6 on the same inputs, the twin's time, the byte
   bound, both launch plans and phase stamps;
25. the int8 tp and sp steps end to end in a one-rank NCCL group, as phase
   14 runs the bf16 ones, with the engine's bf16 LM head and with an int8
   head: ``shard_params`` views, a 512-token prefill, 32 greedy steps of
   ``make_sharded_decode_step`` and 8 of ``make_sp_sharded_decode_step``,
   each stream against kernel 7's int8 step (teacher forced) and the int8
   plain path under the top-2-gap rule; ms per step and tokens/s beside
   phase 14's; launches per step (kernel 6's int8 mode 32; kernel 2 32 in
   the tp step, 0 in the sp step; ``_ffn_int8`` 32; ``_gemv_int8`` 32 O
   products in the sp step and one LM-head product where the head is
   int8); the memory a step allocates beyond what it holds (no bf16 copy
   of a weight); busy time and the tp step's kernels by device time;
26. kernel 7's int8 mode 5 at tp 2 on this card, over the loopback
   communicator, as phase 15 (b) and (c) run bf16 (``[mode5_int8]``,
   ``[fused_step_int8]``): the int8 tree with an int8 LM head in two tp
   shards, each rank's step against the unsharded int8 kernel 7, first on
   4 layers at phase 15's limits, then on all 32, where x_out and the
   residual may also stray 1.25 times the bf16 mode-5 step's drift of
   phase 15 (its largest error over the largest value: at full depth both
   drift by a bf16 rounding a layer), the appended rows at phase 4's
   limits, the ranks bit-identical, the gathered int8 LM head against the
   ranks' own shards concatenated within 1e-3 of the largest logit; then
   16 greedy steps of
   ``make_sharded_decode_step(fused_collectives=True)`` on the int8 tree:
   8L+3 kernels a rank, each step one call of kernel 7's int8 mode, no
   standalone kernel 13 or 14, the ranks bit-identical; ms per pair step
   beside phase 15's bf16 pair step.

Phases 27-31 run after 26, on ``Llama.synthetic(llama2_7b, quant="int4")``
(groups of 128, hg 8, the LM head bf16), beside the bf16 and int8 engines:

27. kernel 7's int4 modes, W4A8 (the default) and exact, with the bf16 and
   an int8 LM head, pos 600 over a random cache with NaN above pos,
   against the int4 twin in the same mode at phase 4's limits: exact, the
   first 1, 4 and all 32 layers; W4A8, each of the 32 layers from one
   input, the kernel's own state after the layer before it (free-running,
   W4A8 and its twin part far beyond bf16 drift: a rounding the two take
   apart moves an int8 activation by a step); the int8 head at one layer;
   repeats bit-identical, the int8 step's launches; ms beside the bf16
   and int8 steps of the same run and the bound (codes and bf16 scales;
   the float32 scale bytes read beside it); device time by pass;
28. the int4 stream: 64 W4A8 greedy tokens after 512 and 16 exact ones,
   prefill ms, tokens/s, launches, the first 8 against the eager prefill
   and the int4 twin's steps under the top-2-gap rule;
29. kernel 8's int4 modes at n 5 and 9, held as phase 27 holds kernel 7,
   ms beside the bf16 kernel 8, the bound, device time by pass; then
   ``spec_generate`` (phase 9's self and small drafts in W4A8, a
   self-draft in the exact mode) against the engine's own stream;
30. kernel 9's int4 mode (exact, as the TPU kernel's) as phase 21 holds
   int8, and the int4 serving products as phase 23 holds int8's, with no
   bf16 copy of a weight;
31. int4 serving at B 8: one step of each kind against the plain-twin
   step (4 layers at phase 9's limits, 32 within 1.25x the bf16 drift);
   phase 8's mix through the default (fused) and the batched step,
   tokens/s and ms a step beside each kind's device busy ms at
   ``SERVE_LENS``, batching invariance; ``Llama.generate`` for one
   prompt against the plain path.

Phases 35-37 run after 31, while the bf16, int8 and int4 engines are
alive (before 32-34, which free the first two):

35. kernel 7 with an ``Int8KV`` and an fp8 cache at 7B width, capacity
   4096, pos 600 and 4000, over random rows with NaN scales (int8) or NaN
   bytes 0x7F (fp8) above pos: bf16 and int8 weights over 32 layers
   against the plain twin at phase 4's limits (layer 0's int8 codes
   within 1 and scales at rtol 1e-5, fp8 rows within one e4m3 step; the
   deeper rows' values at phase 4's limits plus one step of the format),
   every other row and scale unchanged, one kv8 launch counted a call;
   int4 W4A8 weights layer by layer, teacher-forced (``hold_by_layer``);
   CUDA-event step times, two readings in turns, beside the bf16-KV step
   on the same inputs, the bound (8-bit rows and scales below pos), the
   twin's time and the device time by pass at pos 600;
36. kernel 8 at n 5 the same way, pos 600 and 1022 (the five appends
   straddle plane row 8), with the call times beside the bf16-KV verify;
37. 64-token streams after 512 with an int8, an fp8 and a bf16 cache
   (tokens/s side by side; kernel 7's kv8 launches; the first 8 tokens
   against the plain path on the same cache kind), each 8-bit run after
   one teacher-forced step against the twin; ``spec_generate`` (self-
   draft, 32 tokens after 128) with each 8-bit cache (kernel 8's kv8
   launches, one a round); ``python -m clusterfusion_tpu_torch.chat
   --synthetic --kv_int8`` and ``--kv_fp8 --spec_draft synthetic`` on the
   card, exit 0.

Phases 38-40 run after 37, while the bf16, int8 and int4 engines live (8-bit
caches on the multi-card paths):

38. kernel 6's fp8 mode at layer 1 of the 7B bf16, int8 and int4 (exact
   and W4A8) engines, cap 4096, pos 600 and 4000, NaN bytes above pos, in
   full mode with and without the append, partials and ``fold_current=0``,
   against its twin at phase 13's limits (the appended e4m3 row within one
   code of the twin's, the share of equal bytes printed), repeats
   bit-identical; ``queued_ms`` beside the bf16-KV layer on the same
   inputs, the twin's time, the byte bound;
39. kernel 7's mode 5 at tp 2 on this card with an ``Int8KV`` and an fp8
   cache (phase 15's form and limits against kernel 7's unsharded 8-bit
   step, the gathered-head form), 8 steps of the fused tp-2 step on each
   (8L+3 kernels a rank), and one int8-weight run (4 layers, fp8); the
   pair step's ms beside phase 15's bf16 pair, its twin's time, the bound;
40. the tp, sp and fused tp steps on 8-bit caches in phase 14's one-rank
   NCCL group after a 512-token prefill: 32 fp8 tp steps, 8 fp8 sp steps,
   32 fused steps on each format, each stream after one teacher-forced
   step against the twin and held against kernel 7's single-card 8-bit
   step under the top-2-gap rule; launches a step, ms per step and
   tokens/s beside phase 14's bf16-KV steps.

Phases 41-43 run after 40, with the same engines (fp8 e4m3 serving pools):

41. kernel 10 on fp8 pools at phase 6's 7B geometry (kv 32, group 1, B 8,
   lens up to 2047) and Llama-3-8B's GQA geometry (kv 8, group 4), NaN
   (0x7f) in every unowned pool row, against its twin at phase 6's limits,
   the appended e4m3 codes within one code of the twin's, every other byte
   unchanged, a repeat bit-identical; ms (``queued_ms``) and the split and
   merge busy ms beside kernel 10 on bf16 pools of the same values, the
   twin's time, the byte bound;
42. kernel 9 on fp8 pools at phase 7's geometry (B 4, 8 and 1) with the
   bf16, int8 and int4 (exact) 7B layers, and one hd-64 layer at
   TinyLlama-1.1B's widths (its append stores e4m3 of the bf16 row, the
   7B layers e4m3 of the float32 row), each against its twin (phase 7's
   limits, appended codes within one code, other bytes unchanged, repeats
   bit-identical); ms beside the bf16-pool layer of each weight kind;
43. ``ServingEngine(kv_dtype=float8_e4m3fn)``: one step of each kind on
   fp8 pools against the plain-twin step (4 layers at phase 22's logits
   limit, layer 0's rows within one code; 32 layers within
   ``FP8_STEP_DRIFT`` times the bf16-pool step's drift); phase 8's mix
   through both steps on fp8 and on bf16 pools (tokens/s, ms a step,
   device busy ms a step side by side; fp8 launches once per layer and
   step; request 3 alone as in the batch); ``Llama.generate`` with an
   fp8 cache at B 1 (fused) and B 4 (batched) against the plain path on
   an fp8 cache under the top-2-gap rule.

Phases 44-46 run after 43, on TinyLlama-1.1B's widths (22 layers, hidden
2048, 32 heads on 4 kv heads, head dim 64, FFN 5632, vocab 32000, neox
rope; random weights from seed 0), through kernel 7's hd-64 form (the TPU
kernel's defer_append variant):

44. kernel 7 at full width, capacity 1024, pos 600, NaN above pos: bf16,
   int8, int4 exact and int4 W4A8 weights on a bf16 cache, bf16 and int4
   W4A8 weights on an ``Int8KV`` and an fp8 cache, each against its plain
   twin at phase 4's limits (an 8-bit cache: layer 0's codes within one
   and 99 % equal, its int8 scales within 2^-8; W4A8 layer by layer,
   teacher-forced), repeats bit-identical, launches counted; each step's
   ms (CUDA events, two readings in turns) beside the Llama-2-7B hd-128
   step timed in the same turns, device ms, the bound; the split and
   merge passes' busy ms;
45. TinyLlama's bs=1 stream: 64 greedy tokens after a 512-token prompt in
   bf16 and at the JAX package's operating point (int4 W4A8 weights, an
   ``Int8KV`` cache): tokens/s, ms a step, device busy ms a step, launches,
   the first 8 tokens against the plain path under the top-2-gap rule;
46. kernel 7's mode 5 at hd 64 as a tp-2 pair on this card (2 kv heads a
   rank), bf16 and int4 W4A8 + ``Int8KV``, each layer teacher-forced
   against ``fused_decoder_stack_plain_ranks``, the pair's ms; then 8
   steps of the fused tp-2 step on each (``phase_fused_step``).

Phases 32-34 run after 35-46, on the same int4 engine, in both int4 modes:

32. kernel 6's int4 modes at layer 1, pos 600, on the whole tree and the
   first tp-2 shard (``shard_params`` on the int4 tree): full mode with
   the append and partials mode against the int4 twin at phase 13's
   limits, repeats bit-identical, two kernels a W4A8 call (the layer,
   then the ring GEMV's W4A8 O product over the head groups' o) and one
   an exact call; ms (``queued_ms``) beside the int8 and bf16 kernel 6 on
   the same inputs, the bound, the launch plans and phase stamps;
33. the int4 tp and sp steps in a one-rank NCCL group (16 and 8 tokens
   after 512): the exact streams against kernel 7's exact int4 step
   teacher-forced under the top-2-gap rule, each W4A8 layer of one step
   against kernel 6's twin from the same inputs; launches a step and the
   memory a step allocates (no bf16 copy of a weight);
34. kernel 7's int4 mode 5 as a tp-2 pair on this card at 4 and 32
   layers: exact against the unsharded exact step (4 layers running free
   at phase 15's limits; at 32 the free-running drift printed and each
   layer held teacher-forced), W4A8 against its twin over the ranks
   (``fused_decoder_stack_plain_ranks``) layer by layer, teacher-forced;
   the 32-layer pair's ms beside the bf16 and int8 pairs, the bound; then
   4 steps of the fused tp-2 step in each mode (8L+3 kernels a rank; the
   exact stream against kernel 7's exact step).

After the DeepSeek phases, the Mistral-7B cell (``LlamaConfig.mistral_7b()``
at full width and all 32 layers, ``max_seq_len`` 8192, sliding window 4096,
random weights from seed 0; every other engine freed first):

47. kernel 7's window at pos 4600 and 8000 over a random cache of 8192
   rows, NaN above pos: windows 0, 4096, 100, pos + 1 and 1, each against
   its plain twin at kv_split 64 layer by layer, teacher-forced, at phase
   4's limits (at Mistral's width the free-running 32-layer drift reaches
   them without a window too; it is printed, and with a window held at
   1.25x window 0's on the same inputs); pos + 1 gives window 0's
   bits, 4096 differs from 0 at pos 8000, 7L+2 kernels at window 1; the
   step at pos 8000 with windows 4096 and 0 in turns (CUDA events, device
   ms with calls queued, the split and merge passes' busy ms) beside the
   bound; then JAX's window matrix at pos 4600, held the same way: int8 +
   ``Int8KV``, int4 W4A8 + ``Int8KV``, int4 exact + fp8;
48. kernel 4's window against its twin: the 4608-token prompt (window
   4096), a 1024-query chunk at q_offset 4608 and TinyLlama's hd-64 heads
   (window 1000), each head's row within 2e-2 of its largest value, and
   the kernel at window -+ 64 outside that limit; a window over every key
   gives window 0's bits; the prompt's call time beside its twin's, an
   SDPA call with a boolean window mask and the bound over the kept pairs;
49. kernel 8's window at n 5, pos 4600, windows 0, 4096 and 100, against
   its twin layer by layer (stale rows at and above pos), the free-running
   drift with a window at 1.25x window 0's, a repeat bit-identical, its
   time;
50. end to end: ``stream_generate`` of 64 greedy tokens after a
   4608-token prompt (every step past the window; kernel 4 32 times and
   kernel 7 once a token, counted from 0), every token against the eager
   path under the top-2-gap rule; then ``spec_generate`` (n_draft 4, 32
   tokens) with the target as its own draft, one kernel-8 launch a
   round, drafts accepted, its stream equal to the greedy stream's where
   the gap exceeds 0.1.  ``[phases_47_50]`` prints their seconds.
51-53. kernels 10 and 9 with the window and the engine with its rolling
   page buffer (``phase_window_paged_attention``,
   ``phase_window_paged_layer``, ``phase_window_serving``).
54. kernel 6's window on layer 1 of the same tree over an 8192-row cache,
   NaN below each bound and above pos: pos 4600 and 8000, windows 0, 4096,
   100, pos + 1 and 1, bf16 and fp8 caches, int8 and int4-exact weights,
   each against its twin at phase 13's limits (pos + 1 gives window 0's
   bits); partials over four virtual shards of 2048 rows with the sp
   step's bound (``shard_window_lo``) at pos 4600 and 6500, every shard
   case, merged by the sp algebra against the unsharded call; the layer
   at pos 8000, windows 4096 and 0, by ``queued_ms`` beside the bound;
55. kernel 7's mode 5 with the window as a tp-2 pair on this card (the
   tree regrouped to head group 1), pos 8000, windows 4096 and 1, against
   the one-card window step: 4 layers free, 32 layer by layer
   teacher-forced, the ranks' bits, 8L+1 kernels (7L+1 at window 1), the
   pair's ms beside the bound; then 4 fused tp-2 steps after 4608 tokens;
56. the tp and sp steps with the window in phase 14's one-rank NCCL group:
   16 and 8 greedy steps after 4608 tokens against kernel 7's window step,
   ms a step, kernels 6 and 2 counted.  ``[phases_54_56]`` prints their
   seconds.

Then, where the machine has two cards or more:

16. one rank per card (``torch.multiprocessing``, a ``file://`` store,
   NCCL): kernels 13 and 14 over NVLink at the tp step's shapes against
   their plain versions (bit-equal, every rank identical) and NCCL, each
   timed beside NCCL on the same bytes; then the seeded 7B weights, a
   512-token prefill and 32 greedy steps of the fused-collective tp step
   and of the NCCL tp step, ms per step before any profiler, both streams
   against kernel 7 teacher-forced on rank 0, every rank's logits against
   rank 0's bits (the fused step's must be identical); then each step's
   device time
   on rank 0 by pass (``torch.profiler``: kernel 7's GEMVs, split, merge,
   norms, the norms that wait for a reduce, and the tail's LM product and
   gather wait; kernels 6 and 2 and the rest of the NCCL step), and each
   step's last kernels (``[multicard_tail]``); the fused step must launch
   8L+3 kernels a rank, kernel 14 only inside kernel 7 and no standalone
   kernel 13 or 14.  On one card it prints ``[multicard] skipped
   cards=1``: nothing ran.  The collectives' call times are the slowest
   rank's median of 5 batches of 100 back-to-back calls, each batch started
   after ``synchronize`` and ``dist.barrier`` (paced by the host's calls);
   their device times are the profiler's per call over 50 calls, at the
   rank that waited least and the one that waited most.  Then the same two
   steps on an int8 tree (the weights regrouped to 8 kv heads a group and
   quantized per output column, the LM head too; ``step=fused_int8`` and
   ``nccl_int8``), against kernel 7's int8 mode teacher-forced, on
   the int4 tree in the exact mode (``step=fused_int4`` and
   ``nccl_int4``), against kernel 7's exact int4 mode, and on 8-bit
   caches prefilled alike (``step=fused_fp8``, ``nccl_fp8`` and
   ``fused_kvint8``: kernel 7's 8-bit mode 5, kernel 6's fp8 mode),
   against kernel 7's single-card step on the same cache.  Then the fused
   tp step at head dim 64 on TinyLlama's widths (its 4 kv heads over the
   ranks), bf16 and int4 W4A8 + ``Int8KV`` (``step=fused_hd64``,
   ``fused_hd64_int4_kvint8``), 16 steps after a 512-token prefill, the
   bf16 stream against kernel 7 teacher-forced.  Then Mistral-7B (window
   4096, head group 1) after a 6143-token prefill: 16 steps of the fused
   and of the NCCL tp step and 8 of the sp step at sp = the card count
   (at 4 cards every shard case occurs), each against kernel 7's window
   step teacher-forced on rank 0 (``step=mistral_*``).
   ``python3 chip_smoke.py multicard`` runs phases 1, 2 and 16 alone.

Then one JSON line per kernel table, the card line, and last
``{"ok": true, "device": {...}}``.  Weights are random, from a seed.
"""

from __future__ import annotations

import dataclasses
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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "scripts"))
import profiling  # noqa: E402
from profiling import timeline_by_pass  # noqa: E402

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


# A cache below is a bf16 tensor, an fp8 tensor or an ``Int8KV`` pair
# (int8 rows, float32 scales in [L, kv, R, 128] planes).

def kv_positions(c) -> int:
    return c.shape[2]


def kv_take(c, lo, hi):
    """A copy of layers lo..hi-1 of a cache."""
    if hasattr(c, "s"):
        return type(c)(c.q[lo:hi].clone(), c.s[lo:hi].clone())
    return c[lo:hi].clone()


def _kv_scales(c):
    L, H, R, _ = c.s.shape
    return c.s.view(L, H, R * 128)


def kv_values(c, rows):
    """Rows ``rows`` (positions) of every layer as float32 [L, kv, n, hd]
    values (int8: codes times scales)."""
    if hasattr(c, "s"):
        return c.q[:, :, rows].float() * _kv_scales(c)[:, :, rows, None]
    return c[:, :, rows].float()


def kv_same_bits(a, b, rows) -> bool:
    """Bit equality of two caches at positions ``rows`` (a bool mask over
    the capacity; NaN compares equal): rows, and an Int8KV's scales."""
    if hasattr(a, "s"):
        sa, sb = _kv_scales(a), _kv_scales(b)
        cap = a.q.shape[2]
        return (torch.equal(a.q[:, :, rows], b.q[:, :, rows])
                and torch.equal(sa[:, :, :cap][:, :, rows].view(torch.int32),
                                sb[:, :, :cap][:, :, rows].view(torch.int32))
                and torch.equal(sa[:, :, cap:].view(torch.int32),
                                sb[:, :, cap:].view(torch.int32)))
    if a.dtype == torch.float8_e4m3fn:
        return torch.equal(a[:, :, rows].view(torch.uint8),
                           b[:, :, rows].view(torch.uint8))
    return _same_bits(a[:, :, rows], b[:, :, rows])


def kv_heads(c, heads):
    """The kv heads ``heads`` (a slice) of a cache, a view."""
    if hasattr(c, "s"):
        return type(c)(c.q[:, heads], c.s[:, heads])
    return c[:, heads]


STACK_KV_SPLITS = (32, 64, 128)


def stack_vs_plain(phase, out, ref, kk, vk, kc, vc, pos, **where):
    """Kernel 7's step (``out``, caches kk/vk) against its plain twin's
    (``ref``, kc/vc) at phase 4's limits: logits within 2e-2 of the largest,
    the appended K/V rows (layer 0 at atol 0.05, deeper layers at atol 0.05
    + rtol 1e-2 of |row|), every other row unchanged bit for bit, finite
    outputs.  Prints the errors; returns (logits max abs error, ok)."""
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
    others = torch.ones(kc.shape[2], dtype=torch.bool, device=kc.device)
    others[pos] = False
    unchanged = (_same_bits(kk[:, :, others], kc[:, :, others])
                 and _same_bits(vk[:, :, others], vc[:, :, others]))
    finite = bool(torch.isfinite(out[0]).all()) and bool(
        torch.isfinite(out[1].float()).all())
    say(phase, **where, pos=pos, logits_max_abs_err=f"{lg_err:.4g}",
        logits_err_over_max=f"{lg_rel:.4g}", tol_logits=2e-2,
        kv_row_err_layer0=f"{row_err[0].item():.3g}", tol_layer0=0.05,
        kv_row_err_max=f"{row_err.max().item():.4g}",
        kv_row_err_by_layer=[round(e, 4) for e in row_err[::4].tolist()],
        kv_row_max_abs=f"{row_mag.max().item():.3g}",
        tol_rows="atol=0.05+rtol=1e-2", other_rows_unchanged=unchanged,
        nan_above_pos=True, finite=finite)
    return lg_err, lg_rel <= 2e-2 and rows_ok and unchanged and finite


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
    lg_err, ok = stack_vs_plain("stack", out, ref, kk, vk, kc, vc, pos,
                                kernel=7, layers=cfg.n_layers,
                                kernels_per_step=sk.last_step_kernels)
    if not ok:
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
    from the end of those before it) and the busy ms by pass; where no
    profile saw a device event, ``queued_ms`` (nan if the calls cannot be
    queued ahead) and nan by pass."""
    try:
        busy, _, _, by_pass, _ = timeline_by_pass(fn, passes)
    except profiling.LostEvents:
        try:
            busy = queued_ms(fn)
        except AssertionError:
            busy = math.nan
        profiling.note(no_device_events=True, busy_ms_from="queued_ms")
        return busy, dict.fromkeys([*(k for k, _ in passes), "other"],
                                   math.nan)
    return busy, by_pass


def row_ms(fn, passes=()):
    """A kernels-line row's ms, ``queued_ms`` (the profiler loses kernel
    events, more the older the process, and a profile that lost some reads
    low: ``scripts/profiler_events.py``), and the profiler's busy ms by
    pass beside it (``busy_ms``)."""
    return queued_ms(fn), busy_ms(fn, passes)[1]


def device_ms(fn, reps: int = 20) -> float:
    """``profiling.device_ms`` for the kernels line: a profile that lost
    kernel events reads low, so then ``queued_ms`` of the calls stands
    in."""
    try:
        return profiling.device_ms(fn, reps, whole=True)
    except profiling.LostEvents:
        profiling.note(lost_events=True, stands_in="queued_ms")
        return queued_ms(fn)


K6_PHASES = ("norm", "qkv", "rope", "split_kv", "merge", "oproj", "fold")
#: Figures a phase keeps for a later phase to print beside its own (the
#: bf16 steps' ms beside the int8 steps').
FIGURES = {}
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
        ms, by_pass = row_ms(call, PAGED_PASSES)
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


LAYER9_PASSES = (("gemv", "gemv_kernel"), ("norm", "resnorm_kernel"),
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
        ms, by_pass = row_ms(call, LAYER9_PASSES)
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


def plain_logits(params, cfg, dev, prompt, toks, kv_dtype=torch.bfloat16,
                 step=None):
    """The plain path's logits before each of ``toks`` (eager prefill and
    decode on the card, teacher-forced on ``toks``; ``step(params, kc, vc,
    token, pos, cfg)`` in place of the eager decode step when given; a
    cache of ``kv_dtype``), one at a time."""
    from clusterfusion_tpu_torch.models import llama as model
    if step is None:
        step = functools.partial(model.decode_step, fused=False)
    kc, vc = model.init_cache(cfg, device=dev, dtype=kv_dtype)
    lg, kc, vc = model.prefill(params, kc, vc, prompt, cfg, flash=False)
    lg = lg[-1]
    for i, t in enumerate(toks):
        yield lg
        if i + 1 < len(toks):
            lg, kc, vc = step(params, kc, vc, t, len(prompt) + i, cfg)


def check_against_plain(eng, dev, prompt, toks, n=8, step=None):
    """Greedy tokens must match the plain path (``plain_logits``, a cache of
    the engine's ``kv_dtype``) wherever its top-2 gap > 0.1.  Returns
    (plain tokens, gaps, steps that disagree)."""
    plain, gaps = [], []
    for lg in plain_logits(eng.params, eng.cfg, dev, prompt, toks[:n],
                           getattr(eng, "kv_dtype", torch.bfloat16), step):
        top = torch.topk(lg, 2).values
        gaps.append((top[0] - top[1]).item())
        plain.append(int(torch.argmax(lg)))
    bad = [i for i, g in enumerate(gaps) if g > 0.1 and plain[i] != toks[i]]
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
    figures = dict(tokens_per_s=decode_tokens / sum(step_s),
                   ms_per_step=sum(step_s) * 1e3 / steps)
    return pa_launches, layer_launches, figures


def phase_verify(eng, dev, hbm, peak, stack_ms, pos=600):
    """Kernel 8 against its plain twin at n 5 (the default n_draft 4) and
    n 9 (n_draft 8), pos 600 of a 1024-row cache.  Returns n 5's row of the
    kernel table and the cells ``phase_verify_device`` reads."""
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
    rows, cases = {}, {}
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
        cases[n] = dict(args=args, kc=kk, vc=vk, kv_read=kv_read)
    cases.update(kw=kw, pos=pos, hbm=hbm, gemv_bytes=2 * weights)
    return rows[5], cases


VERIFY_PASSES = (("gemv", "gemv_kernel"), ("split", "attn_split_kernel"),
                 ("norms", "resnorm_kernel"), ("merge", "verify_merge_kernel"))
RG_PHASES = ("wait_prior", "first_stage", "stream_half", "stream_rest",
             "partials", "sum", "end")


def stamp_phases(st):
    """Mean µs of each rows-GEMV phase over the blocks that stamped
    (``RG_PHASES``, from their %globaltimer stamps), the launch's span and
    how far its last block ends after the mean."""
    s = st[st[:, 0] != 0].double()
    out = dict(blocks=s.shape[0])
    for k, name in enumerate(RG_PHASES):
        out[f"{name}_us"] = f"{(s[:, k + 1] - s[:, k]).mean().item() / 1e3:.2f}"
    out["span_us"] = f"{(s[:, 7].max() - s[:, 0].min()).item() / 1e3:.2f}"
    out["last_block_after_mean_us"] = \
        f"{(s[:, 7].max() - s[:, 7].mean()).item() / 1e3:.2f}"
    return out


VERIFY_PRODUCTS = ("qkv", "o", "gate_up", "down")


def verify_product_phases(call, at):
    """The phases of kernel 8's rows-GEMV launch number ``at`` inside one
    call (``cf_verify_probe_gemv``)."""
    from clusterfusion_tpu_torch.ops import _build
    st = torch.zeros((16 * 256 * 2, 8), dtype=torch.int64, device="cuda")
    lib = _build.lib()
    lib.cf_verify_probe_gemv(st.data_ptr(), at)
    try:
        call()
        torch.cuda.synchronize()
    finally:
        lib.cf_verify_probe_gemv(None, -1)
    return stamp_phases(st)


def phase_verify_device(cases):
    """Kernel 8's device time by pass at phase 9's cells (``torch.profiler``;
    each kernel charged from the end of those before it), its GEMVs' and
    split pass's rates, and the phase stamps of layer 1's four products
    inside a call; run after ``spec_generate``, whose wall clocks a
    profiler session slows."""
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    kw, pos, hbm = cases["kw"], cases["pos"], cases["hbm"]
    for n in (5, 9):
        c = cases[n]
        busy, span, own, out, cnt = timeline_by_pass(
            lambda: sv.fused_verify_stack(*c["args"], c["kc"], c["vc"], pos,
                                          **kw), VERIFY_PASSES)
        say("verify_device", kernel=8, n=n, pos=pos, busy_ms=f"{busy:.4f}",
            span_ms=f"{span:.4f}", kernels_own_sum_ms=f"{own:.4f}",
            **{f"{k}_ms": f"{v:.4f}" for k, v in out.items()},
            **{f"{k}_launches": f"{v:g}" for k, v in cnt.items()},
            gemv_TBps=f"{cases['gemv_bytes'] / (out['gemv'] * 1e-3) / 1e12:.3f}",
            split_TBps=f"{c['kv_read'] / (out['split'] * 1e-3) / 1e12:.3f}",
            split_bound_ms=f"{c['kv_read'] / hbm * 1e3:.4f}",
            note="each kernel charged from the end of those before it to "
                 "its own end")
        call = lambda: sv.fused_verify_stack(  # noqa: E731
            *c["args"], c["kc"], c["vc"], pos, **kw)
        for j, name in enumerate(VERIFY_PRODUCTS):
            say("verify_gemv_phases", n=n, product=f"{name} (layer 1, in the "
                "call)", **verify_product_phases(call, 4 + j))
        del c["kc"], c["vc"]


SPEC_NEW = 32
SPEC_DRAFT = 4


def spec_run(eng, dev, prompt, draft, ref, label, phase="spec",
             plain_step=None):
    """``spec_generate`` with ``draft``; checks its stream against
    ``stream_generate``'s (``ref``) and the plain path under the top-2-gap
    rule, and one verify launch per round (with int8 or int4 weights, of
    kernel 8's int8 or int4 mode).  Returns (verify launches, rounds where
    a draft was rejected at a top-2 gap > 0.1)."""
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    fp.launches = sk.launches = sv.launches = sv.int8_launches = 0
    sv.int4_launches = 0
    toks = eng.spec_generate(prompt, SPEC_NEW, draft, n_draft=SPEC_DRAFT)
    verify_launches, stack_launches, flash_launches = \
        sv.launches, sk.launches, fp.launches
    int8_verify, int4_verify = sv.int8_launches, sv.int4_launches
    kind = getattr(eng.params["layers"]["wqkv_f"], "kind", None)
    if (int8_verify, int4_verify) != (verify_launches * (kind == "int8"),
                                      verify_launches * (kind == "int4")):
        raise AssertionError(f"{label}: {int8_verify} int8 and {int4_verify} "
                             f"int4 verify launches of {verify_launches}")
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
    plain, gaps, bad = check_against_plain(eng, dev, prompt, toks, len(toks),
                                           plain_step)
    # where a round rejected a draft, the target's own token stands at the
    # round's last emitted place
    rejected, at = [], 1                       # toks[0] is the prefill's
    for c in st["round_counts"]:
        if c < SPEC_DRAFT + 1 and at + c - 1 < len(toks):
            rejected.append(at + c - 1)
        at += c
    div = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b),
               None)
    say(phase, draft=label, prompt_tokens=len(prompt), tokens=len(toks),
        rounds=st["rounds"], accepted_drafts=st["accepted_drafts"],
        round_counts=st["round_counts"],
        tokens_per_s=f"{gs.tokens_per_s:.2f}", wall_s=f"{gs.total_s:.3f}",
        verify_launches=verify_launches, int8_verify_launches=int8_verify,
        int4_verify_launches=int4_verify, stack_launches=stack_launches,
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


def phase_spec(eng, dev, phase="spec", plain_step=None):
    """``spec_generate`` at 7B: a self-draft and an unrelated small (bf16)
    draft (``plain_step``: the plain decode step of ``check_against_plain``).
    Returns the verify launches of the self-draft run."""
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.generation import Llama
    text = ("Speculative decoding drafts a few tokens and one verify step "
            "scores them all. " * 3)[:127]
    prompt = eng.tokenizer.encode(text, bos=True, eos=False)
    ref = list(eng.stream_generate(prompt, SPEC_NEW, temperature=0.0))
    say(phase, baseline="stream_generate", tokens=len(ref),
        tokens_per_s=f"{eng.stats.tokens_per_s:.2f}",
        wall_s=f"{eng.stats.total_s:.3f}")
    # a second engine on the same weights, with its own cache
    self_draft = Llama(eng.params, eng.cfg, eng.tokenizer, fused=True)
    launches, bad = spec_run(eng, dev, prompt, self_draft, ref, "self",
                             phase, plain_step)
    if bad:
        raise AssertionError(f"self-draft: drafts rejected at {bad} where "
                             "the target's top-2 gap exceeds 0.1")
    small = Llama.synthetic(
        LlamaConfig.tiny(hidden_dim=1024, n_heads=8, ffn_dim=2816, n_layers=4,
                         vocab_size=32000, max_seq_len=2048),
        seed=1, fused=True, device=dev)
    spec_run(eng, dev, prompt, small, ref, "small", phase, plain_step)
    return launches


def profile_by_kernel(fn, reps: int = 8, top: int = 12):
    """``torch.profiler`` over ``reps`` calls of ``fn``: (device ms per call,
    profiled wall ms per call, [(kernel, ms per call, launches per call)]
    of the ``top`` kernels by device time)."""
    ev, wall = profiling.profile_calls(fn, reps)
    total = sum(b - a for a, b, _ in ev) / 1e3 / reps
    return total, wall, [(name[:60], ms, n)
                         for name, ms, n in profiling.by_kernel(ev, reps, top)]


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


def _layer_bound(hbm, peak, wbytes, weights, kvh, heads, rows, hd, io_bytes,
                 row_bytes=2):
    """Bound of one attention half: the weights and the K/V rows < seq
    (``row_bytes`` an element: 2 bf16, 1 fp8) read once, the inputs and
    outputs once; two operations per weight and four per (head, row,
    element) of the attention."""
    nbytes = wbytes + 2 * kvh * rows * hd * row_bytes + io_bytes
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
    ms = queued_ms(call)
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


def check_against_stack(params, cfg, k0, v0, pos0, first, toks, kcfg=None):
    """Teacher-force kernel 7's step (``decode_step(fused=True)``, with
    ``kcfg``: an int4 tree's mode) on the whole weights ``params`` along a
    sharded step's stream from copies of the same prefilled caches (bf16,
    fp8 or ``Int8KV``): every
    token must be kernel 7's wherever its top-2 gap exceeds 0.1.  Returns
    (kernel 7's tokens, gaps, steps that disagree)."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    kc, vc = kv_take(k0, 0, k0.shape[0]), kv_take(v0, 0, v0.shape[0])
    inputs = [first] + list(toks[:-1])
    ref, gaps = [], []
    for i, t in enumerate(inputs):
        lg, kc, vc = model.decode_step(params, kc, vc, t, pos0 + i, cfg,
                                       kcfg or KernelConfig(), fused=True)
        top = torch.topk(lg, 2).values
        gaps.append((top[0] - top[1]).item())
        ref.append(int(torch.argmax(lg)))
    bad = [i for i in range(len(toks)) if gaps[i] > 0.1 and ref[i] != toks[i]]
    return ref, gaps, bad


def phase_sharded(eng, dev, prompt=None, steps=(32, 8), phase="sharded",
                  plain=True):
    """The tp and sp fused decode steps end to end in a one-rank NCCL
    group: ``build_mesh(MeshConfig())``, ``shard_params`` (views of the
    engine's weights), a 512-token prefill through ``prefill`` (kernel 4),
    then 32 greedy steps through ``make_sharded_decode_step`` and 8 through
    ``make_sp_sharded_decode_step``, each stream against kernel 7's step and
    the plain path under the top-2-gap rule, with ms per step, tokens/s,
    launches of kernels 6 and 2 per step and the tp step's kernels by
    device time.  Phase 56 runs it on the Mistral-7B engine (``prompt``:
    phase 50's 4608 tokens, ``steps`` 16 and 8, the streams against kernel
    7's one-card window step, not the plain path, ``plain=False``; every
    kernel-6 launch a windowed one).  Returns the launches of kernels 6
    (both steps) and 2."""
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
        if prompt is None:
            text = ("The quick brown fox jumps over the lazy dog. "
                    * 20)[:511]
            prompt = eng.tokenizer.encode(text, bos=True, eos=False)
        k0, v0 = model.init_cache(cfg, device=dev)
        fp.launches = 0
        lg, k0, v0 = model.prefill(eng.params, k0, v0, prompt, cfg)
        first = int(torch.argmax(lg[-1]))
        flash = fp.launches
        pos0 = len(prompt)
        results = {}
        for name, n, make, spec in (
                ("tp", steps[0], par.make_sharded_decode_step,
                 par.cache_pspec()),
                ("sp", steps[1], par.make_sp_sharded_decode_step,
                 par.cache_pspec_2d())):
            step = make(cfg, mesh)
            kc = par.shard_cache(k0.clone(), mesh, spec)
            vc = par.shard_cache(v0.clone(), mesh, spec)
            tok = torch.tensor(first, device=dev)
            dl.launches = dl.window_launches = 0
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
            k6w = dl.window_launches
            toks = [int(t) for t in out]
            finite = bool(torch.isfinite(lg).all())
            ref, gaps, bad = check_against_stack(eng.params, cfg, k0, v0,
                                                 pos0, first, toks)
            say(phase, step=name, mesh="tp=1,sp=1 (one rank, nccl)",
                window=cfg.sliding_window, kernel6_window_launches=k6w,
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
            FIGURES[f"{phase}_{name}_ms_per_step"] = dt * 1e3 / n
            FIGURES[f"{phase}_{name}_tokens_per_s"] = n / dt
            want2 = L * n if name == "tp" else 0
            if k6 != L * n or k2 != want2 or not finite or bad \
                    or flash != L or not views \
                    or k6w != (k6 if cfg.sliding_window else 0):
                raise AssertionError(f"the {name} step: launches, tokens or "
                                     "kernel 7 agreement wrong")
            if plain:
                plain_t, pgaps, pbad = check_against_plain(eng, dev, prompt,
                                                           [first] + toks)
                say(phase, step=name, plain_tokens=plain_t,
                    top2_gaps=[round(x, 3) for x in pgaps],
                    disagree_where_gap_gt_0_1=pbad)
                if pbad:
                    raise AssertionError(f"the {name} step and the plain "
                                         f"path disagree at {pbad}")
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
        say(f"{phase}_busy", tp_device_busy_ms_per_step=f"{busy['tp']:.4f}",
            sp_device_busy_ms_per_step=f"{busy['sp']:.4f}")
        FIGURES[f"{phase}_busy"] = busy
        say(f"{phase}_profile", step="tp", device_ms_per_step=f"{dev_ms:.4f}",
            profiled_wall_ms_per_step=f"{prof_wall:.4f}",
            device_busy_share_profiled=f"{dev_ms / prof_wall:.3f}")
        for kname, kms, cnt in top:
            say(f"{phase}_profile", kernel=repr(kname),
                ms_per_step=f"{kms:.4f}", launches_per_step=f"{cnt:g}")
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


def phase_mode5(eng, dev, pos=600, params=None, phase="mode5", drift=None,
                kv=None):
    """Phase 15, second part: mode 5 of kernel 7 (``reduce_axis``) at tp 2
    on this card (phase 26, ``phase="mode5_int8"``: the same on ``params``,
    the int8 engine's tree with an int8 LM head: the O and down products
    and the LM head's shard push through ring_gemv8_kernel).  The engine's 7B weights and a cache filled at random as
    in phase 4 are cut into two tp shards (``shard_params`` /
    ``shard_cache`` on a loopback communicator's meshes); each virtual rank
    runs ``fused_decoder_stack(reduce_axis="tp")`` without the LM head on
    its own stream, against kernel 7's unsharded step (also without it):
    x_out and the residual within 0.05 + 1e-2 of the largest value, the
    appended rows at phase 4's limits, every other row unchanged, and the
    two ranks' x_out and residual bit-identical.  The unsharded step is run
    three times on the same inputs and must give the same bits each time
    (its GEMVs sum their K chunks in a fixed order).  Then kernel 14 inside
    the stack at the tp step's shapes: each rank's step with its LM-head
    shard and the logits gathered (8L+3 kernels), the ranks bit-identical
    and within 1e-3 of the largest logit of the plain version (the ranks'
    own shards from the public call with the LM head, concatenated).
    ``drift`` (x_out's and the residual's largest error over their largest
    value in phase 15's bf16 run): x_out and the residual may also stray up
    to 1.25 times that share, since at full depth the two steps drift
    apart by a bf16 rounding a layer (phase 26 holds 4 layers at the
    limits above first).  ``kv`` ("int8" or "fp8"; phase 39): the cache
    is that 8-bit pair (``kv8_cache``: NaN scales or bytes above pos), cut
    by ``shard_cache`` (an ``Int8KV``'s rows and scale planes on the kv
    axis), the appended rows held as above plus one step of the format,
    kernel 7's 8-bit launches counted once a rank."""
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    cfg, p = eng.cfg, eng.params if params is None else params
    lw, tp = p["layers"], 2
    L = lw["wqkv_f"].shape[0]
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    gen = torch.Generator(device=dev).manual_seed(2)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    if kv is not None:
        kc, vc = kv8_cache(kc, vc, kv, pos)
    step = 0.0 if kv is None else KV8_STEP[kv]
    x = p["embed"][torch.tensor([7], device=dev)]
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
              eps=cfg.norm_eps)
    refs = []
    for _ in range(3):
        kr, vr = kv_take(kc, 0, kc.shape[0]), kv_take(vc, 0, vc.shape[0])
        refs.append(sk.fused_decoder_stack(
            x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"], kr, vr, pos, **kw))
    ref = refs[0]
    every = torch.ones(kc.shape[2], dtype=torch.bool, device=dev)
    repeatable = all(torch.equal(r[0], ref[0]) and torch.equal(r[1], ref[1])
                     and kv_same_bits(r[2], ref[2], every)
                     and kv_same_bits(r[3], ref[3], every)
                     for r in refs[1:])
    quant = hasattr(lw["wqkv_f"], "q")
    lb = col.LoopbackComm(tp, dev)
    meshes = [lb.mesh(r) for r in range(tp)]
    shards = [par.shard_params(p, cfg, m) for m in meshes]
    streams = [torch.cuda.Stream(dev) for _ in range(tp)]
    try:
        caches = [(par.shard_cache(kc, m), par.shard_cache(vc, m))
                  for m in meshes]

        def both(fn=sk.fused_decoder_stack, head=False):
            outs = []
            for r in range(tp):
                streams[r].wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(streams[r]):
                    sl = shards[r]["layers"]
                    extra = dict(final_norm=p["final_norm"],
                                 lm_head=shards[r]["lm_head"]) if head else {}
                    outs.append(fn(
                        x, sl["attn_norm"], sl["ffn_norm"], cos, sin,
                        sl["wqkv_f"], sl["wo_f"], sl["w13"], sl["w2"],
                        *caches[r], pos, reduce_axis="tp", mesh=meshes[r],
                        **kw, **extra))
            for s in streams:
                torch.cuda.current_stream(dev).wait_stream(s)
            return outs

        k7, k13, i8 = sk.launches, col.launches["all_reduce"], sk.int8_launches
        n8 = sum(sk.kv8_launches.values())
        outs = both()
        torch.cuda.synchronize()
        lb.check()
        per_step = sk.last_step_kernels
        k7, k13 = sk.launches - k7, col.launches["all_reduce"] - k13
        i8 = sk.int8_launches - i8
        n8 = sum(sk.kv8_launches.values()) - n8
        same = all(torch.equal(o[0], outs[0][0]) and
                   torch.equal(o[1], outs[0][1]) for o in outs)
        errs, rows_ok, unchanged, row0, rel = [], True, True, [], [0.0, 0.0]
        others = torch.ones(kc.shape[2], dtype=torch.bool, device=dev)
        others[pos] = False
        for r, (xo, ro, k, v) in enumerate(outs):
            for j, (got, want) in enumerate(((xo, ref[0]), (ro, ref[1]))):
                e = (got.float() - want.float()).abs().max().item()
                m = want.float().abs().max().item()
                errs.append(e)
                rel[j] = max(rel[j], e / m)
                lim = 0.05 + 1e-2 * m
                if drift is not None:
                    lim = max(lim, 1.25 * drift[j] * m)
                rows_ok &= e <= lim
            heads = slice(r * cfg.kv_heads // tp, (r + 1) * cfg.kv_heads // tp)
            # the stack's L layers (the cache may hold more, NaN at pos)
            row_err = torch.maximum(*(
                (kv_values(a, [pos]) - kv_values(kv_heads(b, heads), [pos]))
                [:L].abs().amax(dim=(1, 2, 3)) for a, b in ((k, kr), (v, vr))))
            row_mag = torch.maximum(*(
                kv_values(kv_heads(b, heads), [pos])[:L].abs()
                .amax(dim=(1, 2, 3)) for b in (kr, vr)))
            rows_ok &= bool(row_err[0] <= 0.05 + step * row_mag[0]) and \
                bool((row_err <= 0.05 + (1e-2 + step) * row_mag).all())
            errs.append(row_err.max().item())
            row0.append(row_err[0].item())
            unchanged &= kv_same_bits(k, kv_heads(kc, heads), others)
            unchanged &= kv_same_bits(v, kv_heads(vc, heads), others)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            both()
        torch.cuda.synchronize()
        pair_ms = (time.perf_counter() - t0) * 1e2
        FIGURES[f"{phase}_pair_ms"] = pair_ms
        FIGURES[f"{phase}_drift"] = rel
        FIGURES[f"{phase}_max_abs_err"] = max(errs[0::3] + errs[1::3])
        # kernel 14 inside the stack at the tp step's shapes (the LM head's
        # pushing product over each rank's 16000 columns and the gather's
        # wait) against its plain version: the ranks' own shards (the
        # public call with the LM head) concatenated in rank order
        local = [o[0][0] for o in both(head=True)]
        gathered = [o[0] for o in both(sk._fused_decoder_stack_gathered,
                                       head=True)]
        gathered_kernels = sk.last_step_kernels
        torch.cuda.synchronize()
        lb.check()
        want = col.all_gather_loopback_plain(local)[0]
        g_err = max((g[0] - want).abs().max().item() for g in gathered)
        g_tol = 1e-3 * want.abs().max().item()
        g_same = all(torch.equal(g, gathered[0]) for g in gathered)
        say(phase, kernel=14, in_stack=True, tp=tp, loopback=True,
            shard=local[0].numel(), gather_vs_plain_max_abs_err=g_err,
            tol=f"{g_tol:.3g} (1e-3 of the largest logit: the pushing "
                "product's K chunks may be cut otherwise than the plain "
                "product's)",
            bit_equal_plain=bool(torch.equal(gathered[0][0], want)),
            ranks_bit_identical=g_same, kernels_per_step=gathered_kernels)
        if g_err > g_tol or not g_same or gathered_kernels != 8 * L + 3:
            raise AssertionError("kernel 14 inside the stack disagrees with "
                                 "its plain version")
        int8 = {} if not quant and kv is None else dict(
            layers=L, int8_launches=i8, kv8_launches=n8,
            bf16_both_ranks_ms_per_step=(
                f"{FIGURES['mode5_pair_ms']:.3f}" if "mode5_pair_ms" in FIGURES
                else "not measured"),
            x_res_err_over_max=[round(v, 5) for v in rel],
            bf16_x_res_err_over_max=[round(v, 5) for v in
                                     FIGURES.get("mode5_drift", [])],
            tol_x_res="0.05+1e-2*max|ref|" if drift is None else
            "max(0.05+1e-2*max|ref|, 1.25*bf16 err/max*max|ref|)")
        say(phase, kernel=7, reduce_axis="tp", tp=tp, loopback=True,
            pos=pos, kv=kv or "bf16", x_out_err=f"{errs[0]:.4g}",
            residual_err=f"{errs[1]:.4g}",
            kv_row_err_max=f"{max(errs[2::3]):.4g}",
            tol="x/res 0.05+1e-2*max|ref|; rows layer 0 atol=0.05, "
                "deeper atol=0.05+rtol=1e-2"
                + ("" if kv is None else f", +{step:.4g} of |row| (one step "
                   "of the format)"),
            ranks_bit_identical=same, other_rows_unchanged=unchanged,
            kernel7_repeats_bit_identical=repeatable,
            kernels_per_step=per_step, stack_launches=k7,
            reduces=k13,
            both_ranks_ms_per_step=f"{pair_ms:.3f}",
            error_word=lb.ranks[0].error(), **int8)
        if not (same and rows_ok and unchanged and repeatable and k7 == tp
                and k13 == 2 * L * tp and per_step == 8 * L + 1
                and (not quant or i8 == tp)
                and n8 == (0 if kv is None else tp)):
            raise AssertionError("mode 5 disagrees with kernel 7's "
                                 f"unsharded step (errors {errs}, layer 0's "
                                 f"rows {row0})")
    finally:
        lb.close()
    return shards


def phase_fused_step(eng, dev, shards, n=16, params=None,
                     phase="fused_step", kcfg=None, stack_check=True,
                     kv=None, prompt=None):
    """Phase 15, third part (phase 26's, ``phase="fused_step_int8"``, on
    ``params``, the int8 tree whose ``shards`` phase_mode5 cut, each step
    one call of kernel 7's int8 mode): ``make_sharded_decode_step(
    fused_collectives=True)`` at tp 2 on this card, two virtual ranks on
    their own streams over a loopback communicator: a 512-token prefill
    (kernel 4) on the whole weights, then ``n`` greedy steps per rank, each
    one kernel 7 sequence of 8L+3 kernels with kernel 13's two reduces a
    layer and kernel 14's gather of the logits inside it (no standalone
    launch of either).  Counts are set to 0 just before and read just
    after.  The ranks' logits are bit-identical and their tokens kernel 7's
    (teacher forced) wherever the top-2 gap exceeds 0.1.  Then the pair
    step's device time by pass (``torch.profiler``; the tail's LM product
    and gather wait beside kernel 7's passes) and the last kernels of one
    profiled pair step.  Phase 34 runs it on the int4 tree in both modes
    (``kcfg``): the exact step is kernel 7's exact function and is held the
    same way; the W4A8 step quantizes the down product per f-block of the
    rank's shard, another function than the unsharded W4A8 step, so
    ``stack_check=False`` keeps its launches, ranks and finiteness checks
    and leaves its agreement to phase 34's layer-by-layer check.  Phase 39
    runs it on an 8-bit cache (``kv``: "int8", an ``Int8KV`` pair, or
    "fp8"), prefilled and cut by ``shard_cache`` alike, each step one call
    of kernel 7's 8-bit mode 5 a rank.  Phase 55 runs it on the Mistral-7B
    tree after ``prompt`` (phase 50's 4608 tokens), every step past the
    window.  Returns kernel 13's reduces and kernel 14's gathers."""
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    from clusterfusion_tpu_torch.parallel.mesh import AXES
    cfg, L, tp = eng.cfg, eng.cfg.n_layers, len(shards)
    p = eng.params if params is None else params
    if prompt is None:
        text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
        prompt = eng.tokenizer.encode(text, bos=True, eos=False)
    k0, v0 = model.init_cache(cfg, device=dev, dtype=dict(
        KV8_FORMATS).get(kv, torch.bfloat16))
    lg, k0, v0 = model.prefill(p, k0, v0, prompt, cfg)
    first, pos0 = int(torch.argmax(lg[-1])), len(prompt)
    quant = hasattr(p["layers"]["wqkv_f"], "q")
    # one step at tp 1 first, so that every kernel of the path is loaded
    # before a virtual rank spins on the card (see ``LoopbackComm``); the
    # row it writes at pos0 is rewritten by the first step below
    from clusterfusion_tpu_torch.config import KernelConfig
    kcfg = kcfg or KernelConfig()
    alone = par.Mesh(shape={a: 1 for a in AXES}, coords={a: 0 for a in AXES},
                     groups={a: None for a in AXES})
    par.make_sharded_decode_step(cfg, alone, kcfg, fused_collectives=True)(
        p, k0, v0, first, pos0)
    lb = col.LoopbackComm(tp, dev)
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        steps = [par.make_sharded_decode_step(cfg, m, kcfg,
                                              fused_collectives=True)
                 for m in meshes]
        caches = [[par.shard_cache(k0, m), par.shard_cache(v0, m)]
                  for m in meshes]
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        toks = [torch.tensor(first, device=dev) for _ in range(tp)]
        outs = [[] for _ in range(tp)]
        torch.cuda.synchronize()
        for k in col.launches:
            col.launches[k] = col.standalone[k] = 0
        sk.launches = sk.int8_launches = sk.int4_launches = 0
        for k in sk.kv8_launches:
            sk.kv8_launches[k] = 0
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
        i8 = sk.int8_launches + sk.int4_launches
        k8 = sum(sk.kv8_launches.values())
        FIGURES[f"{phase}_ms_per_step"] = dt * 1e3 / n
        FIGURES[f"{phase}_launches"] = k7
        FIGURES[f"{phase}_kv8_launches"] = k8
        alone13, alone14 = col.standalone["all_reduce"], \
            col.standalone["all_gather"]
        per_step = sk.last_step_kernels
        lb.check()
        same = all(torch.equal(a[1], b[1]) for o in outs[1:]
                   for a, b in zip(outs[0], o))
        tok_lists = [[int(t) for t, _ in o] for o in outs]
        finite = all(bool(torch.isfinite(lg).all()) for _, lg in outs[0])
        if stack_check:
            ref, gaps, bad = check_against_stack(p, cfg, k0, v0, pos0,
                                                 first, tok_lists[0], kcfg)
            held = dict(kernel7_tokens=ref[:8], agree=(
                f"{sum(a == b for a, b in zip(ref, tok_lists[0]))}/{n}"),
                disagree_where_gap_gt_0_1=bad,
                min_top2_gap=f"{min(gaps):.3g}")
        else:
            bad, held = [], dict(kernel7_tokens="not held (another function "
                                 "than the unsharded step; phase 34 holds "
                                 "its layers)")
        int8 = {} if phase == "fused_step" else {
            "bf16_ms_per_step_both_ranks": (
                f"{FIGURES['fused_step_ms_per_step']:.3f}"
                if "fused_step_ms_per_step" in FIGURES else "not measured")}
        if quant:
            int8[f"kernel7_{phase.rsplit('_', 1)[-1]}_launches"] = i8
        if kv is not None:
            int8.update(kv=kv, kernel7_kv8_launches=k8)
        say(phase, step="make_sharded_decode_step(fused_collectives"
            "=True)", tp=tp, loopback=True, prompt_tokens=pos0,
            new_tokens=n, ms_per_step_both_ranks=f"{dt * 1e3 / n:.3f}",
            kernel7_launches=k7, kernel13_reduces=k13, kernel14_gathers=k14,
            standalone_kernel13_14=f"{alone13}/{alone14}",
            per_step_per_rank=f"{k7 / n / tp:g}/{k13 / n / tp:g}/"
                              f"{k14 / n / tp:g}",
            kernels_per_rank_step=per_step,
            ranks_logits_bit_identical=same, tokens=tok_lists[0][:8],
            finite=finite, **held, **int8)
        if (k7 != n * tp or k13 != 2 * L * n * tp or k14 != n * tp or alone13
                or alone14 or per_step != 8 * L + 3 or not same or bad
                or not finite
                or any(t != tok_lists[0] for t in tok_lists)
                or (quant and i8 != n * tp)
                or k8 != (0 if kv is None else n * tp)):
            raise AssertionError("the fused-collective tp step: launches, "
                                 "rank agreement or kernel 7 agreement wrong")

        def pair():                 # one step of both ranks at the next row
            for r in range(tp):
                with torch.cuda.stream(streams[r]):
                    steps[r](shards[r], *caches[r], toks[r], pos0 + n)

        reps = 4
        ev, wall = profiling.profile_calls(pair, reps)
        one, _ = profiling.profile_calls(pair, 1, streams=True)
        lb.check()
    finally:
        lb.close()
    say_tp_profile(phase, ev, reps, wall, "fused", tp=tp,
                   loopback=True, pos=pos0 + n, per="pair_step_(both_ranks)")
    for line in profiling.timeline(one, len(one) - 8, 8):
        print(f"[{phase}_tail] {line}", flush=True)
    return k13, k14


def regroup_heads(name, w, hg_from, hg_to):
    """``wqkv_f`` [..., G, hidden, hg*C1] or ``wo_f`` [..., G, hg*R1,
    hidden], whose head groups hold ``hg_from`` kv heads, regrouped to
    ``hg_to`` (wqkv_f's columns and wo_f's rows are per kv head in head
    order either way; ``shard_params`` cuts the groups over tp, so G must
    divide by it); any other weight as it is."""
    if name == "wo_f":
        *lead, G, r, h = w.shape
        return w.reshape(*lead, G * hg_from // hg_to, r // hg_from * hg_to, h)
    if name != "wqkv_f":
        return w
    *lead, G, h, C = w.shape
    kv, c1, n = G * hg_from, C // hg_from, len(lead)
    per = w.reshape(*lead, G, h, hg_from, c1).movedim(n + 2, n + 1)
    per = per.reshape(*lead, kv // hg_to, hg_to, h, c1).movedim(n + 1, n + 2)
    return per.reshape(*lead, kv // hg_to, h, hg_to * c1)


def quant_stack_weights(lw, hg_from, hg_to, kind="int8"):
    """The four projections of a bf16 tree whose groups hold ``hg_from`` kv
    heads, regrouped to ``hg_to`` (the quantized engines' layout) and
    quantized (``kind``: int8 per output column, or int4 in groups of 128)
    one layer at a time, so that the float32 temporaries are one layer's (a
    stacked float32 copy of the 7B ``w13`` alone is 11.8 GB)."""
    from clusterfusion_tpu_torch.ops.quant import QuantizedTensor, quantize
    L = lw["wqkv_f"].shape[0]
    out = {}
    for name in ("wqkv_f", "wo_f", "w13", "w2"):
        q = s = None
        for l in range(L):
            t = quantize(regroup_heads(name, lw[name][l], hg_from, hg_to),
                         kind, -2)
            if q is None:
                q = torch.empty((L, *t.q.shape), dtype=torch.int8,
                                device=t.q.device)
                s = torch.empty((L, *t.s.shape), dtype=torch.float32,
                                device=t.s.device)
            q[l], s[l] = t.q, t.s
        out[name] = QuantizedTensor(q, s, kind, -2, t.group_size, -2)
    return out


INT8_PASSES = (("split", "attn_split_kernel"), ("gemv8", "ring_gemv8_kernel"),
               ("gemv", "ring_gemv_kernel"), ("norms", "resnorm_kernel"),
               ("merge", "attn_merge_kernel"))


def phase_int8_stack(eng, dev, hbm, peak, pos=600):
    """Phase 17: kernel 7's int8 mode at full Llama-2-7B width, the
    engine's seeded weights regrouped to the quantized layout (hg 8, G 4)
    and quantized layer by layer, pos 600 over a random cache with NaN
    above pos, with the bf16 and with the int8 LM head: against its plain
    twin at phase 4's limits, a repeat bit-identical; the CUDA-event time
    beside the bound and the bf16 step's time in this run (the bf16 weights
    at hg 4), the plain twin's time; then the device time by pass
    (``torch.profiler``: the int8 GEMVs with their TB/s, the bf16 LM
    head's GEMV, split, merge, norms).  Returns the kernels-line entry of
    the bf16-head case (the engine's), and the int8 weights and the two
    heads, which phase 19 reuses."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.ops.quant import quantize_int8
    cfg, p = eng.cfg, eng.params
    lw = p["layers"]
    g, hd, L = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.n_layers
    hg8 = model.default_head_group(cfg, "int8")
    w8 = quant_stack_weights(lw, model.default_head_group(cfg), hg8)
    heads = {"lm_bf16": p["lm_head"], "lm_int8": quantize_int8(p["lm_head"], -2)}
    gen = torch.Generator(device=dev).manual_seed(2)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    kc[:, :, pos + 1:] = float("nan")
    vc[:, :, pos + 1:] = float("nan")
    x = p["embed"][torch.tensor([7], device=dev)]
    cos, sin = model.rope_row(cfg, pos, dev)
    common = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                  eps=cfg.norm_eps, final_norm=p["final_norm"])
    args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, w8["wqkv_f"],
            w8["wo_f"], w8["w13"], w8["w2"])
    kk, vk = kc.clone(), vc.clone()
    bf16_step = functools.partial(
        sk.fused_decoder_stack, x, lw["attn_norm"], lw["ffn_norm"], cos, sin,
        lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kk, vk, pos,
        lm_head=p["lm_head"], **common)
    q_bytes = sum(w8[k].q.numel() + w8[k].s.numel() * 4 for k in w8)
    norm_bytes = 2 * (2 * L + 1) * cfg.hidden_dim
    kv_read = 2 * L * cfg.kv_heads * pos * hd * 2
    kv_write = 2 * L * cfg.kv_heads * hd * 2
    weights = sum(w8[k].q.numel() for k in w8) + p["lm_head"].numel()
    flops = 2 * weights + 4 * L * cfg.n_heads * (pos + 1) * hd
    rows = {}
    for label, head in heads.items():
        kw = dict(common, lm_head=head)
        kk.copy_(kc)
        vk.copy_(vc)
        kp, vp = kc.clone(), vc.clone()
        before = sk.int8_launches
        out = sk.fused_decoder_stack(*args, kk, vk, pos, **kw)
        ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos, **kw)
        lg_err, ok = stack_vs_plain(
            "stack_int8", out, ref, kk, vk, kp, vp, pos, kernel=7, head=label,
            hg=hg8, layers=L, kernels_per_step=sk.last_step_kernels,
            int8_launches=sk.int8_launches - before)
        k2, v2 = kc.clone(), vc.clone()
        again = sk.fused_decoder_stack(*args, k2, v2, pos, **kw)
        torch.cuda.synchronize()
        repeat = (torch.equal(again[0], out[0])
                  and _same_bits(again[1], out[1]) and _same_bits(k2, kk)
                  and _same_bits(v2, vk))
        say("stack_int8", head=label, repeat_bit_identical=repeat)
        if not (ok and repeat and sk.int8_launches - before == 2):
            raise AssertionError(f"kernel 7's int8 mode ({label}) disagrees "
                                 "with its plain twin or with itself")
        del kp, vp, k2, v2, again, ref
        step = functools.partial(sk.fused_decoder_stack, *args, kk, vk, pos,
                                 **kw)
        ms = time_ms(step, 20)
        bf16_ms = time_ms(bf16_step, 20)
        ms_again = time_ms(step, 20)
        plain_ms = time_ms(lambda: sk.fused_decoder_stack_plain(
            *args, kc, vc, pos, **kw), 3, warmup=1)
        lm_bytes = (head.q.numel() + head.s.numel() * 4 if label == "lm_int8"
                    else head.numel() * 2)
        nbytes = (q_bytes + norm_bytes + lm_bytes + kv_read + kv_write
                  + 4 * cfg.vocab_size + 2 * 2 * cfg.hidden_dim)
        bound = max(nbytes / hbm, flops / peak) * 1e3
        say("stack_int8", head=label, ms_per_step=f"{ms:.4f}",
            ms_per_step_again=f"{ms_again:.4f}",
            bf16_ms_per_step_same_run=f"{bf16_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
            bound_by="bytes" if nbytes / hbm >= flops / peak else "operations",
            bytes_per_step=nbytes, int8_weight_and_scale_bytes=q_bytes,
            lm_bytes=lm_bytes)
        busy, span, own, by, n = timeline_by_pass(step, INT8_PASSES)
        gemv_ms = by["gemv8"] + by["gemv"]
        gemv_bytes = q_bytes + lm_bytes
        say("stack_int8_device", head=label, busy_ms=f"{busy:.4f}",
            span_ms=f"{span:.4f}", kernels_own_sum_ms=f"{own:.4f}",
            **{f"{k}_ms": f"{v:.4f}" for k, v in by.items()},
            **{f"{k}_launches": f"{v:g}" for k, v in n.items()},
            gemv_TBps=f"{gemv_bytes / (gemv_ms * 1e-3) / 1e12:.3f}",
            gemv8_TBps=f"{(q_bytes + (lm_bytes if label == 'lm_int8' else 0)) / (by['gemv8'] * 1e-3) / 1e12:.3f}",
            note="each kernel charged from the end of those before it to "
                 "its own end")
        if label == "lm_bf16":
            # layer 1's eight kernels in launch order, int8 and bf16 steps
            for kind, fn in (("int8", step), ("bf16", bf16_step)):
                ev, _ = profiling.profile_calls(fn, 2)
                ch = profiling.charged(ev[:len(ev) // 2])[8:16]
                say("stack_int8_layer", step=kind, layer=1,
                    kernels=[(profiling.short_name(nm), round(sp - st, 1),
                              round(c, 1)) for st, sp, nm, c in ch],
                    note="(kernel, own us, charged us) in launch order: "
                         "resnorm, QKV, split, merge, O, resnorm, gate/up, "
                         "down")
        rows[label] = dict(max_abs_err=lg_err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound,
                           bound_by="bytes" if nbytes / hbm >= flops / peak
                           else "operations", library_ms=None)
    return rows["lm_bf16"], w8, heads


def phase_int8_e2e(dev):
    """Phase 18: ``Llama.synthetic(llama2_7b, quant="int8")`` (seed 0, hg 8,
    the four projections int8, the LM head bf16) streams 64 greedy tokens
    after a 512-token prompt through ``stream_generate``: prefill ms (warm),
    decode tokens/s, the launches of kernel 7's int8 mode and of kernel 4,
    no bf16 copy of a projection weight, and the first 8 tokens against
    the int8 plain path on the card under the top-2-gap rule.  Returns
    kernel 7's int8 launches and the engine (phases 20-22 run it)."""
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.ops.quant import QuantizedTensor
    t0 = time.perf_counter()
    eng = Llama.synthetic(LlamaConfig.llama2_7b(), seed=0, fused=True,
                          quant="int8", device=dev)
    torch.cuda.synchronize()
    cfg, lw = eng.cfg, eng.params["layers"]
    proj = [lw[k] for k in ("wqkv_f", "wo_f", "w13", "w2")]
    int8_only = all(isinstance(w, QuantizedTensor) and w.q.dtype == torch.int8
                    for w in proj)
    say("e2e_int8", init_seconds=f"{time.perf_counter() - t0:.1f}",
        head_group=cfg.kv_heads // lw["wqkv_f"].shape[1],
        projection_bytes=sum(w.q.numel() + 4 * w.s.numel() for w in proj),
        projections_int8=int8_only)
    if not int8_only:
        raise AssertionError("the int8 engine holds a bf16 projection")
    text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
    prompt = eng.tokenizer.encode(text, bos=True, eos=False)
    n_new = 64
    kc, vc = model.init_cache(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(eng.params, kc, vc, prompt, cfg)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    del kc, vc
    fp.launches = 0
    sk.launches = 0
    sk.int8_launches = 0
    stamps, toks = [], []
    for t in eng.stream_generate(prompt, n_new, temperature=0.0):
        stamps.append(time.perf_counter())
        toks.append(t)
    flash_launches, int8_launches = fp.launches, sk.int8_launches
    st = eng.stats
    decode_s = stamps[-1] - stamps[0]
    say("e2e_int8", prompt_tokens=len(prompt), new_tokens=len(toks),
        prefill_ms=f"{st.prefill_s * 1e3:.2f}",
        prefill_first_call_ms=f"{first_ms:.2f}",
        decode_tokens_per_s=f"{(len(toks) - 1) / decode_s:.2f}",
        decode_ms_per_step=f"{decode_s * 1e3 / (len(toks) - 1):.3f}",
        flash_prefill_launches=flash_launches,
        stack_int8_launches=int8_launches, stack_launches=sk.launches)
    if (flash_launches != cfg.n_layers or int8_launches < len(toks) - 1
            or sk.launches != int8_launches):
        raise AssertionError("the int8 path did not run kernel 4 and kernel "
                             "7's int8 mode")
    if len(toks) != n_new or not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"bad tokens {toks}")
    plain, gaps, bad = check_against_plain(eng, dev, prompt, toks)
    agree = sum(a == b for a, b in zip(plain, toks[:8]))
    say("e2e_int8", kernel_tokens=toks[:8], plain_tokens=plain,
        agree=f"{agree}/8", top2_gaps=[round(x, 3) for x in gaps],
        disagree_where_gap_gt_0_1=bad)
    if bad:
        raise AssertionError(f"the int8 kernel and plain paths disagree at "
                             f"steps {bad}")
    return int8_launches, eng


INT8_VERIFY_PASSES = (("gemv8", "gemv8_kernel"), ("gemv", "gemv_kernel"),
                      ("split", "attn_split_kernel"),
                      ("norms", "resnorm_kernel"),
                      ("merge", "verify_merge_kernel"))


def phase_int8_verify(eng, dev, hbm, peak, w8, heads, pos=600):
    """Phase 19: kernel 8's int8 mode at full Llama-2-7B width on phase 17's
    int8 weights (hg 8, G 4), pos 600 over a random cache with NaN at and
    above pos, at n 5 and 9, with the bf16 and the int8 LM head: against
    its plain twin at phase 9's limits (logits within 2e-2 of the largest,
    the appended rows at atol 0.05, deeper layers + 1 % of |row|, every
    other row unchanged bit for bit), a repeat bit-identical; its time
    (CUDA events) beside its byte bound, the bf16 kernel 8 on the engine's
    weights (hg 4) in this phase and the twin's; then its device time by
    pass (``torch.profiler``: the int8 GEMVs with their TB/s, the bf16 LM
    head's GEMV, split, merge, norms).  Returns the kernels-line entry of
    n 5 with the bf16 head (the engine's)."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    cfg, p = eng.cfg, eng.params
    lw = p["layers"]
    g, hd, L = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(19)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    kc[:, :, pos:] = float("nan")
    vc[:, :, pos:] = float("nan")
    common = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                  eps=cfg.norm_eps, final_norm=p["final_norm"])
    q_bytes = sum(w8[k].q.numel() + w8[k].s.numel() * 4 for k in w8)
    norm_bytes = 2 * (2 * L + 1) * cfg.hidden_dim
    weights = sum(w8[k].q.numel() for k in w8) + p["lm_head"].numel()
    kv_read = 2 * L * cfg.kv_heads * pos * hd * 2
    rows = {}
    for n in (5, 9):
        x = p["embed"][torch.arange(n, device=dev) * 37 + 11]
        cos, sin = model.rope_rows(cfg, pos, n, dev)
        args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, w8["wqkv_f"],
                w8["wo_f"], w8["w13"], w8["w2"])
        bf16_args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin,
                     lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"])
        new = slice(pos, pos + n)
        others = torch.ones(kc.shape[2], dtype=torch.bool, device=dev)
        others[new] = False
        kv_write = 2 * L * cfg.kv_heads * n * hd * 2
        io = n * cfg.hidden_dim * 2 * 2 + n * cfg.vocab_size * 4 + 2 * n * hd * 4
        flops = 2 * n * weights + \
            4 * L * cfg.n_heads * hd * (n * pos + n * (n + 1) // 2)
        kk, vk = kc.clone(), vc.clone()
        for label, head in heads.items():
            kw = dict(common, lm_head=head)
            kk.copy_(kc)
            vk.copy_(vc)
            kr, vr = kc.clone(), vc.clone()
            before = sv.int8_launches
            out = sv.fused_verify_stack(*args, kk, vk, pos, **kw)
            launched = sv.int8_launches - before
            ref = sv.fused_verify_stack_plain(*args, kr, vr, pos, **kw)
            torch.cuda.synchronize()
            lg_err = (out[0] - ref[0]).abs().max().item()
            lg_rel = lg_err / ref[0].abs().max().item()
            row_err = torch.maximum(
                (kk[:, :, new].float() - kr[:, :, new].float()).abs().amax(dim=(1, 2, 3)),
                (vk[:, :, new].float() - vr[:, :, new].float()).abs().amax(dim=(1, 2, 3)))
            row_mag = torch.maximum(
                kr[:, :, new].float().abs().amax(dim=(1, 2, 3)),
                vr[:, :, new].float().abs().amax(dim=(1, 2, 3)))
            rows_ok = bool(row_err[0] <= 0.05) and \
                bool((row_err <= 0.05 + 1e-2 * row_mag).all())
            unchanged = (_same_bits(kk[:, :, others], kc[:, :, others])
                         and _same_bits(vk[:, :, others], vc[:, :, others]))
            finite = bool(torch.isfinite(out[0]).all())
            k2, v2 = kc.clone(), vc.clone()
            again = sv.fused_verify_stack(*args, k2, v2, pos, **kw)
            torch.cuda.synchronize()
            repeat = (torch.equal(again[0], out[0]) and _same_bits(k2, kk)
                      and _same_bits(v2, vk))
            say("verify_int8", kernel=8, n=n, head=label, pos=pos, layers=L,
                hg=cfg.kv_heads // w8["wqkv_f"].shape[1],
                logits_max_abs_err=f"{lg_err:.4g}",
                logits_err_over_max=f"{lg_rel:.4g}", tol_logits=2e-2,
                kv_rows_err_layer0=f"{row_err[0].item():.3g}",
                tol_layer0=0.05, kv_rows_err_max=f"{row_err.max().item():.4g}",
                kv_rows_max_abs=f"{row_mag.max().item():.3g}",
                tol_rows="atol=0.05+rtol=1e-2", other_rows_unchanged=unchanged,
                nan_above_pos=True, finite=finite,
                repeat_bit_identical=repeat, int8_launches=launched,
                kernels_per_call=sv.last_step_kernels)
            if not (lg_rel <= 2e-2 and rows_ok and unchanged and finite
                    and repeat and launched == 1):
                raise AssertionError(f"kernel 8's int8 mode (n {n}, {label}) "
                                     "disagrees with its plain twin or with "
                                     "itself")
            del k2, v2, again, ref
            step = functools.partial(sv.fused_verify_stack, *args, kk, vk, pos,
                                     **kw)
            bf16_step = functools.partial(
                sv.fused_verify_stack, *bf16_args, kk, vk, pos,
                **dict(common, lm_head=p["lm_head"]))
            ms = time_ms(step, 10)
            bf16_ms = time_ms(bf16_step, 10)
            ms_again = time_ms(step, 10)
            plain_ms = time_ms(lambda: sv.fused_verify_stack_plain(
                *args, kr, vr, pos, **kw), 2, warmup=1)
            del kr, vr
            int8_head = label == "lm_int8"
            lm_bytes = (head.q.numel() + head.s.numel() * 4 if int8_head
                        else head.numel() * 2)
            nbytes = q_bytes + norm_bytes + lm_bytes + kv_read + kv_write + io
            bound = max(nbytes / hbm, flops / peak) * 1e3
            bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
            say("verify_int8", n=n, head=label, ms_per_call=f"{ms:.4f}",
                ms_per_call_again=f"{ms_again:.4f}",
                bf16_ms_per_call_same_phase=f"{bf16_ms:.4f}",
                plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
                bound_by=bound_by, bytes_per_call=nbytes,
                int8_weight_and_scale_bytes=q_bytes, lm_bytes=lm_bytes)
            busy, span, own, by, cnt = timeline_by_pass(step,
                                                        INT8_VERIFY_PASSES)
            gemv8_bytes = q_bytes + (lm_bytes if int8_head else 0)
            say("verify_int8_device", n=n, head=label, busy_ms=f"{busy:.4f}",
                span_ms=f"{span:.4f}", kernels_own_sum_ms=f"{own:.4f}",
                **{f"{k}_ms": f"{v:.4f}" for k, v in by.items()},
                **{f"{k}_launches": f"{v:g}" for k, v in cnt.items()},
                gemv8_TBps=f"{gemv8_bytes / (by['gemv8'] * 1e-3) / 1e12:.3f}",
                split_TBps=f"{kv_read / (by['split'] * 1e-3) / 1e12:.3f}",
                note="each kernel charged from the end of those before it to "
                     "its own end")
            rows[(n, label)] = dict(max_abs_err=lg_err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound,
                                    bound_by=bound_by, library_ms=None)
        del kk, vk
    return rows[(5, "lm_bf16")]


def quant_bytes(kind, ts):
    """(bytes the work needs, bytes the kernels read, weights) of quantized
    leaves: int8 codes and float32 scales; int4 codes two a byte with the
    scales as bf16 (as the TPU kernels stream them; ``quantize_int4``
    makes bf16 values), where the kernels read the float32 tensors."""
    codes = sum(t.q.numel() for t in ts)
    scales = sum(t.s.numel() for t in ts)
    if kind == "int8":
        return codes + 4 * scales, codes + 4 * scales, codes
    return codes + 2 * scales, codes + 4 * scales, 2 * codes


def phase_quant_paged_layer(engq, eng, dev, hbm, peak, kind):
    """Phases 21 (``kind`` "int8") and 30 (a) ("int4", the exact mode the
    TPU kernel always takes here): kernel 9's quantized mode alone on layer
    1 of the 7B quantized tree (hg 8, G 4) at B 4 (one request of 128 rows
    and the engine's padding rows), 8 (the serving lens up to 2047) and 1,
    NaN in every pool row no request owns: against its plain twin (atol
    2e-2 / rtol 2e-2; appended rows within 0.05, every other row
    bit-unchanged), a repeat bit-identical; its device time (``queued_ms``:
    the profiler, flaky on the card's torch late in a run, is spared here)
    beside its byte bound (``quant_bytes``), the bf16 kernel 9 on the same
    inputs (the bf16 engine's layer 1, hg 4) and the twin's.  Returns the
    kernels-line entry of B 4."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    cfg, lwq, lw = engq.cfg, engq.params["layers"], eng.params["layers"]
    g, hd, kv, hidden = (cfg.n_heads // cfg.kv_heads, cfg.head_dim_,
                         cfg.kv_heads, cfg.hidden_dim)
    cos_t, sin_t = model.rope_table(cfg, device=dev)
    seed = 21 if kind == "int8" else 30
    gen = torch.Generator(device=dev).manual_seed(seed)
    counter = f"llama_decoder_layer_paged_{kind}"
    layer, page = 1, 16
    rows = {}
    for B, lens_l in ((4, [128, 0, 0, 0]), (8, SERVE_LENS),
                      (1, SERVE_LENS[-1:])):
        kp, vp, table, lens = paged_pools(dev, 2, kv, hd, page, lens_l,
                                          seed + 1)
        x = torch.randn((B, hidden), generator=gen, device=dev).bfloat16()
        res = torch.randn((B, hidden), generator=gen, device=dev).bfloat16()
        if B == 4:
            table[1:] = 0
            x[2:], res[2:] = x[1], res[1]
        nan_unowned(kp, vp, table, lens)
        k0, v0 = kp.clone(), vp.clone()
        kr, vr = kp.clone(), vp.clone()
        k2, v2 = kp.clone(), vp.clone()
        args = (lwq["wqkv_f"], lwq["wo_f"], table, lens, lens)
        tail = (layer, lwq["attn_norm"][layer], cfg.norm_eps, cos_t, sin_t)
        kw = dict(group=g, rope_style=cfg.rope_style)
        before = pd.launches[counter]
        out = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, *tail, **kw)
        again = pd.llama_decoder_layer_paged(x, res, *args, k2, v2, *tail,
                                             **kw)
        ref = pd.llama_decoder_layer_paged_plain(x, res, *args, kr, vr, *tail,
                                                 **kw)
        torch.cuda.synchronize()
        launched = pd.launches[counter] - before
        repeat = (_same_bits(out[0], again[0]) and _same_bits(out[1], again[1])
                  and _same_bits(kp, k2) and _same_bits(vp, v2))
        finite = bool(torch.isfinite(out[0].float()).all())
        max_abs = max((out[i].float() - ref[i].float()).abs().max().item()
                      for i in (0, 1))
        for i in (0, 1):
            torch.testing.assert_close(out[i].float(), ref[i].float(),
                                       **LIMITS_TOL)
        app = append_mask(kp, table, lens, layer)
        row_err = max((kp[app].float() - kr[app].float()).abs().max().item(),
                      (vp[app].float() - vr[app].float()).abs().max().item())
        untouched = (_same_bits(kp[~app], k0[~app])
                     and _same_bits(vp[~app], v0[~app]))
        if not (repeat and finite and launched == 2 and row_err <= 0.05
                and untouched):
            raise AssertionError(f"kernel 9's {kind} mode (B {B}) disagrees "
                                 "with its twin or itself, or its pools")
        del k2, v2, again, k0, v0
        call = lambda: pd.llama_decoder_layer_paged(  # noqa: E731
            x, res, *args, kp, vp, *tail, **kw)
        bf16_call = lambda: pd.llama_decoder_layer_paged(  # noqa: E731
            x, res, lw["wqkv_f"], lw["wo_f"], table, lens, lens, kp, vp,
            layer, lw["attn_norm"][layer], cfg.norm_eps, cos_t, sin_t, **kw)
        call_ms = time_ms(call, 20)
        ms, bf16_ms = queued_ms(call), queued_ms(bf16_call)
        plain_ms = time_ms(lambda: pd.llama_decoder_layer_paged_plain(
            x, res, *args, kr, vr, *tail, **kw), 3, warmup=1)
        w_bytes, w_read, w_elems = quant_bytes(
            kind, [lwq["wqkv_f"][layer], lwq["wo_f"][layer]])
        n_rows = sum(lens_l)
        nbytes = w_bytes + 2 * (2 * n_rows * kv * hd + 4 * B * hidden + hidden
                                + 2 * B * kv * hd)
        flops = 2 * B * w_elems + 4 * kv * g * hd * (n_rows + B)
        bound = max(nbytes / hbm, flops / peak) * 1e3
        bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
        say(f"paged_layer_{kind}", kernel=9, B=B, lens=lens_l,
            hg=cfg.kv_heads // lwq["wqkv_f"].shape[1],
            max_abs_err=f"{max_abs:.3g}", tol="atol=2e-2,rtol=2e-2",
            appended_row_err=f"{row_err:.3g}", tol_rows=0.05,
            other_rows_unchanged=untouched, nan_unowned_rows=True,
            repeat_bit_identical=repeat, **{f"{kind}_launches": launched},
            queued_ms=f"{ms:.4f}", call_ms=f"{call_ms:.4f}",
            bf16_queued_ms_same_phase=f"{bf16_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
            bound_by=bound_by, weight_bytes=w_bytes, weight_bytes_read=w_read)
        rows[B] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=bound_by, library_ms=None)
        del kr, vr
    return rows[4]


# of the largest output: bf16 output rounding and the order of the sums
PRODUCT_REL_TOL = 1e-2


def phase_quant_products(engq, dev, hbm, peak, kind, layer=1):
    """Phases 23 (``kind`` "int8") and 30 (b) ("int4", exact): the quantized
    serving step's M=B products alone, through the serving step's own calls
    (``batched_qkv_dot``, ``batched_o_dot``, ``batched_ffn``, which launch
    ``_gemv_int8``/``_ffn_int8`` or ``_gemv_int4``/``_ffn_int4``) on layer
    1 of the 7B quantized tree: the QKV product (bf16 out), the O product
    (int8: each head group's partial scaled before the sum over the groups;
    int4: the group scales along its rows) and the SwiGLU FFN, at B 8
    (``max_batch``), 4 (``generate`` at B 4) and 1 (the fused step's FFN
    for one prompt).  Each against its plain twin within
    ``PRODUCT_REL_TOL`` of its largest output, finite, a repeat
    bit-identical, two launches of its wrapper, and no bf16 copy of a
    weight (the call allocates its outputs and scratch only); at B 8 the
    device ms (``queued_ms``) and the CUDA-event ms of a call beside the
    bound and the twin's.  Returns the kernels-line figures of
    the QKV and O wrapper (B 8) and of the FFN's (B 8)."""
    from clusterfusion_tpu_torch.runtime import serving
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    cfg, lw = engq.cfg, engq.params["layers"]
    wq, wo, w13, w2 = (lw[k][layer] for k in ("wqkv_f", "wo_f", "w13", "w2"))
    G, h, c = wq.shape
    co, f = wo.shape[1], w13.shape[-1]
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(23 if kind == "int8" else 32)
    bits = kind[-1]
    if kind == "int8":
        def qkv_plain(xn):
            return gemv._gemv_int8_plain(xn, wq.q, wq.s.reshape(G, c))

        def o_plain(o3):
            return gemv._gemv_int8_plain(o3.reshape(-1, G * co),
                                         wo.q.reshape(G * co, h),
                                         wo.s.reshape(G, h), co)

        def ffn_plain(xn):
            return gemv._ffn_int8_plain(xn, w13.q, w13.s.reshape(2, f), w2.q,
                                        w2.s.reshape(h))
    else:
        def qkv_plain(xn):
            return gemv._gemv_int4_plain(xn, wq.q, wq.s)

        def o_plain(o3):
            return gemv._gemv_int4_plain(o3.reshape(-1, G * co),
                                         wo.q.reshape(-1, h),
                                         wo.s.reshape(-1, h))

        def ffn_plain(xn):
            return gemv._ffn_int4_plain(xn, w13.q, w13.s, w2.q, w2.s)
    figures = {"gemv": {}, "ffn": {}}
    for B in (8, 4, 1):
        xn = torch.randn((B, h), generator=gen, device=dev).to(bf16)
        o3 = torch.randn((B, G, co), generator=gen, device=dev).to(bf16)
        cases = (
            ("qkv", "gemv", lambda: serving.batched_qkv_dot(xn, wq),
             lambda: qkv_plain(xn).to(bf16).reshape(B, G, c),
             quant_bytes(kind, [wq]), 2 * B * h + 2 * B * G * c,
             2 * B * G * h * c),
            ("o", "gemv", lambda: serving.batched_o_dot(o3, wo),
             lambda: o_plain(o3), quant_bytes(kind, [wo]),
             2 * B * G * co + 4 * B * h, 2 * B * G * co * h),
            ("ffn", "ffn", lambda: serving.batched_ffn(xn, w13, w2,
                                                       cfg.ffn_act),
             lambda: ffn_plain(xn), quant_bytes(kind, [w13, w2]),
             2 * B * h + 2 * B * h, 6 * B * h * f))
        for label, wrapper, call, plain, wbytes, io, flops in cases:
            count = f"ffn{bits}_launches" if wrapper == "ffn" else \
                f"int{bits}_launches"
            before = getattr(gemv, count)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            out = call()
            torch.cuda.synchronize()
            allocated = torch.cuda.max_memory_allocated(dev) - base
            again = call()
            ref = plain()
            torch.cuda.synchronize()
            launched = getattr(gemv, count) - before
            repeat = torch.equal(out, again)
            finite = bool(torch.isfinite(out.float()).all())
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            # a bf16 copy of the weights would allocate 2 bytes a weight
            weight_copy = allocated >= wbytes[2]
            say(f"{kind}_products", product=label,
                wrapper=f"_{wrapper}_{kind}", B=B, out_shape=list(out.shape),
                out_dtype=str(out.dtype), max_abs_err=f"{err:.4g}",
                err_over_max=f"{rel:.4g}", tol_over_max=PRODUCT_REL_TOL,
                finite=finite, repeat_bit_identical=repeat, launches=launched,
                bytes_allocated_by_call=allocated, bf16_weight_copy=weight_copy)
            if not (out.shape == ref.shape and rel <= PRODUCT_REL_TOL
                    and finite and repeat and launched == 2
                    and not weight_copy):
                raise AssertionError(f"the {kind} {label} product (B {B}) "
                                     "disagrees with its plain twin or "
                                     "itself, did not launch, or copied a "
                                     "weight")
            fig = figures[wrapper]
            fig["max_abs_err"] = max(fig.get("max_abs_err", 0.0), err)
            if B != 8:
                continue
            nbytes = wbytes[0] + io
            call_ms = time_ms(call, 20)
            ms = queued_ms(call)
            plain_ms = time_ms(plain, 3, warmup=1)
            bound = max(nbytes / hbm, flops / peak) * 1e3
            say(f"{kind}_products", product=label, B=B, queued_ms=f"{ms:.4f}",
                call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                bound_ms=f"{bound:.4f}",
                bound_by="bytes" if nbytes / hbm >= flops / peak
                else "operations",
                TBps=f"{(wbytes[1] + io) / (ms * 1e-3) / 1e12:.3f}")
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("bytes", nbytes), ("flops", flops)):
                fig[key] = fig.get(key, 0) + v
    rows = {}
    for wrapper, fig in figures.items():
        by_bytes = fig["bytes"] / hbm >= fig["flops"] / peak
        rows[wrapper] = dict(
            max_abs_err=fig["max_abs_err"], ms=fig["ms"],
            plain_ms=fig["plain_ms"],
            bound_ms=max(fig["bytes"] / hbm, fig["flops"] / peak) * 1e3,
            bound_by="bytes" if by_bytes else "operations", library_ms=None)
    return rows


def step_vs_plain(eng, dev, depth=None, impls=("batched", "fused"),
                  kv_dtype=torch.bfloat16):
    """One serving step of each kind at B 8 (``SERVE_LENS`` over shuffled
    pages, NaN in every pool row no request owns, a distinct random token a
    row; pools of ``kv_dtype``, an fp8 pool holding e4m3 of the same random
    rows) on the first ``depth`` layers of ``eng`` (all by default), against
    the same step with the plain twins in place of ``_gemv_int8``,
    ``_ffn_int8``, ``_gemv_int4``, ``_ffn_int4``, ``paged_attention`` and
    ``llama_decoder_layer_paged``,
    on copies of the same pools.  Returns, per step kind: the logits'
    largest error over the largest logit, the least difference between two
    requests' plain logits over the same, each layer's largest error and
    |row| over the appended K/V rows, whether every other pool row is
    bit-unchanged and whether the outputs are finite; on fp8 pools also
    ``codes0``, ``e4m3_one_step`` of layer 0's appended rows."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.ops.reference import fused_add_rmsnorm_ref
    serving = importlib.import_module("clusterfusion_tpu_torch.runtime.serving")
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    cfg, p = eng.cfg, eng.params
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
        p = dict(p, layers={k: w[:depth] for k, w in p["layers"].items()})
    L, kv, hd, page = cfg.n_layers, cfg.kv_heads, cfg.head_dim_, 16
    B = len(SERVE_LENS)
    _, _, table, lens = paged_pools(dev, 1, kv, hd, page, SERVE_LENS, 24)
    gen = torch.Generator(device=dev).manual_seed(24)
    shape = (L, int(table.max()) + 1, kv, page, hd)
    k0 = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    v0 = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    nan_unowned(k0, v0, table, lens)
    k0, v0 = k0.to(kv_dtype), v0.to(kv_dtype)
    tokens = torch.randperm(cfg.vocab_size, generator=gen, device=dev)[:B]
    # (page, row) of each request's appended row
    at = [(int(table[b, n // page]), n % page) for b, n in enumerate(SERVE_LENS)]

    def appended(pool):                       # [L, B, kv, hd] float32
        return torch.stack([pool[:, pg, :, r].float() for pg, r in at], 1)

    def appended_bytes(pool):                 # [L, B, kv, hd * itemsize]
        return torch.stack([pool[:, pg, :, r].contiguous().view(torch.uint8)
                            for pg, r in at], 1)

    temps, tops = [0.0] * B, [0.9] * B
    rope = model.rope_table(cfg, device=dev)

    def gemv_plain(x, q, s, *, kg=0, bf16_out=False):
        N = q.shape[-1]
        y = gemv._gemv_int8_plain(x, q.reshape(-1, q.shape[-2], N),
                                  s.reshape(-1, N), kg)
        return y.to(torch.bfloat16) if bf16_out else y

    def ffn_plain(x, w13_q, w13_s, w2_q, w2_s):
        return gemv._ffn_int8_plain(x, w13_q, w13_s.reshape(2, -1), w2_q,
                                    w2_s.reshape(-1))

    def gemv4_plain(x, q, s, *, kg=0, a8=False, bf16_out=False):
        y = gemv._gemv_int4_plain(x, q, s, kg, a8)
        return y.to(torch.bfloat16) if bf16_out else y

    def ffn4_plain(x, w13_q, w13_s, w2_q, w2_s):
        return gemv._ffn_int4_plain(x, w13_q, w13_s, w2_q, w2_s)

    plain_twins = dict(_gemv_int8=gemv_plain, _ffn_int8=ffn_plain,
                       _gemv_int4=gemv4_plain, _ffn_int4=ffn4_plain,
                       paged_attention=pd.paged_attention_plain,
                       llama_decoder_layer_paged=pd
                       .llama_decoder_layer_paged_plain)
    real_sample = serving._logits_and_sample
    got = []

    def capture(params, x, residual, *rest):
        xn, _ = fused_add_rmsnorm_ref(x, residual, params["final_norm"],
                                      cfg.norm_eps)
        got.append(model._lm_logits(xn, params["lm_head"]))
        return real_sample(params, x, residual, *rest)

    steps = dict(batched=serving._paged_decode_step_batched,
                 fused=serving._paged_decode_step)
    out = {}
    for impl in impls:
        pools = {}
        saved = {k: getattr(serving, k) for k in plain_twins}
        serving._logits_and_sample = capture
        try:
            for kind in ("kernel", "plain"):
                if kind == "plain":
                    for k, fn in plain_twins.items():
                        setattr(serving, k, fn)
                kp, vp = k0.clone(), v0.clone()
                steps[impl](p, kp, vp, tokens, lens, table, lens, None, temps,
                            tops, cfg, rope)
                pools[kind] = (kp, vp)
        finally:
            serving._logits_and_sample = real_sample
            for k, fn in saved.items():
                setattr(serving, k, fn)
        torch.cuda.synchronize()
        lk, lp = got[-2], got[-1]
        top = lp.abs().max().item()
        (kp, vp), (kr, vr) = pools["kernel"], pools["plain"]
        ak, av, rk, rv = (appended(t) for t in (kp, vp, kr, vr))
        dims = (1, 2, 3)
        row_err = torch.maximum((ak - rk).abs().amax(dim=dims),
                                (av - rv).abs().amax(dim=dims))
        row_mag = torch.maximum(rk.abs().amax(dim=dims),
                                rv.abs().amax(dim=dims))
        codes0 = (e4m3_one_step(appended_bytes(kp)[0], appended_bytes(kr)[0])
                  if kv_dtype == torch.float8_e4m3fn else None)
        if codes0 is not None:
            near_v, eq_v = e4m3_one_step(appended_bytes(vp)[0],
                                         appended_bytes(vr)[0])
            codes0 = (codes0[0] and near_v, min(codes0[1], eq_v))
        for pg, r in at:            # the appended rows back: all else as before
            kp[:, pg, :, r] = k0[:, pg, :, r]
            vp[:, pg, :, r] = v0[:, pg, :, r]
        out[impl] = dict(
            layers=L, logits_rel=(lk - lp).abs().max().item() / top,
            request_logits_rel=[(lk[b] - lp[b]).abs().max().item() / top
                                for b in range(B)],
            spread=min((lp[i] - lp[j]).abs().max().item() / top
                       for i in range(B) for j in range(i)),
            row_err=row_err.tolist(), row_mag=row_mag.tolist(),
            codes0=codes0,
            unchanged=_same_bytes(kp, k0) and _same_bytes(vp, v0),
            finite=bool(torch.isfinite(lk).all() and torch.isfinite(ak).all()
                        and torch.isfinite(av).all()))
        del pools, kp, vp, kr, vr
    return out


# the serving-step check's depth: the kernel step and the plain-twin step
# drift apart by a bf16 rounding a layer (about 0.005 of |row| added a
# layer, the bf16 engine's as much as the int8 one's), so phase 9's limits
# hold through 4 layers and the full depth is held against the bf16 drift
STEP_CHECK_DEPTH = 4


def int8_step_vs_plain(eng8, eng, dev):
    """``step_vs_plain`` on the first ``STEP_CHECK_DEPTH`` layers of the
    int8 engine, both step kinds: the logits within 2e-2 of the largest
    logit, the appended rows at phase 9's limits (layer 0 at atol 0.05,
    deeper layers at atol 0.05 + rtol 1e-2 of |row|), every other row
    bit-unchanged, and the requests' plain logits apart by more than the
    logits limit, so that a slot reading another slot's rows or scales
    could not pass.  Then all 32 layers of the int8 engine and of the bf16
    engine ``eng``: the int8 step's logits no further from its twin's than
    1.25 times the bf16 step's from its own."""
    for impl, r in step_vs_plain(eng8, dev, STEP_CHECK_DEPTH).items():
        err, mag = r["row_err"], r["row_mag"]
        rows_ok = err[0] <= 0.05 and all(e <= 0.05 + 1e-2 * m
                                         for e, m in zip(err, mag))
        say("serving_int8_step", step=impl, B=len(SERVE_LENS),
            layers=r["layers"], lens=SERVE_LENS,
            logits_err_over_max=f"{r['logits_rel']:.4g}", tol_logits=2e-2,
            by_request=[round(x, 4) for x in r["request_logits_rel"]],
            least_request_spread_over_max=f"{r['spread']:.4g}",
            kv_rows_err_layer0=f"{err[0]:.3g}", tol_layer0=0.05,
            kv_rows_err_by_layer=[round(x, 4) for x in err],
            kv_rows_max_abs=f"{max(mag):.3g}",
            tol_rows="atol=0.05+rtol=1e-2",
            other_rows_unchanged=r["unchanged"], nan_unowned_rows=True,
            finite=r["finite"])
        if not (r["logits_rel"] <= 2e-2 and rows_ok and r["unchanged"]
                and r["finite"]):
            raise AssertionError(f"the int8 {impl} serving step disagrees "
                                 "with the same step on the plain twins")
        if r["spread"] <= 2e-2:
            raise AssertionError("the requests' logits differ by less than "
                                 "the limit: the comparison cannot tell "
                                 "the slots apart")
    full8, full16 = step_vs_plain(eng8, dev), step_vs_plain(eng, dev)
    for impl, r in full8.items():
        b = full16[impl]
        say("serving_int8_step", step=impl, B=len(SERVE_LENS),
            layers=r["layers"],
            logits_err_over_max=f"{r['logits_rel']:.4g}",
            bf16_logits_err_over_max=f"{b['logits_rel']:.4g}",
            tol="1.25x the bf16 step's",
            kv_rows_err_max=f"{max(r['row_err']):.4g}",
            bf16_kv_rows_err_max=f"{max(b['row_err']):.4g}",
            least_request_spread_over_max=f"{r['spread']:.4g}",
            other_rows_unchanged=r["unchanged"], finite=r["finite"])
        if not (r["logits_rel"] <= 1.25 * b["logits_rel"] and r["unchanged"]
                and r["finite"] and b["unchanged"] and b["finite"]):
            raise AssertionError(f"the int8 {impl} serving step drifts "
                                 "from its twin more than the bf16 step")


def phase_int8_serving(eng8, eng, dev, bf16_figures):
    """Phase 22: int8 serving.  ``int8_step_vs_plain`` first; then phase
    8's B=8 mix (page 16; prompts of 32-512 tokens; 32 new tokens each) on
    the 7B int8 engine, once through
    the batched step (the M=B int8 products on the GEMVs' int8 instances,
    kernel 10) and once through the fused step (kernel 9's int8 mode, the
    int8 FFN): tokens/s and ms a step beside phase 8's bf16 figures, the
    launches, and batching invariance (each request run alone gives the
    tokens it gives in the batch, as JAX ``tests/test_runtime.py:174``
    holds); then ``Llama.generate`` at B 1 (the fused step) and B 4 (the
    batched one), each against the int8 plain path under the top-2-gap
    rule.  Returns the launches of the serving runs: kernel 9's int8 mode
    (fused step), ``_gemv_int8`` (batched) and ``_ffn_int8`` (both)."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.runtime import ServingEngine
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    int8_step_vs_plain(eng8, eng, dev)
    cfg = eng8.cfg
    text = "Serving many users at once on one card, page by page. " * 12
    prompts = [eng8.tokenizer.encode(text[:n - 1], bos=True, eos=False)
               for n in (32, 64, 128, 200, 256, 300, 400, 512)]
    n_new = 32

    def serve(batch, impl, timed=False):
        srv = ServingEngine(eng8.params, cfg, page_size=16, num_pages=136,
                            max_batch=8, step_impl=impl)
        step_s = []
        if timed:
            real_step = srv._step

            def timed_step(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real_step(*a)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                return out

            srv._step = timed_step
        for i in batch:
            srv.submit(i, prompts[i], n_new, temperature=0.0)
        return srv.run(), step_s

    launch = dict(layer=0, gemv=0, ffn=0)
    for impl in ("batched", "fused"):
        serve([0], impl)                                  # warm-up
        pd.launches.update(dict.fromkeys(pd.launches, 0))
        gemv.int8_launches = gemv.ffn8_launches = 0
        out, step_s = serve(range(len(prompts)), impl, timed=True)
        pa, k9 = (pd.launches["paged_attention"],
                  pd.launches["llama_decoder_layer_paged_int8"])
        products, ffns = gemv.int8_launches, gemv.ffn8_launches
        steps = len(step_s)
        decode_tokens = sum(len(t) for t in out.values()) - len(prompts)
        tps = decode_tokens / sum(step_s)
        say("serving_int8", step=impl, requests=len(prompts), new_tokens=n_new,
            decode_steps=steps, decode_tokens_per_s=f"{tps:.2f}",
            ms_per_step=f"{sum(step_s) * 1e3 / steps:.3f}",
            bf16_decode_tokens_per_s_phase8=f"{bf16_figures['tokens_per_s']:.2f}",
            bf16_ms_per_step_phase8=f"{bf16_figures['ms_per_step']:.3f}",
            paged_attention_launches=pa, layer_int8_launches=k9,
            gemv_int8_launches=products, ffn_int8_launches=ffns)
        L = cfg.n_layers
        ok = ffns == L * steps
        if impl == "batched":
            ok = ok and pa == L * steps and k9 == 0 and products == 2 * L * steps
            launch["gemv"] = products
        else:
            ok = ok and k9 == L * steps and pa == 0 and products == 0
            launch["layer"] = k9
        launch["ffn"] += ffns
        if not ok:
            raise AssertionError(f"the int8 {impl} step did not launch its "
                                 "kernels once per layer and step")
        if any(len(t) != n_new or not all(0 <= x < cfg.vocab_size for x in t)
               for t in out.values()):
            raise AssertionError(f"bad int8 serving output {out}")
        alone = {}
        for i in range(len(prompts)):
            alone.update(serve([i], impl)[0])
        differ = [i for i in out if out[i] != alone[i]]
        say("serving_int8", step=impl, batching_invariant=not differ,
            requests_that_differ_alone=differ, first_tokens=out[0][:8])
        if differ:
            raise AssertionError(f"int8 {impl} serving is not batching-"
                                 f"invariant: requests {differ}")
    for B in (1, 4):
        pd.launches.update(dict.fromkeys(pd.launches, 0))
        gemv.int8_launches = gemv.ffn8_launches = 0
        t0 = time.perf_counter()
        toks, _ = eng8.generate(prompts[2:2 + B], 16, temperature=0.0)
        gen_s = time.perf_counter() - t0
        k9, products = (pd.launches["llama_decoder_layer_paged_int8"],
                        gemv.int8_launches + gemv.ffn8_launches)
        plain, gaps, bad = check_against_plain(eng8, dev, prompts[2],
                                               toks[0], 8)
        say("generate_int8", B=B, step="fused" if B == 1 else "batched",
            tokens=toks[0][:8], plain_tokens=plain,
            top2_gaps=[round(x, 3) for x in gaps],
            disagree_where_gap_gt_0_1=bad, wall_s=f"{gen_s:.3f}",
            layer_int8_launches=k9, int8_product_launches=products)
        if bad or (k9 == 0) != (B > 1) or products == 0:
            raise AssertionError(f"int8 generate at B {B}: disagrees at {bad} "
                                 "or did not run its kernels")
    return launch


def queued_ms(fn, n: int = 20) -> float:
    """Device ms per call of ``fn``, its calls back to back: ``n`` calls
    queued behind a spin kernel between two CUDA events, the spin long
    enough that the host has queued them all before the first starts (the
    host's pace left out; checked, and the spin doubled until it holds).
    It needs neither the profiler nor a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2e9 * 2 * max(host_s, 1e-3))   # twice that at 2 GHz
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(stop) / n
        cycles *= 2
    raise AssertionError("queued_ms: the host did not queue the calls ahead "
                         "of the card")


def int8_head_tree(params):
    """``params`` (the int8 engine's tree, bf16 LM head) with its LM head
    quantized to int8 per output column (phase 17's int8 head)."""
    from clusterfusion_tpu_torch.ops.quant import quantize_int8
    return dict(params, lm_head=quantize_int8(params["lm_head"], -2))


def tp2_shard(params, cfg, rank=0):
    """Rank ``rank``'s ``shard_params`` slices of ``params`` at tp 2 (a mesh
    with no process group: only the slicing)."""
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.parallel.mesh import AXES
    mesh = par.Mesh(shape=dict(dict.fromkeys(AXES, 1), tp=2),
                    coords=dict(dict.fromkeys(AXES, 0), tp=rank),
                    groups=dict.fromkeys(AXES))
    return par.shard_params(params, cfg, mesh)


def phase_int8_layer(eng8, eng, dev, hbm, peak, pos=600, cap=4096, layer=1):
    """Phase 24: kernel 6's int8 mode, as phase 13 runs the bf16 mode, on
    layer 1 of the 7B int8 engine (hg 8, G 4), the whole tree and the
    first tp-2 shard's slices (16 kv heads, G 2, by ``shard_params``): full
    mode with the append at pos 600 of a 4096-row cache with large garbage
    at and above pos (the output, residual and appended rows against the
    int8 plain twin at phase 13's limits, every other row unchanged, a
    repeat bit-identical, one launch a call); partials mode on [0, 300) and
    [300, 600) merged against one partials call and, O-projected over the
    int8 codes and scales, against the full output.  Then, on the whole
    tree: device time (``queued_ms``; the profiler's busy time beside it)
    and call time beside the bf16 kernel 6 on the same inputs (the bf16
    engine's layer), the twin's time and the byte bound, the launch plans
    and the phase stamps of both.  Returns the kernel table's row."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    cfg = eng8.cfg
    g, hd, hidden = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.hidden_dim
    kvh = cfg.kv_heads
    gen = torch.Generator(device=dev).manual_seed(24)

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
    trees = {"whole": (eng8.params["layers"], kvh),
             "tp2_shard": (tp2_shard(eng8.params, cfg)["layers"], kvh // 2)}
    err = 0.0
    for label, (lw, heads) in trees.items():
        wq, wo = lw["wqkv_f"][layer], lw["wo_f"][layer]
        kcl = kc[:, :heads].contiguous()
        vcl = vc[:, :heads].contiguous()
        args = (x, res, norm, cos, sin, wq, wo)
        kk, vk = kcl.clone(), vcl.clone()
        kr, vr = kcl.clone(), vcl.clone()
        before = (dl.launches, dl.int8_launches)
        out = dl._fused_decoder_layer(*args, kk, vk, pos, 1, append_kv=True,
                                      **kw)
        kernels = dl.last_call_kernels
        launched = (dl.launches - before[0], dl.int8_launches - before[1])
        kk2, vk2 = kcl.clone(), vcl.clone()
        again = dl._fused_decoder_layer(*args, kk2, vk2, pos, 1,
                                        append_kv=True, **kw)
        ref = dl._fused_decoder_layer_plain(*args, kr, vr, pos, 1,
                                            append_kv=True, **kw)
        torch.cuda.synchronize()
        repeat = all(_same_bits(out[i], again[i]) for i in range(4)) and \
            _same_bits(kk, kk2) and _same_bits(vk, vk2)
        e = max((out[i].float() - ref[i].float()).abs().max().item()
                for i in (0, 1))
        if label == "whole":
            err = e
        for i in (0, 1):
            torch.testing.assert_close(out[i].float(), ref[i].float(),
                                       **LIMITS_TOL)
        row_err = max((a[1, :, pos].float() - b[1, :, pos].float()).abs()
                      .max().item() for a, b in ((kk, kr), (vk, vr)))
        new_err = max((out[i].float() - ref[i].float()).abs().max().item()
                      for i in (2, 3))
        others = torch.ones(cap, dtype=torch.bool, device=dev)
        others[pos] = False
        unchanged = (torch.equal(kk[:, :, others], kcl[:, :, others])
                     and torch.equal(vk[:, :, others], vcl[:, :, others])
                     and torch.equal(kk[0], kcl[0])
                     and torch.equal(vk[0], vcl[0]))
        say("layer_int8", kernel=6, tree=label, kv_heads=heads,
            head_groups=wq.shape[0], mode="full+append", pos=pos, cap=cap,
            max_abs_err=f"{e:.3g}", tol="atol=2e-2,rtol=2e-2",
            appended_row_err=f"{row_err:.3g}",
            k_new_v_new_err=f"{new_err:.3g}", tol_rows=0.05,
            other_rows_unchanged=unchanged, repeat_bit_identical=repeat,
            kernels_per_call=kernels, launches_int8=launched)
        if not (row_err <= 0.05 and new_err <= 0.05 and unchanged and repeat
                and kernels == 1 and launched == (1, 1)):
            raise AssertionError(f"kernel 6's int8 mode ({label}): appended "
                                 "rows disagree, other rows changed, a "
                                 "repeat differs or the launches are wrong")
        del kk2, vk2, again, kr, vr
        # partials: two shards merged in the log2 domain vs one shard
        pkw = dict(kw, emit_partials=True)
        halves = [(kcl[:, :, :300].contiguous(), vcl[:, :, :300].contiguous(),
                   300, 0), (kcl[:, :, 300:].contiguous(),
                             vcl[:, :, 300:].contiguous(), pos - 300, 1)]
        parts = [dl._fused_decoder_layer(*args, k, v, n, 1, fold_current=f,
                                         **pkw) for k, v, n, f in halves]
        whole = dl._fused_decoder_layer(*args, kcl, vcl, pos, 1,
                                        fold_current=1, **pkw)
        m = torch.stack([q[1][0] for q in parts])
        alpha = torch.exp2(m - m.amax(dim=0))
        l_g = sum(q[1][1] * a for q, a in zip(parts, alpha))
        acc_g = sum(q[0] * a[:, None] for q, a in zip(parts, alpha))
        o_merged = acc_g / l_g[:, None]
        o_whole = whole[0] / whole[1][1][:, None]
        merge_err = (o_merged - o_whole).abs().max().item()
        G = wo.shape[0]                  # each group's partial scaled, summed
        proj = (torch.einsum("Gc,Gco->Go",
                             o_merged.bfloat16().float().reshape(G, -1),
                             wo.q.float()) * wo.s[:, 0]).sum(dim=0)[None]
        proj_err = (proj - out[0].float()).abs().max().item()
        torch.cuda.synchronize()
        say("layer_int8", kernel=6, tree=label,
            mode="partials [0,300)+[300,600) merged",
            o_err_vs_one_shard=f"{merge_err:.3g}", tol_o=2e-2,
            oproj_err_vs_full=f"{proj_err:.3g}",
            tol_out="atol=2e-2,rtol=2e-2")
        torch.testing.assert_close(o_merged, o_whole, atol=2e-2, rtol=0)
        torch.testing.assert_close(proj, out[0].float(), **LIMITS_TOL)
        del parts, whole, halves
        if label != "whole":
            del kk, vk, kcl, vcl
            continue
        # times on the whole tree, beside the bf16 kernel 6 on the inputs
        lw16 = eng.params["layers"]
        args16 = (x, res, norm, cos, sin, lw16["wqkv_f"][layer],
                  lw16["wo_f"][layer])
        call = lambda: dl._fused_decoder_layer(  # noqa: E731
            *args, kk, vk, pos, 1, append_kv=True, **kw)
        call16 = lambda: dl._fused_decoder_layer(  # noqa: E731
            *args16, kk, vk, pos, 1, append_kv=True, **kw)
        ms, ms16 = queued_ms(call), queued_ms(call16)
        prof_ms, _ = busy_ms(call)
        prof16_ms, _ = busy_ms(call16)
        call_ms = time_ms(call, 50)
        call16_ms = time_ms(call16, 50)
        for kind, fn in (("int8", call), ("bf16", call16)):
            say("layer_int8_launch", kernel=6, weights=kind,
                **dl.launch_plan(hidden, kvh, g, hd, kind=kind),
                **launch_phases(dl, fn, 16 * kvh, K6_PHASES),
                note="phases from %globaltimer stamps inside the one launch")
        plain_ms = time_ms(lambda: dl._fused_decoder_layer_plain(
            *args, kk, vk, pos, 1, append_kv=True, **kw), 5)
        wbytes = _bytes(wq.q, wq.s, wo.q, wo.s)
        bound, bound_by, nbytes = _layer_bound(
            hbm, peak, wbytes, wq.q.numel() + wo.q.numel(), kvh, cfg.n_heads,
            pos, hd, 5 * hidden * 2 + 4 * kvh * hd * 2)
        say("layer_int8", kernel=6, ms=f"{ms:.4f}", queued_ms=f"{ms:.4f}",
            profiler_busy_ms=f"{prof_ms:.4f}", call_ms=f"{call_ms:.4f}",
            bf16_queued_ms_same_inputs=f"{ms16:.4f}",
            bf16_profiler_busy_ms=f"{prof16_ms:.4f}",
            bf16_call_ms=f"{call16_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by, bytes=nbytes,
            weight_and_scale_bytes=wbytes,
            rate_TBps=f"{nbytes / ms / 1e9:.3f}", library_ms="null")
        del kk, vk, kcl, vcl
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bound_by, library_ms=None)
    return row


def phase_int8_sharded(eng8, dev, tree8):
    """Phase 25: the int8 tp and sp steps end to end in a one-rank NCCL
    group, as phase 14 runs the bf16 ones: ``shard_params`` views of the
    int8 engine's tree (bf16 LM head) and of ``tree8`` (its int8 head), a
    512-token prefill, then 32 greedy steps of ``make_sharded_decode_step``
    and 8 of ``make_sp_sharded_decode_step``, each stream against kernel
    7's int8 step (teacher forced) and the int8 plain path under the
    top-2-gap rule; ms per step and tokens/s beside phase 14's bf16 steps;
    launches per step with the counts set to 0 just before (kernel 6 int8
    32; kernel 2 32 in the tp step, 0 in the sp step; ``_ffn_int8`` 32;
    ``_gemv_int8`` 32 O products in the sp step and one LM-head product
    where the head is int8); the peak of memory allocated during a step
    over what was allocated before it (a bf16 copy of one layer's FFN
    weights would be 185 MB); then each step's device busy time and the
    tp step's kernels by device time.  Returns kernel 6's int8 launches in
    the bf16-head run (both steps)."""
    import types

    import torch.distributed as dist
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import MeshConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    gm = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    rn = importlib.import_module("clusterfusion_tpu_torch.ops.rmsnorm")
    cfg = eng8.cfg
    L = cfg.n_layers
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    launched6 = None
    try:
        mesh = par.build_mesh(MeshConfig())
        text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
        prompt = eng8.tokenizer.encode(text, bos=True, eos=False)
        for head, full in (("bf16", eng8.params), ("int8", tree8)):
            params = par.shard_params(full, cfg, mesh)
            views = all(params["layers"][k] is full["layers"][k]
                        or params["layers"][k].q is full["layers"][k].q
                        for k in params["layers"])
            k0, v0 = model.init_cache(cfg, device=dev)
            fp.launches = 0
            lg, k0, v0 = model.prefill(full, k0, v0, prompt, cfg)
            first, flash, pos0 = int(torch.argmax(lg[-1])), fp.launches, \
                len(prompt)
            results = {}
            for name, n, make, spec in (
                    ("tp", 32, par.make_sharded_decode_step,
                     par.cache_pspec()),
                    ("sp", 8, par.make_sp_sharded_decode_step,
                     par.cache_pspec_2d())):
                step = make(cfg, mesh)
                kc = par.shard_cache(k0.clone(), mesh, spec)
                vc = par.shard_cache(v0.clone(), mesh, spec)
                tok = torch.tensor(first, device=dev)
                dl.launches = dl.int8_launches = 0
                gm.int8_launches = gm.ffn8_launches = 0
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
                got = dict(kernel6=dl.launches, kernel6_int8=dl.int8_launches,
                           kernel2=rn.launches["fused_add_rmsnorm"],
                           ffn_int8=gm.ffn8_launches,
                           gemv_int8=gm.int8_launches)
                want = dict(kernel6=L * n, kernel6_int8=L * n,
                            kernel2=L * n if name == "tp" else 0,
                            ffn_int8=L * n,
                            gemv_int8=(L * n if name == "sp" else 0)
                            + (n if head == "int8" else 0))
                # memory a step allocates beyond what it holds before
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                step(params, kc, vc, tok, pos0 + n)
                torch.cuda.synchronize()
                extra_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
                toks = [int(t) for t in out]
                finite = bool(torch.isfinite(lg).all())
                ref, gaps, bad = check_against_stack(full, cfg, k0, v0, pos0,
                                                     first, toks)
                say("sharded_int8", step=name, lm_head=head,
                    mesh="tp=1,sp=1 (one rank, nccl)", prompt_tokens=pos0,
                    new_tokens=n, params_are_views=views,
                    flash_prefill_launches=flash,
                    ms_per_step=f"{dt * 1e3 / n:.3f}",
                    tokens_per_s=f"{n / dt:.2f}",
                    bf16_ms_per_step=(
                        f"{FIGURES[f'sharded_{name}_ms_per_step']:.3f}"
                        if f"sharded_{name}_ms_per_step" in FIGURES
                        else "not measured"),
                    bf16_tokens_per_s=(
                        f"{FIGURES[f'sharded_{name}_tokens_per_s']:.2f}"
                        if f"sharded_{name}_tokens_per_s" in FIGURES
                        else "not measured"),
                    launches=got,
                    per_step={k: v / n for k, v in got.items()},
                    peak_extra_alloc_mb_per_step=f"{extra_mb:.2f}",
                    finite=finite, tokens=toks[:8], kernel7_tokens=ref[:8],
                    agree=f"{sum(a == b for a, b in zip(ref, toks))}/{n}",
                    disagree_where_gap_gt_0_1=bad,
                    min_top2_gap=f"{min(gaps):.3g}")
                if got != want or not finite or bad or flash != L \
                        or not views or extra_mb > 32:
                    raise AssertionError(
                        f"the int8 {name} step ({head} head): launches {got} "
                        f"(want {want}), tokens, kernel 7 agreement or "
                        f"{extra_mb:.1f} MB allocated a step wrong")
                plain, pgaps, pbad = check_against_plain(
                    types.SimpleNamespace(cfg=cfg, params=full), dev, prompt,
                    [first] + toks)
                say("sharded_int8", step=name, lm_head=head,
                    plain_tokens=plain, top2_gaps=[round(x, 3) for x in pgaps],
                    disagree_where_gap_gt_0_1=pbad)
                if pbad:
                    raise AssertionError(f"the int8 {name} step and the plain "
                                         f"path disagree at {pbad}")
                results[name] = (step, kc, vc)
                if head == "bf16":
                    launched6 = (launched6 or 0) + got["kernel6_int8"]
            busy = {}
            for name, (st_, kc_, vc_) in results.items():
                busy[name], _ = busy_ms(
                    lambda: st_(params, kc_, vc_, first, pos0))  # noqa: B023
            say("sharded_int8_busy", lm_head=head,
                tp_device_busy_ms_per_step=f"{busy['tp']:.4f}",
                sp_device_busy_ms_per_step=f"{busy['sp']:.4f}")
            if head == "bf16":
                step, kc, vc = results["tp"]
                dev_ms, prof_wall, top = profile_by_kernel(
                    lambda: step(params, kc, vc, first, pos0))
                say("sharded_int8_profile", step="tp", lm_head=head,
                    device_ms_per_step=f"{dev_ms:.4f}",
                    profiled_wall_ms_per_step=f"{prof_wall:.4f}",
                    device_busy_share_profiled=f"{dev_ms / prof_wall:.3f}")
                for kname, kms, cnt in top:
                    say("sharded_int8_profile", kernel=repr(kname),
                        ms_per_step=f"{kms:.4f}", launches_per_step=f"{cnt:g}")
            del results, k0, v0
    finally:
        dist.destroy_process_group()
    return launched6


def say_tp_profile(phase, ev, reps, wall, step, **where):
    """A tp step's device time by pass from ``reps`` profiled calls
    (``profiling.TP_STEP_PASSES``: kernel 7's GEMVs, split, merge, norms,
    the norms that wait for a reduce, and its tail, the LM head's pushing
    product and the gather's wait; kernels 13 and 14 standalone, kernels 6
    and 2): per call, the ms charged to each pass's kernels (each from the
    end of those before it: kernels launched with programmatic dependent
    launch overlap, so the charges add up to the busy time), their own ms
    and their launches.  Returns (busy ms per call, the rows)."""
    busy = profiling.busy_ms(ev) / reps
    rows = {k: v for k, v in profiling.breakdown(
        ev, reps, profiling.TP_STEP_PASSES).items() if v[2]}
    say(phase, step=step, **where, device_busy_ms_per_step=f"{busy:.4f}",
        profiled_wall_ms_per_step=f"{wall:.4f}",
        note="charged: each kernel from the end of those before it")
    for k, (c, own, cnt) in rows.items():
        say(phase, step=step, part=k, charged_ms_per_step=f"{c:.4f}",
            own_ms_per_step=f"{own:.4f}", launches_per_step=f"{cnt:g}",
            charged_us_per_launch=f"{c / cnt * 1e3:.2f}")
    return busy, rows


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


# -- int4 weights (phases 27-31) ---------------------------------------------

INT4_MODES = (("w4a8", True), ("exact", False))
INT4_CHECK_DEPTHS = (1, 4)
INT4_PASSES = (("split", "attn_split_kernel"), ("gemv4", "ring_gemv4_kernel"),
               ("gemv8", "ring_gemv8_kernel"), ("gemv", "ring_gemv_kernel"),
               ("norms", "resnorm_kernel"), ("merge", "attn_merge_kernel"))
INT4_VERIFY_PASSES = (("gemv4", "gemv4_kernel"), ("gemv", "gemv_kernel"),
                      ("split", "attn_split_kernel"),
                      ("norms", "resnorm_kernel"),
                      ("merge", "verify_merge_kernel"))


def stack_plain_step(a8):
    """The decode step's plain twin (kernel 7's ``fused_decoder_stack_plain``
    with the final norm and the LM head; int4 weights in one mode), for
    ``check_against_plain``: W4A8 is another function than the eager path's
    dequantized one, and an 8-bit cache's eager step attends its own row
    quantized, where kernel 7 folds it in float32."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk

    def step(params, kc, vc, token, pos, cfg):
        cos, sin = model.rope_row(cfg, pos, kc.device)
        tok = torch.as_tensor(token, device=kc.device).reshape(1)
        lw = params["layers"]
        logits, _, kc, vc = sk.fused_decoder_stack_plain(
            params["embed"][tok], lw["attn_norm"], lw["ffn_norm"], cos, sin,
            lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kc, vc, pos,
            group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
            rope_style=cfg.rope_style, eps=cfg.norm_eps,
            final_norm=params["final_norm"], lm_head=params["lm_head"],
            int4_w4a8=a8)
        return logits[0], kc, vc

    return step


def hold_by_layer(fn, plain, args, kc, vc, pos, rows, layers, kcfg, kw,
                  phase, rows_rtol=0.0, **where):
    """Kernel 7 or 8 (``fn``) held layer by layer, teacher-forced:
    layer l of the kernel and of its plain twin from one input, the
    kernel's own state after its layer l - 1 (x_out + residual_out, each
    layer run alone from the last one's), at phase 4's limits for layer l:
    logits within 2e-2 of the largest, the ``rows`` appended K/V rows at
    atol 0.05 (layer 0) or 0.05 + 1e-2 of |row|, every other row
    unchanged, finite.  Free-running, W4A8 and its twin part layer by
    layer far beyond bf16 drift: a bf16 rounding the two take apart moves
    an activation across a step of its int8 quantization (absmax/127),
    which moves the next layer's input.  An 8-bit cache (phases 35-36):
    the rows' values (int8 dequantized), ``rows_rtol`` of |row| more (one
    step of the 8-bit format).  The twin runs W4A8 where ``kcfg`` does
    (``int4_w4a8``; it changes nothing for bf16 and int8 weights): bf16,
    int8 and exact int4 steps are held the same way (phase 47 holds its
    32-layer Mistral-7B steps so, as their free-running drift reaches
    phase 4's limits without a window too).  Prints one line; returns (the
    largest logits max abs error, ok)."""
    a8 = kcfg.int4_w4a8
    x, norms, rope, proj = args[0], args[1:3], args[3:5], args[5:]
    bare = {k: v for k, v in kw.items() if k not in ("final_norm", "lm_head")}
    new = slice(pos, pos + rows)
    others = torch.ones(kv_positions(kc), dtype=torch.bool, device=x.device)
    others[new] = False
    lg_err, rels, errs, ok = 0.0, [], [], True
    for l in range(layers):
        one = (*(t[l:l + 1] for t in norms), *rope,
               *(t[l:l + 1] for t in proj))
        kk, vk = kv_take(kc, l, l + 1), kv_take(vc, l, l + 1)
        kp, vp = kv_take(kk, 0, 1), kv_take(vk, 0, 1)
        out = fn(x, *one, kk, vk, pos, kcfg=kcfg, **kw)
        ref = plain(x, *one, kp, vp, pos, int4_w4a8=a8, **kw)
        err = (out[0] - ref[0]).abs().max().item()
        rel = err / ref[0].abs().max().item()
        row = max((kv_values(a, new) - kv_values(b, new)).abs().max().item()
                  for a, b in ((kk, kp), (vk, vp)))
        mag = max(kv_values(b, new).abs().max().item() for b in (kp, vp))
        ok = (ok and rel <= 2e-2
              and row <= 0.05 + ((l > 0) * 1e-2 + rows_rtol) * mag
              and kv_same_bits(kk, kp, others)
              and kv_same_bits(vk, vp, others)
              and bool(torch.isfinite(out[0]).all()))
        lg_err = max(lg_err, err)
        rels.append(round(rel, 4))
        errs.append(round(row, 4))
        if l + 1 < layers:
            h, r, _, _ = fn(x, *one, kv_take(kc, l, l + 1),
                            kv_take(vc, l, l + 1), pos, kcfg=kcfg, **bare)
            x = (h.float() + r.float()).bfloat16()
    kind = getattr(proj[0], "kind", "bf16")
    say(phase, **where,
        mode=("w4a8" if a8 else "exact") if kind == "int4" else kind,
        held="layer by layer, teacher-forced",
        layers=layers, pos=pos, logits_err_over_max_by_layer=rels,
        logits_err_over_max_worst=max(rels), tol_logits=2e-2,
        kv_rows_err_by_layer=errs, kv_rows_err_worst=max(errs),
        tol_rows="layer 0 atol=0.05, deeper atol=0.05+rtol=1e-2"
                 + (f", and rtol={rows_rtol:.4g} of the 8-bit step"
                    if rows_rtol else ""),
        within=ok)
    return lg_err, ok


def int4_engine(dev):
    """``Llama.synthetic(llama2_7b, quant="int4")``: seed 0, hg 8, the four
    projections int4 in groups of 128, the LM head bf16."""
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.generation import Llama
    t0 = time.perf_counter()
    eng = Llama.synthetic(LlamaConfig.llama2_7b(), seed=0, fused=True,
                          quant="int4", device=dev)
    torch.cuda.synchronize()
    lw = eng.params["layers"]
    proj = [lw[k] for k in ("wqkv_f", "wo_f", "w13", "w2")]
    int4_only = all(getattr(w, "kind", None) == "int4" and w.group_size == 128
                    and w.q.dtype == torch.int8 for w in proj)
    say("e2e_int4", init_seconds=f"{time.perf_counter() - t0:.1f}",
        head_group=eng.cfg.kv_heads // lw["wqkv_f"].shape[1],
        projection_bytes_bf16_scales=quant_bytes("int4", proj)[0],
        projection_bytes_f32_scales=quant_bytes("int4", proj)[1],
        projections_int4=int4_only)
    if not int4_only:
        raise AssertionError("the int4 engine holds a projection that is not "
                             "int4 in groups of 128")
    return eng


def phase_int4_stack(eng4, eng, eng8, dev, hbm, peak, pos=600):
    """Phase 27: kernel 7's int4 modes (W4A8, the default, and exact) at
    full Llama-2-7B width on the int4 engine's weights (hg 8, G 4), pos 600
    over a random cache with NaN above pos, with the bf16 and with the int8
    LM head: against the int4 plain twin in the same mode at phase 4's
    limits (exact: the first 1, 4 and 32 layers; W4A8: each layer,
    teacher-forced, ``hold_by_layer``; the int8 head: one layer), a
    repeat bit-identical, the int8 step's launches; the
    CUDA-event ms beside the bf16 step (the bf16 engine's weights, hg 4)
    and the int8 step (the int8 engine's, hg 8) of this run, the bound
    (codes and bf16 scales; the float32 scale bytes the kernel reads
    beside it) and the twin's ms; then the device time by pass.  Returns
    the kernels-line entries of both modes (bf16 head)."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.ops.quant import quantize_int8
    cfg, p = eng4.cfg, eng4.params
    w4, lw, lw8 = p["layers"], eng.params["layers"], eng8.params["layers"]
    g, hd, L = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.n_layers
    heads = {"lm_bf16": p["lm_head"], "lm_int8": quantize_int8(p["lm_head"], -2)}
    gen = torch.Generator(device=dev).manual_seed(27)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    kc[:, :, pos + 1:] = float("nan")
    vc[:, :, pos + 1:] = float("nan")
    x = p["embed"][torch.tensor([7], device=dev)]
    cos, sin = model.rope_row(cfg, pos, dev)
    common = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                  eps=cfg.norm_eps, final_norm=p["final_norm"])
    proj = [w4[k] for k in ("wqkv_f", "wo_f", "w13", "w2")]
    args = (x, w4["attn_norm"], w4["ffn_norm"], cos, sin, *proj)
    kk, vk = kc.clone(), vc.clone()
    other = {kind: functools.partial(
        sk.fused_decoder_stack, x, tree["attn_norm"], tree["ffn_norm"], cos,
        sin, tree["wqkv_f"], tree["wo_f"], tree["w13"], tree["w2"], kk, vk,
        pos, lm_head=p["lm_head"], **common)
        for kind, tree in (("bf16", lw), ("int8", lw8))}
    q_bytes, q_bytes_f32, _ = quant_bytes("int4", proj)
    norm_bytes = 2 * (2 * L + 1) * cfg.hidden_dim
    kv_read = 2 * L * cfg.kv_heads * pos * hd * 2
    kv_write = 2 * L * cfg.kv_heads * hd * 2
    weights = 2 * sum(t.q.numel() for t in proj) + p["lm_head"].numel()
    flops = 2 * weights + 4 * L * cfg.n_heads * (pos + 1) * hd
    hg = cfg.kv_heads // w4["wqkv_f"].shape[1]
    keep = torch.ones(kc.shape[2], dtype=torch.bool, device=dev)
    keep[pos] = False
    rows = {}
    for mode, a8 in INT4_MODES:
        kcfg = KernelConfig(int4_w4a8=a8)
        for label, head in heads.items():
            kw = dict(common, lm_head=head)
            # the int8 head is no int4 code: one layer is enough for it
            depths = (1,) if label == "lm_int8" else (*INT4_CHECK_DEPTHS, L)
            if a8:
                lg_err, ok = hold_by_layer(
                    sk.fused_decoder_stack, sk.fused_decoder_stack_plain,
                    args, kc, vc, pos, 1, depths[-1], kcfg, kw, "stack_int4",
                    kernel=7, head=label, hg=hg)
                if not ok:
                    raise AssertionError(
                        f"kernel 7's W4A8 mode ({label}) disagrees with its "
                        "plain twin at a layer")
            for depth in depths:
                dargs = (x, *(t[:depth] for t in args[1:3]), cos, sin,
                         *(t[:depth] for t in proj))
                kd, vd = kc[:depth].clone(), vc[:depth].clone()
                k2, v2 = kd.clone(), vd.clone()
                before = sk.int4_launches
                out = sk.fused_decoder_stack(*dargs, kd, vd, pos, kcfg=kcfg,
                                             **kw)
                n_kernels = sk.last_step_kernels
                ok = bool(torch.isfinite(out[0]).all()) and all(
                    _same_bits(a[:, :, keep], b[:depth, :, keep])
                    for a, b in ((kd, kc), (vd, vc)))
                if not a8:      # W4A8: layer by layer above
                    kp, vp = kc[:depth].clone(), vc[:depth].clone()
                    ref = sk.fused_decoder_stack_plain(
                        *dargs, kp, vp, pos, int4_w4a8=False, **kw)
                    lg_err, ok = stack_vs_plain(
                        "stack_int4", out, ref, kd, vd, kp, vp, pos, kernel=7,
                        mode=mode, head=label, hg=hg, layers=depth,
                        kernels_per_step=n_kernels)
                    del kp, vp, ref
                again = sk.fused_decoder_stack(*dargs, k2, v2, pos, kcfg=kcfg,
                                               **kw)
                torch.cuda.synchronize()
                launched = sk.int4_launches - before
                repeat = (torch.equal(again[0], out[0])
                          and _same_bits(again[1], out[1])
                          and _same_bits(k2, kd) and _same_bits(v2, vd))
                say("stack_int4", mode=mode, head=label, layers=depth,
                    repeat_bit_identical=repeat, int4_launches=launched,
                    kernels_per_step=n_kernels)
                if not (ok and repeat and launched == 2
                        and n_kernels == 8 * depth + 2):
                    raise AssertionError(
                        f"kernel 7's int4 mode ({mode}, {label}, {depth} "
                        "layers) disagrees with its plain twin or with "
                        "itself, or launched otherwise")
                del k2, v2, again, kd, vd
            kk.copy_(kc)
            vk.copy_(vc)
            step = functools.partial(sk.fused_decoder_stack, *args, kk, vk,
                                     pos, kcfg=kcfg, **kw)
            step()
            n_kernels = sk.last_step_kernels
            other["int8"]()
            if sk.last_step_kernels != n_kernels:
                raise AssertionError("kernel 7's int4 and int8 steps launch "
                                     "other counts")
            ms = time_ms(step, 20)
            bf16_ms = time_ms(other["bf16"], 20)
            int8_ms = time_ms(other["int8"], 20)
            ms_again = time_ms(step, 20)
            lm_bytes = (head.q.numel() + head.s.numel() * 4
                        if label == "lm_int8" else head.numel() * 2)
            io = 4 * cfg.vocab_size + 2 * 2 * cfg.hidden_dim
            nbytes = (q_bytes + norm_bytes + lm_bytes + kv_read + kv_write
                      + io)
            read = nbytes - q_bytes + q_bytes_f32
            bound = max(nbytes / hbm, flops / peak) * 1e3
            bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
            plain_ms = None
            if label == "lm_bf16":
                plain_ms = time_ms(lambda: sk.fused_decoder_stack_plain(
                    *args, kc.clone(), vc.clone(), pos, int4_w4a8=a8, **kw),
                    1, warmup=0)
            say("stack_int4", mode=mode, head=label, ms_per_step=f"{ms:.4f}",
                ms_per_step_again=f"{ms_again:.4f}",
                bf16_ms_per_step_same_run=f"{bf16_ms:.4f}",
                int8_ms_per_step_same_run=f"{int8_ms:.4f}",
                plain_ms="not timed" if plain_ms is None else f"{plain_ms:.4f}",
                bound_ms=f"{bound:.4f}", bound_by=bound_by,
                bytes_per_step=nbytes, int4_codes_bf16_scale_bytes=q_bytes,
                int4_codes_f32_scale_bytes_read=q_bytes_f32,
                bound_ms_at_f32_scale_bytes=f"{read / hbm * 1e3:.4f}",
                lm_bytes=lm_bytes)
            if label == "lm_bf16":
                rows[mode] = dict(max_abs_err=lg_err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound, bound_by=bound_by,
                                  library_ms=None)
            if label != "lm_bf16" or not a8:    # the profiler, once a phase
                continue
            busy, span, own, by, n = timeline_by_pass(step, INT4_PASSES)
            say("stack_int4_device", mode=mode, head=label,
                busy_ms=f"{busy:.4f}", span_ms=f"{span:.4f}",
                kernels_own_sum_ms=f"{own:.4f}",
                **{f"{k}_ms": f"{v:.4f}" for k, v in by.items()},
                **{f"{k}_launches": f"{v:g}" for k, v in n.items()},
                gemv4_TBps=f"{q_bytes_f32 / (by['gemv4'] * 1e-3) / 1e12:.3f}",
                note="each kernel charged from the end of those before it "
                     "to its own end; gemv4_TBps over the codes and the "
                     "float32 scales it reads")
    return rows


def phase_int4_e2e(eng4, dev):
    """Phase 28: the int4 engine streams 64 greedy tokens after a 512-token
    prompt through ``stream_generate`` in W4A8 (kernel 7's default int4
    mode): prefill ms (warm), decode tokens/s, the launches of kernel 7's
    int4 mode and of kernel 4, the first 8 tokens against the int4 plain
    path under the top-2-gap rule; then 16 tokens in the exact mode the
    same way.  Returns kernel 7's int4 launches of each mode's stream."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    cfg = eng4.cfg
    text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
    prompt = eng4.tokenizer.encode(text, bos=True, eos=False)
    kc, vc = model.init_cache(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(eng4.params, kc, vc, prompt, cfg)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    del kc, vc
    launches = {}
    for mode, a8, n_new in (("w4a8", True, 64), ("exact", False, 16)):
        eng = Llama(eng4.params, cfg, eng4.tokenizer, fused=True,
                    kcfg=KernelConfig(int4_w4a8=a8))
        fp.launches = sk.launches = sk.int4_launches = 0
        stamps, toks = [], []
        for t in eng.stream_generate(prompt, n_new, temperature=0.0):
            stamps.append(time.perf_counter())
            toks.append(t)
        flash_launches, int4 = fp.launches, sk.int4_launches
        st = eng.stats
        decode_s = stamps[-1] - stamps[0]
        say("e2e_int4", mode=mode, prompt_tokens=len(prompt),
            new_tokens=len(toks), prefill_ms=f"{st.prefill_s * 1e3:.2f}",
            prefill_first_call_ms=f"{first_ms:.2f}",
            decode_tokens_per_s=f"{(len(toks) - 1) / decode_s:.2f}",
            decode_ms_per_step=f"{decode_s * 1e3 / (len(toks) - 1):.3f}",
            flash_prefill_launches=flash_launches,
            stack_int4_launches=int4, stack_launches=sk.launches)
        if (flash_launches != cfg.n_layers or int4 < len(toks) - 1
                or sk.launches != int4):
            raise AssertionError(f"the int4 path ({mode}) did not run kernel "
                                 "4 and kernel 7's int4 mode")
        if len(toks) != n_new or not all(0 <= t < cfg.vocab_size
                                         for t in toks):
            raise AssertionError(f"bad tokens {toks}")
        plain, gaps, bad = check_against_plain(eng, dev, prompt, toks,
                                               step=stack_plain_step(a8))
        say("e2e_int4", mode=mode, kernel_tokens=toks[:8], plain_tokens=plain,
            agree=f"{sum(a == b for a, b in zip(plain, toks[:8]))}/8",
            top2_gaps=[round(x, 3) for x in gaps],
            disagree_where_gap_gt_0_1=bad,
            note="plain path: the eager prefill, then kernel 7's int4 twin "
                 "in the same mode")
        if bad:
            raise AssertionError(f"the int4 kernel ({mode}) and plain paths "
                                 f"disagree at steps {bad}")
        launches[mode] = int4
    return launches


def phase_int4_verify(eng4, eng, dev, hbm, peak, pos=600):
    """Phase 29: kernel 8's int4 modes at full Llama-2-7B width on the int4
    engine's weights, pos 600 over a random cache with NaN at and above
    pos, at n 5 and 9, bf16 LM head: against the int4 plain twin at phase
    9's limits (logits within 2e-2 of the largest, the appended rows at
    atol 0.05, deeper layers + 1 % of |row|, every other row unchanged;
    exact: the first 1, 4 and 32 layers; W4A8: each layer, teacher-forced,
    ``hold_by_layer``), a repeat bit-identical at 1, 4 and 32 layers; the
    CUDA-event ms beside the bound, the bf16 kernel 8 on the bf16 engine's
    weights in this phase and the twin's;
    the device time by pass.  Then ``spec_generate`` on the int4 engine
    (phase 9's run: a self-draft and an unrelated small draft), and a
    self-draft run in the exact mode.  Returns the kernels-line entries of
    n 5 in both modes and the verify launches of the two self-draft runs."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    cfg, p, lw = eng4.cfg, eng4.params, eng.params["layers"]
    w4 = p["layers"]
    g, hd, L = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(29)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    kc[:, :, pos:] = float("nan")
    vc[:, :, pos:] = float("nan")
    common = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                  eps=cfg.norm_eps, final_norm=p["final_norm"],
                  lm_head=p["lm_head"])
    proj = [w4[k] for k in ("wqkv_f", "wo_f", "w13", "w2")]
    q_bytes, q_bytes_f32, _ = quant_bytes("int4", proj)
    norm_bytes = 2 * (2 * L + 1) * cfg.hidden_dim
    weights = 2 * sum(t.q.numel() for t in proj) + p["lm_head"].numel()
    kv_read = 2 * L * cfg.kv_heads * pos * hd * 2
    lm_bytes = p["lm_head"].numel() * 2
    rows = {}
    for n in (5, 9):
        x = p["embed"][torch.arange(n, device=dev) * 37 + 11]
        cos, sin = model.rope_rows(cfg, pos, n, dev)
        args = (x, w4["attn_norm"], w4["ffn_norm"], cos, sin, *proj)
        new = slice(pos, pos + n)
        others = torch.ones(kc.shape[2], dtype=torch.bool, device=dev)
        others[new] = False
        kv_write = 2 * L * cfg.kv_heads * n * hd * 2
        io = n * cfg.hidden_dim * 2 * 2 + n * cfg.vocab_size * 4 + 2 * n * hd * 4
        flops = 2 * n * weights + \
            4 * L * cfg.n_heads * hd * (n * pos + n * (n + 1) // 2)
        kk, vk = kc.clone(), vc.clone()
        for mode, a8 in INT4_MODES:
            kcfg = KernelConfig(int4_w4a8=a8)
            if a8:
                lg_err, ok = hold_by_layer(
                    sv.fused_verify_stack, sv.fused_verify_stack_plain, args,
                    kc, vc, pos, n, L, kcfg, common, "verify_int4", kernel=8,
                    n=n)
                if not ok:
                    raise AssertionError(
                        f"kernel 8's W4A8 mode (n {n}) disagrees with its "
                        "plain twin at a layer")
            for depth in (*INT4_CHECK_DEPTHS, L):
                dargs = (x, *(t[:depth] for t in args[1:3]), cos, sin,
                         *(t[:depth] for t in proj))
                kd, vd = kc[:depth].clone(), vc[:depth].clone()
                k2, v2 = kd.clone(), vd.clone()
                before = sv.int4_launches
                out = sv.fused_verify_stack(*dargs, kd, vd, pos, kcfg=kcfg,
                                            **common)
                again = sv.fused_verify_stack(*dargs, k2, v2, pos, kcfg=kcfg,
                                              **common)
                torch.cuda.synchronize()
                launched = sv.int4_launches - before
                unchanged = (_same_bits(kd[:, :, others], kc[:depth, :, others])
                             and _same_bits(vd[:, :, others],
                                            vc[:depth, :, others]))
                finite = bool(torch.isfinite(out[0]).all())
                repeat = (torch.equal(again[0], out[0]) and _same_bits(k2, kd)
                          and _same_bits(v2, vd))
                within, errs = True, {}
                if not a8:      # W4A8: layer by layer above
                    kr, vr = kc[:depth].clone(), vc[:depth].clone()
                    ref = sv.fused_verify_stack_plain(
                        *dargs, kr, vr, pos, int4_w4a8=False, **common)
                    lg_err = (out[0] - ref[0]).abs().max().item()
                    lg_rel = lg_err / ref[0].abs().max().item()
                    dims = (1, 2, 3)
                    row_err = torch.maximum(
                        (kd[:, :, new].float() - kr[:, :, new].float()).abs().amax(dim=dims),
                        (vd[:, :, new].float() - vr[:, :, new].float()).abs().amax(dim=dims))
                    row_mag = torch.maximum(
                        kr[:, :, new].float().abs().amax(dim=dims),
                        vr[:, :, new].float().abs().amax(dim=dims))
                    within = (lg_rel <= 2e-2 and bool(row_err[0] <= 0.05)
                              and bool((row_err <= 0.05 + 1e-2 * row_mag).all()))
                    errs = dict(
                        logits_max_abs_err=f"{lg_err:.4g}",
                        logits_err_over_max=f"{lg_rel:.4g}", tol_logits=2e-2,
                        kv_rows_err_layer0=f"{row_err[0].item():.3g}",
                        kv_rows_err_max=f"{row_err.max().item():.4g}",
                        kv_rows_err_by_layer=[round(e, 4) for e in row_err[
                            ::1 if depth <= 4 else 4].tolist()],
                        kv_rows_max_abs=f"{row_mag.max().item():.3g}",
                        tol_rows="atol=0.05+rtol=1e-2")
                    del kr, vr, ref
                say("verify_int4", kernel=8, n=n, mode=mode, pos=pos,
                    layers=depth, **errs, other_rows_unchanged=unchanged,
                    finite=finite, repeat_bit_identical=repeat,
                    int4_launches=launched,
                    kernels_per_call=sv.last_step_kernels)
                if not (within and unchanged and finite and repeat
                        and launched == 2):
                    raise AssertionError(
                        f"kernel 8's int4 mode (n {n}, {mode}, {depth} "
                        "layers) disagrees with its plain twin or itself")
                del k2, v2, again, kd, vd
            kk.copy_(kc)
            vk.copy_(vc)
            step = functools.partial(sv.fused_verify_stack, *args, kk, vk,
                                     pos, kcfg=kcfg, **common)
            bf16_step = functools.partial(
                sv.fused_verify_stack, x, lw["attn_norm"], lw["ffn_norm"],
                cos, sin, lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kk,
                vk, pos, **common)
            ms = time_ms(step, 10)
            bf16_ms = time_ms(bf16_step, 10)
            plain_ms = None
            if n == 5:
                plain_ms = time_ms(lambda: sv.fused_verify_stack_plain(
                    *args, kc.clone(), vc.clone(), pos, int4_w4a8=a8,
                    **common), 1, warmup=0)
            nbytes = q_bytes + norm_bytes + lm_bytes + kv_read + kv_write + io
            bound = max(nbytes / hbm, flops / peak) * 1e3
            bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
            say("verify_int4", n=n, mode=mode, ms_per_call=f"{ms:.4f}",
                bf16_ms_per_call_same_phase=f"{bf16_ms:.4f}",
                plain_ms="not timed" if plain_ms is None else f"{plain_ms:.4f}",
                bound_ms=f"{bound:.4f}", bound_by=bound_by,
                bytes_per_call=nbytes, int4_codes_bf16_scale_bytes=q_bytes,
                int4_codes_f32_scale_bytes_read=q_bytes_f32)
            if n == 5 and a8:                   # the profiler, once a phase
                busy, span, own, by, cnt = timeline_by_pass(
                    step, INT4_VERIFY_PASSES)
                say("verify_int4_device", n=n, mode=mode,
                    busy_ms=f"{busy:.4f}", span_ms=f"{span:.4f}",
                    kernels_own_sum_ms=f"{own:.4f}",
                    **{f"{k}_ms": f"{v:.4f}" for k, v in by.items()},
                    **{f"{k}_launches": f"{v:g}" for k, v in cnt.items()},
                    gemv4_TBps=f"{q_bytes_f32 / (by['gemv4'] * 1e-3) / 1e12:.3f}")
            if n == 5:
                rows[mode] = dict(max_abs_err=lg_err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound, bound_by=bound_by,
                                  library_ms=None)
        del kk, vk
    launches = {"w4a8": phase_spec(eng4, dev, "spec_int4",
                                   stack_plain_step(True))}
    exact = Llama(eng4.params, cfg, eng4.tokenizer, fused=True,
                  kcfg=KernelConfig(int4_w4a8=False))
    text = ("Speculative decoding drafts a few tokens and one verify step "
            "scores them all. " * 3)[:127]
    prompt = exact.tokenizer.encode(text, bos=True, eos=False)
    ref = list(exact.stream_generate(prompt, SPEC_NEW, temperature=0.0))
    self_draft = Llama(exact.params, cfg, exact.tokenizer, fused=True,
                       kcfg=exact.kcfg)
    launches["exact"], _ = spec_run(exact, dev, prompt, self_draft, ref,
                                    "self_exact", "spec_int4",
                                    stack_plain_step(False))
    return rows, launches


def phase_int4_serving(eng4, eng, dev, bf16_figures):
    """Phase 31: int4 serving at B 8.  First one step of each kind against
    the same step on the plain twins, as phase 22 holds int8 (4 layers at
    phase 9's limits; all 32 within 1.25x the bf16 step's drift).  Then
    phase 8's mix (8 requests of 32-512 prompt tokens, 32 new each) through
    the default step (fused for an int4 tree: kernel 9's int4 mode and
    ``_ffn_int4``) and the batched one (``_gemv_int4``/``_ffn_int4``
    around kernel 10): tokens/s and ms a step beside phase 8's bf16
    figures and the device busy ms of one step of that kind at
    ``SERVE_LENS`` (``torch.profiler``), the launches; then
    ``Llama.generate`` for one prompt (the fused step) against the int4
    plain path under the top-2-gap rule.  Returns the launches of kernel 9's
    int4 mode, ``_gemv_int4`` and ``_ffn_int4`` in the serving runs."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.runtime import ServingEngine
    serving = importlib.import_module("clusterfusion_tpu_torch.runtime.serving")
    gemv = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    for impl, r in step_vs_plain(eng4, dev, STEP_CHECK_DEPTH).items():
        err, mag = r["row_err"], r["row_mag"]
        rows_ok = err[0] <= 0.05 and all(e <= 0.05 + 1e-2 * m
                                         for e, m in zip(err, mag))
        say("serving_int4_step", step=impl, B=len(SERVE_LENS),
            layers=r["layers"], logits_err_over_max=f"{r['logits_rel']:.4g}",
            tol_logits=2e-2,
            least_request_spread_over_max=f"{r['spread']:.4g}",
            kv_rows_err_layer0=f"{err[0]:.3g}", tol_layer0=0.05,
            kv_rows_err_by_layer=[round(x, 4) for x in err],
            tol_rows="atol=0.05+rtol=1e-2",
            other_rows_unchanged=r["unchanged"], finite=r["finite"])
        if not (r["logits_rel"] <= 2e-2 and rows_ok and r["unchanged"]
                and r["finite"] and r["spread"] > 2e-2):
            raise AssertionError(f"the int4 {impl} serving step disagrees "
                                 "with the same step on the plain twins")
    full4, full16 = step_vs_plain(eng4, dev), step_vs_plain(eng, dev)
    for impl, r in full4.items():
        b = full16[impl]
        say("serving_int4_step", step=impl, layers=r["layers"],
            logits_err_over_max=f"{r['logits_rel']:.4g}",
            bf16_logits_err_over_max=f"{b['logits_rel']:.4g}",
            tol="1.25x the bf16 step's",
            kv_rows_err_max=f"{max(r['row_err']):.4g}",
            bf16_kv_rows_err_max=f"{max(b['row_err']):.4g}",
            other_rows_unchanged=r["unchanged"], finite=r["finite"])
        if not (r["logits_rel"] <= 1.25 * b["logits_rel"] and r["unchanged"]
                and r["finite"]):
            raise AssertionError(f"the int4 {impl} serving step drifts from "
                                 "its twin more than the bf16 step")
    cfg = eng4.cfg
    if ServingEngine(eng4.params, cfg).step_impl != "fused":
        raise AssertionError("an int4 tree does not default to the fused step")
    text = "Serving many users at once on one card, page by page. " * 12
    prompts = [eng4.tokenizer.encode(text[:n - 1], bos=True, eos=False)
               for n in (32, 64, 128, 200, 256, 300, 400, 512)]
    n_new = 32
    # one step of each kind at SERVE_LENS, for its device busy time
    L, kv, hd, page = cfg.n_layers, cfg.kv_heads, cfg.head_dim_, 16
    _, _, table, lens = paged_pools(dev, 1, kv, hd, page, SERVE_LENS, 33)
    shape = (L, int(table.max()) + 1, kv, page, hd)
    kp = torch.zeros(shape, device=dev, dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    tokens = torch.arange(len(SERVE_LENS), device=dev) * 7 + 3
    rope = model.rope_table(cfg, device=dev)
    temps, tops = [0.0] * len(SERVE_LENS), [0.9] * len(SERVE_LENS)
    steps = dict(batched=serving._paged_decode_step_batched,
                 fused=serving._paged_decode_step)
    launch = dict(layer=0, gemv=0, ffn=0)
    for impl in ("fused", "batched"):
        def serve(batch, timed=False):
            srv = ServingEngine(eng4.params, cfg, page_size=16, num_pages=136,
                                max_batch=8,
                                step_impl=None if impl == "fused" else impl)
            step_s = []
            if timed:
                real_step = srv._step

                def timed_step(*a):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = real_step(*a)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    return out

                srv._step = timed_step
            for i in batch:
                srv.submit(i, prompts[i], n_new, temperature=0.0)
            return srv.run(), step_s

        serve([0])                                        # warm-up
        pd.launches.update(dict.fromkeys(pd.launches, 0))
        gemv.int4_launches = gemv.ffn4_launches = 0
        out, step_s = serve(range(len(prompts)), timed=True)
        pa, k9 = (pd.launches["paged_attention"],
                  pd.launches["llama_decoder_layer_paged_int4"])
        products, ffns = gemv.int4_launches, gemv.ffn4_launches
        n_steps = len(step_s)
        decode_tokens = sum(len(t) for t in out.values()) - len(prompts)
        tps = decode_tokens / sum(step_s)
        busy, _ = busy_ms(lambda: steps[impl](  # noqa: B023
            eng4.params, kp, vp, tokens, lens, table, lens, None, temps, tops,
            cfg, rope))
        say("serving_int4", step=impl, requests=len(prompts), new_tokens=n_new,
            decode_steps=n_steps, decode_tokens_per_s=f"{tps:.2f}",
            ms_per_step=f"{sum(step_s) * 1e3 / n_steps:.3f}",
            device_busy_ms_per_step_at_serve_lens=f"{busy:.4f}",
            **({} if bf16_figures is None else dict(
                bf16_decode_tokens_per_s_phase8=f"{bf16_figures['tokens_per_s']:.2f}",
                bf16_ms_per_step_phase8=f"{bf16_figures['ms_per_step']:.3f}")),
            paged_attention_launches=pa, layer_int4_launches=k9,
            gemv_int4_launches=products, ffn_int4_launches=ffns)
        ok = ffns == L * n_steps
        if impl == "batched":
            ok = ok and pa == L * n_steps and k9 == 0 and \
                products == 2 * L * n_steps
            launch["gemv"] = products
        else:
            ok = ok and k9 == L * n_steps and pa == 0 and products == 0
            launch["layer"] = k9
        launch["ffn"] += ffns
        if not ok:
            raise AssertionError(f"the int4 {impl} step did not launch its "
                                 "kernels once per layer and step")
        if any(len(t) != n_new or not all(0 <= x < cfg.vocab_size for x in t)
               for t in out.values()):
            raise AssertionError(f"bad int4 serving output {out}")
        alone = serve([3])[0]
        say("serving_int4", step=impl, request_3_alone_equal=alone[3] == out[3],
            first_tokens=out[0][:8])
        if alone[3] != out[3]:
            raise AssertionError(f"int4 {impl} serving is not batching-"
                                 "invariant")
    pd.launches.update(dict.fromkeys(pd.launches, 0))
    t0 = time.perf_counter()
    toks, _ = eng4.generate(prompts[2:3], 16, temperature=0.0)
    gen_s = time.perf_counter() - t0
    k9 = pd.launches["llama_decoder_layer_paged_int4"]
    plain, gaps, bad = check_against_plain(eng4, dev, prompts[2], toks[0], 8)
    say("generate_int4", B=1, step="fused", tokens=toks[0][:8],
        plain_tokens=plain, top2_gaps=[round(x, 3) for x in gaps],
        disagree_where_gap_gt_0_1=bad, wall_s=f"{gen_s:.3f}",
        layer_int4_launches=k9)
    if bad or k9 < cfg.n_layers:
        raise AssertionError("int4 generate disagrees with the plain path or "
                             "did not run kernel 9's int4 mode")
    launch["layer"] += k9
    return launch


# -- 8-bit KV caches in kernels 7 and 8 (phases 35-37) ------------------------

# (label, kv_dtype) of the two 8-bit formats
KV8_FORMATS = (("int8", "int8"), ("fp8", torch.float8_e4m3fn))
# a stored row may sit one step of its format apart where the two f32 rows
# it comes from straddle a rounding boundary: one int8 code (|row| / 127)
# or one e4m3 step (1/8 of the value)
KV8_STEP = {"int8": 1 / 127, "fp8": 0.125}
KV8_PASSES = (("split", "attn_split_kernel"), ("gemv", "ring_gemv_kernel"),
              ("norms", "resnorm_kernel"), ("merge", "attn_merge8_kernel"))


def kv8_cache(kc, vc, fmt, pos):
    """bf16 caches as an 8-bit pair: rows < pos stored as the kernels store
    rows (int8: ``quantize_kv_rows`` into an ``init_kv_int8`` pair; fp8: a
    cast), every scale at and above pos NaN (int8) or every byte 0x7F, an
    e4m3 NaN (fp8): the kernels never read them."""
    from clusterfusion_tpu_torch.ops import quant as tq
    out = []
    for c in (kc, vc):
        L, H, cap, hd = c.shape
        if fmt == "int8":
            pair = tq.init_kv_int8(L, H, cap, hd, device=c.device)
            for l in range(L):       # a layer at a time: small f32 copies
                tq.cache_write_layer(pair, l, c[l, :, :pos].float(), 0)
            _kv_scales(pair)[:, :, pos:] = float("nan")
        else:
            pair = c.to(torch.float8_e4m3fn)
            pair.view(torch.uint8)[:, :, pos:] = 0x7F
        out.append(pair)
    return out


def kv8_vs_plain(phase, fmt, out, ref, kk, vk, kc, vc, pos, rows,
                 scale_rtol=1e-5, equal_share=None, **where):
    """A step of kernel 7 or 8 on an 8-bit cache (``out``, caches kk/vk)
    against its plain twin's (``ref``, kc/vc) at phase 4's limits: logits
    within 2e-2 of the largest; the ``rows`` appended rows at layer 0 int8
    codes within 1 and scales at rtol ``scale_rtol`` (1e-5: the same f32
    row up to a sum order; at hd 64 both store the bf16-rounded row, whose
    absmax a bf16 rounding may move by 2^-8) or fp8 rows within one e4m3
    step, and (``equal_share``) that share of layer 0's codes or bytes
    equal; the values of every layer at atol 0.05 + rtol 1e-2 of |row|
    (layer 0: atol 0.05) plus one step of the format; every other row and
    scale unchanged bit for bit; finite outputs.  Prints one line; returns
    (logits max abs error, ok)."""
    torch.cuda.synchronize()
    new = list(range(pos, pos + rows))
    lg_err = (out[0] - ref[0]).abs().max().item()
    lg_rel = lg_err / ref[0].abs().max().item()
    err = torch.maximum(*((kv_values(a, new) - kv_values(b, new)).abs()
                          .amax(dim=(1, 2, 3))
                          for a, b in ((kk, kc), (vk, vc))))
    mag = torch.maximum(*(kv_values(b, new).abs().amax(dim=(1, 2, 3))
                          for b in (kc, vc)))
    step = KV8_STEP[fmt]
    tol = 0.05 + (1e-2 + step) * mag
    tol[0] = 0.05 + step * mag[0]
    rows_ok = bool((err <= tol).all())
    if fmt == "int8":
        codes = max((a.q[0][:, new].int() - b.q[0][:, new].int()).abs().max()
                    .item() for a, b in ((kk, kc), (vk, vc)))
        scale0 = max(((_kv_scales(a)[0][:, new] - _kv_scales(b)[0][:, new])
                      .abs() / _kv_scales(b)[0][:, new]).max().item()
                     for a, b in ((kk, kc), (vk, vc)))
        first = dict(codes_max_diff_layer0=codes, tol_codes=1,
                     scales_rel_err_layer0=f"{scale0:.3g}",
                     tol_scales=f"{scale_rtol:.3g}")
        first_ok = codes <= 1 and scale0 <= scale_rtol
        same = min((a.q[0][:, new] == b.q[0][:, new]).float().mean().item()
                   for a, b in ((kk, kc), (vk, vc)))
    else:
        e0 = max(((a[0][:, new].float() - b[0][:, new].float()).abs()
                  - 0.125 * b[0][:, new].float().abs()).max().item()
                 for a, b in ((kk, kc), (vk, vc)))
        first = dict(e4m3_excess_over_one_step_layer0=f"{e0:.3g}")
        first_ok = e0 <= 1e-6
        same = min((a[0][:, new].view(torch.uint8)
                    == b[0][:, new].view(torch.uint8)).float().mean().item()
                   for a, b in ((kk, kc), (vk, vc)))
    if equal_share is not None:
        first.update(codes_equal_share_layer0=f"{same:.4f}",
                     tol_equal_share=equal_share)
        first_ok = first_ok and same >= equal_share
    others = torch.ones(kv_positions(kc), dtype=torch.bool,
                        device=out[0].device)
    others[new] = False
    unchanged = kv_same_bits(kk, kc, others) and kv_same_bits(vk, vc, others)
    finite = bool(torch.isfinite(out[0]).all()) and bool(
        torch.isfinite(out[1].float()).all())
    say(phase, **where, kv=fmt, pos=pos, rows=rows,
        logits_max_abs_err=f"{lg_err:.4g}",
        logits_err_over_max=f"{lg_rel:.4g}",
        tol_logits=2e-2, **first, row_err_by_layer=[round(e, 4) for e in
                                                  err[::4].tolist()],
        row_err_over_tol_worst=f"{(err / tol).max().item():.3g}",
        tol_rows=f"atol=0.05+rtol=1e-2 (layer 0: atol=0.05), +{step:.4g} of "
                 "|row| (one step of the format)",
        other_rows_unchanged=unchanged, nan_above_pos=True, finite=finite)
    return lg_err, (lg_rel <= 2e-2 and rows_ok and first_ok and unchanged
                    and finite)


def ffn_unpadded(cfg, lw):
    """``lw``'s w13 and w2 cut to ``cfg.ffn_dim`` (views): the zero columns
    and rows that ``padded_ffn_dim`` adds are no work of the step, so a
    bound leaves them out (int4 w2: two k rows a byte, a scale row per
    group; int8 w2: one scale per output column, kept whole)."""
    F, w13, w2 = cfg.ffn_dim, lw["w13"], lw["w2"]
    if not hasattr(w13, "q"):
        return w13[..., :F], w2[:, :F]
    four = w2.kind == "int4"
    return (dataclasses.replace(w13, q=w13.q[..., :F], s=w13.s[..., :F]),
            dataclasses.replace(w2, q=w2.q[:, :F // 2 if four else F],
                                s=w2.s[:, :F // w2.group_size] if four
                                else w2.s))


def kv8_bound(cfg, p, hbm, peak, pos, n, fmt, window=0):
    """(bound ms, bound_by, bytes) of a step of n rows at pos with a cache
    of ``fmt`` ("bf16", "int8", "fp8"): every weight once (bf16 or
    quantized: the tensors' own bytes, the FFN at ``cfg.ffn_dim``), the
    rows below pos (int8: and their float32 scales) that a row attends
    (under a sliding window, those at and above pos + 1 - window), the n
    rows written (and their scales), x, the residual and the logits; each
    row's attention over the positions it attends."""
    lw = dict(p["layers"])
    lw["w13"], lw["w2"] = ffn_unpadded(cfg, lw)
    L, kvh, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim_

    def nbytes_of(t):
        if hasattr(t, "q"):
            return t.q.numel() + t.s.numel() * 4
        return t.numel() * t.element_size()
    wbytes = sum(nbytes_of(t) for t in
                 (lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"],
                  lw["attn_norm"], lw["ffn_norm"], p["final_norm"],
                  p["lm_head"]))
    per_row = 2 * L * kvh * {"bf16": 2 * hd, "int8": hd + 4, "fp8": hd}[fmt]
    read = min(pos, window - 1) if window else pos
    nbytes = wbytes + per_row * (read + n) + n * (2 * 2 * cfg.hidden_dim
                                                  + 4 * cfg.vocab_size)

    def count(t):
        return t.q.numel() * (2 if t.kind == "int4" else 1) \
            if hasattr(t, "q") else t.numel()
    weights = sum(count(t) for t in (lw["wqkv_f"], lw["wo_f"], lw["w13"],
                                     lw["w2"], p["lm_head"]))
    attended = sum(min(pos + t + 1, window) if window else pos + t + 1
                   for t in range(n))
    flops = 2 * n * weights + 4 * L * cfg.n_heads * hd * attended
    bound = max(nbytes / hbm, flops / peak) * 1e3
    return bound, "bytes" if nbytes / hbm >= flops / peak else "operations", \
        nbytes


def kv8_engines(eng, eng8, eng4):
    """(label, engine, KernelConfig) of the weights phases 35-36 run: bf16,
    int8 and int4 in W4A8 (the default)."""
    from clusterfusion_tpu_torch.config import KernelConfig
    return (("bf16", eng, KernelConfig()), ("int8", eng8, KernelConfig()),
            ("int4_w4a8", eng4, KernelConfig(int4_w4a8=True)))


def phase_kv8_stack(eng, eng8, eng4, dev, hbm, peak, cap=4096):
    """Phase 35: kernel 7 with an ``Int8KV`` and an fp8 cache at full
    Llama-2-7B width, capacity 4096, pos 600 and 4000, over random rows
    with NaN scales (int8) or NaN bytes (fp8) above pos: with bf16 and int8
    weights over all 32 layers against the plain twin (``kv8_vs_plain``),
    with int4 W4A8 weights layer by layer, teacher-forced
    (``hold_by_layer``); the kv8 launch counted once a call; CUDA-event
    step times, two readings in turns, beside the bf16-KV step on the same
    inputs, the bound (8-bit rows and scales below pos) and, at pos 600
    with bf16 weights, the twin's time and the device time by pass.
    Returns the kernels-line rows of both formats (bf16 weights, pos
    600)."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    cfg = eng.cfg
    g, hd, L = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(35)
    shape = (L, cfg.kv_heads, cap, hd)
    kb = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    vb = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    rows, errs = {}, {}
    for pos in (600, 4000):
        caches = {fmt: kv8_cache(kb, vb, fmt, pos) for fmt, _ in KV8_FORMATS}
        cos, sin = model.rope_row(cfg, pos, dev)
        for wname, e, kcfg in kv8_engines(eng, eng8, eng4):
            p, lw = e.params, e.params["layers"]
            x = p["embed"][torch.tensor([7], device=dev)]
            kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                      eps=cfg.norm_eps, final_norm=p["final_norm"],
                      lm_head=p["lm_head"])
            args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin,
                    lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"])
            steps = {"bf16": functools.partial(
                sk.fused_decoder_stack, *args, kb, vb, pos, kcfg=kcfg, **kw)}
            for fmt, _ in KV8_FORMATS:
                kc8, vc8 = caches[fmt]
                kind = sk_kind(fmt)
                if wname == "int4_w4a8":
                    lg_err, ok = hold_by_layer(
                        sk.fused_decoder_stack, sk.fused_decoder_stack_plain,
                        args, kc8, vc8, pos, 1, L, kcfg, kw, "stack_kv8",
                        rows_rtol=KV8_STEP[fmt], kernel=7, kv=fmt,
                        weights=wname)
                else:
                    kk, vk = kv_take(kc8, 0, L), kv_take(vc8, 0, L)
                    kp, vp = kv_take(kc8, 0, L), kv_take(vc8, 0, L)
                    before = (sk.launches, sk.kv8_launches[kind])
                    out = sk.fused_decoder_stack(*args, kk, vk, pos,
                                                 kcfg=kcfg, **kw)
                    n_kernels = sk.last_step_kernels
                    counted = (sk.launches - before[0],
                               sk.kv8_launches[kind] - before[1])
                    ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos,
                                                       **kw)
                    lg_err, ok = kv8_vs_plain(
                        "stack_kv8", fmt, out, ref, kk, vk, kp, vp, pos, 1,
                        kernel=7, weights=wname, layers=L,
                        kernels_per_step=n_kernels, launches_counted=counted)
                    ok = ok and counted == (1, 1) and n_kernels == 8 * L + 2
                    del kk, vk, kp, vp, out, ref
                if not ok:
                    raise AssertionError(f"kernel 7 with an {fmt} cache "
                                         f"({wname} weights, pos {pos}) "
                                         "disagrees with its plain twin")
                errs[fmt] = lg_err
                kk, vk = kv_take(kc8, 0, L), kv_take(vc8, 0, L)
                steps[fmt] = functools.partial(sk.fused_decoder_stack, *args,
                                               kk, vk, pos, kcfg=kcfg, **kw)
            order = ("bf16", "int8", "fp8", "fp8", "int8", "bf16")
            reps = 20 if (pos, wname) == (600, "bf16") else 10
            ms = {k: [] for k in steps}
            for k in order:
                ms[k].append(time_ms(steps[k], reps))
            for fmt, _ in KV8_FORMATS:
                bound, bound_by, nbytes = kv8_bound(cfg, p, hbm, peak, pos, 1,
                                                    fmt)
                bf_bound = kv8_bound(cfg, p, hbm, peak, pos, 1, "bf16")[0]
                say("stack_kv8", kv=fmt, weights=wname, pos=pos,
                    ms_per_step=[f"{v:.4f}" for v in ms[fmt]],
                    bf16_kv_ms_per_step_same_inputs=[f"{v:.4f}"
                                                     for v in ms["bf16"]],
                    bound_ms=f"{bound:.4f}", bound_by=bound_by,
                    bytes_per_step=nbytes, bf16_kv_bound_ms=f"{bf_bound:.4f}")
                if (pos, wname) != (600, "bf16"):
                    continue
                kc8, vc8 = caches[fmt]
                plain_ms = time_ms(lambda: sk.fused_decoder_stack_plain(
                    *args, kv_take(kc8, 0, L), kv_take(vc8, 0, L), pos,
                    **kw), 1, warmup=0)
                rows[fmt] = dict(max_abs_err=errs[fmt],
                                 ms=statistics.mean(ms[fmt]),
                                 plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=bound_by, library_ms=None)
                busy, span, own, by, n = timeline_by_pass(steps[fmt],
                                                          KV8_PASSES)
                say("stack_kv8_device", kv=fmt, weights=wname, pos=pos,
                    busy_ms=f"{busy:.4f}", span_ms=f"{span:.4f}",
                    **{f"{k}_ms": f"{v:.4f}" for k, v in by.items()},
                    **{f"{k}_launches": f"{v:g}" for k, v in n.items()},
                    note="each kernel charged from the end of those before "
                         "it to its own end")
            del steps
        del caches
    del kb, vb
    torch.cuda.empty_cache()
    return rows


def phase_kv8_verify(eng, eng8, eng4, dev, hbm, peak, cap=4096, n=5):
    """Phase 36: kernel 8 at n 5 with an ``Int8KV`` and an fp8 cache at
    Llama-2-7B width, pos 600 and 1022 (the five appends straddle plane row
    8), NaN above pos: bf16 and int8 weights over all 32 layers against the
    plain twin, int4 W4A8 layer by layer, teacher-forced; with bf16
    weights the CUDA-event call times, two readings in turns, beside the
    bf16-KV verify on the same inputs, the bound and (pos 600) the twin's
    time.  Returns the kernels-line rows of both formats (bf16 weights,
    pos 600)."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    cfg = eng.cfg
    g, hd, L = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(36)
    shape = (L, cfg.kv_heads, cap, hd)
    kb = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    vb = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    rows = {}
    for pos in (600, 1022):
        caches = {fmt: kv8_cache(kb, vb, fmt, pos) for fmt, _ in KV8_FORMATS}
        cos, sin = model.rope_rows(cfg, pos, n, dev)
        for wname, e, kcfg in kv8_engines(eng, eng8, eng4):
            p, lw = e.params, e.params["layers"]
            x = p["embed"][torch.arange(n, device=dev) * 37 + 11]
            kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                      eps=cfg.norm_eps, final_norm=p["final_norm"],
                      lm_head=p["lm_head"])
            args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin,
                    lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"])
            for fmt, _ in KV8_FORMATS:
                kc8, vc8 = caches[fmt]
                kind = sk_kind(fmt)
                if wname == "int4_w4a8":
                    _, ok = hold_by_layer(
                        sv.fused_verify_stack, sv.fused_verify_stack_plain,
                        args, kc8, vc8, pos, n, L, kcfg, kw, "verify_kv8",
                        rows_rtol=KV8_STEP[fmt], kernel=8, kv=fmt, n=n,
                        weights=wname)
                    lg_err = None
                else:
                    kk, vk = kv_take(kc8, 0, L), kv_take(vc8, 0, L)
                    kp, vp = kv_take(kc8, 0, L), kv_take(vc8, 0, L)
                    before = sv.kv8_launches[kind]
                    out = sv.fused_verify_stack(*args, kk, vk, pos, kcfg=kcfg,
                                                **kw)
                    counted = sv.kv8_launches[kind] - before
                    ref = sv.fused_verify_stack_plain(*args, kp, vp, pos,
                                                      **kw)
                    lg_err, ok = kv8_vs_plain(
                        "verify_kv8", fmt, out, ref, kk, vk, kp, vp, pos, n,
                        kernel=8, n=n, weights=wname, layers=L,
                        kernels_per_call=sv.last_step_kernels,
                        launches_counted=counted)
                    ok = ok and counted == 1
                    del kk, vk, kp, vp, out, ref
                if not ok:
                    raise AssertionError(f"kernel 8 with an {fmt} cache "
                                         f"({wname} weights, pos {pos}) "
                                         "disagrees with its plain twin")
                if wname == "bf16" and pos == 600:
                    rows[fmt] = dict(max_abs_err=lg_err)
            if wname != "bf16":
                continue
            kk8 = {fmt: (kv_take(c[0], 0, L), kv_take(c[1], 0, L))
                   for fmt, c in caches.items()}
            steps = {"bf16": functools.partial(
                sv.fused_verify_stack, *args, kb, vb, pos, **kw)}
            steps.update({fmt: functools.partial(
                sv.fused_verify_stack, *args, *kk8[fmt], pos, **kw)
                for fmt in kk8})
            ms = {k: [] for k in steps}
            for k in ("bf16", "int8", "fp8", "fp8", "int8", "bf16"):
                ms[k].append(time_ms(steps[k], 10))
            for fmt, _ in KV8_FORMATS:
                bound, bound_by, nbytes = kv8_bound(cfg, p, hbm, peak, pos, n,
                                                    fmt)
                say("verify_kv8", kv=fmt, weights=wname, pos=pos, n=n,
                    ms_per_call=[f"{v:.4f}" for v in ms[fmt]],
                    bf16_kv_ms_per_call_same_inputs=[f"{v:.4f}"
                                                     for v in ms["bf16"]],
                    bound_ms=f"{bound:.4f}", bound_by=bound_by,
                    bytes_per_call=nbytes)
                if pos != 600:
                    continue
                kc8, vc8 = caches[fmt]
                plain_ms = time_ms(lambda: sv.fused_verify_stack_plain(
                    *args, kv_take(kc8, 0, L), kv_take(vc8, 0, L), pos,
                    **kw), 1, warmup=0)
                rows[fmt].update(ms=statistics.mean(ms[fmt]),
                                 plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=bound_by, library_ms=None)
            del steps, kk8
        del caches
    del kb, vb
    torch.cuda.empty_cache()
    return rows


def sk_kind(fmt):
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    return sk.KV_INT8 if fmt == "int8" else sk.KV_FP8


def kv8_step_check(eng, dev, prompt, fmt, phase):
    """One teacher-forced step on the engine's 8-bit cache after the
    prompt (prefilled through kernel 4) against the plain-twin step, at
    phase 4's limits (``kv8_vs_plain``): random 7B weights repeat a token,
    so a stream alone could hide a wrong kernel."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    cfg, p = eng.cfg, eng.params
    lw = p["layers"]
    kc, vc = model.init_cache(cfg, device=dev, dtype=eng.kv_dtype)
    model.prefill(p, kc, vc, prompt, cfg)
    pos = len(prompt)
    kp, vp = kv_take(kc, 0, cfg.n_layers), kv_take(vc, 0, cfg.n_layers)
    cos, sin = model.rope_row(cfg, pos, dev)
    x = p["embed"][torch.tensor([prompt[-1]], device=dev)]
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, eps=cfg.norm_eps,
              final_norm=p["final_norm"], lm_head=p["lm_head"])
    args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"])
    out = sk.fused_decoder_stack(*args, kc, vc, pos, **kw)
    ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos, **kw)
    _, ok = kv8_vs_plain(phase, fmt, out, ref, kc, vc, kp, vp, pos, 1,
                         kernel=7, check="teacher-forced step after the "
                         "prompt's prefill")
    if not ok:
        raise AssertionError(f"kernel 7 with an {fmt} cache disagrees with "
                             "its twin after the prefill")


def phase_kv8_e2e(eng, dev):
    """Phase 37: 64-token greedy streams after a 512-token prompt with an
    ``Int8KV``, an fp8 and a bf16 cache (the engine's bf16 weights;
    tokens/s side by side, kernel 7's kv8 launches, the first 8 tokens
    against the plain path: the eager prefill on the same cache kind, then
    kernel 7's twin), each 8-bit run after one teacher-forced step against
    the twin (``kv8_step_check``); then ``spec_generate`` (self-draft, 32
    tokens after 128) with each 8-bit cache (kernel 8's kv8 launches, one
    a round, ``spec_run``'s checks); then ``python -m
    clusterfusion_tpu_torch.chat --synthetic --kv_int8`` and ``--kv_fp8
    --spec_draft synthetic`` on the card, exit 0.  Returns {fmt: (kernel
    7's kv8 launches in the stream, kernel 8's in the spec run)}."""
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    cfg = eng.cfg
    text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
    prompt = eng.tokenizer.encode(text, bos=True, eos=False)
    n_new = 64
    launches, tok_s = {}, {}
    for fmt, kv_dtype in (("bf16", torch.bfloat16), *KV8_FORMATS):
        e = Llama(eng.params, cfg, eng.tokenizer, fused=True,
                  kv_dtype=kv_dtype)
        if fmt != "bf16":
            kv8_step_check(e, dev, prompt, fmt, "e2e_kv8")
        kind = None if fmt == "bf16" else sk_kind(fmt)
        before = dict(sk.kv8_launches)
        sk.launches = 0
        stamps, toks = [], []
        for t in e.stream_generate(prompt, n_new, temperature=0.0):
            stamps.append(time.perf_counter())
            toks.append(t)
        decode_s = stamps[-1] - stamps[0]
        tok_s[fmt] = (len(toks) - 1) / decode_s
        kv8 = 0 if kind is None else sk.kv8_launches[kind] - before[kind]
        plain, gaps, bad = check_against_plain(e, dev, prompt, toks,
                                               step=stack_plain_step(True))
        say("e2e_kv8", kv=fmt, prompt_tokens=len(prompt), new_tokens=len(toks),
            prefill_ms=f"{e.stats.prefill_s * 1e3:.2f}",
            decode_tokens_per_s=f"{tok_s[fmt]:.2f}",
            decode_ms_per_step=f"{decode_s * 1e3 / (len(toks) - 1):.3f}",
            stack_launches=sk.launches, stack_kv8_launches=kv8,
            kernel_tokens=toks[:8], plain_tokens=plain,
            top2_gaps=[round(x, 3) for x in gaps],
            disagree_where_gap_gt_0_1=bad)
        if len(toks) != n_new or bad or sk.launches < n_new - 1 or (
                kind is not None and kv8 != sk.launches):
            raise AssertionError(f"the {fmt}-KV stream failed its checks")
        launches[fmt] = [kv8]
    say("e2e_kv8", tokens_per_s_int8=f"{tok_s['int8']:.2f}",
        tokens_per_s_fp8=f"{tok_s['fp8']:.2f}",
        tokens_per_s_bf16=f"{tok_s['bf16']:.2f}")
    spec_text = ("Speculative decoding drafts a few tokens and one verify "
                 "step scores them all. " * 3)[:127]
    spec_prompt = eng.tokenizer.encode(spec_text, bos=True, eos=False)
    for fmt, kv_dtype in KV8_FORMATS:
        e = Llama(eng.params, cfg, eng.tokenizer, fused=True,
                  kv_dtype=kv_dtype)
        ref = list(e.stream_generate(spec_prompt, SPEC_NEW, temperature=0.0))
        draft = Llama(eng.params, cfg, eng.tokenizer, fused=True,
                      kv_dtype=kv_dtype)
        before = sv.kv8_launches[sk_kind(fmt)]
        verify, bad = spec_run(e, dev, spec_prompt, draft, ref, "self",
                               f"spec_kv8_{fmt}", stack_plain_step(True))
        counted = sv.kv8_launches[sk_kind(fmt)] - before
        say(f"spec_kv8_{fmt}", kv8_verify_launches=counted)
        if bad or counted != verify:
            raise AssertionError(f"spec_generate with an {fmt} cache failed "
                                 "its checks")
        launches[fmt].append(counted)
    for flags in (["--kv_int8"], ["--kv_fp8", "--spec_draft", "synthetic"]):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "clusterfusion_tpu_torch.chat",
             "--synthetic", "--max_gen_len", "16", "--temperature", "0",
             *flags], capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        tail = res.stdout.strip().splitlines()
        say("chat_kv8", flags=" ".join(flags), rc=res.returncode,
            seconds=f"{time.perf_counter() - t0:.1f}",
            header=repr(tail[0] if tail else ""),
            footer=repr(tail[-1] if tail else ""))
        kind = "int8" if "--kv_int8" in flags else "fp8"
        if res.returncode != 0 or f"kv={kind}" not in res.stdout or \
                "tokens/sec" not in res.stdout:
            raise AssertionError(f"chat {' '.join(flags)} failed: "
                                 f"{res.stderr[-2000:]}")
    return launches


# -- 8-bit KV caches on the multi-card paths (phases 38-40) -------------------


def e4m3_one_step(got, want):
    """Two e4m3 rows stored from float32 rows that differ by a sum order:
    (every byte equal or one code apart, as adjacent values of one sign
    are, or both zero or the least denormal; the share of equal bytes)."""
    a, b = got.view(torch.uint8).int(), want.view(torch.uint8).int()
    near = ((a ^ b) & 0x80 == 0) & ((a - b).abs() <= 1)
    near |= ((a & 0x7F) <= 1) & ((b & 0x7F) <= 1)
    return bool(near.all()), (a == b).float().mean().item()


# (label, engine attribute, KernelConfig keywords) of phase 38's weights
KV8_LAYER_WEIGHTS = (("bf16", 0, {}), ("int8", 1, {}),
                     ("int4_exact", 2, dict(int4_w4a8=False)),
                     ("int4_w4a8", 2, dict(int4_w4a8=True)))
# kernel 6's modes phase 38 holds: (label, keywords)
KV8_LAYER_MODES = (("full_append", dict(append_kv=True)), ("full", {}),
                   ("partials", dict(emit_partials=True)),
                   ("fold0", dict(emit_partials=True, fold_current=0)))


def phase_kv8_layer(eng, eng8, eng4, dev, hbm, peak, cap=4096, layer=1):
    """Phase 38: kernel 6's fp8 mode at full Llama-2-7B width, layer 1 of
    the bf16, int8 and int4 engines (int4 exact and W4A8), an fp8 cache of
    4096 rows at pos 600 and 4000 with NaN bytes (0x7F) at and above pos,
    in full mode with and without the append, partials mode and
    partials with ``fold_current=0``: each against
    ``_fused_decoder_layer_plain`` at phase 13's limits (outputs and
    residual atol 2e-2 / rtol 2e-2, partials' acc 5e-2, k_new and v_new
    0.05), the appended e4m3 row within one code of the twin's (e4m3 of
    float32 rows that differ by a sum order; the share of equal bytes
    printed), every other byte unchanged, a repeat bit-identical, counted
    as fp8, one kernel a call (two in W4A8's full mode).  Then
    ``queued_ms`` of the fp8 layer beside the bf16-KV layer on the same
    inputs at both positions (bf16 weights) and of each weight kind at pos
    600, the twin's time and the byte bound (weights, e4m3 rows below
    pos).  Returns the kernels-line row (bf16 weights, pos 600)."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    cfg = eng.cfg
    g, hd, hidden = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.hidden_dim
    kvh = cfg.kv_heads
    gen = torch.Generator(device=dev).manual_seed(38)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

    kc, vc = rnd((2, kvh, cap, hd)), rnd((2, kvh, cap, hd))
    x, res = rnd((1, hidden)), rnd((1, hidden))
    norm = 1 + 0.1 * rnd((hidden,))
    engines = (eng, eng8, eng4)
    row, times = None, {}
    for pos in (600, 4000):
        k8, v8 = kv8_cache(kc, vc, "fp8", pos)
        cos, sin = model.rope_row(cfg, pos, dev)
        others = torch.ones(cap, dtype=torch.bool, device=dev)
        others[pos] = False
        for label, which, kcfg_kw in KV8_LAYER_WEIGHTS:
            lw = engines[which].params["layers"]
            args = (x, res, norm, cos, sin, lw["wqkv_f"][layer],
                    lw["wo_f"][layer])
            kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                      fuse_residual=True, eps=cfg.norm_eps,
                      kcfg=KernelConfig(**kcfg_kw))
            a8 = label == "int4_w4a8"
            for mode, extra in KV8_LAYER_MODES:
                partials = "emit_partials" in extra
                kk, vk = k8.clone(), v8.clone()
                kp, vp = k8.clone(), v8.clone()
                before = (dl.launches, dl.fp8_launches)
                out = dl._fused_decoder_layer(*args, kk, vk, pos, 1, **kw,
                                              **extra)
                kernels = dl.last_call_kernels
                launched = (dl.launches - before[0],
                            dl.fp8_launches - before[1])
                kk2, vk2 = k8.clone(), v8.clone()
                again = dl._fused_decoder_layer(*args, kk2, vk2, pos, 1, **kw,
                                                **extra)
                ref = dl._fused_decoder_layer_plain(*args, kp, vp, pos, 1,
                                                    **kw, **extra)
                torch.cuda.synchronize()
                n_out = 5 if partials else 4
                repeat = all(torch.equal(a.view(torch.uint8),
                                         b.view(torch.uint8))
                             for a, b in zip(out[:n_out], again[:n_out])
                             if a is not None)
                repeat &= kv_same_bits(kk, kk2, others | ~others) and \
                    kv_same_bits(vk, vk2, others | ~others)
                # outputs at phase 13's limits: (got, want, atol, rtol)
                res_i = 2 if partials else 1
                held = ([(out[1], ref[1], 2e-2, 2e-2),
                         (out[0], ref[0], 5e-2, 2e-2)] if partials
                        else [(out[0], ref[0], 2e-2, 2e-2)])
                held.append((out[res_i], ref[res_i], 2e-2, 2e-2))
                held += [(out[i], ref[i], 0.05, 0.0)
                         for i in (res_i + 1, res_i + 2)]
                errs = [(a.float() - b.float()).abs().max().item()
                        for a, b, _, _ in held]
                within = all(bool(((a.float() - b.float()).abs()
                                   <= at + rt * b.float().abs()).all())
                             for a, b, at, rt in held)
                finite = all(bool(torch.isfinite(a.float()).all())
                             for a, _, _, _ in held)
                rows = dict(other_bytes_unchanged=(
                    kv_same_bits(kk, k8, others) and
                    kv_same_bits(vk, v8, others)))
                ok_rows = rows["other_bytes_unchanged"]
                if "append_kv" in extra:
                    nk, eq_k = e4m3_one_step(kk[1, :, pos], kp[1, :, pos])
                    nv, eq_v = e4m3_one_step(vk[1, :, pos], vp[1, :, pos])
                    rows.update(appended_within_one_code=nk and nv,
                                appended_bytes_equal_share=(
                                    f"{min(eq_k, eq_v):.4f}"))
                    ok_rows &= nk and nv
                else:
                    ok_rows &= kv_same_bits(kk, k8, others | ~others)
                want_kernels = 2 if a8 and not partials else 1
                say("layer_kv8", kernel=6, kv="fp8", weights=label, mode=mode,
                    pos=pos, cap=cap, max_abs_err=f"{max(errs[:-2]):.3g}",
                    k_new_v_new_err=f"{max(errs[-2:]):.3g}",
                    tol="phase 13's: out/res atol 2e-2+rtol 2e-2 (partials' "
                        "acc 5e-2), k_new/v_new 0.05", within=within,
                    finite=finite, repeat_bit_identical=repeat,
                    kernels_per_call=kernels, launches_fp8=launched, **rows)
                if not (within and finite and repeat and ok_rows
                        and kernels == want_kernels and launched == (1, 1)):
                    raise AssertionError(f"kernel 6's fp8 mode ({label}, "
                                         f"{mode}, pos {pos}) disagrees with "
                                         "its twin")
                if (pos, label, mode) == (600, "bf16", "full_append"):
                    row = dict(max_abs_err=max(errs[:-2]), library_ms=None)
                del kk, vk, kp, vp, kk2, vk2, out, again, ref
            if label == "bf16" or pos == 600:
                kk, vk = k8.clone(), v8.clone()
                times[pos, label] = queued_ms(
                    lambda: dl._fused_decoder_layer(  # noqa: B023
                        *args, kk, vk, pos, 1, append_kv=True, **kw))
            if label == "bf16":
                kb, vb = kc.clone(), vc.clone()
                times[pos, "bf16_kv"] = queued_ms(
                    lambda: dl._fused_decoder_layer(  # noqa: B023
                        *args, kb, vb, pos, 1, append_kv=True, **kw))
                wq, wo = args[5], args[6]
                io = 5 * hidden * 2 + 2 * kvh * hd * 2 + 2 * kvh * hd
                bound, bound_by, nbytes = _layer_bound(
                    hbm, peak, _bytes(wq, wo), wq.numel() + wo.numel(), kvh,
                    cfg.n_heads, pos, hd, io, row_bytes=1)
                times[pos, "bound"] = (bound, bound_by, nbytes)
                if pos == 600:
                    kp, vp = k8.clone(), v8.clone()
                    plain_ms = time_ms(lambda: dl._fused_decoder_layer_plain(
                        *args, kp, vp, pos, 1, append_kv=True, **kw), 3)
                    kk, vk = k8.clone(), v8.clone()
                    row.update(ms=times[pos, label], plain_ms=plain_ms,
                               bound_ms=bound, bound_by=bound_by)
                    say("layer_kv8_launch", kernel=6, kv="fp8",
                        **dl.launch_plan(hidden, kvh, g, hd, kv="fp8"),
                        **launch_phases(dl, lambda: dl._fused_decoder_layer(
                            *args, kk, vk, pos, 1, append_kv=True, **kw),
                            16 * kvh, K6_PHASES))
    for pos in (600, 4000):
        bound, bound_by, nbytes = times[pos, "bound"]
        say("layer_kv8", kernel=6, kv="fp8", pos=pos, weights="bf16",
            queued_ms=f"{times[pos, 'bf16']:.4f}",
            bf16_kv_queued_ms_same_inputs=f"{times[pos, 'bf16_kv']:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by, bytes=nbytes,
            rate_TBps=f"{nbytes / times[pos, 'bf16'] / 1e9:.3f}")
    say("layer_kv8", kernel=6, kv="fp8", pos=600,
        **{f"{label}_queued_ms": f"{times[600, label]:.4f}"
           for label, _, _ in KV8_LAYER_WEIGHTS},
        plain_ms=f"{row['plain_ms']:.4f}", library_ms="null")
    return row


def mode5_kv8_bound(cfg, lw, hbm, peak, pos, fmt, window=0):
    """(bound ms, bound_by, bytes) of a mode-5 pair step without the LM
    head at tp 2 on one card: both ranks' shards of the four projections
    (the FFN at ``cfg.ffn_dim``) and the norms read once, the rows below
    pos (``fmt`` "bf16", or 8-bit: int8 with their scales; under a sliding
    ``window`` those at and above pos + 1 - window) and the row written, x
    in, x_out and the residual out."""
    lw = dict(lw)
    lw["w13"], lw["w2"] = ffn_unpadded(cfg, lw)
    L, kvh, hd = lw["wqkv_f"].shape[0], cfg.kv_heads, cfg.head_dim_

    def size(t):
        return t.q.numel() + 4 * t.s.numel() if hasattr(t, "q") \
            else t.numel() * t.element_size()

    def count(t):
        return t.q.numel() * (2 if t.kind == "int4" else 1) \
            if hasattr(t, "q") else t.numel()
    names = ("wqkv_f", "wo_f", "w13", "w2")
    wbytes = sum(size(lw[k]) for k in (*names, "attn_norm", "ffn_norm"))
    per_row = 2 * L * kvh * {"bf16": 2 * hd, "int8": hd + 4, "fp8": hd}[fmt]
    attended = min(pos + 1, window) if window else pos + 1
    nbytes = wbytes + per_row * attended + 3 * 2 * cfg.hidden_dim
    flops = 2 * sum(count(lw[k]) for k in names) + \
        4 * L * cfg.n_heads * hd * attended
    bound_by = "bytes" if nbytes / hbm >= flops / peak else "operations"
    return max(nbytes / hbm, flops / peak) * 1e3, bound_by, nbytes


def phase_kv8_mode5(eng, eng8, dev, hbm, peak, pos=600):
    """Phase 39: kernel 7's mode 5 with an ``Int8KV`` and an fp8 cache at
    tp 2 on this card (``phase_mode5`` with its cache kind: two virtual
    ranks against kernel 7's unsharded 8-bit step on the same cache, the
    ranks bit-identical, then the gathered-head form; 4 of the engine's
    bf16 layers at phase 15's limits, then all 32, where x_out and the
    residual may also stray 1.25 times phase 15's bf16 share, as phase 26
    holds int8 weights: the sharded and unsharded steps drift apart by a
    bf16 rounding a layer), then ``phase_fused_step`` on the same
    cache kind (8 steps of the fused tp-2 step after a 512-token prefill
    into the 8-bit cache, each rank's step one call of kernel 7's 8-bit
    mode 5), and once with int8 weights (4 layers of phase 26's tree, an
    fp8 cache).  The pair step's twin (``fused_decoder_stack_plain_ranks``)
    is timed once on the ranks' shards.  Returns the kernels-line rows by
    format and the fused steps' 8-bit launches."""
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    cfg, p = eng.cfg, eng.params
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    rows, launches = {}, {}
    for fmt in ("int8", "fp8"):
        phase = f"mode5_kv8_{fmt}"
        phase_mode5(eng, dev, pos=pos, phase=f"{phase}_4layers", kv=fmt,
                    params=dict(p, layers={k: w[:4] for k, w in
                                           p["layers"].items()}))
        shards = phase_mode5(eng, dev, pos=pos, phase=phase, kv=fmt,
                             drift=FIGURES.get("mode5_drift"))
        # the pair step's twin on the ranks' shards, timed once
        gen = torch.Generator(device=dev).manual_seed(39)
        kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
        kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                     device=dev).bfloat16()
        vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                     device=dev).bfloat16()
        kc, vc = kv8_cache(kc, vc, fmt, pos)
        lb = col.LoopbackComm(2, dev)
        try:
            meshes = [lb.mesh(r) for r in range(2)]
            x = p["embed"][torch.tensor([7], device=dev)]
            cos, sin = model.rope_row(cfg, pos, dev)
            rank_args = []
            for r, m in enumerate(meshes):
                sl = shards[r]["layers"]
                rank_args.append((x, sl["attn_norm"], sl["ffn_norm"], cos, sin,
                                  sl["wqkv_f"], sl["wo_f"], sl["w13"],
                                  sl["w2"], par.shard_cache(kc, m),
                                  par.shard_cache(vc, m), pos))
        finally:
            lb.close()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sk.fused_decoder_stack_plain_ranks(
            rank_args, group=g, head_dim=hd, rope_style=cfg.rope_style,
            eps=cfg.norm_eps)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        del rank_args, kc, vc
        bound, bound_by, nbytes = mode5_kv8_bound(cfg, p["layers"], hbm, peak,
                                                  pos, fmt)
        ms = FIGURES[f"{phase}_pair_ms"]
        rows[fmt] = dict(max_abs_err=FIGURES[f"{phase}_max_abs_err"], ms=ms,
                         plain_ms=plain_ms, bound_ms=bound,
                         bound_by=bound_by, library_ms=None)
        phase_fused_step(eng, dev, shards, n=8,
                         phase=f"fused_step_kv8_{fmt}", kv=fmt)
        launches[fmt] = FIGURES[f"fused_step_kv8_{fmt}_kv8_launches"]
        say(phase, kernel=7, kv=fmt, pair_ms=f"{ms:.3f}",
            bf16_pair_ms=(f"{FIGURES['mode5_pair_ms']:.3f}"
                          if "mode5_pair_ms" in FIGURES else "not measured"),
            plain_ms=f"{plain_ms:.2f}", bound_ms=f"{bound:.4f}",
            bound_by=bound_by, bytes=nbytes, library_ms="null",
            fused_step_kv8_launches=launches[fmt])
        del shards
        torch.cuda.empty_cache()
    tree8 = int8_head_tree(eng8.params)
    shards8 = phase_mode5(eng8, dev, pos=pos, kv="fp8",
                          phase="mode5_kv8_fp8_int8_4layers",
                          params=dict(tree8, layers={
                              k: w[:4] for k, w in tree8["layers"].items()}))
    del tree8, shards8
    torch.cuda.empty_cache()
    return rows, launches


def phase_kv8_sharded(eng, dev):
    """Phase 40: the tp, sp and fused tp steps on 8-bit caches end to end
    in the one-rank NCCL group of phase 14: a 512-token prefill (kernel 4)
    into an fp8 and an ``Int8KV`` cache, then 32 greedy steps of the fp8
    tp step, 8 of the fp8 sp step, and 32 of the fused tp step with each
    format.  Before each stream one teacher-forced step against the plain
    twin (the kernel-6 steps: every layer's call against kernel 6's twin,
    ``LayerTwinCheck``; the fused step: against
    ``fused_decoder_stack_plain`` at phase 4's limits, ``kv8_vs_plain``),
    since random 7B weights repeat a token; each stream against kernel 7's
    single-card step on the same 8-bit cache, teacher-forced, under the
    top-2-gap rule.  Counts are set to 0 just before each stream and read
    just after: kernel 6's fp8 launches (L a step) or kernel 7's 8-bit
    ones (one a step).  ms per step and tokens/s beside phase 14's bf16-KV
    steps.  Returns {"k6_fp8": kernel 6's fp8 launches in the tp and sp
    streams, "k7_int8", "k7_fp8": kernel 7's in the fused streams}."""
    import torch.distributed as dist
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import MeshConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import decode as par_decode
    from clusterfusion_tpu_torch.parallel import sp_decode as par_sp
    cfg, L = eng.cfg, eng.cfg.n_layers
    lw = eng.params["layers"]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    launched = {"k6_fp8": 0}
    try:
        mesh = par.build_mesh(MeshConfig())
        params = par.shard_params(eng.params, cfg, mesh)
        text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
        prompt = eng.tokenizer.encode(text, bos=True, eos=False)
        for fmt, kv_dtype in (("fp8", torch.float8_e4m3fn), ("int8", "int8")):
            k0, v0 = model.init_cache(cfg, device=dev, dtype=kv_dtype)
            lg, k0, v0 = model.prefill(eng.params, k0, v0, prompt, cfg)
            first, pos0 = int(torch.argmax(lg[-1])), len(prompt)
            runs = [("fused", 32, par.make_sharded_decode_step,
                     par.cache_pspec(), None)]
            if fmt == "fp8":
                runs = [("tp", 32, par.make_sharded_decode_step,
                         par.cache_pspec(), par_decode),
                        ("sp", 8, par.make_sp_sharded_decode_step,
                         par.cache_pspec_2d(), par_sp)] + runs
            for name, n, make, spec, mod in runs:
                step = make(cfg, mesh, fused_collectives=True) \
                    if name == "fused" else make(cfg, mesh)

                def fresh():
                    return (par.shard_cache(kv_take(k0, 0, L), mesh, spec),
                            par.shard_cache(kv_take(v0, 0, L), mesh, spec))
                kc, vc = fresh()
                if mod is not None:     # every layer against kernel 6's twin
                    with LayerTwinCheck(mod) as chk:
                        step(params, kc, vc, first, pos0)
                    torch.cuda.synchronize()
                    twin = dict(held="each layer against kernel 6's twin, "
                                     "teacher-forced",
                                layer_calls=chk.calls,
                                worst_out_err=f"{chk.worst[0]:.3g}",
                                worst_row_err=f"{chk.worst[1]:.3g}",
                                past_limits=chk.bad)
                    twin_ok = not chk.bad and chk.calls == L
                else:                   # the whole step against its twin
                    kp, vp = fresh()
                    lg1, _, _ = step(params, kc, vc, first, pos0)
                    cos, sin = model.rope_row(cfg, pos0, dev)
                    x = eng.params["embed"][torch.tensor([first], device=dev)]
                    ref = sk.fused_decoder_stack_plain(
                        x, lw["attn_norm"], lw["ffn_norm"], cos, sin,
                        lw["wqkv_f"], lw["wo_f"], lw["w13"], lw["w2"], kp, vp,
                        pos0, group=cfg.n_heads // cfg.kv_heads,
                        head_dim=cfg.head_dim_, rope_style=cfg.rope_style,
                        eps=cfg.norm_eps, final_norm=eng.params["final_norm"],
                        lm_head=eng.params["lm_head"])
                    # the step returns no residual: its logits stand in
                    # for kv8_vs_plain's finiteness check of one
                    _, twin_ok = kv8_vs_plain(
                        "kv8_sharded", fmt, (lg1[None], lg1[None]), ref, kc,
                        vc, kp, vp, pos0, 1, step=name,
                        check="teacher-forced step against the plain twin")
                    twin = dict(held="the step against "
                                     "fused_decoder_stack_plain, "
                                     "teacher-forced")
                    del kp, vp
                kc, vc = fresh()
                tok = torch.tensor(first, device=dev)
                dl.launches = dl.fp8_launches = sk.launches = 0
                for k in sk.kv8_launches:
                    sk.kv8_launches[k] = 0
                out = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(n):
                    lg, kc, vc = step(params, kc, vc, tok, pos0 + i)
                    tok = torch.argmax(lg)
                    out.append(tok)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                got = dict(kernel6=dl.launches, kernel6_fp8=dl.fp8_launches,
                           kernel7=sk.launches,
                           kernel7_kv8=sum(sk.kv8_launches.values()))
                want = dict(kernel6=0, kernel6_fp8=0, kernel7=n,
                            kernel7_kv8=n) if name == "fused" else dict(
                    kernel6=L * n, kernel6_fp8=L * n, kernel7=0,
                    kernel7_kv8=0)
                if name == "fused":
                    launched[f"k7_{fmt}"] = got["kernel7_kv8"]
                else:
                    launched["k6_fp8"] += got["kernel6_fp8"]
                toks = [int(t) for t in out]
                finite = bool(torch.isfinite(lg).all())
                ref, gaps, bad = check_against_stack(eng.params, cfg, k0, v0,
                                                     pos0, first, toks)
                bf16 = FIGURES.get(f"sharded_{name}_ms_per_step")
                say("kv8_sharded", step=name, kv=fmt,
                    mesh="tp=1,sp=1 (one rank, nccl)", prompt_tokens=pos0,
                    new_tokens=n, ms_per_step=f"{dt * 1e3 / n:.3f}",
                    tokens_per_s=f"{n / dt:.2f}",
                    bf16_kv_ms_per_step=("not measured" if bf16 is None
                                         else f"{bf16:.3f}"),
                    launches=got, finite=finite, tokens=toks[:8],
                    kernel7_tokens=ref[:8],
                    agree=f"{sum(a == b for a, b in zip(ref, toks))}/{n}",
                    disagree_where_gap_gt_0_1=bad,
                    min_top2_gap=f"{min(gaps):.3g}", **twin)
                if got != want or not finite or bad or not twin_ok:
                    raise AssertionError(
                        f"the {name} step on an {fmt} cache: launches {got} "
                        f"(want {want}), kernel 7 agreement ({bad}) or the "
                        "twin check wrong")
                del kc, vc
            del k0, v0
    finally:
        dist.destroy_process_group()
    return launched


# -- fp8 e4m3 pools in kernels 9 and 10, fp8 serving (phases 41-43) ----------

FP8 = torch.float8_e4m3fn


def _same_bytes(a, b) -> bool:
    """Byte equality of two tensors of one dtype and shape (NaN too)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def appended_rows(pool, table, lens, layer):
    """The row each request's append wrote, [B, kv, hd] in the pool's dtype
    (``lens`` before the call)."""
    page = pool.shape[3]
    return torch.stack([pool[layer, int(table[b, n // page]), :, n % page]
                        .view(torch.uint8)
                        for b, n in enumerate(lens.tolist())]).view(pool.dtype)


def fp8_appends_check(got_k, got_v, want_k, want_v, table, lens, layer,
                      k0, v0):
    """The appended e4m3 rows of two pools within one code of the twin's
    (``e4m3_one_step``; the share of equal bytes) and every other byte of
    the kernel's pools as before the call."""
    app = append_mask(got_k, table, lens, layer)
    near_k, eq_k = e4m3_one_step(appended_rows(got_k, table, lens, layer),
                                 appended_rows(want_k, table, lens, layer))
    near_v, eq_v = e4m3_one_step(appended_rows(got_v, table, lens, layer),
                                 appended_rows(want_v, table, lens, layer))
    untouched = (torch.equal(got_k.view(torch.uint8)[~app],
                             k0.view(torch.uint8)[~app])
                 and torch.equal(got_v.view(torch.uint8)[~app],
                                 v0.view(torch.uint8)[~app]))
    return near_k and near_v, min(eq_k, eq_v), untouched


def fp8_bound(hbm, peak, n_rows, kv, g, hd, B, other_bytes, flops):
    """(bound ms, what bounds it, bytes): ``other_bytes`` plus the e4m3 K
    and V rows below lens read once, and ``flops`` plus the walk's."""
    nbytes = other_bytes + 2 * n_rows * kv * hd
    flops = flops + 4 * kv * g * hd * (n_rows + B)
    bound = max(nbytes / hbm, flops / peak) * 1e3
    return bound, "bytes" if nbytes / hbm >= flops / peak else "operations", \
        nbytes


def phase_fp8_paged_attention(dev, hbm, peak):
    """Phase 41: kernel 10 on fp8 e4m3 pools, at phase 6's Llama-2-7B
    geometry (kv 32, group 1, B 8, ``SERVE_LENS``) and at Llama-3-8B's GQA
    geometry (``LlamaConfig.llama3_8b()``: kv 8, group 4, hd 128), page 16,
    NaN (0x7f) in every pool row no request owns: against
    ``paged_attention_plain`` on copies of the same pools at phase 6's
    limits (o atol 2e-2 / rtol 2e-2, each head's row within 2 % of its
    largest value), the appended e4m3 codes within one code of the twin's
    (both store e4m3 of the same bf16 row: the share of equal bytes is
    printed), every other byte unchanged, a repeat bit-identical, one fp8
    launch a call.  Then ``queued_ms`` of the call beside kernel 10 on bf16
    pools holding the same values (the busy ms of the split and merge
    apart beside each), the twin's time and the byte bound.  Returns the
    kernels-line row of the 7B geometry."""
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    gen = torch.Generator(device=dev).manual_seed(41)
    c3 = LlamaConfig.llama3_8b()
    rows = {}
    for label, kv, g in (("llama2_7b", 32, 1),
                         ("llama3_8b_gqa", c3.kv_heads,
                          c3.n_heads // c3.kv_heads)):
        hd, page, L, layer, B = 128, 16, 2, 1, len(SERVE_LENS)
        kb, vb, table, lens = paged_pools(dev, L, kv, hd, page, SERVE_LENS, 41)
        nan_unowned(kb, vb, table, lens)
        kp, vp = kb.to(FP8), vb.to(FP8)
        kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)  # same values
        q = torch.randn((B, kv, g, hd), generator=gen, device=dev).bfloat16()
        k_new = torch.randn((B, kv, hd), generator=gen, device=dev).bfloat16()
        v_new = torch.randn((B, kv, hd), generator=gen, device=dev).bfloat16()
        k0, v0 = kp.clone(), vp.clone()
        k2, v2 = kp.clone(), vp.clone()
        kr, vr = kp.clone(), vp.clone()
        before = pd.launches["paged_attention_fp8"]
        out, _, _ = pd.paged_attention(q, k_new, v_new, kp, vp, table, lens,
                                       layer)
        again, _, _ = pd.paged_attention(q, k_new, v_new, k2, v2, table, lens,
                                         layer)
        launched = pd.launches["paged_attention_fp8"] - before
        ref, _, _ = pd.paged_attention_plain(q, k_new, v_new, kr, vr, table,
                                             lens, layer)
        torch.cuda.synchronize()
        repeat = (_same_bits(out, again) and _same_bytes(kp, k2)
                  and _same_bytes(vp, v2))
        finite = bool(torch.isfinite(out.float()).all())
        max_abs = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), **LIMITS_TOL)
        row_rel = row_rel_err(out, ref, hd)
        near, eq_share, untouched = fp8_appends_check(
            kp, vp, kr, vr, table, lens, layer, k0, v0)
        say("paged_attention_fp8", kernel=10, kv_pool="fp8", shape=label, B=B,
            kv=kv, group=g, page=page, lens=SERVE_LENS,
            max_abs_err=f"{max_abs:.3g}", tol="atol=2e-2,rtol=2e-2",
            row_rel_err=f"{row_rel:.3g}", tol_row_rel=ROW_REL_TOL,
            appended_within_one_code=near,
            appended_bytes_equal_share=f"{eq_share:.4f}",
            other_bytes_unchanged=untouched, nan_unowned_rows=True,
            repeat_bit_identical=repeat, finite=finite, fp8_launches=launched)
        if not (repeat and finite and row_rel <= ROW_REL_TOL and near
                and untouched and launched == 2):
            raise AssertionError(f"kernel 10 on fp8 pools ({label}) disagrees "
                                 "with its twin or itself, or its pools")
        del k2, v2, again, k0, v0
        call = lambda: pd.paged_attention(  # noqa: E731
            q, k_new, v_new, kp, vp, table, lens, layer)
        bf16_call = lambda: pd.paged_attention(  # noqa: E731
            q, k_new, v_new, kb, vb, table, lens, layer)
        ms, by_pass = row_ms(call, PAGED_PASSES)
        bf16_ms, bf16_pass = row_ms(bf16_call, PAGED_PASSES)
        plain_ms = time_ms(lambda: pd.paged_attention_plain(
            q, k_new, v_new, kr, vr, table, lens, layer), 5)
        n_rows = sum(SERVE_LENS)
        # q in, o out, k/v_new in (bf16); the appended e4m3 rows
        io = 2 * 2 * q.numel() + 2 * 2 * B * kv * hd + 2 * B * kv * hd
        bound, bound_by, nbytes = fp8_bound(hbm, peak, n_rows, kv, g, hd, B,
                                            io, 0)
        bf16_bound = max((nbytes + 2 * n_rows * kv * hd) / hbm,
                         4 * kv * g * hd * (n_rows + B) / peak) * 1e3
        say("paged_attention_fp8", kernel=10, kv_pool="fp8", shape=label,
            queued_ms=f"{ms:.4f}", split_ms=f"{by_pass['split']:.4f}",
            merge_ms=f"{by_pass['merge']:.4f}",
            bf16_pool_queued_ms_same_values=f"{bf16_ms:.4f}",
            bf16_split_ms=f"{bf16_pass['split']:.4f}",
            bf16_merge_ms=f"{bf16_pass['merge']:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
            bound_by=bound_by, bf16_pool_bound_ms=f"{bf16_bound:.4f}",
            bytes=nbytes, TBps=f"{nbytes / (ms * 1e-3) / 1e12:.3f}",
            library_ms="null")
        rows[label] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by, library_ms=None)
        del kp, vp, kb, vb, kr, vr
    return rows["llama2_7b"]


# (label, engine index) of the weights phase 42 runs kernel 9's fp8 mode on
FP8_LAYER_WEIGHTS = (("bf16", 0), ("int8", 1), ("int4_exact", 2))


def fp8_layer_case(pd, args, tail, kw, x, res, kp, vp, table, lens, layer):
    """One checked call of kernel 9 on fp8 pools (``phase_fp8_paged_layer``):
    (max error, rows within one code, equal share, other bytes unchanged,
    repeat bit-identical, finite, fp8 launches of its two calls, the twin's
    pools)."""
    k0, v0 = kp.clone(), vp.clone()
    k2, v2 = kp.clone(), vp.clone()
    kr, vr = kp.clone(), vp.clone()
    before = pd.launches["llama_decoder_layer_paged_fp8"]
    out = pd.llama_decoder_layer_paged(x, res, *args, kp, vp, *tail, **kw)
    again = pd.llama_decoder_layer_paged(x, res, *args, k2, v2, *tail, **kw)
    launched = pd.launches["llama_decoder_layer_paged_fp8"] - before
    ref = pd.llama_decoder_layer_paged_plain(x, res, *args, kr, vr, *tail,
                                             **kw)
    torch.cuda.synchronize()
    repeat = (_same_bits(out[0], again[0]) and _same_bits(out[1], again[1])
              and _same_bytes(kp, k2) and _same_bytes(vp, v2))
    finite = bool(torch.isfinite(out[0].float()).all())
    max_abs = max((out[i].float() - ref[i].float()).abs().max().item()
                  for i in (0, 1))
    for i in (0, 1):
        torch.testing.assert_close(out[i].float(), ref[i].float(),
                                   **LIMITS_TOL)
    near, eq_share, untouched = fp8_appends_check(kp, vp, kr, vr, table, lens,
                                                  layer, k0, v0)
    return max_abs, near, eq_share, untouched, repeat, finite, launched, \
        (kr, vr)


def phase_fp8_paged_layer(eng, eng8, eng4, dev, hbm, peak):
    """Phase 42: kernel 9 on fp8 e4m3 pools at phase 7's geometry (layer 1
    of the 7B engines, page 16; B 4 with the engine's padding rows and B 1
    at 2047 rows, and B 8 at ``SERVE_LENS`` with bf16 weights), NaN (0x7f)
    in every pool row no request owns, with bf16, int8 and int4 (exact)
    weights; then one hd-64 layer (random weights at TinyLlama-1.1B's
    widths: hidden 2048, 32 heads of 64, kv 4; B 8) whose append stores
    e4m3 of the bf16 row (the TPU wrapper's scatter), where the 7B layers
    store e4m3 of the float32 row.  Each against
    ``llama_decoder_layer_paged_plain`` on copies of the pools at phase
    7's limits (out and res_out atol 2e-2 / rtol 2e-2), the appended codes
    within one code of the twin's (e4m3 of float32 rows that differ by a
    sum order; the share of equal bytes printed), every other byte
    unchanged, a repeat bit-identical, one fp8 launch a call.
    ``queued_ms`` of each weight kind at B 4 beside the same layer on bf16
    pools holding the same values, the twin's time and the byte bound.
    Returns the kernels-line row (bf16 weights, B 4)."""
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    cfg = eng.cfg
    g, hd, kv, hidden = (cfg.n_heads // cfg.kv_heads, cfg.head_dim_,
                         cfg.kv_heads, cfg.hidden_dim)
    cos_t, sin_t = model.rope_table(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    layer, page = 1, 16
    kw = dict(group=g, rope_style=cfg.rope_style)
    engines = (eng, eng8, eng4)
    row = None
    for B, lens_l in ((4, [128, 0, 0, 0]), (8, SERVE_LENS),
                      (1, SERVE_LENS[-1:])):
        kb, vb, table, lens = paged_pools(dev, 2, kv, hd, page, lens_l, 42)
        x = torch.randn((B, hidden), generator=gen, device=dev).bfloat16()
        res = torch.randn((B, hidden), generator=gen, device=dev).bfloat16()
        if B == 4:          # padding rows as the engine pads them
            table[1:] = 0
            x[2:], res[2:] = x[1], res[1]
        nan_unowned(kb, vb, table, lens)
        k8, v8 = kb.to(FP8), vb.to(FP8)
        kb, vb = k8.to(torch.bfloat16), v8.to(torch.bfloat16)
        for label, which in FP8_LAYER_WEIGHTS:
            if B == 8 and label != "bf16":
                continue
            lw = engines[which].params["layers"]
            args = (lw["wqkv_f"], lw["wo_f"], table, lens, lens)
            tail = (layer, lw["attn_norm"][layer], cfg.norm_eps, cos_t, sin_t)
            kp, vp = k8.clone(), v8.clone()
            max_abs, near, eq_share, untouched, repeat, finite, launched, \
                (kr, vr) = fp8_layer_case(pd, args, tail, kw, x, res, kp, vp,
                                          table, lens, layer)
            timed = {}
            if B == 4:
                timed = dict(
                    queued_ms=queued_ms(functools.partial(
                        pd.llama_decoder_layer_paged, x, res, *args, kp, vp,
                        *tail, **kw)),
                    bf16_pool_queued_ms_same_values=queued_ms(
                        functools.partial(pd.llama_decoder_layer_paged, x, res,
                                          *args, kb, vb, *tail, **kw)))
            say("paged_layer_fp8", kernel=9, kv_pool="fp8", weights=label, B=B,
                lens=lens_l, max_abs_err=f"{max_abs:.3g}",
                tol="atol=2e-2,rtol=2e-2", append_rule="e4m3(float32 row)",
                appended_within_one_code=near,
                appended_bytes_equal_share=f"{eq_share:.4f}",
                other_bytes_unchanged=untouched, nan_unowned_rows=True,
                repeat_bit_identical=repeat, finite=finite,
                fp8_launches=launched,
                **{k: f"{v:.4f}" for k, v in timed.items()})
            if not (near and untouched and repeat and finite
                    and launched == 2):
                raise AssertionError(f"kernel 9 on fp8 pools ({label} "
                                     f"weights, B {B}) disagrees with its "
                                     "twin or itself, or its pools")
            if B == 4 and label == "bf16":
                plain_ms = time_ms(functools.partial(
                    pd.llama_decoder_layer_paged_plain, x, res, *args, kr, vr,
                    *tail, **kw), 3, warmup=1)
                w_elems = lw["wqkv_f"][layer].numel() + lw["wo_f"][layer].numel()
                io = 2 * (w_elems + 4 * B * hidden + hidden) + 2 * B * kv * hd
                bound, bound_by, nbytes = fp8_bound(
                    hbm, peak, sum(lens_l), kv, g, hd, B, io, 2 * B * w_elems)
                say("paged_layer_fp8", kernel=9, kv_pool="fp8", weights=label,
                    B=B, plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
                    bound_by=bound_by, bytes=nbytes, library_ms="null")
                row = dict(max_abs_err=max_abs, ms=timed["queued_ms"],
                           plain_ms=plain_ms, bound_ms=bound,
                           bound_by=bound_by, library_ms=None)
            del kp, vp, kr, vr
        del k8, v8, kb, vb
    # hd 64: the append stores e4m3 of the bf16 row (rule of the TPU
    # wrapper's scatter); random weights at TinyLlama-1.1B's widths
    ct = LlamaConfig.tinyllama_1b()
    kvt, gt, hdt, hid = ct.kv_heads, ct.n_heads // ct.kv_heads, ct.head_dim_, \
        ct.hidden_dim
    G, hg = 2, ct.kv_heads // 2
    B = len(SERVE_LENS)
    wq = (torch.randn((G, hid, hg * (gt + 2) * hdt), generator=gen,
                      device=dev) * hid ** -0.5).bfloat16()
    wo = (torch.randn((G, hg * gt * hdt, hid), generator=gen, device=dev)
          * (kvt * gt * hdt) ** -0.5).bfloat16()
    norm = (1 + 0.1 * torch.randn((hid,), generator=gen, device=dev)).bfloat16()
    x = torch.randn((B, hid), generator=gen, device=dev).bfloat16()
    res = torch.randn((B, hid), generator=gen, device=dev).bfloat16()
    kb, vb, table, lens = paged_pools(dev, 2, kvt, hdt, page, SERVE_LENS, 43)
    nan_unowned(kb, vb, table, lens)
    kp, vp = kb.to(FP8), vb.to(FP8)
    cos_s, sin_s = model.rope_table(ct, device=dev)
    args = (wq, wo, table, lens, lens)
    tail = (layer, norm, ct.norm_eps, cos_s, sin_s)
    kwt = dict(group=gt, rope_style=ct.rope_style)
    max_abs, near, eq_share, untouched, repeat, finite, launched, (kr, vr) = \
        fp8_layer_case(pd, args, tail, kwt, x, res, kp, vp, table, lens, layer)
    say("paged_layer_fp8", kernel=9, kv_pool="fp8", weights="bf16 (random)",
        model="tinyllama_1b widths", hd=hdt, kv=kvt, group=gt, B=B,
        lens=SERVE_LENS, max_abs_err=f"{max_abs:.3g}",
        tol="atol=2e-2,rtol=2e-2", append_rule="e4m3(bf16 row)",
        appended_within_one_code=near,
        appended_bytes_equal_share=f"{eq_share:.4f}",
        other_bytes_unchanged=untouched, nan_unowned_rows=True,
        repeat_bit_identical=repeat, finite=finite, fp8_launches=launched)
    if not (near and untouched and repeat and finite and launched == 2):
        raise AssertionError("kernel 9 on fp8 pools at hd 64 disagrees with "
                             "its twin or itself, or its pools")
    return row


# the fp8 serving step's drift from its plain-twin step at full depth, as a
# multiple of the bf16-pool step's drift measured in the same phase (the
# multiple phases 22 and 31 allow int8 and int4 weights; on an H100 the fp8
# pools drifted 0.96x (batched) and 0.82x (fused) as far as bf16 pools)
FP8_STEP_DRIFT = 1.25


def step_busy_ms(fn, reps=2):
    """Device busy ms of one call of a serving step (``timeline_by_pass``
    over ``reps`` calls: a 7B step is ~2000 kernels, and fewer calls keep
    each profile small), ``queued_ms`` where no profile kept its events."""
    try:
        return timeline_by_pass(fn, (), reps)[0]
    except profiling.LostEvents:
        profiling.note(no_device_events=True, busy_ms_from="queued_ms")
        return queued_ms(fn)


def fp8_step_vs_plain(eng, dev):
    """Phase 43 (a): ``step_vs_plain`` on fp8 pools (e4m3 of the random rows,
    NaN in every unowned row), both step kinds, against the same step on
    the plain twins.  At ``STEP_CHECK_DEPTH`` layers: the logits within
    2e-2 of the largest logit, layer 0's appended rows within one e4m3 code
    of the twin's (the rows they store differ by a sum order at most),
    every layer's within atol 0.08 + rtol 0.125 of its largest |row| (one
    e4m3 step), every other byte unchanged, the requests' plain logits
    apart by more than the limit.  At all 32 layers, the fp8 step's logits
    no further from its twin's than ``FP8_STEP_DRIFT`` times the bf16-pool
    step's from its own, measured here on the same weights, table and
    tokens."""
    for impl, r in step_vs_plain(eng, dev, STEP_CHECK_DEPTH,
                                 kv_dtype=FP8).items():
        err, mag = r["row_err"], r["row_mag"]
        rows_ok = r["codes0"][0] and all(e <= 0.08 + 0.125 * m
                                         for e, m in zip(err, mag))
        say("serving_fp8_step", step=impl, kv_pool="fp8", B=len(SERVE_LENS),
            layers=r["layers"], lens=SERVE_LENS,
            logits_err_over_max=f"{r['logits_rel']:.4g}", tol_logits=2e-2,
            least_request_spread_over_max=f"{r['spread']:.4g}",
            layer0_rows_within_one_code=r["codes0"][0],
            layer0_bytes_equal_share=f"{r['codes0'][1]:.4f}",
            kv_rows_err_by_layer=[round(x, 4) for x in err],
            kv_rows_max_abs=f"{max(mag):.3g}", tol_rows="atol=0.08+rtol=0.125",
            other_bytes_unchanged=r["unchanged"], nan_unowned_rows=True,
            finite=r["finite"])
        if not (r["logits_rel"] <= 2e-2 and rows_ok and r["unchanged"]
                and r["finite"] and r["spread"] > 2e-2):
            raise AssertionError(f"the {impl} serving step on fp8 pools "
                                 "disagrees with the same step on the plain "
                                 "twins")
    full8, full16 = step_vs_plain(eng, dev, kv_dtype=FP8), step_vs_plain(eng,
                                                                         dev)
    for impl, r in full8.items():
        b = full16[impl]
        say("serving_fp8_step", step=impl, kv_pool="fp8", layers=r["layers"],
            logits_err_over_max=f"{r['logits_rel']:.4g}",
            bf16_pool_logits_err_over_max=f"{b['logits_rel']:.4g}",
            tol=f"{FP8_STEP_DRIFT}x the bf16-pool step's",
            kv_rows_err_max=f"{max(r['row_err']):.4g}",
            bf16_pool_kv_rows_err_max=f"{max(b['row_err']):.4g}",
            other_bytes_unchanged=r["unchanged"], finite=r["finite"])
        if not (r["logits_rel"] <= FP8_STEP_DRIFT * b["logits_rel"]
                and r["unchanged"] and r["finite"] and b["unchanged"]
                and b["finite"]):
            raise AssertionError(f"the {impl} serving step on fp8 pools "
                                 "drifts from its twin more than "
                                 f"{FP8_STEP_DRIFT}x the bf16-pool step")


def phase_fp8_serving(eng, dev):
    """Phase 43: ``ServingEngine(kv_dtype=torch.float8_e4m3fn)``.  First
    ``fp8_step_vs_plain``; then phase 8's mix (page 16, eight requests of
    32-512 prompt tokens, 32 new each) through the batched step (kernel 10
    on e4m3 pools) and the fused step (kernel 9 on them), each beside the
    same run on bf16 pools in this phase: tokens/s, ms a step and the
    device busy ms of one step at ``SERVE_LENS`` (``busy_ms``: walls swing
    between runs, so busy time is the figure to compare), the fp8
    launches (once per layer and step), every token in range, request 3
    alone equal to its tokens in the batch; then ``Llama.generate`` with an
    fp8 cache at B 1 (the fused step) and B 4 (the batched one), each
    request 0 against the plain path on an fp8 cache (eager prefill and
    decode on the card) under the top-2-gap rule.  Returns the fp8
    launches of kernels 10 and 9 on that path (the serving runs and
    ``generate``)."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.runtime import ServingEngine
    serving = importlib.import_module("clusterfusion_tpu_torch.runtime.serving")
    t0 = time.perf_counter()
    fp8_step_vs_plain(eng, dev)
    seconds = dict(step_checks=time.perf_counter() - t0)
    cfg = eng.cfg
    text = "Serving many users at once on one card, page by page. " * 12
    prompts = [eng.tokenizer.encode(text[:n - 1], bos=True, eos=False)
               for n in (32, 64, 128, 200, 256, 300, 400, 512)]
    n_new = 32
    L, kv, hd, page = cfg.n_layers, cfg.kv_heads, cfg.head_dim_, 16
    _, _, table, lens = paged_pools(dev, 1, kv, hd, page, SERVE_LENS, 43)
    shape = (L, int(table.max()) + 1, kv, page, hd)
    tokens = torch.arange(len(SERVE_LENS), device=dev) * 7 + 3
    rope = model.rope_table(cfg, device=dev)
    temps, tops = [0.0] * len(SERVE_LENS), [0.9] * len(SERVE_LENS)
    steps = dict(batched=serving._paged_decode_step_batched,
                 fused=serving._paged_decode_step)
    counter = dict(batched="paged_attention", fused="llama_decoder_layer_paged")
    launch = dict(paged_attention=0, layer=0)
    figures = {}

    def serve(batch, impl, kv_dtype, timed=False, new=n_new):
        srv = ServingEngine(eng.params, cfg, page_size=16, num_pages=136,
                            max_batch=8, step_impl=impl, kv_dtype=kv_dtype)
        step_s = []
        if timed:
            real_step = srv._step

            def timed_step(*a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real_step(*a)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                return out

            srv._step = timed_step
        for i in batch:
            srv.submit(i, prompts[i], new, temperature=0.0)
        return srv.run(), step_s, srv.k_pool.dtype

    for impl in ("batched", "fused"):
        for pool in ("bf16", "fp8"):
            t0 = time.perf_counter()
            kv_dtype = FP8 if pool == "fp8" else torch.bfloat16
            serve([0], impl, kv_dtype, new=2)              # warm-up
            pd.launches.update(dict.fromkeys(pd.launches, 0))
            out, step_s, pool_dtype = serve(range(len(prompts)), impl,
                                            kv_dtype, timed=True)
            got = dict(pd.launches)
            n_steps = len(step_s)
            decode_tokens = sum(len(t) for t in out.values()) - len(prompts)
            kp = torch.zeros(shape, device=dev, dtype=kv_dtype)
            vp = torch.zeros_like(kp)
            t1 = time.perf_counter()
            busy = step_busy_ms(functools.partial(
                steps[impl], eng.params, kp, vp, tokens, lens, table, lens,
                None, temps, tops, cfg, rope))
            seconds[f"busy_{impl}_{pool}"] = time.perf_counter() - t1
            del kp, vp
            figures[impl, pool] = dict(
                tokens_per_s=decode_tokens / sum(step_s),
                ms_per_step=sum(step_s) * 1e3 / n_steps, busy_ms=busy)
            fp8_count = got[counter[impl] + "_fp8"]
            say("serving_fp8", step=impl, kv_pool=pool, requests=len(prompts),
                new_tokens=n_new, decode_steps=n_steps,
                decode_tokens_per_s=f"{figures[impl, pool]['tokens_per_s']:.2f}",
                ms_per_step=f"{figures[impl, pool]['ms_per_step']:.3f}",
                device_busy_ms_per_step_at_serve_lens=f"{busy:.4f}",
                pool_dtype=str(pool_dtype),
                **{f"{k}_launches": v for k, v in got.items() if v})
            want = L * n_steps if pool == "fp8" else 0
            if got[counter[impl]] != L * n_steps or fp8_count != want or \
                    pool_dtype != kv_dtype:
                raise AssertionError(f"the {impl} step on {pool} pools did not "
                                     "launch its kernel once per layer and "
                                     "step")
            if any(len(t) != n_new or not all(0 <= x < cfg.vocab_size
                                              for x in t)
                   for t in out.values()):
                raise AssertionError(f"bad {pool}-pool serving output {out}")
            if pool == "fp8":
                launch["paged_attention" if impl == "batched" else "layer"] += \
                    fp8_count
                alone = serve([3], impl, kv_dtype)[0]
                say("serving_fp8", step=impl, kv_pool=pool,
                    request_3_alone_equal=alone[3] == out[3],
                    first_tokens=out[0][:8])
                if alone[3] != out[3]:
                    raise AssertionError(f"fp8-pool {impl} serving is not "
                                         "batching-invariant")
            seconds[f"serve_{impl}_{pool}"] = (time.perf_counter() - t0
                                               - seconds[f"busy_{impl}_{pool}"])
        f8, f16 = figures[impl, "fp8"], figures[impl, "bf16"]
        say("serving_fp8", step=impl,
            busy_ms_fp8_over_bf16=f"{f8['busy_ms'] / f16['busy_ms']:.4f}",
            tokens_per_s_fp8=f"{f8['tokens_per_s']:.2f}",
            tokens_per_s_bf16=f"{f16['tokens_per_s']:.2f}")
    t0 = time.perf_counter()
    e8 = Llama(eng.params, cfg, eng.tokenizer, fused=True, kv_dtype=FP8)
    for B in (1, 4):
        pd.launches.update(dict.fromkeys(pd.launches, 0))
        t0 = time.perf_counter()
        toks, _ = e8.generate(prompts[2:2 + B], 16, temperature=0.0)
        gen_s = time.perf_counter() - t0
        got = dict(pd.launches)
        plain, gaps, bad = check_against_plain(e8, dev, prompts[2], toks[0], 8)
        say("generate_fp8", B=B, step="fused" if B == 1 else "batched",
            kv_dtype="float8_e4m3fn", tokens=toks[0][:8], plain_tokens=plain,
            top2_gaps=[round(x, 3) for x in gaps],
            disagree_where_gap_gt_0_1=bad, wall_s=f"{gen_s:.3f}",
            **{f"{k}_launches": v for k, v in got.items() if v})
        k9, k10 = got["llama_decoder_layer_paged_fp8"], \
            got["paged_attention_fp8"]
        ran = (k9 >= cfg.n_layers and k10 == 0) if B == 1 else \
            (k10 >= cfg.n_layers and k9 == 0)
        if bad or not ran:
            raise AssertionError(f"generate with an fp8 cache at B {B}: "
                                 f"disagrees at {bad} or did not run its "
                                 "fp8 kernel")
        launch["layer"] += k9
        launch["paged_attention"] += k10
    seconds["generate"] = time.perf_counter() - t0
    say("serving_fp8", **{f"{k}_s": f"{v:.1f}" for k, v in seconds.items()})
    return launch


# -- head dim 64 in kernel 7 (phases 44-46) -----------------------------------

# (label, weight kind, KernelConfig.int4_w4a8, cache) of phase 44's runs
HD64_RUNS = (("bf16", "bf16", True, "bf16"), ("int8", "int8", True, "bf16"),
             ("int4_exact", "int4", False, "bf16"),
             ("int4_w4a8", "int4", True, "bf16"),
             ("bf16_kvint8", "bf16", True, "int8"),
             ("bf16_fp8", "bf16", True, "fp8"),
             ("int4_w4a8_kvint8", "int4", True, "int8"),
             ("int4_w4a8_fp8", "int4", True, "fp8"))
# the kernels line's rows: (name, run)
HD64_ROWS = (("fused_decoder_stack (hd 64)", "bf16"),
             ("fused_decoder_stack (hd 64, int4 + Int8KV)",
              "int4_w4a8_kvint8"))
HD64_LIB_NULL = ("no single PyTorch call computes a whole decode step (22 "
                 "layers, the attention over the cache and the LM head)")
# kernel 7's passes at hd 64, by kernel name (every weight and cache kind)
HD64_PASSES = (("split", "attn_split_kernel"), ("merge", "attn_merge"),
               ("gemv4", "ring_gemv4_kernel"), ("gemv8", "ring_gemv8_kernel"),
               ("gemv", "ring_gemv_kernel"), ("norms", "resnorm_kernel"))


def tinyllama_engines(dev):
    """Phases 44-46's engines: ``Llama.synthetic(tinyllama_1b)`` with seed
    0 in bf16 (head group 4, so G 1) and at JAX's operating point
    (``quant="int4"``, ``kv_dtype="int8"``: the same bf16 weights quantized
    in groups of 128, the LM head bf16, an ``Int8KV`` cache), and the int8
    tree of the same weights."""
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    t0 = time.perf_counter()
    cfg = LlamaConfig.tinyllama_1b()
    eng = Llama.synthetic(cfg, seed=0, fused=True, device=dev)
    eng4 = Llama.synthetic(cfg, seed=0, fused=True, quant="int4",
                           kv_dtype="int8", device=dev)
    tree8 = quantize_llama_params(eng.params, "int8")
    torch.cuda.synchronize()
    lw = eng.params["layers"]
    say("hd64_init", model="tinyllama_1b", layers=cfg.n_layers,
        hidden=cfg.hidden_dim, heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim_, ffn=cfg.ffn_dim, vocab=cfg.vocab_size,
        head_group=cfg.kv_heads // lw["wqkv_f"].shape[1],
        seconds=f"{time.perf_counter() - t0:.1f}")
    return eng, eng4, tree8


def phase_hd64_stack(eng7b, eng, eng4, tree8, dev, hbm, peak, pos=600,
                     cap=1024):
    """Phase 44: kernel 7 at head dim 64 (the TPU kernel's defer_append
    variant) at TinyLlama-1.1B's full width (22 layers, hidden 2048, 32
    heads on 4 kv heads, FFN 5632 padded to 6144, vocab 32000, neox rope;
    hg 4, G 1), capacity 1024, pos 600 over random rows with NaN above pos
    (an 8-bit cache: ``kv8_cache``, NaN scales or 0x7F bytes), with the LM
    head: bf16, int8, int4 exact and int4 W4A8 weights on a bf16 cache,
    bf16 and int4 W4A8 weights on an ``Int8KV`` and an fp8 cache
    (``HD64_RUNS``).  Each against its plain twin at phase 4's limits
    (``stack_vs_plain``; ``kv8_vs_plain`` with layer 0's scales within 2^-8
    and 99 % of its codes equal; W4A8 layer by layer, teacher-forced,
    ``hold_by_layer``), a repeat bit-identical, one launch counted (and
    one quantized and one 8-bit launch where they apply), 8L+2 kernels.
    Then each step's CUDA-event time, two readings in turns, beside the
    Llama-2-7B hd-128 step (phase 4's inputs made again) in the same
    turns, each step's device time (``queued_ms`` over 3 calls), the byte bound
    (``kv8_bound``) and, for the kernels line's two runs, the twin's time
    and the busy ms by pass (``HD64_PASSES``).  Returns {run: kernels-line
    row}."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    t0 = time.perf_counter()
    cfg = eng.cfg
    g, hd, L = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(44)
    shape = (L, cfg.kv_heads, cap, hd)
    kb = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vb = torch.randn(shape, generator=gen, device=dev).bfloat16()
    kb[:, :, pos + 1:] = float("nan")
    vb[:, :, pos + 1:] = float("nan")
    caches = {"bf16": (kb, vb)}
    for fmt, _ in KV8_FORMATS:
        caches[fmt] = kv8_cache(kb, vb, fmt, pos)
    trees = {"bf16": eng.params, "int8": tree8, "int4": eng4.params}
    cos, sin = model.rope_row(cfg, pos, dev)
    x = eng.params["embed"][torch.tensor([7], device=dev)]
    errs, steps, ok_all = {}, {}, True
    for label, kind, a8, kv in HD64_RUNS:
        p = trees[kind]
        lw = p["layers"]
        kcfg = KernelConfig(int4_w4a8=a8)
        kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                  eps=cfg.norm_eps, final_norm=p["final_norm"],
                  lm_head=p["lm_head"])
        args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
                lw["wo_f"], lw["w13"], lw["w2"])
        kc, vc = caches[kv]
        fresh = lambda: (kv_take(kc, 0, L), kv_take(vc, 0, L))  # noqa: E731
        kk, vk = fresh()
        k2, v2 = fresh()
        n0 = (sk.launches, sk.int8_launches + sk.int4_launches,
              sum(sk.kv8_launches.values()))
        out = sk.fused_decoder_stack(*args, kk, vk, pos, kcfg=kcfg, **kw)
        n_kernels = sk.last_step_kernels
        again = sk.fused_decoder_stack(*args, k2, v2, pos, kcfg=kcfg, **kw)
        torch.cuda.synchronize()
        counted = (sk.launches - n0[0],
                   sk.int8_launches + sk.int4_launches - n0[1],
                   sum(sk.kv8_launches.values()) - n0[2])
        every = torch.ones(cap, dtype=torch.bool, device=dev)
        repeat = (torch.equal(out[0], again[0])
                  and torch.equal(out[1].view(torch.int16),
                                  again[1].view(torch.int16))
                  and kv_same_bits(kk, k2, every)
                  and kv_same_bits(vk, v2, every))
        want_counted = (2, 2 * (kind != "bf16"), 2 * (kv != "bf16"))
        where = dict(kernel=7, head_dim=hd, run=label,
                     kernels_per_step=n_kernels, launches_counted=counted,
                     repeat_bit_identical=repeat)
        if kind == "int4" and a8:
            lg_err, ok = hold_by_layer(
                sk.fused_decoder_stack, sk.fused_decoder_stack_plain, args,
                kc, vc, pos, 1, L, kcfg, kw, "hd64_stack",
                rows_rtol=KV8_STEP.get(kv, 0.0), **where)
        else:
            kp, vp = fresh()
            ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos,
                                               int4_w4a8=a8, **kw)
            if kv == "bf16":
                lg_err, ok = stack_vs_plain("hd64_stack", out, ref, kk, vk,
                                            kp, vp, pos, layers=L, **where)
            else:
                lg_err, ok = kv8_vs_plain(
                    "hd64_stack", kv, out, ref, kk, vk, kp, vp, pos, 1,
                    scale_rtol=2.0 ** -8, equal_share=0.99, layers=L,
                    **where)
            del kp, vp, ref
        ok = (ok and repeat and counted == want_counted
              and n_kernels == 8 * L + 2)
        ok_all &= ok
        errs[label] = lg_err
        steps[label] = functools.partial(sk.fused_decoder_stack, *args, kk,
                                         vk, pos, kcfg=kcfg, **kw)
        del out, again, k2, v2
    if not ok_all:
        raise AssertionError("kernel 7 at hd 64 disagrees with its plain "
                             "twin, or its launches or repeats are wrong")
    check_s = time.perf_counter() - t0
    # the Llama-2-7B hd-128 step on phase 4's inputs, timed in the same turns
    cfg7 = eng7b.cfg
    p7, lw7 = eng7b.params, eng7b.params["layers"]
    gen = torch.Generator(device=dev).manual_seed(2)
    k7, v7 = model.init_cache(cfg7, max_seq=1024, device=dev)
    k7[:, :, :pos] = torch.randn(k7[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    v7[:, :, :pos] = torch.randn(v7[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    cos7, sin7 = model.rope_row(cfg7, pos, dev)
    steps["llama2_7b_hd128"] = functools.partial(
        sk.fused_decoder_stack, p7["embed"][torch.tensor([7], device=dev)],
        lw7["attn_norm"], lw7["ffn_norm"], cos7, sin7, lw7["wqkv_f"],
        lw7["wo_f"], lw7["w13"], lw7["w2"], k7, v7, pos,
        group=cfg7.n_heads // cfg7.kv_heads, head_dim=cfg7.head_dim_,
        rope_style=cfg7.rope_style, eps=cfg7.norm_eps,
        final_norm=p7["final_norm"], lm_head=p7["lm_head"])
    names = list(steps)
    ms = {k: [] for k in names}
    for k in names + names[::-1]:
        ms[k].append(time_ms(steps[k], 10))
    # 3 calls queued: a step is 178-258 kernels, and more calls overflow
    # the launch queue, so the host falls behind the card
    dev_ms = {k: queued_ms(f, 3) for k, f in steps.items()}
    rows = {}
    for label, kind, a8, kv in HD64_RUNS:
        bound, bound_by, nbytes = kv8_bound(cfg, trees[kind], hbm, peak, pos,
                                            1, kv)
        say("hd64_stack", run=label, pos=pos,
            ms_per_step=[f"{v:.4f}" for v in ms[label]],
            device_ms_per_step=f"{dev_ms[label]:.4f}",
            llama2_7b_hd128_ms_per_step=[f"{v:.4f}"
                                         for v in ms["llama2_7b_hd128"]],
            llama2_7b_hd128_device_ms=f"{dev_ms['llama2_7b_hd128']:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by, bytes_per_step=nbytes,
            ms_over_bound=f"{statistics.mean(ms[label]) / bound:.2f}")
        if label not in dict((r, n) for n, r in HD64_ROWS):
            continue
        plain_ms = time_ms(functools.partial(
            sk.fused_decoder_stack_plain, *steps[label].args[:9],
            kv_take(caches[kv][0], 0, L), kv_take(caches[kv][1], 0, L), pos,
            int4_w4a8=a8, **{k: v for k, v in steps[label].keywords.items()
                             if k != "kcfg"}), 1, warmup=0)
        rows[label] = dict(max_abs_err=errs[label],
                           ms=statistics.mean(ms[label]), plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by,
                           library_ms=None)
        # the split and merge passes at hd 64, by device time
        busy, by = busy_ms(steps[label], HD64_PASSES)
        say("hd64_stack_device", run=label, pos=pos, busy_ms=f"{busy:.4f}",
            **{f"{k}_ms": f"{v:.4f}" for k, v in by.items()},
            split_us_per_layer=f"{by['split'] * 1e3 / L:.2f}",
            merge_us_per_layer=f"{by['merge'] * 1e3 / L:.2f}",
            note="each kernel charged from the end of those before it to its "
                 "own end", library_ms="null: " + HD64_LIB_NULL)
    del steps, caches, kb, vb, k7, v7
    torch.cuda.empty_cache()
    say("hd64_stack", check_s=f"{check_s:.1f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    return rows


def phase_hd64_e2e(eng, eng4, dev):
    """Phase 45: TinyLlama-1.1B's bs=1 stream, as phase 5 runs the 7B one:
    ``stream_generate`` of 64 greedy tokens after a 512-token prompt, in
    bf16 and at the JAX package's operating point (int4 W4A8 weights, an
    ``Int8KV`` cache), counts set to 0 just before and read just after
    (kernel 4 once a layer, kernel 7 once a step, 8-bit and int4 launches
    as each applies); tokens/s, ms a step, the prefill's ms and one step's
    device busy ms (``busy_ms`` by pass); the first 8 tokens against the
    plain path under the top-2-gap rule (bf16: the eager prefill and
    step; the operating point: the eager prefill into an ``Int8KV`` cache
    and kernel 7's plain twin in W4A8, ``stack_plain_step``).  Returns
    {run: kernel 7's launches}."""
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    t0 = time.perf_counter()
    cfg = eng.cfg
    text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
    prompt = eng.tokenizer.encode(text, bos=True, eos=False)
    launches = {}
    for run, e, plain_step in (("bf16", eng, None),
                               ("int4_w4a8_kvint8", eng4,
                                stack_plain_step(True))):
        # a warm stream first: the timed run below pays no first-call costs
        list(e.stream_generate(prompt[:32], 4, temperature=0.0))
        torch.cuda.synchronize()
        fp.launches = sk.launches = 0
        sk.int8_launches = sk.int4_launches = 0
        for k in sk.kv8_launches:
            sk.kv8_launches[k] = 0
        stamps, toks = [], []
        for t in e.stream_generate(prompt, 64, temperature=0.0):
            stamps.append(time.perf_counter())
            toks.append(t)
        got = dict(flash_prefill=fp.launches, stack=sk.launches,
                   stack_int4=sk.int4_launches,
                   stack_kv8=sum(sk.kv8_launches.values()))
        decode_s = stamps[-1] - stamps[0]
        quant = run != "bf16"
        ran = (got["flash_prefill"] == cfg.n_layers
               and got["stack"] >= len(toks) - 1
               and got["stack_int4"] == got["stack"] * quant
               and got["stack_kv8"] == got["stack"] * quant)
        # one step's device time at the prompt's end, by pass
        kc, vc = model.init_cache(cfg, device=dev, dtype=e.kv_dtype)
        _, kc, vc = model.prefill(e.params, kc, vc, prompt, cfg)
        busy, by = busy_ms(lambda: model.decode_step(  # noqa: B023
            e.params, kc, vc, toks[0], len(prompt), cfg, e.kcfg, True),
            HD64_PASSES)
        del kc, vc
        plain, gaps, bad = check_against_plain(e, dev, prompt, toks,
                                               step=plain_step)
        say("hd64_e2e", model="tinyllama_1b", run=run,
            prompt_tokens=len(prompt), new_tokens=len(toks),
            prefill_ms=f"{e.stats.prefill_s * 1e3:.2f}",
            decode_tokens_per_s=f"{(len(toks) - 1) / decode_s:.2f}",
            decode_ms_per_step=f"{decode_s * 1e3 / (len(toks) - 1):.3f}",
            device_busy_ms_per_step=f"{busy:.4f}",
            **{f"busy_{k}_ms": f"{v:.4f}" for k, v in by.items()},
            **{f"{k}_launches": v for k, v in got.items()},
            kernel_tokens=toks[:8], plain_tokens=plain,
            plain="eager" if plain_step is None else "kernel 7's twin (W4A8)",
            top2_gaps=[round(v, 3) for v in gaps],
            disagree_where_gap_gt_0_1=bad)
        if not ran or bad or len(toks) != 64 or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"TinyLlama's stream ({run}): launches "
                                 f"{got}, tokens disagree at {bad}")
        launches[run] = got["stack"]
    say("hd64_e2e", seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


def phase_hd64_mode5(eng, dev, hbm, peak, pos=600):
    """Phase 46: kernel 7's mode 5 at head dim 64 as a tp-2 pair on this
    card (phase 26's form: two virtual ranks on their own streams over a
    loopback communicator, no LM head) on TinyLlama-1.1B's widths, its
    weights made with head group 2 (G 2, so that the head groups divide
    over the ranks: 2 kv heads a rank), with bf16 weights on a bf16 cache
    and with int4 W4A8 weights on an ``Int8KV`` cache, pos 600 over random
    rows (``shard_params`` / ``shard_cache``): all 22 layers, 8L+1 kernels
    a rank, the ranks' x_out and residual bit-identical and repeated bit
    for bit; each layer from the pair's own state (teacher-forced) within
    2e-2 of the largest value of its twin over the ranks
    (``fused_decoder_stack_plain_ranks``), the appended rows at phase 4's
    limits (Int8KV: plus one code).  The 22-layer pair step's time (10
    back to back, as phase 26 times its pair) beside the twin's and the
    bound (both ranks' shards, rows and scales read once).  Then
    ``phase_fused_step`` on each tree: 8 steps of the fused tp-2 step
    after a 512-token prefill (bf16 held against kernel 7's unsharded step
    teacher-forced; W4A8 + Int8KV, another function than the unsharded
    step, checked for launches, ranks and finiteness)."""
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    from clusterfusion_tpu_torch.parallel import collective as col
    t0 = time.perf_counter()
    cfg, tp = eng.cfg, 2
    g, hd, L = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.n_layers
    tree = model.init_params(cfg, seed=46, head_group=2, device=dev)
    tree4 = quantize_llama_params(tree, "int4")
    gen = torch.Generator(device=dev).manual_seed(46)
    kb, vb = model.init_cache(cfg, max_seq=1024, device=dev)
    kb[:, :, :pos] = torch.randn(kb[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vb[:, :, :pos] = torch.randn(vb[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    caches_by = {"bf16": (kb, vb), "int8": kv8_cache(kb, vb, "int8", pos)}
    cos, sin = model.rope_row(cfg, pos, dev)
    kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
              eps=cfg.norm_eps)
    names = ("attn_norm", "ffn_norm", "wqkv_f", "wo_f", "w13", "w2")
    kcfg = KernelConfig(int4_w4a8=True)
    out_rows = {}
    for run, p, kv in (("bf16", tree, "bf16"),
                       ("int4_w4a8_kvint8", tree4, "int8")):
        step_tol = KV8_STEP.get(kv, 0.0)
        lb = col.LoopbackComm(tp, dev)
        try:
            meshes = [lb.mesh(r) for r in range(tp)]
            shards = [par.shard_params(p, cfg, m) for m in meshes]
            kc, vc = caches_by[kv]
            caches = [(par.shard_cache(kc, m), par.shard_cache(vc, m))
                      for m in meshes]
            streams = [torch.cuda.Stream(dev) for _ in range(tp)]
            x0 = p["embed"][torch.tensor([7], device=dev)]

            def pair(x, ly, cs=None):
                cs = cs or [(kv_take(k, ly.start, ly.stop),
                             kv_take(v, ly.start, ly.stop))
                            for k, v in caches]
                outs = []
                for r in range(tp):
                    streams[r].wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(streams[r]):
                        sl = shards[r]["layers"]
                        outs.append(sk.fused_decoder_stack(
                            x, *(sl[k][ly] for k in names[:2]), cos, sin,
                            *(sl[k][ly] for k in names[2:]), *cs[r], pos,
                            kcfg=kcfg, reduce_axis="tp", mesh=meshes[r],
                            **kw))
                for st_ in streams:
                    torch.cuda.current_stream(dev).wait_stream(st_)
                return outs

            # every kernel of the path loaded before a virtual rank spins
            # (see ``LoopbackComm``): the unsharded step first
            lw = p["layers"]
            sk.fused_decoder_stack(
                x0, lw["attn_norm"][:1], lw["ffn_norm"][:1], cos, sin,
                *(lw[k][:1] for k in names[2:]), kv_take(kc, 0, 1),
                kv_take(vc, 0, 1), pos, kcfg=kcfg, **kw)
            n0 = (sk.launches, sum(sk.kv8_launches.values()))
            whole = slice(0, L)
            outs = pair(x0, whole)
            per_step = sk.last_step_kernels
            again = pair(x0, whole)
            torch.cuda.synchronize()
            lb.check()
            n7, n8 = sk.launches - n0[0], sum(sk.kv8_launches.values()) - n0[1]
            same = all(_same_bits(o[j], outs[0][j]) and
                       _same_bits(a[j], outs[0][j])
                       for o, a in zip(outs, again) for j in (0, 1))
            finite = all(bool(torch.isfinite(o[0].float()).all())
                         for o in outs)
            ok = (same and finite and per_step == 8 * L + 1
                  and n7 == 2 * tp and n8 == 2 * tp * (kv != "bf16"))
            # layer by layer, teacher-forced, against the twin over the ranks
            x, rels, rerr, amax = x0, [], [], 0.0
            for l in range(L):
                one = slice(l, l + 1)
                got = pair(x, one)
                want = sk.fused_decoder_stack_plain_ranks(
                    [(x, *(shards[r]["layers"][k][one] for k in names[:2]),
                      cos, sin,
                      *(shards[r]["layers"][k][one] for k in names[2:]),
                      kv_take(caches[r][0], l, l + 1),
                      kv_take(caches[r][1], l, l + 1), pos)
                     for r in range(tp)],
                    kv_split=kcfg.kv_split, int4_w4a8=True, **kw)
                torch.cuda.synchronize()
                lb.check()
                d_ = [((got[r][j].float() - want[r][j].float()).abs().max()
                       .item(), want[r][j].float().abs().max().item())
                      for r in range(tp) for j in (0, 1)]
                e = max(a / b for a, b in d_)
                amax = max(amax, *(a for a, _ in d_))
                re_ = 0.0
                for r in range(tp):
                    for j in (2, 3):
                        a_ = kv_values(got[r][j], [pos])
                        b_ = kv_values(want[r][j], [pos])
                        d = (a_ - b_).abs().max().item()
                        re_ = max(re_, d)
                        ok &= d <= 0.05 + ((l > 0) * 1e-2 + step_tol) * \
                            b_.abs().max().item()
                ok &= e <= 2e-2
                rels.append(round(e, 4))
                rerr.append(round(re_, 4))
                x = (got[0][0].float() + got[0][1].float()).bfloat16()
            # the 22-layer pair step's time, its twin's and its bound
            cs = [(kv_take(k, 0, L), kv_take(v, 0, L)) for k, v in caches]
            pair(x0, whole, cs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(10):
                pair(x0, whole, cs)
            torch.cuda.synchronize()
            pair_ms = (time.perf_counter() - t1) * 1e2
            lb.check()
            t1 = time.perf_counter()
            sk.fused_decoder_stack_plain_ranks(
                [(x0, *(shards[r]["layers"][k] for k in names[:2]), cos, sin,
                  *(shards[r]["layers"][k] for k in names[2:]),
                  kv_take(caches[r][0], 0, L), kv_take(caches[r][1], 0, L),
                  pos) for r in range(tp)],
                kv_split=kcfg.kv_split, int4_w4a8=True, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t1) * 1e3
        finally:
            lb.close()
        if kv != "bf16":
            bound, bound_by, nbytes = mode5_kv8_bound(cfg, p["layers"], hbm,
                                                      peak, pos, kv)
        else:
            lw = dict(p["layers"])
            lw["w13"], lw["w2"] = ffn_unpadded(cfg, lw)
            nbytes = sum(_bytes(lw[k]) for k in names) + \
                2 * L * cfg.kv_heads * 2 * hd * (pos + 1) + \
                3 * 2 * cfg.hidden_dim
            flops = 2 * sum(lw[k].numel() for k in names[2:]) + \
                4 * L * cfg.n_heads * hd * (pos + 1)
            bound = max(nbytes / hbm, flops / peak) * 1e3
            bound_by = "bytes" if nbytes / hbm >= flops / peak \
                else "operations"
        say("hd64_mode5", kernel=7, run=run, reduce_axis="tp", tp=tp,
            loopback=True, layers=L, pos=pos, head_group=2,
            kv_heads_per_rank=cfg.kv_heads // tp,
            ranks_bit_identical_and_repeat=same, finite=finite,
            kernels_per_step=per_step, stack_launches=n7, kv8_launches=n8,
            held="each layer vs fused_decoder_stack_plain_ranks, "
                 "teacher-forced",
            err_over_max_by_layer=rels, err_over_max_worst=max(rels),
            kv_rows_err_worst=max(rerr),
            tol="x/res within 2e-2 of the largest; rows layer 0 atol=0.05, "
                "deeper atol=0.05+rtol=1e-2" + (f", +{step_tol:.4g} of |row|"
                                                if step_tol else ""),
            both_ranks_ms_per_step=f"{pair_ms:.4f}",
            plain_ms=f"{plain_ms:.2f}", bound_ms=f"{bound:.4f}",
            bound_by=bound_by, bytes=nbytes, within=ok)
        if not ok:
            raise AssertionError(f"kernel 7's mode 5 at hd 64 ({run}) "
                                 "disagrees with its twin over the ranks, or "
                                 "its launches or bits are wrong")
        out_rows[run] = dict(max_abs_err=amax, ms=pair_ms, plain_ms=plain_ms,
                             bound_ms=bound)
        e = Llama(p, cfg, eng.tokenizer, fused=True,
                  kv_dtype="int8" if kv == "int8" else torch.bfloat16)
        phase_fused_step(e, dev, shards, n=8, params=p,
                         phase=f"hd64_fused_step_{run}", kcfg=kcfg,
                         stack_check=run == "bf16",
                         kv=None if kv == "bf16" else kv)
        del shards, caches, e
        torch.cuda.empty_cache()
    del tree, tree4, caches_by, kb, vb
    torch.cuda.empty_cache()
    say("hd64_mode5", seconds=f"{time.perf_counter() - t0:.1f}")
    return out_rows



# -- int4 on the multi-card paths (phases 32-34) ------------------------------


def int4_layer_proj(o, wo, a8):
    """The int4 O projection of the merged partials' o [kv*g, hd] (bf16) as
    kernel 6's twin projects it: each head group's o by ``_int4_dot``, the
    groups' float32 partials summed in order."""
    from clusterfusion_tpu_torch.ops.decoder_layer import _int4_dot
    og = o.bfloat16().reshape(wo.shape[0], -1)
    out = 0.0
    for i in range(og.shape[0]):
        out = out + _int4_dot(og[i][None], wo.q[i], wo.s[i], wo.group_size,
                              a8)[0]
    return out[None]


def phase_int4_layer(eng4, eng8, eng, dev, hbm, peak, pos=600, cap=4096,
                     layer=1):
    """Phase 32: kernel 6's int4 modes (W4A8 and exact), as phase 24 runs
    the int8 mode, on layer 1 of the 7B int4 engine (hg 8, G 4), the whole
    tree and the first tp-2 shard's slices (16 kv heads, G 2, by
    ``shard_params`` on the int4 tree): full mode with the append at pos 600
    of a 4096-row cache with large garbage at and above pos (the output,
    residual and appended rows against the int4 plain twin in the same mode
    at phase 13's limits, every other row unchanged, a repeat
    bit-identical, counted as int4, two kernels a W4A8 call (the layer,
    then the ring GEMV's W4A8 O projection over the head groups' o) and one
    an exact call); partials mode on [0, 300) and [300, 600) merged against
    one partials call and, O-projected as the twin projects (each head
    group's o by ``_int4_dot``), against the full output.  Then, on the
    whole tree, each mode's device time (``queued_ms``; the profiler's busy
    time beside it) beside the int8 and the bf16 kernel 6 on the same
    inputs (phases 24 and 13's weights), the twin's time, the byte bound
    (codes, float32 scales, K/V rows), the launch plans and the phase
    stamps.  Returns the kernel table's rows by mode."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    cfg = eng4.cfg
    g, hd, hidden = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.hidden_dim
    kvh = cfg.kv_heads
    gen = torch.Generator(device=dev).manual_seed(32)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

    kc, vc = rnd((2, kvh, cap, hd)), rnd((2, kvh, cap, hd))
    kc[:, :, pos:] *= 8                  # garbage the kernel must not read
    vc[:, :, pos:] *= 8
    x, res = rnd((1, hidden)), rnd((1, hidden))
    norm = 1 + 0.1 * rnd((hidden,))
    cos, sin = model.rope_row(cfg, pos, dev)
    trees = {"whole": (eng4.params["layers"], kvh),
             "tp2_shard": (tp2_shard(eng4.params, cfg)["layers"], kvh // 2)}
    rows, times = {}, {}
    for mode, a8 in INT4_MODES:
        kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
                  fuse_residual=True, eps=cfg.norm_eps,
                  kcfg=KernelConfig(int4_w4a8=a8))
        for label, (lw, heads) in trees.items():
            wq, wo = lw["wqkv_f"][layer], lw["wo_f"][layer]
            kcl = kc[:, :heads].contiguous()
            vcl = vc[:, :heads].contiguous()
            args = (x, res, norm, cos, sin, wq, wo)
            kk, vk = kcl.clone(), vcl.clone()
            kr, vr = kcl.clone(), vcl.clone()
            before = (dl.launches, dl.int4_launches)
            out = dl._fused_decoder_layer(*args, kk, vk, pos, 1,
                                          append_kv=True, **kw)
            kernels = dl.last_call_kernels
            launched = (dl.launches - before[0], dl.int4_launches - before[1])
            kk2, vk2 = kcl.clone(), vcl.clone()
            again = dl._fused_decoder_layer(*args, kk2, vk2, pos, 1,
                                            append_kv=True, **kw)
            ref = dl._fused_decoder_layer_plain(*args, kr, vr, pos, 1,
                                                append_kv=True, **kw)
            torch.cuda.synchronize()
            repeat = all(_same_bits(out[i], again[i]) for i in range(4)) and \
                _same_bits(kk, kk2) and _same_bits(vk, vk2)
            e = max((out[i].float() - ref[i].float()).abs().max().item()
                    for i in (0, 1))
            for i in (0, 1):
                torch.testing.assert_close(out[i].float(), ref[i].float(),
                                           **LIMITS_TOL)
            row_err = max((a[1, :, pos].float() - b[1, :, pos].float()).abs()
                          .max().item() for a, b in ((kk, kr), (vk, vr)))
            new_err = max((out[i].float() - ref[i].float()).abs().max().item()
                          for i in (2, 3))
            others = torch.ones(cap, dtype=torch.bool, device=dev)
            others[pos] = False
            unchanged = (torch.equal(kk[:, :, others], kcl[:, :, others])
                         and torch.equal(vk[:, :, others], vcl[:, :, others])
                         and torch.equal(kk[0], kcl[0])
                         and torch.equal(vk[0], vcl[0]))
            want_kernels = 2 if a8 else 1
            say("layer_int4", kernel=6, mode=mode, tree=label,
                kv_heads=heads, head_groups=wq.shape[0], call="full+append",
                pos=pos, cap=cap, max_abs_err=f"{e:.3g}",
                tol="atol=2e-2,rtol=2e-2", appended_row_err=f"{row_err:.3g}",
                k_new_v_new_err=f"{new_err:.3g}", tol_rows=0.05,
                other_rows_unchanged=unchanged, repeat_bit_identical=repeat,
                kernels_per_call=kernels, launches_int4=launched)
            if not (row_err <= 0.05 and new_err <= 0.05 and unchanged
                    and repeat and kernels == want_kernels
                    and launched == (1, 1)):
                raise AssertionError(f"kernel 6's int4 {mode} mode ({label}): "
                                     "appended rows disagree, other rows "
                                     "changed, a repeat differs or the "
                                     "launches are wrong")
            del kk2, vk2, again, kr, vr
            # partials: two shards merged in the log2 domain vs one shard
            pkw = dict(kw, emit_partials=True)
            halves = [(kcl[:, :, :300].contiguous(),
                       vcl[:, :, :300].contiguous(), 300, 0),
                      (kcl[:, :, 300:].contiguous(),
                       vcl[:, :, 300:].contiguous(), pos - 300, 1)]
            parts = [dl._fused_decoder_layer(*args, k, v, n, 1,
                                             fold_current=f, **pkw)
                     for k, v, n, f in halves]
            whole = dl._fused_decoder_layer(*args, kcl, vcl, pos, 1,
                                            fold_current=1, **pkw)
            m = torch.stack([q[1][0] for q in parts])
            alpha = torch.exp2(m - m.amax(dim=0))
            l_g = sum(q[1][1] * a for q, a in zip(parts, alpha))
            acc_g = sum(q[0] * a[:, None] for q, a in zip(parts, alpha))
            o_merged = acc_g / l_g[:, None]
            o_whole = whole[0] / whole[1][1][:, None]
            merge_err = (o_merged - o_whole).abs().max().item()
            proj = int4_layer_proj(o_merged, wo, a8)
            proj_err = (proj - out[0].float()).abs().max().item()
            torch.cuda.synchronize()
            say("layer_int4", kernel=6, mode=mode, tree=label,
                call="partials [0,300)+[300,600) merged",
                o_err_vs_one_shard=f"{merge_err:.3g}", tol_o=2e-2,
                oproj_err_vs_full=f"{proj_err:.3g}",
                tol_out="atol=2e-2,rtol=2e-2")
            torch.testing.assert_close(o_merged, o_whole, atol=2e-2, rtol=0)
            torch.testing.assert_close(proj, out[0].float(), **LIMITS_TOL)
            del parts, whole, halves
            if label != "whole":
                del kk, vk, kcl, vcl
                continue
            call = lambda: dl._fused_decoder_layer(  # noqa: E731
                *args, kk, vk, pos, 1, append_kv=True, **kw)
            ms = queued_ms(call)
            prof_ms, _ = busy_ms(call)
            times[mode] = (ms, prof_ms)
            say("layer_int4_launch", kernel=6, mode=mode,
                **dl.launch_plan(hidden, kvh, g, hd, kind=mode),
                **launch_phases(dl, call, 16 * kvh, K6_PHASES),
                note="phases from %globaltimer stamps inside the layer's "
                     "launch (W4A8: no O phase; its O projection is the "
                     "second kernel)")
            plain_ms = time_ms(lambda: dl._fused_decoder_layer_plain(
                *args, kk, vk, pos, 1, append_kv=True, **kw), 3)
            wbytes = _bytes(wq.q, wq.s, wo.q, wo.s)
            # the layer's o written and read back between the two kernels
            io = 5 * hidden * 2 + 4 * kvh * hd * 2 + (
                2 * 2 * kvh * g * hd if a8 else 0)
            bound, bound_by, nbytes = _layer_bound(
                hbm, peak, wbytes, 2 * (wq.q.numel() + wo.q.numel()), kvh,
                cfg.n_heads, pos, hd, io)
            rows[mode] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound, bound_by=bound_by,
                              library_ms=None)
            say("layer_int4", kernel=6, mode=mode, ms=f"{ms:.4f}",
                queued_ms=f"{ms:.4f}", profiler_busy_ms=f"{prof_ms:.4f}",
                plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
                bound_by=bound_by, bytes=nbytes,
                code_and_scale_bytes=wbytes,
                rate_TBps=f"{nbytes / ms / 1e9:.3f}", library_ms="null")
            del kk, vk, kcl, vcl
    # the int8 and bf16 kernel 6 on the same inputs (their engines' layer)
    kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
              fuse_residual=True, eps=cfg.norm_eps)
    same = {}
    for kind, e_ in (("int8", eng8), ("bf16", eng)):
        lw_ = e_.params["layers"]
        kk, vk = kc.clone(), vc.clone()
        a_ = (x, res, norm, cos, sin, lw_["wqkv_f"][layer], lw_["wo_f"][layer])
        same[kind] = queued_ms(lambda: dl._fused_decoder_layer(  # noqa: B023
            *a_, kk, vk, pos, 1, append_kv=True, **kw))
        del kk, vk
    say("layer_int4", kernel=6, pos=pos, hg=kvh // trees["whole"][0][
        "wqkv_f"].shape[1],
        w4a8_queued_ms=f"{times['w4a8'][0]:.4f}",
        exact_queued_ms=f"{times['exact'][0]:.4f}",
        w4a8_profiler_busy_ms=f"{times['w4a8'][1]:.4f}",
        exact_profiler_busy_ms=f"{times['exact'][1]:.4f}",
        int8_queued_ms_same_inputs=f"{same['int8']:.4f}",
        bf16_queued_ms_same_inputs=f"{same['bf16']:.4f}")
    return rows


class LayerTwinCheck:
    """Kernel 6 held against its plain twin on every call a step makes,
    teacher-forced: ``mod._fused_decoder_layer`` (the name a step module
    calls) is wrapped so that each call's layer is also run through
    ``_fused_decoder_layer_plain`` from the same inputs (a copy of the
    layer's cache rows), outputs at phase 13's limits, new rows at 0.05;
    the partials (sp) at phase 13's partials limits.  The largest errors
    are kept in ``worst`` and any call past a limit in ``bad``."""

    def __init__(self, mod):
        from clusterfusion_tpu_torch.ops import decoder_layer as dl
        self.mod, self.real, self.dl = mod, mod._fused_decoder_layer, dl
        self.worst, self.bad, self.calls = [0.0, 0.0], [], 0

    def __enter__(self):
        self.mod._fused_decoder_layer = self._call
        return self

    def __exit__(self, *exc):
        self.mod._fused_decoder_layer = self.real

    def _call(self, x, residual, rms_w, cos, sin, wqkv_f, wo_f, k_cache,
              v_cache, seq_len, layer_id=0, **kw):
        l = int(layer_id)
        kc1, vc1 = k_cache[l:l + 1].clone(), v_cache[l:l + 1].clone()
        out = self.real(x, residual, rms_w, cos, sin, wqkv_f, wo_f, k_cache,
                        v_cache, seq_len, layer_id, **kw)
        ref = self.dl._fused_decoder_layer_plain(
            x, residual, rms_w[l], cos, sin, wqkv_f[l],
            None if wo_f is None else wo_f[l], kc1, vc1, seq_len, 0, **kw)
        partials = kw.get("emit_partials", False)
        pairs = ((out[1], ref[1], 2e-2, 2e-2), (out[0], ref[0], 5e-2, 2e-2)) \
            if partials else ((out[0], ref[0], 2e-2, 2e-2),
                              (out[1], ref[1], 2e-2, 2e-2))
        rows = ((out[3], ref[3], 0.05, 0), (out[4], ref[4], 0.05, 0)) \
            if partials else ((out[2], ref[2], 0.05, 0),
                              (out[3], ref[3], 0.05, 0))
        for i, (a, b, atol, rtol) in enumerate((*pairs, *rows)):
            d = (a.float() - b.float()).abs()
            lim = atol + rtol * b.float().abs()
            j = 0 if i < 2 else 1
            self.worst[j] = max(self.worst[j], d.max().item())
            if not bool((d <= lim).all()) or not bool(torch.isfinite(a).all()):
                self.bad.append((l, i))
        self.calls += 1
        return out


def phase_int4_sharded(eng4, dev):
    """Phase 33: the int4 tp and sp steps end to end in a one-rank NCCL
    group, as phase 25 runs the int8 ones, in both int4 modes: the int4
    engine's tree (hg 8, the bf16 LM head) by ``shard_params``, a 512-token
    prefill, then 16 greedy steps of ``make_sharded_decode_step`` and 8 of
    ``make_sp_sharded_decode_step``.  The step is JAX's function: kernel 6
    in the mode (W4A8 or exact QKV and O), the FFN exact on ``_ffn_int4``
    (the sp step's O projection on ``_gemv_int4``).  Exact: the streams
    against kernel 7's exact int4 step teacher-forced under the top-2-gap
    rule (the same function).  W4A8: one more step with every layer held
    against kernel 6's twin, teacher-forced (``LayerTwinCheck``).  Launches
    per step with the counts set to 0 just before (kernel 6 int4 32; kernel
    2 32 in the tp step, 0 in the sp step; ``_ffn_int4`` 32; ``_gemv_int4``
    32 O products in the sp step), ms per step, and the peak of memory a
    step allocates over what it held before (a bf16 copy of one layer's
    FFN weights would be 185 MB, of its O weights 34 MB).  Returns kernel
    6's int4 launches by mode (both steps)."""
    import torch.distributed as dist
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import KernelConfig, MeshConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.parallel import decode as par_decode
    from clusterfusion_tpu_torch.parallel import sp_decode as par_sp
    gm = importlib.import_module("clusterfusion_tpu_torch.ops.gemv")
    rn = importlib.import_module("clusterfusion_tpu_torch.ops.rmsnorm")
    cfg, full = eng4.cfg, eng4.params
    L = cfg.n_layers
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    launched6 = {}
    try:
        mesh = par.build_mesh(MeshConfig())
        params = par.shard_params(full, cfg, mesh)
        views = all(params["layers"][k] is full["layers"][k]
                    or params["layers"][k].q is full["layers"][k].q
                    for k in params["layers"])
        text = ("The quick brown fox jumps over the lazy dog. " * 20)[:511]
        prompt = eng4.tokenizer.encode(text, bos=True, eos=False)
        k0, v0 = model.init_cache(cfg, device=dev)
        lg, k0, v0 = model.prefill(full, k0, v0, prompt, cfg)
        first, pos0 = int(torch.argmax(lg[-1])), len(prompt)
        for mode, a8 in INT4_MODES:
            kcfg = KernelConfig(int4_w4a8=a8)
            launched6[mode] = 0
            for name, n, make, spec, mod in (
                    ("tp", 16, par.make_sharded_decode_step,
                     par.cache_pspec(), par_decode),
                    ("sp", 8, par.make_sp_sharded_decode_step,
                     par.cache_pspec_2d(), par_sp)):
                step = make(cfg, mesh, kcfg)
                kc = par.shard_cache(k0.clone(), mesh, spec)
                vc = par.shard_cache(v0.clone(), mesh, spec)
                tok = torch.tensor(first, device=dev)
                dl.launches = dl.int4_launches = 0
                gm.int4_launches = gm.ffn4_launches = gm.int8_launches = 0
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
                got = dict(kernel6=dl.launches, kernel6_int4=dl.int4_launches,
                           kernel2=rn.launches["fused_add_rmsnorm"],
                           ffn_int4=gm.ffn4_launches,
                           gemv_int4=gm.int4_launches,
                           gemv_int8=gm.int8_launches)
                want = dict(kernel6=L * n, kernel6_int4=L * n,
                            kernel2=L * n if name == "tp" else 0,
                            ffn_int4=L * n,
                            gemv_int4=L * n if name == "sp" else 0,
                            gemv_int8=0)
                launched6[mode] += got["kernel6_int4"]
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                step(params, kc, vc, tok, pos0 + n)
                torch.cuda.synchronize()
                extra_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
                toks = [int(t) for t in out]
                finite = bool(torch.isfinite(lg).all())
                if a8:          # one more step, each layer against the twin
                    with LayerTwinCheck(mod) as chk:
                        step(params, kc, vc, tok, pos0 + n)
                    torch.cuda.synchronize()
                    check = dict(held="each layer against kernel 6's twin, "
                                      "teacher-forced",
                                 layer_calls=chk.calls,
                                 worst_out_err=f"{chk.worst[0]:.3g}",
                                 worst_row_err=f"{chk.worst[1]:.3g}",
                                 past_limits=chk.bad)
                    bad = chk.bad or chk.calls != L
                else:
                    ref, gaps, badt = check_against_stack(
                        full, cfg, k0, v0, pos0, first, toks, kcfg)
                    check = dict(held="stream vs kernel 7's exact int4 step,"
                                      " teacher-forced",
                                 kernel7_tokens=ref[:8],
                                 agree=f"{sum(a == b for a, b in zip(ref, toks))}"
                                       f"/{n}",
                                 disagree_where_gap_gt_0_1=badt,
                                 min_top2_gap=f"{min(gaps):.3g}")
                    bad = badt
                say("sharded_int4", step=name, mode=mode, lm_head="bf16",
                    mesh="tp=1,sp=1 (one rank, nccl)", prompt_tokens=pos0,
                    new_tokens=n, params_are_views=views,
                    ms_per_step=f"{dt * 1e3 / n:.3f}",
                    tokens_per_s=f"{n / dt:.2f}", launches=got,
                    per_step={k: v / n for k, v in got.items()},
                    peak_extra_alloc_mb_per_step=f"{extra_mb:.2f}",
                    finite=finite, tokens=toks[:8], **check)
                if got != want or not finite or bad or not views \
                        or extra_mb > 32:
                    raise AssertionError(
                        f"the int4 {name} step ({mode}): launches {got} "
                        f"(want {want}), the check ({bad}) or "
                        f"{extra_mb:.1f} MB allocated a step wrong")
                del kc, vc
        del k0, v0
    finally:
        dist.destroy_process_group()
    return launched6


def phase_int4_mode5(eng4, dev, hbm, pos=600):
    """Phase 34: kernel 7's int4 mode 5 as a tp-2 pair step on this card
    (phase 26's form: two virtual ranks on their own streams over a
    loopback communicator, ``shard_params`` / ``shard_cache`` of the int4
    engine's tree and of a cache filled at random, no LM head), at 4 layers
    and at all 32, in both modes: the O and down products run
    ring_gemv4_kernel's G1_PUSH_SUM instances.  Each pair step: 8L+1
    kernels a rank, counted as int4, the ranks' x_out and residual
    bit-identical.  Exact, the unsharded exact step's function: at 4
    layers x_out and the residual within 0.05 + 1e-2 of the largest value
    of kernel 7's unsharded exact step running free, the appended rows at
    phase 4's limits; at 32 layers the free-running shares are printed
    beside phase 15's bf16 pair's (bf16 flips taken apart compound layer
    by layer, on this tree further than on the bf16 one: ``PERF.md``) and
    every layer is held one at a time, teacher-forced, against the
    unsharded exact step from the pair's own state (``hold_by_layer``'s
    rule: x_out and the residual within 2e-2 of their largest value, rows
    at 0.05 + 1e-2 of |row|).  W4A8, whose down product quantizes per
    f-block of the rank's shard (512 rows at tp 2; the unsharded step's
    are 1024): held the same way against its own twin over the ranks
    (``fused_decoder_stack_plain_ranks``), at 4 and 32 layers.  Then the
    32-layer pair step's time in each mode (10 back to back, as phase 26
    times its pair), beside phase 15's
    bf16 and phase 26's int8 pair steps, the byte bound of the pair (every
    shard read once: codes, float32 scales, K/V rows < pos) and the twin's
    time.  Returns (the kernel table's rows by mode, the 32-layer shards)."""
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    cfg, tree, tp = eng4.cfg, eng4.params, 2
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    gen = torch.Generator(device=dev).manual_seed(34)
    kc, vc = model.init_cache(cfg, max_seq=1024, device=dev)
    kc[:, :, :pos] = torch.randn(kc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    vc[:, :, :pos] = torch.randn(vc[:, :, :pos].shape, generator=gen,
                                 device=dev).bfloat16()
    x0 = tree["embed"][torch.tensor([7], device=dev)]
    cos, sin = model.rope_row(cfg, pos, dev)
    others = torch.ones(kc.shape[2], dtype=torch.bool, device=dev)
    others[pos] = False
    lb = col.LoopbackComm(tp, dev)
    rows, shards = {}, None
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards = [par.shard_params(tree, cfg, m) for m in meshes]
        caches = [(par.shard_cache(kc, m), par.shard_cache(vc, m))
                  for m in meshes]
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]
        names = ("attn_norm", "ffn_norm", "wqkv_f", "wo_f", "w13", "w2")

        def pair(x, ly, kcfg, caches_=None):
            """Each rank's mode-5 step over layers ``ly`` (a slice) from x,
            on its own stream, with copies of its caches' layers."""
            cs = caches_ or [(k[ly].clone(), v[ly].clone())
                             for k, v in caches]
            outs = []
            for r in range(tp):
                streams[r].wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(streams[r]):
                    sl = shards[r]["layers"]
                    outs.append(sk.fused_decoder_stack(
                        x, *(sl[k][ly] for k in names[:2]), cos, sin,
                        *(sl[k][ly] for k in names[2:]), *cs[r], pos,
                        group=g, head_dim=hd, rope_style=cfg.rope_style,
                        eps=cfg.norm_eps, kcfg=kcfg, reduce_axis="tp",
                        mesh=meshes[r]))
            for st_ in streams:
                torch.cuda.current_stream(dev).wait_stream(st_)
            return outs

        # every kernel of the path loaded before a virtual rank spins (see
        # ``LoopbackComm``): each mode's unsharded step first
        for _, a8 in INT4_MODES:
            lw = tree["layers"]
            sk.fused_decoder_stack(
                x0, lw["attn_norm"][:1], lw["ffn_norm"][:1], cos, sin,
                *(lw[k][:1] for k in names[2:]), kc[:1].clone(),
                vc[:1].clone(), pos, group=g, head_dim=hd,
                rope_style=cfg.rope_style, eps=cfg.norm_eps,
                kcfg=KernelConfig(int4_w4a8=a8))
        for layers in (4, cfg.n_layers):
            ly = slice(0, layers)
            for mode, a8 in INT4_MODES:
                kcfg = KernelConfig(int4_w4a8=a8)
                n4, k7 = sk.int4_launches, sk.launches
                outs = pair(x0, ly, kcfg)
                torch.cuda.synchronize()
                lb.check()
                per_step = sk.last_step_kernels
                n4, k7 = sk.int4_launches - n4, sk.launches - k7
                same = all(torch.equal(o[0], outs[0][0]) and
                           torch.equal(o[1], outs[0][1]) for o in outs)
                finite = all(bool(torch.isfinite(o[0].float()).all())
                             for o in outs)
                ok = (same and finite and n4 == tp and k7 == tp
                      and per_step == 8 * layers + 1)
                held = {}
                if not a8:      # free-running against the unsharded step
                    lw = tree["layers"]
                    kr, vr = kc[ly].clone(), vc[ly].clone()
                    ref = sk.fused_decoder_stack(
                        x0, lw["attn_norm"][ly], lw["ffn_norm"][ly], cos, sin,
                        *(lw[k][ly] for k in names[2:]), kr, vr, pos,
                        group=g, head_dim=hd, rope_style=cfg.rope_style,
                        eps=cfg.norm_eps, kcfg=kcfg)
                    errs, rel, row_err, strict = [], [], 0.0, layers <= 4
                    for j in (0, 1):
                        e = max((o[j].float() - ref[j].float()).abs().max()
                                .item() for o in outs)
                        mx = ref[j].float().abs().max().item()
                        errs.append(e)
                        rel.append(round(e / mx, 5))
                        ok &= e <= 0.05 + 1e-2 * mx or not strict
                    for r, o in enumerate(outs):
                        heads = slice(r * cfg.kv_heads // tp,
                                      (r + 1) * cfg.kv_heads // tp)
                        for a, b, c in ((o[2], kr, 0), (o[3], vr, 1)):
                            want = b[:, heads, pos].float()
                            d = (a[:, :, pos].float() - want).abs()
                            lim = 0.05 + 1e-2 * want.abs().amax(dim=(1, 2))
                            if strict:      # layer 0 at 0.05, deeper + 1e-2
                                ok &= bool(d[0].max() <= 0.05) and bool(
                                    (d.amax(dim=(1, 2)) <= lim).all())
                            row_err = max(row_err, d.max().item())
                            ok &= torch.equal(a[:, :, others],
                                              caches[r][c][ly][:, :, others])
                    held = dict(free_running_vs="kernel 7's unsharded exact "
                                                "step",
                                x_out_err=f"{errs[0]:.4g}",
                                residual_err=f"{errs[1]:.4g}",
                                err_over_max=rel, kv_row_err=f"{row_err:.4g}",
                                bf16_pair_err_over_max=[
                                    round(v, 5)
                                    for v in FIGURES.get("mode5_drift", [])],
                                tol="x/res 0.05+1e-2*max|ref|; rows layer 0 "
                                    "atol=0.05, deeper atol=0.05+rtol=1e-2"
                                if strict else "reported (the free-running "
                                "steps part by bf16 flips layer by layer); "
                                "held one layer at a time below")
                if a8 or layers > 4:
                    # layer by layer, teacher-forced: each layer of the pair
                    # from the pair's own state, against the unsharded exact
                    # step (exact) or the twin over the ranks (W4A8)
                    x, rels, rerr, amax = x0, [], [], 0.0
                    for l in range(layers):
                        one = slice(l, l + 1)
                        got = pair(x, one, kcfg)
                        if a8:
                            want = sk.fused_decoder_stack_plain_ranks(
                                [(x, *(shards[r]["layers"][k][one]
                                       for k in names[:2]), cos, sin,
                                  *(shards[r]["layers"][k][one]
                                    for k in names[2:]),
                                  caches[r][0][one].clone(),
                                  caches[r][1][one].clone(), pos)
                                 for r in range(tp)],
                                group=g, head_dim=hd,
                                rope_style=cfg.rope_style, eps=cfg.norm_eps,
                                kv_split=kcfg.kv_split, int4_w4a8=True)
                        else:
                            lw = tree["layers"]
                            u = sk.fused_decoder_stack(
                                x, lw["attn_norm"][one], lw["ffn_norm"][one],
                                cos, sin, *(lw[k][one] for k in names[2:]),
                                kc[one].clone(), vc[one].clone(), pos,
                                group=g, head_dim=hd,
                                rope_style=cfg.rope_style, eps=cfg.norm_eps,
                                kcfg=kcfg)
                            h_ = cfg.kv_heads // tp
                            want = [(u[0], u[1], u[2][:, r * h_:(r + 1) * h_],
                                     u[3][:, r * h_:(r + 1) * h_])
                                    for r in range(tp)]
                        torch.cuda.synchronize()
                        lb.check()
                        d_ = [((got[r][j].float() - want[r][j].float()).abs()
                               .max().item(), want[r][j].float().abs().max()
                               .item()) for r in range(tp) for j in (0, 1)]
                        e = max(a / b for a, b in d_)
                        amax = max(amax, *(a for a, _ in d_))
                        re_ = 0.0
                        for r in range(tp):
                            for j in (2, 3):
                                a = got[r][j][:, :, pos].float()
                                b = want[r][j][:, :, pos].float()
                                d = (a - b).abs().max().item()
                                re_ = max(re_, d)
                                ok &= d <= 0.05 + (l > 0) * 1e-2 * \
                                    b.abs().max().item()
                        ok &= e <= 2e-2
                        rels.append(round(e, 4))
                        rerr.append(round(re_, 4))
                        x = (got[0][0].float() + got[0][1].float()).bfloat16()
                    held.update(
                        by_layer_vs=("its twin over the ranks" if a8 else
                                     "kernel 7's unsharded exact step")
                        + ", teacher-forced",
                        err_over_max_by_layer=rels,
                        err_over_max_worst=max(rels),
                        kv_rows_err_worst=max(rerr),
                        tol_by_layer="x/res within 2e-2 of the largest; rows "
                                     "layer 0 atol=0.05, deeper "
                                     "atol=0.05+rtol=1e-2")
                    if layers == cfg.n_layers:
                        rows[mode] = dict(max_abs_err=amax)
                say("mode5_int4", kernel=7, mode=mode, reduce_axis="tp",
                    tp=tp, loopback=True, layers=layers, pos=pos,
                    ranks_bit_identical=same, finite=finite,
                    kernels_per_step=per_step, stack_launches=k7,
                    int4_launches=n4, within=ok, **held)
                if not ok:
                    raise AssertionError(f"kernel 7's int4 mode 5 ({mode}, "
                                         f"{layers} layers) disagrees or its "
                                         "launches are wrong")
        # the 32-layer pair step's time in each mode, its bound and twin
        ly = slice(0, cfg.n_layers)
        nbytes = sum(_bytes(w.q, w.s) for sh in shards
                     for w in (sh["layers"][k] for k in names[2:])) + sum(
            _bytes(sh["layers"]["attn_norm"], sh["layers"]["ffn_norm"])
            for sh in shards) + 2 * kc[:, :, :pos].numel() * 2
        bound = nbytes / hbm * 1e3
        for mode, a8 in INT4_MODES:
            kcfg = KernelConfig(int4_w4a8=a8)
            cs = [(k.clone(), v.clone()) for k, v in caches]
            pair(x0, ly, kcfg, cs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()     # phase 26's pair timing: the
            for _ in range(10):          # launches of 10 pair steps exceed
                pair(x0, ly, kcfg, cs)   # the launch queue, so no queuing
            torch.cuda.synchronize()     # ahead of the card (queued_ms)
            ms = (time.perf_counter() - t0) * 1e2
            lb.check()
            t0 = time.perf_counter()
            sk.fused_decoder_stack_plain_ranks(
                [(x0, *(shards[r]["layers"][k] for k in names[:2]), cos,
                  sin, *(shards[r]["layers"][k] for k in names[2:]),
                  caches[r][0].clone(), caches[r][1].clone(), pos)
                 for r in range(tp)],
                group=g, head_dim=hd, rope_style=cfg.rope_style,
                eps=cfg.norm_eps, kv_split=kcfg.kv_split, int4_w4a8=a8)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            rows[mode].update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by="bytes", library_ms=None)
            FIGURES[f"mode5_int4_{mode}_pair_ms"] = ms
            say("mode5_int4", kernel=7, mode=mode, layers=cfg.n_layers,
                both_ranks_ms_per_step=f"{ms:.4f}",
                bf16_both_ranks_ms_per_step=(
                    f"{FIGURES['mode5_pair_ms']:.3f}"
                    if "mode5_pair_ms" in FIGURES else "not measured"),
                int8_both_ranks_ms_per_step=(
                    f"{FIGURES['mode5_int8_pair_ms']:.3f}"
                    if "mode5_int8_pair_ms" in FIGURES else "not measured"),
                plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
                bound_by="bytes", bytes=nbytes,
                rate_TBps=f"{nbytes / ms / 1e9:.3f}")
    finally:
        lb.close()
    return rows, shards


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
        ms, by_pass = row_ms(call, MLA_PASSES)
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
    ms, by_pass = row_ms(call, MLA_PASSES)
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
    ms = queued_ms(call)
    prof_ms, _ = busy_ms(call)
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
        kernels_per_call=kernels5, ms=f"{ms:.4f}", queued_ms=f"{ms:.4f}",
        profiler_busy_ms=f"{prof_ms:.4f}", call_ms=f"{call_ms:.4f}",
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
    bad = [i for i, g in enumerate(gaps) if g > 0.1 and plain[i] != toks[i]]
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


#: Phases 47-50's cell: Mistral-7B at full width and depth, a cache of
#: 8192 positions, random weights from seed 0.
MISTRAL_CAP = 8192
MISTRAL_WINDOW = 4096
#: Kernel 7's windows at each position (None: pos + 1, which reaches row 0)
MISTRAL_STACK_WINDOWS = (MISTRAL_WINDOW, 100, None, 1, 0)
MISTRAL_STACK_POS = (4600, 8000)
#: The stream's prompt and new tokens: every step past the window
MISTRAL_PROMPT, MISTRAL_NEW, MISTRAL_SPEC_NEW = 4608, 64, 32
# a windowed step's free-running 32-layer drift over window 0's on the same
# inputs (kernel 7 read at most 1.17 at pos 4600 and 8000 in its first runs)
DRIFT_OVER_WINDOW_0 = 1.25
MISTRAL_ROWS = (("flash_prefill_attention (sliding window)", "flash",
                 "flash_prefill.cu", "flash_prefill.py:131"),
                ("fused_decoder_stack (sliding window)", "stack",
                 "stack_kernel.cu", "stack_kernel.py:524"),
                ("fused_verify_stack (sliding window)", "verify",
                 "stack_verify.cu", "stack_verify.py:432"),
                ("_fused_decoder_layer (sliding window)", "layer6_window",
                 "decoder_layer.cu", "decoder_layer.py:421"),
                ("fused_decoder_stack mode 5 (sliding window)",
                 "mode5_window", "stack_kernel.cu", "stack_kernel.py:524"),
                ("paged_attention (sliding window)", "paged_window",
                 "paged_attention.cu", "paged_decoder_layer.py:932"),
                ("llama_decoder_layer_paged (sliding window)", "layer_window",
                 "paged_decoder_layer.cu", "paged_decoder_layer.py:399"))
MISTRAL_LIB_NULL = ("no single PyTorch call computes the windowed decode "
                    "step or verify")


def mistral_engine(dev):
    """``Llama.synthetic(mistral_7b)`` with ``max_seq_len`` 8192, seed 0:
    hidden 4096, 32 heads on 8 kv heads of 128, FFN 14336, vocab 32000,
    neox rope, ``sliding_window`` 4096 (pattern "all"), 32 layers."""
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models.generation import Llama
    t0 = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.mistral_7b(),
                              max_seq_len=MISTRAL_CAP)
    eng = Llama.synthetic(cfg, seed=0, fused=True, device=dev)
    torch.cuda.synchronize()
    lw = eng.params["layers"]
    say("mistral_init", model="mistral_7b", layers=cfg.n_layers,
        hidden=cfg.hidden_dim, heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim_, ffn=cfg.ffn_dim, vocab=cfg.vocab_size,
        sliding_window=cfg.sliding_window, window_pattern=cfg.window_pattern,
        max_seq_len=cfg.max_seq_len,
        head_group=cfg.kv_heads // lw["wqkv_f"].shape[1],
        param_bytes=sum(t.numel() * 2 for t in
                        [eng.params["embed"], eng.params["lm_head"],
                         *lw.values()]),
        seconds=f"{time.perf_counter() - t0:.1f}")
    return eng


def _mistral_stack_case(cfg, p, dev, pos, seed):
    """Kernel 7's inputs at ``pos`` on the tree ``p``: token 7's row, rope
    row pos, random bf16 rows below pos and NaN above it, the LM head."""
    from clusterfusion_tpu_torch.models import llama as model
    lw = p["layers"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.n_layers, cfg.kv_heads, MISTRAL_CAP, cfg.head_dim_)
    kc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    kc[:, :, pos + 1:] = float("nan")
    vc[:, :, pos + 1:] = float("nan")
    cos, sin = model.rope_row(cfg, pos, dev)
    x = p["embed"][torch.tensor([7], device=dev)]
    args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"])
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, eps=cfg.norm_eps,
              final_norm=p["final_norm"], lm_head=p["lm_head"])
    return args, kw, kc, vc


def step_drift(phase, out, ref, kk, vk, kp, vp, pos, rows, **where):
    """Print a free-running step of kernel 7 or 8 (``out``, caches kk/vk)
    beside its plain twin's (``ref``, kp/vp): the logits' error over the
    largest logit and the appended rows' error by layer (the drift that
    compounds over the layers; held layer by layer, ``hold_by_layer``).
    Returns (every other row unchanged bit for bit and the output finite,
    the logits' max abs error, that error over the largest logit)."""
    torch.cuda.synchronize()
    new = list(range(pos, pos + rows))
    err = (out[0] - ref[0]).abs().max().item()
    rel = err / ref[0].abs().max().item()
    rows_err = torch.maximum(*((kv_values(a, new) - kv_values(b, new)).abs()
                               .amax(dim=(1, 2, 3))
                               for a, b in ((kk, kp), (vk, vp))))
    others = torch.ones(kv_positions(kp), dtype=torch.bool,
                        device=out[0].device)
    others[new] = False
    unchanged = kv_same_bits(kk, kp, others) and kv_same_bits(vk, vp, others)
    finite = bool(torch.isfinite(out[0]).all())
    say(phase, **where, pos=pos,
        held="free-running (printed; held by layer and, with a window, "
             f"against window 0: at most {DRIFT_OVER_WINDOW_0}x its drift)",
        logits_err_over_max=f"{rel:.4g}",
        row_err_by_layer=[round(e, 4) for e in rows_err[::4].tolist()],
        other_rows_unchanged=unchanged, finite=finite)
    return unchanged and finite, err, rel


def phase_mistral_stack(eng, dev, hbm, peak):
    """Phase 47: kernel 7's sliding window at Mistral-7B's full width and
    depth, capacity 8192, over random rows with NaN above pos: at pos 4600
    and 8000, windows 0, 4096 (Mistral's), 100 (starting inside a split of
    kv_split 64), pos + 1 (reaching row 0) and 1 (the current token alone:
    no split pass), each against its plain twin at the same kv_split layer
    by layer, teacher-forced, at phase 4's limits (``hold_by_layer``; at
    this width the free-running 32-layer drift reaches those limits
    without a window too: ``step_drift`` prints it); the free-running step
    must drift at most DRIFT_OVER_WINDOW_0 times window 0's on the same
    inputs, leave every other row unchanged, launch 8L+2 kernels (7L+2 at
    window 1), give window 0's bits at window pos + 1 (logits and appended
    rows) and, at pos 8000, differ from window 0 at window 4096.  Then at
    pos 8000 the step at windows 4096 and 0 in turns (CUDA events, A B B
    A), their device time with calls queued and their split and merge
    passes' busy time (``busy_ms``), beside the byte bound (``kv8_bound``:
    the weights and the 4095 rows in the window).  Then one step of each
    of JAX's window x weight x cache pairs (``phase_mistral_matrix``).
    Returns the kernels line's row (pos 8000, window 4096)."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    t0 = time.perf_counter()
    cfg, L = eng.cfg, eng.cfg.n_layers
    kcfg = KernelConfig()
    ok_all, logits, errs, drift, steps = True, {}, {}, {}, {}
    for pos in MISTRAL_STACK_POS:
        args, kw, kc, vc = _mistral_stack_case(cfg, eng.params, dev, pos, 47)
        for w in (0, *(pos + 1 if w is None else w
                       for w in MISTRAL_STACK_WINDOWS if w != 0)):
            where = dict(kernel=7, window=w, kv_split=kcfg.kv_split)
            kk, vk = kc.clone(), vc.clone()
            kp, vp = kc.clone(), vc.clone()
            n0 = sk.launches
            out = sk.fused_decoder_stack(*args, kk, vk, pos, kcfg=kcfg,
                                         window=w, **kw)
            n_kernels = sk.last_step_kernels
            ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos,
                                               kv_split=kcfg.kv_split,
                                               window=w, **kw)
            want = 8 * L + 2 - (w == 1) * L
            ok, errs[pos, w], drift[pos, w] = step_drift(
                "mistral_stack", out, ref, kk, vk, kp, vp, pos, 1, layers=L,
                kernels_per_step=n_kernels, want_kernels=want, **where)
            ok_all &= ok and n_kernels == want and sk.launches == n0 + 1
            ok_all &= drift[pos, w] <= DRIFT_OVER_WINDOW_0 * drift[pos, 0]
            logits[pos, w] = (out[0], kk[:, :, pos].clone(),
                              vk[:, :, pos].clone())
            del kk, vk, kp, vp, out, ref
            ok_all &= hold_by_layer(
                sk.fused_decoder_stack, sk.fused_decoder_stack_plain, args,
                kc, vc, pos, 1, L, kcfg, dict(kw, window=w), "mistral_stack",
                **where)[1]
        full, none = logits[pos, pos + 1], logits[pos, 0]
        same = torch.equal(full[0], none[0]) and all(
            _same_bits(a, b) for a, b in zip(full[1:], none[1:]))
        differ = (logits[pos, MISTRAL_WINDOW][0]
                  - none[0]).abs().max().item()
        say("mistral_stack", pos=pos, window_pos_plus_1_bits_equal_window_0=same,
            window_4096_vs_0_max_abs_diff=f"{differ:.4g}")
        ok_all &= same and (pos < MISTRAL_WINDOW or differ > 1e-3)
        if pos == MISTRAL_STACK_POS[-1]:
            for w in (MISTRAL_WINDOW, 0):
                steps[w] = functools.partial(
                    sk.fused_decoder_stack, *args, kc.clone(), vc.clone(),
                    pos, kcfg=kcfg, window=w, **kw)
        del kc, vc
    if not ok_all:
        raise AssertionError("kernel 7's window disagrees with its plain "
                             "twin, or its bits, launches or effect are "
                             "wrong")
    check_s = time.perf_counter() - t0
    pos = MISTRAL_STACK_POS[-1]
    ms = {w: [] for w in steps}
    for w in (MISTRAL_WINDOW, 0, 0, MISTRAL_WINDOW):
        ms[w].append(time_ms(steps[w], 10))
    # device time a step, calls back to back (3: a step is 258 kernels)
    queued = {w: queued_ms(f, 3) for w, f in steps.items()}
    by = {w: busy_ms(f, STACK_PASSES) for w, f in steps.items()}
    args, kw, kc, vc = _mistral_stack_case(cfg, eng.params, dev, pos, 47)
    plain_ms = time_ms(lambda: sk.fused_decoder_stack_plain(
        *args, kc, vc, pos, window=MISTRAL_WINDOW, **kw), 1, warmup=0)
    del kc, vc
    bound, bound_by, nbytes = kv8_bound(cfg, eng.params, hbm, peak, pos, 1,
                                        "bf16", MISTRAL_WINDOW)
    bound0, _, nbytes0 = kv8_bound(cfg, eng.params, hbm, peak, pos, 1, "bf16")
    say("mistral_stack_time", kernel=7, pos=pos,
        ms_per_step_window_4096=[f"{v:.4f}" for v in ms[MISTRAL_WINDOW]],
        ms_per_step_window_0=[f"{v:.4f}" for v in ms[0]],
        device_ms_window_4096=f"{queued[MISTRAL_WINDOW]:.4f}",
        device_ms_window_0=f"{queued[0]:.4f}",
        busy_ms_window_4096=f"{by[MISTRAL_WINDOW][0]:.4f}",
        busy_ms_window_0=f"{by[0][0]:.4f}",
        split_ms_window_4096=f"{by[MISTRAL_WINDOW][1]['split']:.4f}",
        split_ms_window_0=f"{by[0][1]['split']:.4f}",
        merge_ms_window_4096=f"{by[MISTRAL_WINDOW][1]['merge']:.4f}",
        merge_ms_window_0=f"{by[0][1]['merge']:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
        bound_by=bound_by, bytes_per_step=nbytes,
        bound_ms_window_0=f"{bound0:.4f}", bytes_per_step_window_0=nbytes0,
        ms_over_bound=f"{statistics.mean(ms[MISTRAL_WINDOW]) / bound:.2f}",
        library_ms="null: " + MISTRAL_LIB_NULL)
    row = dict(max_abs_err=errs[pos, MISTRAL_WINDOW],
               ms=statistics.mean(ms[MISTRAL_WINDOW]), plain_ms=plain_ms,
               bound_ms=bound, bound_by=bound_by, library_ms=None)
    del steps
    torch.cuda.empty_cache()
    t_matrix = time.perf_counter()
    phase_mistral_matrix(eng, dev, hbm, peak)
    say("mistral_stack", check_s=f"{check_s:.1f}",
        matrix_s=f"{time.perf_counter() - t_matrix:.1f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    return row


def phase_mistral_matrix(eng, dev, hbm, peak):
    """Phase 47's weight x cache pairs (JAX's ``test_window_quant_kv_matrix``)
    at Mistral-7B width, window 4096, pos 4600, each against its plain twin
    layer by layer, teacher-forced (``hold_by_layer``, one step of the
    8-bit format more): int8 + ``Int8KV``, int4 W4A8 + ``Int8KV``, int4
    exact + fp8; the free-running step printed (``step_drift``), every
    other row unchanged; each step's time beside its bound.  The int8 and
    int4 trees regroup the bf16 one to 8 kv heads a group
    (``quant_stack_weights``)."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    cfg, p = eng.cfg, eng.params
    L, pos = cfg.n_layers, MISTRAL_STACK_POS[0]
    hg = cfg.kv_heads // p["layers"]["wqkv_f"].shape[1]
    ok_all = True
    for kind, a8, fmt in (("int8", True, "int8"), ("int4", True, "int8"),
                          ("int4", False, "fp8")):
        tree = dict(p, layers=dict(p["layers"], **quant_stack_weights(
            p["layers"], hg, cfg.kv_heads, kind)))
        args, kw, kc, vc = _mistral_stack_case(cfg, tree, dev, pos, 48)
        kw["window"] = MISTRAL_WINDOW
        k8, v8 = kv8_cache(kc, vc, fmt, pos)
        del kc, vc
        kcfg = KernelConfig(int4_w4a8=a8)
        label = f"{kind}{'_w4a8' if kind == 'int4' and a8 else ''}+kv_{fmt}"
        where = dict(kernel=7, run=label, window=MISTRAL_WINDOW)
        kk, vk = kv_take(k8, 0, L), kv_take(v8, 0, L)
        kp, vp = kv_take(k8, 0, L), kv_take(v8, 0, L)
        out = sk.fused_decoder_stack(*args, kk, vk, pos, kcfg=kcfg, **kw)
        ref = sk.fused_decoder_stack_plain(*args, kp, vp, pos, int4_w4a8=a8,
                                           **kw)
        ok = step_drift("mistral_matrix", out, ref, kk, vk, kp, vp, pos, 1,
                        layers=L, **where)[0]
        del kk, vk, kp, vp, out, ref
        ok &= hold_by_layer(sk.fused_decoder_stack,
                            sk.fused_decoder_stack_plain, args, k8, v8, pos,
                            1, L, kcfg, kw, "mistral_matrix",
                            rows_rtol=KV8_STEP[fmt], **where)[1]
        ms = time_ms(functools.partial(sk.fused_decoder_stack, *args, k8, v8,
                                       pos, kcfg=kcfg, **kw), 5)
        bound, bound_by, nbytes = kv8_bound(cfg, tree, hbm, peak, pos, 1, fmt,
                                            MISTRAL_WINDOW)
        say("mistral_matrix_time", run=label, pos=pos, ms_per_step=f"{ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=bound_by, bytes_per_step=nbytes)
        ok_all &= ok
        del tree, args, k8, v8
        torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("kernel 7's window disagrees with its plain twin "
                             "on a quantized tree or an 8-bit cache")


def phase_mistral_flash(eng, dev, hbm, peak):
    """Phase 48: kernel 4's window at Mistral-7B's attention geometry (8 kv
    heads, group 4, hd 128) against its plain twin: the 4608-token prompt
    with window 4096 (its keys past 4096 masked below the window), a chunk
    of 1024 queries at q_offset 4608, and TinyLlama's hd-64 heads (kv 4,
    group 8) over 2048 tokens with window 1000.  Each head's output row
    within ROW_REL_TOL of its own largest |value| (``row_rel_err``: a row
    over ~4096 keys holds values near 0.03, so an absolute limit would
    pass a wrong window), and the kernel run at window - 64 and window +
    64 (a window edge one key tile off) must miss that limit against the
    twin at the window; window = the keys' count gives window 0's bits.  The 4608-token call's time
    (CUDA events) beside the plain twin's, one SDPA call with a boolean
    window mask (``library_ms``; the port never calls it), the same
    kernel without a window and the bound over the pairs the window keeps.
    Returns the kernels line's row."""
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    F = torch.nn.functional
    cfg = eng.cfg
    kv, g, hd = cfg.kv_heads, cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    gen = torch.Generator(device=dev).manual_seed(48)
    row = None
    for label, kv_, g_, T, q_off, hd_, w in (
            ("mistral_prompt", kv, g, MISTRAL_PROMPT, 0, hd, MISTRAL_WINDOW),
            ("mistral_chunk", kv, g, 1024, MISTRAL_PROMPT, hd,
             MISTRAL_WINDOW),
            ("hd64_gqa", 4, 8, 2048, 0, 64, 1000)):
        keys = q_off + T
        q = torch.randn((kv_, T, g_, hd_), generator=gen,
                        device=dev).bfloat16()
        k = torch.randn((kv_, keys, hd_), generator=gen, device=dev).bfloat16()
        v = torch.randn((kv_, keys, hd_), generator=gen, device=dev).bfloat16()
        call = functools.partial(fp.flash_prefill_attention, q, k, v,
                                 q_offset=q_off, window=w)
        out = call()
        ref = fp.flash_prefill_attention_plain(q, k, v, q_offset=q_off,
                                               window=w)
        none = fp.flash_prefill_attention(q, k, v, q_offset=q_off)
        wide = fp.flash_prefill_attention(q, k, v, q_offset=q_off,
                                          window=keys)
        # a window edge one key tile off, against the twin at the window
        off = {d: row_rel_err(fp.flash_prefill_attention(
            q, k, v, q_offset=q_off, window=w + d), ref, hd_)
            for d in (-64, 64)}
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all())
        max_abs = (out.float() - ref.float()).abs().max().item()
        rms = ref.float().square().mean().sqrt().item()
        row_rel = row_rel_err(out, ref, hd_)
        same = _same_bits(none, wide)
        differ = (out.float() - none.float()).abs().max().item()
        say("mistral_flash", kernel=4, shape=label, kv=kv_, group=g_, T=T,
            hd=hd_, q_offset=q_off, window=w, finite=finite,
            max_abs_err=f"{max_abs:.3g}", ref_rms=f"{rms:.4g}",
            max_abs_err_over_ref_rms=f"{max_abs / rms:.3g}",
            row_rel_err=f"{row_rel:.3g}", tol_row_rel=ROW_REL_TOL,
            row_rel_err_window_minus_64=f"{off[-64]:.3g}",
            row_rel_err_window_plus_64=f"{off[64]:.3g}",
            window_keys_bits_equal_window_0=same,
            window_vs_none_max_abs_diff=f"{differ:.3g}")
        if not (finite and same and differ > 1e-3 and row_rel <= ROW_REL_TOL
                and min(off.values()) > ROW_REL_TOL):
            raise AssertionError(f"kernel 4's window {label}: finite "
                                 f"{finite}, bits {same}, row error "
                                 f"{row_rel:.3g}, window -+64 {off}")
        if label != "mistral_prompt":
            continue
        ms = time_ms(call, 20)
        ms_none = time_ms(functools.partial(fp.flash_prefill_attention, q, k,
                                            v, q_offset=q_off), 20)
        plain_ms = time_ms(functools.partial(
            fp.flash_prefill_attention_plain, q, k, v, q_offset=q_off,
            window=w), 3, warmup=1)
        qs = q.permute(0, 2, 1, 3).reshape(1, kv_ * g_, T, hd_).contiguous()
        qpos = q_off + torch.arange(T, device=dev)[:, None]
        kpos = torch.arange(keys, device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - w)
        lib_ms = time_ms(functools.partial(
            F.scaled_dot_product_attention, qs, k[None], v[None],
            attn_mask=mask, enable_gqa=g_ > 1), 20)
        pairs = kv_ * g_ * sum(min(q_off + i + 1, w) for i in range(T))
        flops = 4 * hd_ * pairs
        nbytes = 2 * (2 * q.numel() + 2 * kv_ * keys * hd_)
        bound = max(flops / peak, nbytes / hbm) * 1e3
        bound_by = "operations" if flops / peak > nbytes / hbm else "bytes"
        say("mistral_flash_time", kernel=4, shape=label, window=w,
            ms=f"{ms:.4f}", ms_without_window=f"{ms_none:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
            library="scaled_dot_product_attention, boolean window mask",
            bound_ms=f"{bound:.4f}", bound_by=bound_by,
            tflops=f"{flops / ms / 1e9:.1f}",
            share_of_peak=f"{flops / ms / 1e9 / (peak / 1e12):.3f}")
        row = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)
    return row


def phase_mistral_verify(eng, dev, hbm, peak, n=5):
    """Phase 49: kernel 8's window at Mistral-7B width, n 5 at pos 4600
    over a random cache with large stale rows at and above pos, windows
    0, 4096 and 100 (each token its own bound), against its plain twin
    layer by layer, teacher-forced, at phase 9's limits
    (``hold_by_layer``), the free-running call printed (``step_drift``),
    its drift with a window at most DRIFT_OVER_WINDOW_0 times window 0's,
    every other row unchanged and a repeat bit-identical; the window-4096
    call's time beside the twin's and the bound.  Returns the kernels
    line's row."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    cfg, p = eng.cfg, eng.params
    lw, L, pos = p["layers"], cfg.n_layers, MISTRAL_STACK_POS[0]
    gen = torch.Generator(device=dev).manual_seed(49)
    shape = (L, cfg.kv_heads, MISTRAL_CAP, cfg.head_dim_)
    kc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    kc[:, :, pos:] *= 8
    vc[:, :, pos:] *= 8
    x = p["embed"][torch.arange(n, device=dev) * 37 + 11]
    cos, sin = model.rope_rows(cfg, pos, n, dev)
    args = (x, lw["attn_norm"], lw["ffn_norm"], cos, sin, lw["wqkv_f"],
            lw["wo_f"], lw["w13"], lw["w2"])
    kw = dict(group=cfg.n_heads // cfg.kv_heads, head_dim=cfg.head_dim_,
              rope_style=cfg.rope_style, eps=cfg.norm_eps,
              final_norm=p["final_norm"], lm_head=p["lm_head"])
    kcfg = KernelConfig()
    row, ok_all, drift = None, True, {}
    for w in (0, MISTRAL_WINDOW, 100):
        kk, vk = kc.clone(), vc.clone()
        out = sv.fused_verify_stack(*args, kk, vk, pos, window=w, **kw)
        n_kernels = sv.last_step_kernels
        kp, vp = kc.clone(), vc.clone()
        ref = sv.fused_verify_stack_plain(*args, kp, vp, pos, window=w, **kw)
        again = sv.fused_verify_stack(*args, kc.clone(), vc.clone(), pos,
                                      window=w, **kw)
        repeat = torch.equal(again[0], out[0])
        where = dict(kernel=8, n=n, window=w)
        ok, err, drift[w] = step_drift(
            "mistral_verify", out, ref, kk, vk, kp, vp, pos, n, layers=L,
            kernels_per_call=n_kernels, repeat_bit_identical=repeat, **where)
        ok_all &= ok and repeat and n_kernels == 8 * L + 2
        ok_all &= drift[w] <= DRIFT_OVER_WINDOW_0 * drift[0]
        ok_all &= hold_by_layer(
            sv.fused_verify_stack, sv.fused_verify_stack_plain, args, kc, vc,
            pos, n, L, kcfg, dict(kw, window=w), "mistral_verify",
            **where)[1]
        if w == MISTRAL_WINDOW:
            ms = time_ms(lambda: sv.fused_verify_stack(
                *args, kk, vk, pos, window=w, **kw), 10)
            plain_ms = time_ms(lambda: sv.fused_verify_stack_plain(
                *args, kp, vp, pos, window=w, **kw), 1, warmup=0)
            bound, bound_by, nbytes = kv8_bound(cfg, p, hbm, peak, pos, n,
                                                "bf16", w)
            say("mistral_verify_time", n=n, pos=pos, window=w,
                ms_per_call=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                bound_ms=f"{bound:.4f}", bound_by=bound_by,
                bytes_per_call=nbytes, library_ms="null: " + MISTRAL_LIB_NULL)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=bound_by, library_ms=None)
        del kk, vk, kp, vp, out, ref, again
    if not ok_all:
        raise AssertionError("kernel 8's window disagrees with its plain twin")
    del kc, vc
    torch.cuda.empty_cache()
    return row


def phase_mistral_e2e(eng, dev):
    """Phase 50: Mistral-7B's bs=1 paths end to end, window 4096.  The
    stream: ``stream_generate`` of 64 greedy tokens after a 4608-token
    prompt (so every decode step is past the window), the launch counts
    of kernels 4 and 7 set to 0 just before it and read just after (32
    and 64), prefill ms and tokens/s, every token against the plain path
    (eager prefill and decode on the card, windowed, teacher-forced)
    wherever its top-2 gap exceeds 0.1.  Then ``spec_generate`` (n_draft
    4, 32 tokens) with the target as its own draft (its own cache), its
    kernel-8 count set to 0 just before: one verify launch a round, some
    drafts accepted (so verify rows 1-4 decide tokens), its stream equal
    to the greedy stream's wherever the top-2 gap at the first difference
    exceeds 0.1.  Returns the launches {flash, stack, verify}."""
    from clusterfusion_tpu_torch.models.generation import Llama
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.ops import stack_verify as sv
    t0 = time.perf_counter()
    cfg = eng.cfg
    text = ("A sliding window keeps the last four thousand positions. "
            * 90)[:MISTRAL_PROMPT - 1]
    prompt = eng.tokenizer.encode(text, bos=True, eos=False)
    assert len(prompt) == MISTRAL_PROMPT
    fp.launches = sk.launches = 0
    stamps, toks = [], []
    for t in eng.stream_generate(prompt, MISTRAL_NEW, temperature=0.0):
        stamps.append(time.perf_counter())
        toks.append(t)
    launches = dict(flash=fp.launches, stack=sk.launches)
    st = eng.stats
    tok_s = (len(toks) - 1) / (stamps[-1] - stamps[0])
    say("mistral_e2e", prompt_tokens=len(prompt), new_tokens=len(toks),
        window=cfg.sliding_window, prefill_ms=f"{st.prefill_s * 1e3:.2f}",
        decode_tokens_per_s=f"{tok_s:.2f}",
        decode_ms_per_step=f"{1e3 / tok_s:.3f}",
        flash_prefill_launches=launches["flash"],
        stack_launches=launches["stack"])
    # a step follows each yielded token, the last one's too
    if launches != dict(flash=cfg.n_layers, stack=len(toks)) or \
            len(toks) != MISTRAL_NEW or \
            not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"the Mistral stream did not run kernels 4 and "
                             f"7 as expected: {launches}, {len(toks)} tokens")
    plain, gaps, bad = check_against_plain(eng, dev, prompt, toks, len(toks))
    FIGURES["mistral_stream"] = (prompt, toks, gaps)      # for phase 53
    agree = sum(a == b for a, b in zip(plain, toks))
    say("mistral_e2e", kernel_tokens=toks[:8], plain_tokens=plain[:8],
        agree=f"{agree}/{len(toks)}",
        min_top2_gap=f"{min(gaps):.3f}",
        disagree_where_gap_gt_0_1=bad)
    if bad:
        raise AssertionError(f"the Mistral stream and the plain path "
                             f"disagree at steps {bad}")
    draft = Llama(eng.params, cfg, eng.tokenizer, fused=True)
    sv.launches = 0
    spec = eng.spec_generate(prompt, MISTRAL_SPEC_NEW, draft, n_draft=4)
    launches["verify"] = sv.launches
    ss, gs = dict(eng.spec_stats), eng.stats
    div = next((i for i, (a, b) in enumerate(zip(spec, toks)) if a != b),
               None)
    say("mistral_spec", draft="the target", n_draft=4,
        tokens=len(spec), rounds=ss["rounds"],
        accepted_drafts=ss["accepted_drafts"],
        round_counts=ss["round_counts"], tokens_per_s=f"{gs.tokens_per_s:.2f}",
        verify_launches=launches["verify"],
        equal_to_stream=spec == toks[:len(spec)],
        first_difference_from_stream=div,
        top2_gap_there=None if div is None else f"{gaps[div]:.3f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    if launches["verify"] != ss["rounds"] or len(spec) != MISTRAL_SPEC_NEW \
            or not ss["accepted_drafts"]:
        raise AssertionError(f"spec_generate: {launches['verify']} verify "
                             f"launches for {ss['rounds']} rounds, "
                             f"{ss['accepted_drafts']} drafts accepted")
    if div is not None and gaps[div] > 0.1:
        raise AssertionError(f"spec_generate and the stream differ at {div}, "
                             f"top-2 gap {gaps[div]:.3f}")
    return launches


#: Phases 51-53: kernels 10 and 9 with Mistral's window, then the engine
#: with its rolling page buffer, on the Mistral-7B tree of phases 47-50.
SERVE_WINDOW_LENS = [0, 37, 4095, 4096, 4097, 4608, 6000, 8000]
SERVE_WINDOW_LAYER_LENS = [4095, 4608, 6000, 8000]
#: one page: the kernel run this far off the window must miss the limit
WINDOW_EDGE = 16
SERVE_WINDOW_NEW = 64
#: phase 53's prompt lengths past request 0 (phase 50's 4608 tokens)
SERVE_WINDOW_PROMPTS = [4100 + 72 * i for i in range(1, 8)]
SERVE_WINDOW_LIB_NULL = ("no single PyTorch call pages, windows and "
                         "appends")


def first_live(n, window):
    """The first cached row of a request of ``n`` rows in the window."""
    return min(n, max(0, n + 1 - window)) if window else 0


def window_inputs(kb, vb, table, lens, window, dtype):
    """The rolling buffer's view of bf16 pools: (table with the slots
    wholly below each request's bound on the NULL page 0, copies of the
    pools in ``dtype`` with NaN in page 0 and in every row below each
    bound)."""
    page = kb.shape[3]
    t = table.clone()
    kw, vw = kb.clone(), vb.clone()
    kw[:, 0] = vw[:, 0] = float("nan")
    for b, n in enumerate(lens.tolist()):
        lo = first_live(n, window)
        j = torch.arange(lo, device=kb.device)
        kw[:, table[b, j // page].long(), :, j % page] = float("nan")
        vw[:, table[b, j // page].long(), :, j % page] = float("nan")
        t[b, :lo // page] = 0
    return t, kw.to(dtype), vw.to(dtype)


def window_row_bound(hbm, peak, lens, window, kv, g, hd, B, other_bytes=0,
                     flops=0, rb=2):
    """(bound ms, bound_by, bytes): ``other_bytes`` plus the K and V rows
    of ``rb`` bytes an element in each request's window read once, and the
    walk's operations plus ``flops``."""
    rows = sum(n - first_live(n, window) for n in lens)
    nbytes = other_bytes + 2 * rows * kv * hd * rb
    flops = flops + 4 * kv * g * hd * (rows + B)
    bound = max(nbytes / hbm, flops / peak) * 1e3
    return bound, "bytes" if nbytes / hbm >= flops / peak else "operations", \
        nbytes


def windowed_case(label, call, plain, kb, vb, table, lens, window, rows_of,
                  appended_ok, dtype, **where):
    """One checked window of kernel 10 or 9 (``call``/``plain`` take
    (pools, table, window) and return the output and the pools) on pools
    of ``dtype`` made from the bf16 ``kb``/``vb``: the kernel over NaN in
    page 0 and below every bound (``window_inputs``) against its twin over
    the same, each row (``rows_of``: elements a row) within ROW_REL_TOL,
    finite, the appends by ``appended_ok`` and every other byte unchanged;
    where the window lies inside a request's rows, the kernel at window -+
    WINDOW_EDGE on the pools without that NaN must miss that limit against
    the twin at the window.  Returns (ok, max abs error)."""
    tw, kw, vw = window_inputs(kb, vb, table, lens, window, dtype)
    kp, vp = kb.to(dtype), vb.to(dtype)
    k0, v0 = kw.clone(), vw.clone()
    kr, vr = kw.clone(), vw.clone()
    out, kk, vk = call(kw, vw, tw, window)
    ref, _, _ = plain(kr, vr, tw, window)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out.float()).all())
    max_abs = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref, rows_of)
    app = append_mask(kk, tw, lens, 1)          # layer 1 of two
    appended = appended_ok(kk, vk, kr, vr, tw)
    untouched = (_same_bytes(kk[~app], k0[~app])
                 and _same_bytes(vk[~app], v0[~app]))
    ref_clean = plain(kp.clone(), vp.clone(), table, window)[0]
    edge = {}
    for d in (-WINDOW_EDGE, WINDOW_EDGE):
        if window + d >= 1 and window <= int(lens.max()):
            got = call(kp.clone(), vp.clone(), table, window + d)[0]
            edge[d] = row_rel_err(got, ref_clean, rows_of)
    torch.cuda.synchronize()
    say(label, **where, window=window, lens=lens.tolist(), finite=finite,
        max_abs_err=f"{max_abs:.3g}", row_rel_err=f"{rel:.3g}",
        tol_row_rel=ROW_REL_TOL, appended_ok=appended,
        other_bytes_unchanged=untouched,
        nan_in_page_0_and_below_each_bound=True,
        **{f"row_rel_err_window_{'minus' if d < 0 else 'plus'}_{abs(d)}":
           f"{e:.3g}" for d, e in edge.items()})
    ok = (finite and rel <= ROW_REL_TOL and appended and untouched
          and all(e > ROW_REL_TOL for e in edge.values()))
    return ok, max_abs


def past_row_0_bits(call, kp, vp, table, lens):
    """Window max(lens) + 1 against window 0: the output and both pools
    equal bit for bit."""
    a = call(kp.clone(), vp.clone(), table, 0)
    b = call(kp.clone(), vp.clone(), table, int(lens.max()) + 1)
    torch.cuda.synchronize()
    return all(_same_bytes(x, y) for x, y in zip(a, b))


def phase_window_paged_attention(dev, hbm, peak, cfg):
    """Phase 51: kernel 10 with Mistral's window at Mistral-7B's attention
    geometry (kv 8, group 4, hd 128, page 16, B 8 at lens 0 (a padding row
    on the NULL page), 37, 4095-4097, 4608, 6000 and 8000), windows 4096,
    100 (its bound inside a page and a split), 1 and max(lens) + 1, on bf16
    and fp8 pools (``windowed_case``: NaN in page 0 and below every bound,
    the slots wholly below it on page 0; the appended rows equal to the
    twin's; window -+16 missing the limit), window max(lens) + 1 giving
    window 0's bits; one hd-64 case (kv 4, group 8, window 100).  Then B 8
    at lens 8000: window 4096 against window 0 (CUDA events, calls back to
    back, and the split and merge passes' busy time), and window 0 at lens
    4095 over a table of 501 pages and of 256 (the cost of the dead split
    blocks the first grid keeps), beside the twin and the byte bound.
    Returns the kernels line's row."""
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    kv, g, hd = cfg.kv_heads, cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    gen = torch.Generator(device=dev).manual_seed(51)
    page, layer, ok_all = 16, 1, True
    for kv_, g_, hd_, lens_l, windows, pools in (
            (kv, g, hd, SERVE_WINDOW_LENS,
             (MISTRAL_WINDOW, 100, 1, max(SERVE_WINDOW_LENS) + 1),
             ("bf16", "fp8")),
            (4, 8, 64, SERVE_WINDOW_LENS, (100,), ("bf16",))):
        B = len(lens_l)
        kb, vb, table, lens = paged_pools(dev, 2, kv_, hd_, page, lens_l, 51)
        table[0] = 0                       # the padding row: the NULL page
        nan_unowned(kb, vb, table, lens)
        q = torch.randn((B, kv_, g_, hd_), generator=gen,
                        device=dev).bfloat16()
        kn = torch.randn((B, kv_, hd_), generator=gen, device=dev).bfloat16()
        vn = torch.randn((B, kv_, hd_), generator=gen, device=dev).bfloat16()
        for pool in pools:
            dtype = FP8 if pool == "fp8" else torch.bfloat16
            kp, vp = kb.to(dtype), vb.to(dtype)

            def call(k, v, t, w):
                return pd.paged_attention(q, kn, vn, k, v, t, lens, layer,
                                          window=w)

            def plain(k, v, t, w):
                return pd.paged_attention_plain(q, kn, vn, k, v, t, lens,
                                                layer, window=w)

            def appended_ok(kk, vk, kr, vr, t):
                return _same_bytes(kk, kr) and _same_bytes(vk, vr)

            for w in windows:
                ok, _ = windowed_case(
                    "window_paged_attention", call, plain, kb, vb, table,
                    lens, w, hd_, appended_ok, dtype, kernel=10,
                    kv_pool=pool, kv=kv_, group=g_, hd=hd_, B=B, page=page)
                ok_all &= ok
            bits = past_row_0_bits(call, kp, vp, table, lens)
            say("window_paged_attention", kernel=10, kv_pool=pool, hd=hd_,
                window_max_lens_plus_1_bits_equal_window_0=bits)
            ok_all &= bits
    if not ok_all:
        raise AssertionError("kernel 10's window disagrees with its twin, "
                             "reads below a bound, or its edge is off")
    # the row: B 8 at the longest lens, window 4096 against window 0
    B, n_max = 8, max(SERVE_WINDOW_LENS)
    kb, vb, table, lens = paged_pools(dev, 2, kv, hd, page, [n_max] * B, 52)
    q = torch.randn((B, kv, g, hd), generator=gen, device=dev).bfloat16()
    kn = torch.randn((B, kv, hd), generator=gen, device=dev).bfloat16()
    vn = torch.randn((B, kv, hd), generator=gen, device=dev).bfloat16()
    kr, vr = kb.clone(), vb.clone()
    calls = {w: functools.partial(pd.paged_attention, q, kn, vn, kb, vb,
                                  table, lens, layer, window=w)
             for w in (MISTRAL_WINDOW, 0)}
    out = calls[MISTRAL_WINDOW]()
    ref = pd.paged_attention_plain(q, kn, vn, kr, vr, table, lens, layer,
                                   window=MISTRAL_WINDOW)
    max_abs = (out[0].float() - ref[0].float()).abs().max().item()
    rel = row_rel_err(out[0], ref[0], hd)
    ms = {w: [] for w in calls}
    for w in (MISTRAL_WINDOW, 0, 0, MISTRAL_WINDOW):
        ms[w].append(queued_ms(calls[w]))
    by = {w: busy_ms(f, PAGED_PASSES) for w, f in calls.items()}
    plain_ms = time_ms(lambda: pd.paged_attention_plain(
        q, kn, vn, kr, vr, table, lens, layer, window=MISTRAL_WINDOW), 3,
        warmup=1)
    # window 0 at the window's rows, over the wide table and a narrow one
    lens_d = torch.full_like(lens, MISTRAL_WINDOW - 1)
    narrow = table[:, :MISTRAL_WINDOW // page].clone()
    dead = {name: queued_ms(functools.partial(
        pd.paged_attention, q, kn, vn, kb, vb, t, lens_d, layer))
        for name, t in (("wide", table), ("narrow", narrow))}
    io = 2 * (2 * q.numel() + 4 * B * kv * hd)
    bound, bound_by, nbytes = window_row_bound(
        hbm, peak, lens.tolist(), MISTRAL_WINDOW, kv, g, hd, B, io)
    bound0, _, nbytes0 = window_row_bound(hbm, peak, lens.tolist(), 0, kv, g,
                                          hd, B, io)
    ns = pd.cdiv(table.shape[1] * page, pd.SPLIT)
    live = ns - first_live(n_max, MISTRAL_WINDOW) // pd.SPLIT
    say("window_paged_attention_time", kernel=10, B=B, lens=n_max, kv=kv,
        group=g, hd=hd, page=page, split=pd.SPLIT,
        row_rel_err=f"{rel:.3g}", max_abs_err=f"{max_abs:.3g}",
        ms_window_4096=[f"{v:.4f}" for v in ms[MISTRAL_WINDOW]],
        ms_window_0=[f"{v:.4f}" for v in ms[0]],
        split_ms_window_4096=f"{by[MISTRAL_WINDOW][1]['split']:.4f}",
        merge_ms_window_4096=f"{by[MISTRAL_WINDOW][1]['merge']:.4f}",
        split_ms_window_0=f"{by[0][1]['split']:.4f}",
        merge_ms_window_0=f"{by[0][1]['merge']:.4f}",
        grid_splits=ns, live_splits_window_4096=live,
        lens_dead_case=MISTRAL_WINDOW - 1,
        ms_dead_case_table_pages={table.shape[1]: f"{dead['wide']:.4f}",
                                  narrow.shape[1]: f"{dead['narrow']:.4f}"},
        dead_split_blocks_ms=f"{dead['wide'] - dead['narrow']:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
        bound_by=bound_by, bytes=nbytes, bound_ms_window_0=f"{bound0:.4f}",
        bytes_window_0=nbytes0,
        library_ms="null: " + SERVE_WINDOW_LIB_NULL)
    if not rel <= ROW_REL_TOL:
        raise AssertionError(f"kernel 10 at lens {n_max}, window "
                             f"{MISTRAL_WINDOW}: row error {rel:.3g}")
    return dict(max_abs_err=max_abs, ms=statistics.mean(ms[MISTRAL_WINDOW]),
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None)


def phase_window_paged_layer(eng, tree4, dev, hbm, peak):
    """Phase 52: kernel 9 with Mistral's window on layer 1 of the Mistral-7B
    tree, B 4 at lens 4095, 4608, 6000 and 8000 (positions = lens), windows
    4096, 100, 1 and max(lens) + 1, as phase 51 holds kernel 10
    (``windowed_case``; each request's output row of 4096 within
    ROW_REL_TOL of its own largest value; the appended rows within 0.05 on
    bf16 pools, within one e4m3 code on fp8 ones): bf16, int8 and int4
    (exact, ``tree4``) weights on bf16 pools and bf16 weights on an fp8
    pool; one hd-64 layer (random weights at TinyLlama-1.1B's widths,
    window 100).  Then the bf16 layer at window 4096 and at window 0
    (calls back to back) beside its twin and the byte bound (the QKV and O
    weights once and the rows in the windows).  Returns the kernels line's
    row."""
    from clusterfusion_tpu_torch.config import LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    cfg, p = eng.cfg, eng.params
    g, hd, kv, hidden = (cfg.n_heads // cfg.kv_heads, cfg.head_dim_,
                         cfg.kv_heads, cfg.hidden_dim)
    gen = torch.Generator(device=dev).manual_seed(52)
    layer, page, ok_all, row = 1, 16, True, None
    hg = cfg.kv_heads // p["layers"]["wqkv_f"].shape[1]
    two = {k: w[:2] for k, w in p["layers"].items()}
    lw8 = quant_stack_weights(two, hg, cfg.kv_heads, "int8")
    lw4 = tree4["layers"]
    ct = LlamaConfig.tinyllama_1b()
    G, hgt = 2, ct.kv_heads // 2
    gt = ct.n_heads // ct.kv_heads
    hd64 = dict(
        wqkv_f=(torch.randn((2, G, ct.hidden_dim, hgt * (gt + 2) * 64),
                            generator=gen, device=dev)
                * ct.hidden_dim ** -0.5).bfloat16(),
        wo_f=(torch.randn((2, G, hgt * gt * 64, ct.hidden_dim), generator=gen,
                          device=dev) * (ct.kv_heads * gt * 64) ** -0.5
              ).bfloat16(),
        attn_norm=(1 + 0.1 * torch.randn((2, ct.hidden_dim), generator=gen,
                                         device=dev)).bfloat16())
    lens_l = SERVE_WINDOW_LAYER_LENS
    B = len(lens_l)
    windows = (MISTRAL_WINDOW, 100, 1, max(lens_l) + 1)
    for label, c, lw, pool, ws in (
            ("bf16", cfg, p["layers"], "bf16", windows),
            ("int8", cfg, dict(two, **lw8), "bf16", windows),
            ("int4_exact", cfg, lw4, "bf16", windows),
            ("bf16", cfg, p["layers"], "fp8", windows),
            ("bf16 (random, tinyllama widths)", ct, hd64, "bf16", (100,))):
        kvc, gc, hdc, hid = (c.kv_heads, c.n_heads // c.kv_heads, c.head_dim_,
                             c.hidden_dim)
        cos_t, sin_t = model.rope_table(dataclasses.replace(
            c, max_seq_len=MISTRAL_CAP), device=dev)
        kb, vb, table, lens = paged_pools(dev, 2, kvc, hdc, page, lens_l, 53)
        nan_unowned(kb, vb, table, lens)
        dtype = FP8 if pool == "fp8" else torch.bfloat16
        kp, vp = kb.to(dtype), vb.to(dtype)
        x = torch.randn((B, hid), generator=gen, device=dev).bfloat16()
        res = torch.randn((B, hid), generator=gen, device=dev).bfloat16()
        tail = (layer, lw["attn_norm"][layer], c.norm_eps, cos_t, sin_t)
        kw = dict(group=gc, rope_style=c.rope_style)

        def call(k, v, t, w, lw=lw, x=x, res=res, lens=lens, tail=tail,
                 kw=kw):
            out = pd.llama_decoder_layer_paged(
                x, res, lw["wqkv_f"], lw["wo_f"], t, lens, lens, k, v, *tail,
                window=w, **kw)
            return out[0], out[2], out[3]

        def plain(k, v, t, w, lw=lw, x=x, res=res, lens=lens, tail=tail,
                  kw=kw):
            out = pd.llama_decoder_layer_paged_plain(
                x, res, lw["wqkv_f"], lw["wo_f"], t, lens, lens, k, v, *tail,
                window=w, **kw)
            return out[0], out[2], out[3]

        def appended_ok(kk, vk, kr, vr, t, lens=lens, pool=pool):
            if pool == "fp8":
                return all(e4m3_one_step(appended_rows(a, t, lens, layer),
                                         appended_rows(b, t, lens, layer))[0]
                           for a, b in ((kk, kr), (vk, vr)))
            return max((appended_rows(a, t, lens, layer).float()
                        - appended_rows(b, t, lens, layer).float()).abs()
                       .max().item() for a, b in ((kk, kr), (vk, vr))) <= 0.05

        for w in ws:
            ok, max_abs = windowed_case(
                "window_paged_layer", call, plain, kb, vb, table, lens, w,
                hid, appended_ok, dtype, kernel=9, weights=label,
                kv_pool=pool, hd=hdc, B=B)
            ok_all &= ok
        if len(ws) > 1:
            bits = past_row_0_bits(call, kp, vp, table, lens)
            say("window_paged_layer", kernel=9, weights=label, kv_pool=pool,
                window_max_lens_plus_1_bits_equal_window_0=bits)
            ok_all &= bits
        if label == "bf16" and pool == "bf16":
            calls = {w: functools.partial(call, kp, vp, table, w)
                     for w in (MISTRAL_WINDOW, 0)}
            out = calls[MISTRAL_WINDOW]()[0]
            kr, vr = kp.clone(), vp.clone()
            ref = plain(kr, vr, table, MISTRAL_WINDOW)[0]
            max_abs = (out.float() - ref.float()).abs().max().item()
            ms = {w: [] for w in calls}
            for w in (MISTRAL_WINDOW, 0, 0, MISTRAL_WINDOW):
                ms[w].append(queued_ms(calls[w]))
            by = busy_ms(calls[MISTRAL_WINDOW], LAYER9_PASSES)[1]
            plain_ms = time_ms(functools.partial(plain, kr, vr, table,
                                                 MISTRAL_WINDOW), 3, warmup=1)
            w_elems = lw["wqkv_f"][layer].numel() + lw["wo_f"][layer].numel()
            io = 2 * (w_elems + 4 * B * hid + hid + 2 * B * kvc * hdc)
            bound, bound_by, nbytes = window_row_bound(
                hbm, peak, lens_l, MISTRAL_WINDOW, kvc, gc, hdc, B, io,
                2 * B * w_elems)
            say("window_paged_layer_time", kernel=9, weights=label, B=B,
                lens=lens_l, ms_window_4096=[f"{v:.4f}"
                                             for v in ms[MISTRAL_WINDOW]],
                ms_window_0=[f"{v:.4f}" for v in ms[0]],
                **{f"{k}_ms_window_4096": f"{v:.4f}" for k, v in by.items()},
                plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
                bound_by=bound_by, bytes=nbytes, weight_bytes=2 * w_elems,
                library_ms="null: " + SERVE_WINDOW_LIB_NULL)
            row = dict(max_abs_err=max_abs,
                       ms=statistics.mean(ms[MISTRAL_WINDOW]),
                       plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                       library_ms=None)
        del kb, vb, kp, vp
    del lw8, two
    torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("kernel 9's window disagrees with its twin, "
                             "reads below a bound, or its edge is off")
    return row


def window_prompts(eng):
    """Phase 53's eight prompts of 4100-4608 tokens: request 0 is phase
    50's prompt, the others other texts."""
    prompts = [FIGURES["mistral_stream"][0]]
    for i, n in enumerate(SERVE_WINDOW_PROMPTS, 1):
        text = (f"Request {i} reads a long document, page after page. "
                * 120)[:n - 1]
        prompts.append(eng.tokenizer.encode(text, bos=True, eos=False))
    return prompts


def near_argmax(params, cfg, dev, prompt, toks, kv_dtype):
    """Every served token against the plain path (``plain_logits``,
    windowed, a cache of ``kv_dtype``): (the steps whose token lies 0.02 x
    the largest |logit| or more below the plain argmax, the largest such
    distance over that scale, the plain top-2 gaps)."""
    bad, worst, gaps = [], 0.0, []
    for i, lg in enumerate(plain_logits(params, cfg, dev, prompt, toks,
                                        kv_dtype)):
        lg = lg.float()
        gap = (lg.max() - lg[toks[i]]).item() / max(lg.abs().max().item(), 1.0)
        top = torch.topk(lg, 2).values
        gaps.append((top[0] - top[1]).item())
        worst = max(worst, gap)
        if gap >= 0.02:
            bad.append(i)
    return bad, worst, gaps


def serve_window(eng, params, dev, prompts, impl, kv_dtype, label):
    """One run of ``ServingEngine`` with Mistral's window and its rolling
    page buffer: page 16, ``max_batch`` 8, a pool of 8 x 257 + 1 + 8
    pages (full context needs more), every prompt past the window, 64
    greedy tokens each.  The kernels' launch counts are set to 0 just
    before the run and read just after.  Returns (outputs, launches,
    figures, the last step's arguments)."""
    from clusterfusion_tpu_torch.ops import flash_prefill as fp
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    from clusterfusion_tpu_torch.runtime import ServingEngine
    cfg, page, mb, n_new = eng.cfg, 16, 8, SERVE_WINDOW_NEW
    window_pages = -(-cfg.sliding_window // page) + 1
    num_pages = mb * window_pages + 1 + 8
    full_need = sum(-(-(len(p) + n_new) // page) for p in prompts)
    srv = ServingEngine(params, cfg, page_size=page, num_pages=num_pages,
                        max_batch=mb, kv_dtype=kv_dtype, step_impl=impl)
    pre_ms, step_s, batch, peak_pages, last = [], [], [], [0], []
    real_prefill, real_step = srv._prefill_into_pool, srv._step
    total = srv.sched.num_pages - 1

    def timed_prefill(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_prefill(req)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)

    def timed_step(*a):
        batch.append(int((a[6] > 0).sum()))
        peak_pages[0] = max(peak_pages[0], total - srv.sched.free_pages)
        last[:] = a
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
    out = srv.run()
    launches = dict(pd.launches, flash=fp.launches)
    steps = len(step_s)
    decode_tokens = sum(len(t) for t in out.values()) - len(prompts)
    fig = dict(tokens_per_s=decode_tokens / sum(step_s),
               ms_per_step=sum(step_s) * 1e3 / steps)
    busy = step_busy_ms(lambda: real_step(*last))
    say("serving_window", run=label, step=impl, kv_pool=str(kv_dtype),
        requests=len(prompts), prompt_tokens=[len(p) for p in prompts],
        new_tokens=n_new, window=cfg.sliding_window, page=page,
        window_pages=window_pages, pool_pages=num_pages,
        full_context_pages=full_need, peak_pages_in_use=peak_pages[0],
        decode_steps=steps, batch_rows_min=min(batch),
        decode_tokens_per_s=f"{fig['tokens_per_s']:.2f}",
        ms_per_step=f"{fig['ms_per_step']:.3f}",
        device_busy_ms_last_step=f"{busy:.3f}",
        prefill_ms_per_request=[round(x, 1) for x in pre_ms],
        prefills=len(pre_ms), flash_prefill_launches=launches["flash"],
        **{k: v for k, v in launches.items() if k != "flash" and v})
    key = "paged_attention" if impl == "batched" else \
        "llama_decoder_layer_paged"
    want = cfg.n_layers * steps
    ok = (len(pre_ms) == len(prompts) and min(batch) == len(prompts)
          and steps == n_new - 1 and num_pages < full_need
          and peak_pages[0] <= mb * window_pages
          and launches[key] == want and launches[key + "_window"] == want
          and launches["flash"] == cfg.n_layers * sum(
              -(-len(p) // 1024) for p in prompts)
          and (kv_dtype != FP8 or launches[key + "_fp8"] == want)
          and all(len(t) == n_new and all(0 <= x < cfg.vocab_size for x in t)
                  for t in out.values())
          and all(r.error is None for r in srv.last_results.values()))
    if not ok:
        raise AssertionError(f"serving with the window ({label}): "
                             f"{len(pre_ms)} prefills, batch {min(batch)}, "
                             f"{steps} steps, launches {launches}, peak "
                             f"pages {peak_pages[0]}")
    del srv, last
    torch.cuda.empty_cache()
    return out, launches, dict(fig, busy_ms=busy, prefill_ms=pre_ms,
                               peak_pages=peak_pages[0],
                               full_need=full_need)


def phase_window_serving(eng, tree4, dev):
    """Phase 53: ``ServingEngine`` with Mistral's window and its rolling
    page buffer on Mistral-7B (``serve_window``: eight requests of
    4100-4608 prompt tokens, each past the window, 64 greedy tokens, in a
    pool of 2065 pages where full context needs 2336: all admitted at
    once, none preempted, at most 257 pages a request), through the
    batched step (kernel 10) and the fused step (kernel 9) on bf16 pools,
    then the int4 (exact) tree's default fused step on an fp8 pool.  Each
    run: every served token of requests 0 and 5 within 0.02 x the largest
    |logit| of the plain path's argmax fed the same prefix
    (``near_argmax``); request 0 against phase 50's bs=1 stream on the same
    prompt (equal up to the first difference, where the plain top-2 gap is
    at most 0.1, phase 8's limit).  Then ``Llama.generate`` at B 4 on the
    same config, held the same way against the batched run.  Returns the
    launches {paged, layer} of the bf16 runs."""
    t0 = time.perf_counter()
    cfg = eng.cfg
    prompts = window_prompts(eng)
    s_prompt, s_toks, s_gaps = FIGURES["mistral_stream"]
    runs, launches, plain_gaps, ok_all = {}, {}, {}, True
    for label, impl, kvd, params in (
            ("bf16_batched", "batched", torch.bfloat16, eng.params),
            ("bf16_fused", "fused", torch.bfloat16, eng.params),
            ("int4_fused_fp8_pool", "fused", FP8, tree4)):
        out, lc, fig = serve_window(eng, params, dev, prompts, impl, kvd,
                                    label)
        runs[label] = (out, fig)
        launches[label] = lc
        for rid in (0, 5):
            bad, worst, gaps = near_argmax(params, cfg, dev, prompts[rid],
                                           out[rid], kvd)
            plain_gaps[label, rid] = gaps
            say("serving_window", run=label, request=rid,
                kernel_tokens=out[rid][:8],
                worst_gap_over_scale=f"{worst:.4f}", tol=0.02,
                steps_past_tol=bad, min_top2_gap=f"{min(gaps):.3f}")
            ok_all &= not bad
        if params is not eng.params:
            continue                       # the stream ran the bf16 tree
        div = next((i for i, (a, b) in enumerate(zip(out[0], s_toks))
                    if a != b), None)
        say("serving_window", run=label, request=0,
            vs_phase_50_stream_first_difference=div,
            stream_top2_gap_there=None if div is None
            else f"{s_gaps[div]:.3f}")
        ok_all &= div is None or s_gaps[div] <= 0.1
    from clusterfusion_tpu_torch.ops import paged_decoder_layer as pd
    # generate at B 4: requests 0 and 5 first, held by their plain gaps
    # along the batched run's tokens (the byte tokenizer's eos may end a
    # row early)
    pd.launches.update(dict.fromkeys(pd.launches, 0))
    rids = (0, 5, 1, 2)
    gen_toks, _ = eng.generate([prompts[r] for r in rids], 8,
                               temperature=0.0)
    gen_launch = pd.launches["paged_attention_window"]
    ref = runs["bf16_batched"][0]
    divs = [next((i for i, (a, b) in enumerate(zip(gen_toks[j], ref[r]))
                  if a != b), None) for j, r in enumerate(rids)]
    say("generate_window", B=4, requests=list(rids), new_tokens=8,
        tokens=[t[:4] for t in gen_toks],
        paged_attention_window_launches=gen_launch,
        first_difference_from_batched_run=divs,
        seconds=f"{time.perf_counter() - t0:.1f}")
    ok_all &= (all(0 < len(t) <= 8 for t in gen_toks) and gen_launch > 0
               and gen_launch % cfg.n_layers == 0
               and all(divs[j] is None or divs[j] >= len(gen_toks[j])
                       or plain_gaps["bf16_batched", r][divs[j]] <= 0.1
                       for j, r in enumerate(rids[:2])))
    b, f = runs["bf16_batched"][1], runs["bf16_fused"][1]
    say("serving_window", batched_tokens_per_s=f"{b['tokens_per_s']:.2f}",
        fused_tokens_per_s=f"{f['tokens_per_s']:.2f}",
        int4_fp8_tokens_per_s=
        f"{runs['int4_fused_fp8_pool'][1]['tokens_per_s']:.2f}",
        peak_pages=b["peak_pages"], full_context_pages=b["full_need"])
    if not ok_all:
        raise AssertionError("windowed serving disagrees with the plain path "
                             "or with the bs=1 stream")
    return dict(paged=launches["bf16_batched"]["paged_attention_window"],
                layer=launches["bf16_fused"]
                ["llama_decoder_layer_paged_window"])


# -- Mistral's window on the multi-card paths (phases 54-56) -----------------

#: Phase 54: kernel 6's positions and windows (None: pos + 1, reaching row
#: 0), and the sp step's four virtual shards of K6_SHARD rows at each of
#: K6_SHARD_POS (4600: shard 0 cut by the window, 1 inside, 2 the owner, 3
#: empty; 6500: shard 0 wholly below the window, 1 cut, 2 inside, 3 the
#: owner).
K6_WINDOW_POS = (4600, 8000)
K6_WINDOWS = (0, MISTRAL_WINDOW, 100, None, 1)
K6_SHARD, K6_SHARD_POS = 2048, (4600, 6500)
#: Phase 55: the pair's position and windows, the layers it runs free.
MODE5_WINDOW_POS, MODE5_WINDOWS, MODE5_FREE_LAYERS = 8000, (MISTRAL_WINDOW,
                                                            1), 4
#: Phase 56: greedy steps of the tp and the sp step.
SHARDED_WINDOW_STEPS = (16, 8)
K6_WINDOW_LIB_NULL = ("no single PyTorch call computes the fused layer "
                      "half or the mode-5 step")


def nan_outside(c, lo, hi):
    """NaN in every row of the cache ``c`` below ``lo`` and at and above
    ``hi`` (e4m3: the NaN byte 0x7F), in place; returns ``c``."""
    fp8 = c.dtype == torch.float8_e4m3fn
    v = c.view(torch.uint8) if fp8 else c
    nan = 0x7F if fp8 else float("nan")
    v[:, :, :max(lo, 0)] = nan
    v[:, :, hi:] = nan
    return c


def phase_window_layer(eng, dev, hbm, peak, layer=1):
    """Phase 54: kernel 6's sliding window (``_fused_decoder_layer`` with
    ``window`` and ``window_lo``) at Mistral-7B's width, layer 1 of the
    engine's tree (head group 8), over a random 8192-row cache with NaN
    above pos and below each window's bound: at pos 4600 and 8000, windows
    0, 4096, 100, pos + 1 and 1, on bf16 and fp8 caches, full mode with the
    append, each against its plain twin at phase 13's limits (out and
    residual atol 2e-2 + rtol 2e-2; k_new, v_new and the appended row
    0.05, fp8 plus one e4m3 step), finite, every other row's bits
    unchanged, one kernel; window pos + 1 gives window 0's bits.  One case
    with int8 weights (layer 1 quantized per output column) and one with
    int4 weights in the exact mode (groups of 128) at pos 8000, window
    4096.  Then partials mode with the sp step's bound
    (``shard_window_lo``) over four virtual shards of 2048 rows, at pos
    4600 and 6500 (``K6_SHARD_POS``): each shard against its twin (m and l
    at 2e-2, acc at atol 5e-2 + rtol 2e-2), the wholly-below and empty
    shards exactly (m = -1e30, l = 0, acc = 0), the four merged by the sp
    step's algebra against one partials call over the whole cache with
    the window (o within 2e-2).  Then the bf16 layer at pos 8000, windows
    4096 and 0, by ``queued_ms`` beside the bound (the weights and the rows
    in the window), its launch plan and phases.  Returns the kernels
    line's row (pos 8000, window 4096, bf16)."""
    from clusterfusion_tpu_torch.config import KernelConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.parallel.sp_decode import shard_window_lo
    t0 = time.perf_counter()
    cfg, lw = eng.cfg, eng.params["layers"]
    g, hd, hidden = cfg.n_heads // cfg.kv_heads, cfg.head_dim_, cfg.hidden_dim
    kvh, cap = cfg.kv_heads, MISTRAL_CAP
    hg = kvh // lw["wqkv_f"].shape[1]
    gen = torch.Generator(device=dev).manual_seed(54)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).bfloat16()

    base = [rnd((1, kvh, cap, hd)) for _ in range(2)]
    x, res = rnd((1, hidden)), rnd((1, hidden))
    norm = 1 + 0.1 * rnd((hidden,))
    kw = dict(group=g, head_dim=hd, rope_style=cfg.rope_style,
              fuse_residual=True, eps=cfg.norm_eps)
    one = {k: lw[k][layer:layer + 1] for k in ("wqkv_f", "wo_f", "w13", "w2")}
    weights = {"bf16": (lw["wqkv_f"][layer], lw["wo_f"][layer], True)}
    for kind, a8 in (("int8", True), ("int4", False)):
        q = quant_stack_weights(one, hg, hg, kind)
        weights[kind] = (q["wqkv_f"], q["wo_f"], a8)
    fmts = dict(bf16=torch.bfloat16, fp8=torch.float8_e4m3fn)

    def cache(pos, lo, fmt):
        return [nan_outside(b.to(fmts[fmt], copy=True), lo, pos)
                for b in base]

    cases = [(pos, w, fmt, "bf16") for pos in K6_WINDOW_POS
             for fmt in fmts for w in K6_WINDOWS]
    cases += [(K6_WINDOW_POS[-1], MISTRAL_WINDOW, "bf16", wts)
              for wts in ("int8", "int4")]
    ok_all, outs, errs = True, {}, {}
    for pos, w, fmt, wts in cases:
        w = pos + 1 if w is None else w
        lo = pos + 1 - w if w else 0
        wq, wo, a8 = weights[wts]
        kcfg = KernelConfig(int4_w4a8=a8)
        cos, sin = model.rope_row(cfg, pos, dev)
        kc, vc = cache(pos, lo, fmt)
        kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        args = (x, res, norm, cos, sin, wq, wo)
        out = dl._fused_decoder_layer(*args, kk, vk, pos, 0, append_kv=True,
                                      window=w, kcfg=kcfg, **kw)
        n_kernels = dl.last_call_kernels
        ref = dl._fused_decoder_layer_plain(*args, kp, vp, pos, 0,
                                            append_kv=True, window=w,
                                            kcfg=kcfg, **kw)
        torch.cuda.synchronize()
        err = max((out[i].float() - ref[i].float()).abs().max().item()
                  for i in (0, 1))
        within = all(bool(torch.isclose(out[i].float(), ref[i].float(),
                                        **LIMITS_TOL).all()) for i in (0, 1))
        new_err = max((out[i].float() - ref[i].float()).abs().max().item()
                      for i in (2, 3))
        step = KV8_STEP["fp8"] if fmt == "fp8" else 0.0
        row_err = max((kv_values(a, [pos]) - kv_values(b, [pos])).abs().max()
                      .item() for a, b in ((kk, kp), (vk, vp)))
        row_mag = max(kv_values(b, [pos]).abs().max().item()
                      for b in (kp, vp))
        others = torch.ones(cap, dtype=torch.bool, device=dev)
        others[pos] = False
        unchanged = kv_same_bits(kk, kc, others) and \
            kv_same_bits(vk, vc, others)
        finite = all(bool(torch.isfinite(out[i].float()).all())
                     for i in range(4))
        ok = (within and new_err <= 0.05 and finite and unchanged
              and row_err <= 0.05 + step * row_mag and n_kernels == 1)
        say("window_layer", kernel=6, pos=pos, window=w, window_lo=lo,
            cache=fmt, weights=wts, max_abs_err=f"{err:.4g}",
            tol="out/res atol=2e-2+rtol=2e-2, new rows 0.05"
                + (" + one e4m3 step" if step else ""),
            k_new_v_new_err=f"{new_err:.4g}",
            appended_row_err=f"{row_err:.4g}", finite=finite,
            nan_below_bound_and_above_pos=True,
            other_rows_unchanged=unchanged, kernels=n_kernels,
            **dl.launch_plan(hidden, kvh, g, hd,
                             kind=dict(int4="exact").get(wts, wts), kv=fmt,
                             seq_len=pos, window=w), within=ok)
        ok_all &= ok
        outs[pos, w, fmt, wts] = [t.clone() for t in out[:4]] + [
            kk[0, :, pos].clone(), vk[0, :, pos].clone()]
        errs[pos, w, fmt, wts] = err
        del kc, vc, kk, vk, kp, vp
    for pos in K6_WINDOW_POS:
        for fmt in fmts:
            same = all(_bits_equal(a, b) for a, b in zip(
                outs[pos, pos + 1, fmt, "bf16"], outs[pos, 0, fmt, "bf16"]))
            say("window_layer", pos=pos, cache=fmt,
                window_pos_plus_1_bits_equal_window_0=same)
            ok_all &= same
    del outs

    # partials: the sp step's bound over four virtual shards, merged
    wq, wo, _ = weights["bf16"]
    for pos in K6_SHARD_POS:
        lo_g = pos + 1 - MISTRAL_WINDOW
        cos, sin = model.rope_row(cfg, pos, dev)
        args = (x, res, norm, cos, sin, wq, wo)
        kc, vc = cache(pos, lo_g, "bf16")
        pkw = dict(kw, emit_partials=True, window=MISTRAL_WINDOW)
        whole = dl._fused_decoder_layer(*args, kc, vc, pos, 0,
                                        fold_current=1, **pkw)
        parts, kinds = [], []
        for s in range(cap // K6_SHARD):
            start = s * K6_SHARD
            seq = min(max(pos - start, 0), K6_SHARD)
            fold = int(start <= pos < start + K6_SHARD)
            lo = shard_window_lo(pos, MISTRAL_WINDOW, start)
            ks = kc[:, :, start:start + K6_SHARD].contiguous()
            vs = vc[:, :, start:start + K6_SHARD].contiguous()
            got = dl._fused_decoder_layer(*args, ks, vs, seq, 0,
                                          fold_current=fold, window_lo=lo,
                                          **pkw)
            ref = dl._fused_decoder_layer_plain(*args, ks, vs, seq, 0,
                                                fold_current=fold,
                                                window_lo=lo, **pkw)
            torch.cuda.synchronize()
            kind = ("empty" if seq == 0 else "below" if lo >= seq
                    else "inside" if lo <= 0 else "cut") \
                + ("+owner" if fold else "")
            ml_err = (got[1] - ref[1]).abs().max().item()
            acc_err = (got[0] - ref[0]).abs().max().item()
            ok = (bool(torch.isclose(got[1], ref[1], atol=2e-2,
                                     rtol=2e-2).all())
                  and bool(torch.isclose(got[0], ref[0], atol=5e-2,
                                         rtol=2e-2).all()))
            exact = None
            if kind in ("empty", "below"):
                exact = bool(torch.all(got[1][0] == -1e30)
                             and torch.all(got[1][1] == 0)
                             and torch.all(got[0] == 0))
                ok &= exact
            say("window_layer_shard", kernel=6, pos=pos, shard=s,
                rows=f"{start}-{start + K6_SHARD - 1}", seq_local=seq,
                window_lo=lo, fold=fold, case=kind,
                ml_err=f"{ml_err:.4g}", acc_err=f"{acc_err:.4g}",
                tol="m,l atol=2e-2+rtol=2e-2; acc atol=5e-2+rtol=2e-2",
                empty_state_exact=exact, within=ok)
            ok_all &= ok
            parts.append(got)
            kinds.append(kind)
        m = torch.stack([q[1][0] for q in parts])
        m_g = m.amax(dim=0)
        alpha = torch.exp2(m - m_g)
        l_g = sum(q[1][1] * a for q, a in zip(parts, alpha))
        acc_g = sum(q[0] * a[:, None] for q, a in zip(parts, alpha))
        o_err = (acc_g / l_g[:, None]
                 - whole[0] / whole[1][1][:, None]).abs().max().item()
        say("window_layer_shard", pos=pos, shards=kinds,
            merged_o_err_vs_unsharded=f"{o_err:.4g}", tol_o=2e-2)
        ok_all &= o_err <= 2e-2
        del kc, vc, parts, whole
    if not ok_all:
        raise AssertionError("kernel 6's window disagrees with its plain "
                             "twin, or its bits, rows or shards are wrong")
    check_s = time.perf_counter() - t0

    # the bf16 layer at pos 8000, windows 4096 and 0, on the card's clock
    pos = K6_WINDOW_POS[-1]
    cos, sin = model.rope_row(cfg, pos, dev)
    args = (x, res, norm, cos, sin, wq, wo)
    ms, bounds, calls = {}, {}, {}
    for w in (MISTRAL_WINDOW, 0):
        kc, vc = cache(pos, pos + 1 - w if w else 0, "bf16")
        calls[w] = functools.partial(dl._fused_decoder_layer, *args, kc, vc,
                                     pos, 0, append_kv=True, window=w, **kw)
        ms[w] = queued_ms(calls[w])
        bounds[w] = _layer_bound(
            hbm, peak, _bytes(wq, wo), wq.numel() + wo.numel(), kvh,
            cfg.n_heads, min(pos, w - 1) if w else pos, hd,
            5 * hidden * 2 + 4 * kvh * hd * 2)
    phases = launch_phases(dl, calls[MISTRAL_WINDOW], 16 * kvh, K6_PHASES)
    kc, vc = cache(pos, pos + 1 - MISTRAL_WINDOW, "bf16")
    plain_ms = time_ms(lambda: dl._fused_decoder_layer_plain(
        *args, kc, vc, pos, 0, append_kv=True, window=MISTRAL_WINDOW, **kw),
        3)
    bound, bound_by, nbytes = bounds[MISTRAL_WINDOW]
    say("window_layer_time", kernel=6, pos=pos, cap=cap,
        ms_window_4096=f"{ms[MISTRAL_WINDOW]:.4f}", ms_window_0=f"{ms[0]:.4f}",
        how="queued_ms: 20 calls queued behind a spin, CUDA events",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.4f}",
        bound_by=bound_by, bytes=nbytes,
        bound_ms_window_0=f"{bounds[0][0]:.4f}", bytes_window_0=bounds[0][2],
        ms_over_bound=f"{ms[MISTRAL_WINDOW] / bound:.2f}",
        **dl.launch_plan(hidden, kvh, g, hd, seq_len=pos,
                         window=MISTRAL_WINDOW),
        **phases, library_ms="null: " + K6_WINDOW_LIB_NULL,
        check_s=f"{check_s:.1f}", seconds=f"{time.perf_counter() - t0:.1f}")
    del base, kc, vc, calls
    torch.cuda.empty_cache()
    return dict(max_abs_err=errs[pos, MISTRAL_WINDOW, "bf16", "bf16"],
                ms=ms[MISTRAL_WINDOW], plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=None)


def phase_window_mode5(eng, dev, hbm, peak):
    """Phase 55: kernel 7's mode 5 with Mistral's window as a tp-2 pair on
    this card (phase 46's form: two virtual ranks on their own streams
    over a loopback communicator), the engine's tree regrouped to one kv
    head a group (``shard_params`` cuts the groups over the ranks: 4 kv
    heads a rank), pos 8000 over random rows with NaN above pos, no LM
    head, at windows 4096 and 1, against kernel 7's one-card window step
    on the same cache at phase 15's limits (x_out and the residual within
    0.05 + 1e-2 of the largest value, the appended rows at phase 4's
    limits, every other row's bits unchanged): the first 4 layers running
    free, then all 32 layer by layer, teacher-forced (each layer from the
    pair's own state).  The 32-layer pair's ranks bit-identical and
    repeated, 8L+1 kernels a rank (7L+1 at window 1: no split pass), its
    ms (10 pair steps back to back, as phase 26 times its pair) at windows
    4096 and 0 beside the bound (both ranks' weights and the rows in the
    window read once).  Then ``phase_fused_step``: 4 steps of the fused
    tp-2 step with the LM head after phase 50's 4608-token prompt, against
    kernel 7's one-card window step teacher-forced.  Returns (the kernels
    line's row, the fused step's kernel-7 launches)."""
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    t0 = time.perf_counter()
    cfg, tp, L, pos = eng.cfg, 2, eng.cfg.n_layers, MODE5_WINDOW_POS
    lw = eng.params["layers"]
    hg = cfg.kv_heads // lw["wqkv_f"].shape[1]
    p1 = dict(eng.params, layers=dict(lw, **{
        k: regroup_heads(k, lw[k], hg, 1).contiguous()
        for k in ("wqkv_f", "wo_f")}))
    args, kw, kc, vc = _mistral_stack_case(cfg, p1, dev, pos, 55)
    bare = {k: v for k, v in kw.items() if k not in ("final_norm",
                                                     "lm_head")}
    x, norms, rope, proj = args[0], args[1:3], args[3:5], args[5:]
    names = ("attn_norm", "ffn_norm", "wqkv_f", "wo_f", "w13", "w2")
    lb = col.LoopbackComm(tp, dev)
    ok_all, errs, pair_ms = True, {}, {}
    try:
        meshes = [lb.mesh(r) for r in range(tp)]
        shards = [par.shard_params(p1, cfg, m) for m in meshes]
        streams = [torch.cuda.Stream(dev) for _ in range(tp)]

        def pair(xin, ly, caches, w):
            outs = []
            for r in range(tp):
                streams[r].wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(streams[r]):
                    sl = shards[r]["layers"]
                    outs.append(sk.fused_decoder_stack(
                        xin, *(sl[k][ly] for k in names[:2]), *rope,
                        *(sl[k][ly] for k in names[2:]), *caches[r], pos,
                        window=w, reduce_axis="tp", mesh=meshes[r], **bare))
            for st_ in streams:
                torch.cuda.current_stream(dev).wait_stream(st_)
            return outs

        def rank_caches(lo, hi):
            return [(par.shard_cache(kv_take(kc, lo, hi), m),
                     par.shard_cache(kv_take(vc, lo, hi), m))
                    for m in meshes]

        def one_card(xin, lo, hi, w):
            k, v = kv_take(kc, lo, hi), kv_take(vc, lo, hi)
            out = sk.fused_decoder_stack(
                xin, *(t[lo:hi] for t in norms), *rope,
                *(t[lo:hi] for t in proj), k, v, pos, window=w, **bare)
            return out[0], out[1], k, v

        def held(got, want, lo, hi, r, l0):
            """(x/res error over the largest value, rows error, within)."""
            rel, ok = 0.0, True
            for j in (0, 1):
                e = (got[j].float() - want[j].float()).abs().max().item()
                m_ = want[j].float().abs().max().item()
                rel = max(rel, e / m_)
                ok &= e <= 0.05 + 1e-2 * m_
            hs = slice(r * cfg.kv_heads // tp, (r + 1) * cfg.kv_heads // tp)
            rows = 0.0
            others = torch.ones(MISTRAL_CAP, dtype=torch.bool, device=dev)
            others[pos] = False
            for a, b, before in ((got[2], want[2], kc), (got[3], want[3], vc)):
                d = (kv_values(a, [pos]) - kv_values(kv_heads(b, hs), [pos])
                     ).abs().amax(dim=(1, 2, 3))
                mag = kv_values(kv_heads(b, hs), [pos]).abs().amax(
                    dim=(1, 2, 3))
                lim = 0.05 + 1e-2 * mag
                if l0:
                    lim[0] = 0.05
                ok &= bool((d <= lim).all())
                rows = max(rows, d.max().item())
                ok &= kv_same_bits(a, kv_heads(kv_take(before, lo, hi), hs),
                                   others)
            return rel, rows, ok

        # every kernel of the path loaded before a virtual rank spins (see
        # ``LoopbackComm``): the one-card step first
        one_card(x, 0, 1, MISTRAL_WINDOW)
        for w in MODE5_WINDOWS:
            n = MODE5_FREE_LAYERS
            got = pair(x, slice(0, n), rank_caches(0, n), w)
            per_free = sk.last_step_kernels
            want = one_card(x, 0, n, w)
            torch.cuda.synchronize()
            lb.check()
            free = [held(got[r], want, 0, n, r, True) for r in range(tp)]
            ok = all(f[2] for f in free) and \
                per_free == 8 * n + 1 - n * (w == 1)
            # all 32 layers, layer by layer, teacher-forced
            xin, rels, rows = x, [], []
            for l in range(L):
                got1 = pair(xin, slice(l, l + 1), rank_caches(l, l + 1), w)
                want1 = one_card(xin, l, l + 1, w)
                torch.cuda.synchronize()
                lb.check()
                h1 = [held(got1[r], want1, l, l + 1, r, l == 0)
                      for r in range(tp)]
                ok &= all(h[2] for h in h1)
                rels.append(round(max(h[0] for h in h1), 5))
                rows.append(round(max(h[1] for h in h1), 4))
                xin = (got1[0][0].float() + got1[0][1].float()).bfloat16()
            # the 32-layer pair: ranks' bits, a repeat, the launches
            k0 = sk.launches
            whole = pair(x, slice(0, L), rank_caches(0, L), w)
            per_step = sk.last_step_kernels
            again = pair(x, slice(0, L), rank_caches(0, L), w)
            torch.cuda.synchronize()
            lb.check()
            same = all(_same_bits(o[j], whole[0][j]) and
                       _same_bits(a[j], whole[0][j])
                       for o, a in zip(whole, again) for j in (0, 1))
            finite = all(bool(torch.isfinite(o[0].float()).all())
                         for o in whole)
            want_k = 8 * L + 1 - L * (w == 1)
            ok &= (same and finite and per_step == want_k
                   and sk.launches - k0 == 2 * tp)
            errs[w] = max(max(f[0] for f in free), max(rels))
            say("window_mode5", kernel=7, reduce_axis="tp", tp=tp,
                loopback=True, pos=pos, window=w, head_group=1,
                kv_heads_per_rank=cfg.kv_heads // tp,
                free_layers=n, free_x_res_err_over_max=[
                    round(f[0], 5) for f in free],
                free_rows_err=[round(f[1], 4) for f in free],
                free_kernels_per_step=per_free,
                held="32 layers one by one vs kernel 7's one-card window "
                     "step, teacher-forced",
                x_res_err_over_max_by_layer=rels,
                x_res_err_over_max_worst=max(rels),
                rows_err_by_layer=rows, rows_err_worst=max(rows),
                tol="x/res 0.05+1e-2*max|ref|; rows layer 0 atol=0.05, "
                    "deeper atol=0.05+rtol=1e-2",
                kernels_per_step=per_step, want_kernels=want_k,
                ranks_bit_identical_and_repeat=same, finite=finite,
                within=ok)
            ok_all &= ok
            del got, want, whole, again
        # the 32-layer pair's time at windows 4096 and 0, beside the bound
        for w in (MISTRAL_WINDOW, 0):
            cs = rank_caches(0, L)
            pair(x, slice(0, L), cs, w)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(10):
                pair(x, slice(0, L), cs, w)
            torch.cuda.synchronize()
            pair_ms[w] = (time.perf_counter() - t1) * 1e2
            lb.check()
            del cs
        t1 = time.perf_counter()
        sk.fused_decoder_stack_plain_ranks(
            [(x, *(shards[r]["layers"][k] for k in names[:2]), *rope,
              *(shards[r]["layers"][k] for k in names[2:]),
              *(par.shard_cache(kv_take(c, 0, L), meshes[r])
                for c in (kc, vc)), pos) for r in range(tp)],
            window=MISTRAL_WINDOW, **bare)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
    finally:
        lb.close()
    if not ok_all:
        raise AssertionError("kernel 7's mode 5 with the window disagrees "
                             "with the one-card window step, or its bits or "
                             "launches are wrong")
    bound, bound_by, nbytes = mode5_kv8_bound(cfg, p1["layers"], hbm, peak,
                                              pos, "bf16", MISTRAL_WINDOW)
    bound0 = mode5_kv8_bound(cfg, p1["layers"], hbm, peak, pos, "bf16")
    say("window_mode5_time", kernel=7, tp=tp, loopback=True, layers=L,
        pos=pos, both_ranks_ms_per_step_window_4096=(
            f"{pair_ms[MISTRAL_WINDOW]:.4f}"),
        both_ranks_ms_per_step_window_0=f"{pair_ms[0]:.4f}",
        how="10 pair steps back to back, host clock after a synchronize",
        plain_ms=f"{plain_ms:.2f}", bound_ms=f"{bound:.4f}",
        bound_by=bound_by, bytes=nbytes, bound_ms_window_0=f"{bound0[0]:.4f}",
        ms_over_bound=f"{pair_ms[MISTRAL_WINDOW] / bound:.2f}",
        library_ms="null: " + K6_WINDOW_LIB_NULL)
    row = dict(max_abs_err=errs[MISTRAL_WINDOW], ms=pair_ms[MISTRAL_WINDOW],
               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
               library_ms=None)
    del kc, vc
    torch.cuda.empty_cache()
    phase_fused_step(eng, dev, shards, n=4, params=p1,
                     phase="window_fused_step",
                     prompt=FIGURES["mistral_stream"][0])
    launches = FIGURES["window_fused_step_launches"]
    del shards, p1
    torch.cuda.empty_cache()
    say("window_mode5", seconds=f"{time.perf_counter() - t0:.1f}")
    return row, launches


def phase_window_sharded(eng, dev):
    """Phase 56: the tp and sp steps with Mistral's window end to end in a
    one-rank NCCL group (phase 14's form, ``phase_sharded``): phase 50's
    4608-token prompt through the windowed prefill (kernel 4), then 16
    greedy steps of ``make_sharded_decode_step`` (kernel 6 with its default
    bound, the append inside it, kernel 2 between the halves) and 8 of
    ``make_sp_sharded_decode_step`` (kernel 6 in partials mode with the
    shard's bound), each stream against kernel 7's one-card window step
    teacher-forced under the top-2-gap rule, ms a step and launches of
    kernels 6 (every one windowed) and 2.  Returns kernel 6's launches."""
    k6, _ = phase_sharded(eng, dev, prompt=FIGURES["mistral_stream"][0],
                          steps=SHARDED_WINDOW_STEPS,
                          phase="window_sharded", plain=False)
    return k6


def phase_mistral(dev, hbm, peak):
    """Phases 47-56 (the Mistral-7B cell): returns {kernel: kernels-line
    row} and the main path's launches."""
    t0 = time.perf_counter()
    eng = mistral_engine(dev)
    t47 = time.perf_counter()
    rows = dict(stack=phase_mistral_stack(eng, dev, hbm, peak))
    t48 = time.perf_counter()
    rows["flash"] = phase_mistral_flash(eng, dev, hbm, peak)
    t49 = time.perf_counter()
    rows["verify"] = phase_mistral_verify(eng, dev, hbm, peak)
    t50 = time.perf_counter()
    launches = phase_mistral_e2e(eng, dev)
    t51 = time.perf_counter()
    say("phases_47_50", seconds=f"{t51 - t0:.1f}",
        init_s=f"{t47 - t0:.1f}", phase47_s=f"{t48 - t47:.1f}",
        phase48_s=f"{t49 - t48:.1f}", phase49_s=f"{t50 - t49:.1f}",
        phase50_s=f"{t51 - t50:.1f}")
    rows["paged_window"] = phase_window_paged_attention(dev, hbm, peak,
                                                        eng.cfg)
    t52 = time.perf_counter()
    lw = eng.params["layers"]
    tree4 = dict(eng.params, layers=dict(lw, **quant_stack_weights(
        lw, eng.cfg.kv_heads // lw["wqkv_f"].shape[1], eng.cfg.kv_heads,
        "int4")))
    rows["layer_window"] = phase_window_paged_layer(eng, tree4, dev, hbm,
                                                    peak)
    t53 = time.perf_counter()
    serve = phase_window_serving(eng, tree4, dev)
    launches.update(paged_window=serve["paged"], layer_window=serve["layer"])
    t54 = time.perf_counter()
    say("phases_51_53", seconds=f"{t54 - t51:.1f}",
        phase51_s=f"{t52 - t51:.1f}", phase52_s=f"{t53 - t52:.1f}",
        phase53_s=f"{t54 - t53:.1f}")
    del tree4, lw
    torch.cuda.empty_cache()
    rows["layer6_window"] = phase_window_layer(eng, dev, hbm, peak)
    t55 = time.perf_counter()
    rows["mode5_window"], launches["mode5_window"] = phase_window_mode5(
        eng, dev, hbm, peak)
    t56 = time.perf_counter()
    launches["layer6_window"] = phase_window_sharded(eng, dev)
    t57 = time.perf_counter()
    say("phases_54_56", seconds=f"{t57 - t54:.1f}",
        phase54_s=f"{t55 - t54:.1f}", phase55_s=f"{t56 - t55:.1f}",
        phase56_s=f"{t57 - t56:.1f}")
    del eng
    torch.cuda.empty_cache()
    return rows, launches


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
            timing="call time: per call, the slowest rank; median of 5 "
                   "batches of CUDA events over 100 back-to-back calls, each "
                   "batch after synchronize and barrier, so paced by the "
                   "host's calls",
            note="bound: HBM bytes, a flag round trip over NVLink is the floor")
    # device time per call: the kernels' own time on the card over 50 calls
    # (torch.profiler, one profile on every rank: a retry on one rank alone
    # would strand the others' collectives), the wait for the peers
    # included, the host's time between calls left out
    dev_ms = {}
    for name, fn in (
            ("all_reduce", lambda: comm.all_reduce(x)),
            ("all_reduce_nccl", lambda: dist.all_reduce(y, group=group)),
            ("all_gather", lambda: comm.all_gather(shard)),
            ("all_gather_nccl", lambda: dist.all_gather_into_tensor(
                buf, shard, group=group))):
        torch.cuda.synchronize()
        dist.barrier()
        ev, _ = profiling.profile_calls(fn, 50, attempts=1)
        dev_ms[name] = sum(b - a for a, b, _ in ev) / 1e3 / 50
    comm.check()
    least = torch.tensor(list(dev_ms.values()), dtype=torch.float64, device=dev)
    most = least.clone()
    dist.all_reduce(least, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(most, op=dist.ReduceOp.MAX, group=group)
    for k, a, b in zip(dev_ms, least.tolist(), most.tolist()):
        out[f"{k}_device_ms"] = a
        out[f"{k}_device_ms_most"] = b
    if rank == 0:
        say("multicard", ranks=world, timing="device time per call "
            "(torch.profiler, 50 calls), the rank that waited least / most",
            **{f"{k}_device_ms": f"{out[k + '_device_ms']:.5f}/"
                                 f"{out[k + '_device_ms_most']:.5f}"
               for k in dev_ms})
    return out


def _multicard_steps(rank, world, dev, mesh, n=32):
    """Phase 16, second part: the seeded 7B weights (head group 1) on every
    rank, a 512-token prefill (kernel 4), then ``n`` greedy steps of
    ``make_sharded_decode_step(fused_collectives=True)`` and of the NCCL
    step, timed before any profiler; rank 0 holds both streams against
    kernel 7 teacher-forced on the whole weights, and every rank's logits
    are held against rank 0's bits.  Then the same two steps on the int8
    tree (the weights regrouped to 8 kv heads a group, or 32 / world,
    quantized per output column, the LM head too) from the same prefilled
    caches: the fused step one call of kernel 7's int8 mode, the NCCL step
    kernel 6's.  Then the same on the int4 tree (regrouped alike, groups of
    128, the bf16 LM head) in the exact mode, whose sharded steps are
    kernel 7's exact function: kernel 7's int4 mode 5, kernel 6's int4
    mode.  Then the bf16 weights on 8-bit caches prefilled alike: the
    fused and the NCCL step on an fp8 cache (kernel 7's 8-bit mode 5,
    kernel 6's fp8 mode) and the fused step on an ``Int8KV`` cache (the
    NCCL step refuses one, as JAX's does)."""
    import torch.distributed as dist
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
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
    hg8 = min(8, cfg.kv_heads // world)
    full8 = int8_head_tree(dict(full, layers=dict(
        full["layers"], **quant_stack_weights(full["layers"], 1, hg8))))
    params8 = par.shard_params(full8, cfg, mesh)
    full4 = dict(full, layers=dict(
        full["layers"], **quant_stack_weights(full["layers"], 1, hg8,
                                              "int4")))
    params4 = par.shard_params(full4, cfg, mesh)
    exact = KernelConfig(int4_w4a8=False)
    caches = {None: (k0, v0)}
    for fmt, kv_dtype in KV8_FORMATS:
        kq, vq = model.init_cache(cfg, max_seq=1024, device=dev,
                                  dtype=kv_dtype)
        _, kq, vq = model.prefill(full, kq, vq, prompt, cfg)
        caches[fmt] = (kq, vq)
    out, steps = {}, {}
    for name, fused, full_, params_ in (
            ("fused", True, full, params), ("nccl", False, full, params),
            ("fused_int8", True, full8, params8),
            ("nccl_int8", False, full8, params8),
            ("fused_int4", True, full4, params4),
            ("nccl_int4", False, full4, params4),
            ("fused_fp8", True, full, params), ("nccl_fp8", False, full, params),
            ("fused_kvint8", True, full, params)):
        int8, int4 = name.endswith("_int8"), name.endswith("_int4")
        fmt = "fp8" if name.endswith("_fp8") else (
            "int8" if name.endswith("_kvint8") else None)
        kcfg = exact if int4 else KernelConfig()
        step = par.make_sharded_decode_step(cfg, mesh, kcfg,
                                            fused_collectives=fused)
        k0_, v0_ = caches[fmt]
        kc, vc = par.shard_cache(k0_, mesh), par.shard_cache(v0_, mesh)
        for i in range(2):                       # warm-up, rows rewritten
            step(params_, kc, vc, first, pos0 + i)
        dist.barrier()
        torch.cuda.synchronize()
        for k in col.launches:
            col.launches[k] = col.standalone[k] = 0
        sk.launches = dl.launches = sk.last_step_kernels = 0
        sk.int8_launches = dl.int8_launches = 0
        sk.int4_launches = dl.int4_launches = 0
        dl.fp8_launches = 0
        for k in sk.kv8_launches:
            sk.kv8_launches[k] = 0
        tok, toks, logs = torch.tensor(first, device=dev), [], []
        t0 = time.perf_counter()
        for i in range(n):
            lg, kc, vc = step(params_, kc, vc, tok, pos0 + i)
            tok = torch.argmax(lg)
            toks.append(tok)
            logs.append(lg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        # every rank's logits of every step, against rank 0's bits
        mine = torch.stack(logs)
        every = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(every, mine, group=mesh.groups["tp"])
        same = all(_bits_equal(e, every[0]) for e in every)
        launched = dict(kernel7=sk.launches, kernel6=dl.launches,
                        kernel13=col.launches["all_reduce"],
                        kernel14=col.launches["all_gather"],
                        standalone13=col.standalone["all_reduce"],
                        standalone14=col.standalone["all_gather"],
                        kernel7_kernels_per_step=sk.last_step_kernels)
        if int8:
            launched.update(kernel7_int8=sk.int8_launches,
                            kernel6_int8=dl.int8_launches)
        if int4:
            launched.update(kernel7_int4=sk.int4_launches,
                            kernel6_int4=dl.int4_launches)
        if fmt is not None:
            launched.update(kernel7_kv8=sum(sk.kv8_launches.values()),
                            kernel6_fp8=dl.fp8_launches)
        # the fused step: kernel 7 once, 8L+3 kernels, its 2L reduces and
        # the logits' gather inside them, no standalone kernel 13 or 14
        want = (dict(kernel7=n, kernel6=0, kernel13=2 * L * n, kernel14=n,
                     standalone13=0, standalone14=0,
                     kernel7_kernels_per_step=8 * L + 3)
                if fused else
                dict(kernel7=0, kernel6=L * n, kernel13=0, kernel14=0,
                     standalone13=0, standalone14=0,
                     kernel7_kernels_per_step=0))
        if int8:
            want.update(kernel7_int8=want["kernel7"],
                        kernel6_int8=want["kernel6"])
        if int4:
            want.update(kernel7_int4=want["kernel7"],
                        kernel6_int4=want["kernel6"])
        if fmt is not None:
            want.update(kernel7_kv8=want["kernel7"],
                        kernel6_fp8=want["kernel6"])
        toks = [int(t) for t in toks]
        bad = []
        if rank == 0:
            ref, gaps, bad = check_against_stack(full_, cfg, k0_, v0_, pos0,
                                                 first, toks, kcfg)
            say("multicard", step=name, tp=world, kv=fmt or "bf16",
                prompt_tokens=pos0,
                new_tokens=n, ms_per_step=f"{dt * 1e3 / n:.3f}",
                tokens_per_s=f"{n / dt:.2f}", **launched,
                ranks_logits_bit_identical=same, tokens=toks[:8],
                kernel7_tokens=ref[:8],
                agree=f"{sum(a == b for a, b in zip(ref, toks))}/{n}",
                disagree_where_gap_gt_0_1=bad,
                min_top2_gap=f"{min(gaps):.3g}")
        dist.barrier()
        if launched != want or bad or (fused and not same):
            raise AssertionError(f"rank {rank}, the {name} step: launches "
                                 f"{launched} (want {want}), tokens {bad} or "
                                 f"ranks' logits identical: {same}")
        out[f"{name}_ms_per_step"] = dt * 1e3 / n
        if not int8 and not int4 and fmt is None:
            steps[name] = (step, kc, vc)
    # each step's device time by pass on rank 0, after the wall clocks (a
    # profiler session slows the launches after it); every rank profiles
    # the same calls once
    reps = 8
    for name, (step, kc, vc) in steps.items():
        torch.cuda.synchronize()
        dist.barrier()
        ev, wall = profiling.profile_calls(
            lambda: step(params, kc, vc, first, pos0), reps,  # noqa: B023
            attempts=1)
        if rank != 0:
            continue
        busy, rows = say_tp_profile("multicard_profile", ev, reps, wall,
                                    name, tp=world, rank=0, pos=pos0)
        out[f"{name}_device_busy_ms"] = busy
        # one layer of the first profiled step, kernel by kernel, and the
        # step's last kernels (the fused step's tail: the final norm, the
        # LM head's pushing product and the gather's wait, nothing after)
        for line in profiling.timeline(ev, 20, 24):
            print(f"[multicard_timeline] step={name} rank=0 {line}",
                  flush=True)
        per = len(ev) // reps
        for line in profiling.timeline(ev, per - 6, 6):
            print(f"[multicard_tail] step={name} rank=0 {line}", flush=True)
        if "reduce_norm" in rows and "norm" in rows:
            # a reduce's consumer does a plain norm's work (a little less:
            # it holds its row in registers) once its inputs are in, so the
            # difference is about its wait for the peers
            wait = (rows["reduce_norm"][0] / rows["reduce_norm"][2]
                    - rows["norm"][0] / rows["norm"][2])
            say("multicard_profile", step=name,
                reduce_wait_us_per_reduce=f"{wait * 1e3:.2f}",
                how="charged µs of a norm after a reduce minus a plain norm's")
    return out


def _multicard_hd64(rank, world, dev, mesh, n=16):
    """Phase 16, third part: the fused tp step at head dim 64 on
    TinyLlama-1.1B's widths, its 4 kv heads over the ranks (head group
    4 / world, so that G = world: one kv head a rank at 4 cards), with
    bf16 weights on a bf16 cache and at the operating point (int4 W4A8, an
    ``Int8KV`` cache): a 512-token prefill, then ``n`` greedy steps of
    ``make_sharded_decode_step(fused_collectives=True)``, counts set to 0
    before and read after (one kernel-7 call a step with 8L+3 kernels, its
    2L reduces and the logits' gather inside it, nothing standalone), every
    rank's logits bit-identical to rank 0's; rank 0 holds the bf16 stream
    against kernel 7 teacher-forced (the W4A8 step quantizes the shard's
    own f-blocks, another function than the unsharded step)."""
    import torch.distributed as dist
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.ops.quant import quantize_llama_params
    from clusterfusion_tpu_torch.parallel import collective as col
    cfg = LlamaConfig.tinyllama_1b()
    if cfg.kv_heads % world:
        if rank == 0:
            print(f"[multicard_hd64] skipped tp={world} kv_heads="
                  f"{cfg.kv_heads}", flush=True)
        return {}
    L, out = cfg.n_layers, {}
    full = model.init_params(cfg, seed=0, head_group=cfg.kv_heads // world,
                             device=dev)
    prompt = [(i * 37 + 11) % cfg.vocab_size for i in range(512)]
    for name, tree, kv in (("fused_hd64", full, torch.bfloat16),
                           ("fused_hd64_int4_kvint8",
                            quantize_llama_params(full, "int4"), "int8")):
        kcfg = KernelConfig(int4_w4a8=True)
        k0, v0 = model.init_cache(cfg, max_seq=1024, device=dev, dtype=kv)
        lg, k0, v0 = model.prefill(tree, k0, v0, prompt, cfg)
        first, pos0 = int(torch.argmax(lg[-1])), len(prompt)
        params = par.shard_params(tree, cfg, mesh)
        step = par.make_sharded_decode_step(cfg, mesh, kcfg,
                                            fused_collectives=True)
        kc, vc = par.shard_cache(k0, mesh), par.shard_cache(v0, mesh)
        step(params, kc, vc, first, pos0)       # warm-up, row rewritten
        dist.barrier()
        torch.cuda.synchronize()
        for k in col.launches:
            col.launches[k] = col.standalone[k] = 0
        sk.launches = sk.int4_launches = sk.last_step_kernels = 0
        for k in sk.kv8_launches:
            sk.kv8_launches[k] = 0
        tok, toks, logs = torch.tensor(first, device=dev), [], []
        t0 = time.perf_counter()
        for i in range(n):
            lg, kc, vc = step(params, kc, vc, tok, pos0 + i)
            tok = torch.argmax(lg)
            toks.append(tok)
            logs.append(lg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        mine = torch.stack(logs)
        every = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(every, mine, group=mesh.groups["tp"])
        same = all(_bits_equal(e, every[0]) for e in every)
        quant = name != "fused_hd64"
        launched = dict(kernel7=sk.launches, kernel7_int4=sk.int4_launches,
                        kernel7_kv8=sum(sk.kv8_launches.values()),
                        kernel13=col.launches["all_reduce"],
                        kernel14=col.launches["all_gather"],
                        standalone13=col.standalone["all_reduce"],
                        standalone14=col.standalone["all_gather"],
                        kernel7_kernels_per_step=sk.last_step_kernels)
        want = dict(kernel7=n, kernel7_int4=n * quant, kernel7_kv8=n * quant,
                    kernel13=2 * L * n, kernel14=n, standalone13=0,
                    standalone14=0, kernel7_kernels_per_step=8 * L + 3)
        toks = [int(t) for t in toks]
        finite = bool(torch.isfinite(mine).all())
        bad, held = [], {}
        if rank == 0:
            if not quant:
                ref, gaps, bad = check_against_stack(tree, cfg, k0, v0, pos0,
                                                     first, toks, kcfg)
                held = dict(kernel7_tokens=ref[:8], agree=(
                    f"{sum(a == b for a, b in zip(ref, toks))}/{n}"),
                    disagree_where_gap_gt_0_1=bad,
                    min_top2_gap=f"{min(gaps):.3g}")
            say("multicard_hd64", step=name, tp=world, model="tinyllama_1b",
                head_dim=cfg.head_dim_, kv_heads_per_rank=cfg.kv_heads // world,
                prompt_tokens=pos0, new_tokens=n,
                ms_per_step=f"{dt * 1e3 / n:.3f}",
                tokens_per_s=f"{n / dt:.2f}", **launched,
                ranks_logits_bit_identical=same, finite=finite,
                tokens=toks[:8], **held)
        dist.barrier()
        if launched != want or bad or not same or not finite:
            raise AssertionError(f"rank {rank}, the {name} step: launches "
                                 f"{launched} (want {want}), tokens {bad}, "
                                 f"ranks' logits identical: {same}")
        out[f"{name}_ms_per_step"] = dt * 1e3 / n
    return out


#: Phase 16's Mistral-7B prompt: at sp 4 (shards of 2048 rows) its first
#: step finds shard 0 wholly below the window, shard 1 inside it from its
#: first row, shard 2 inside it and the owner, shard 3 empty; the next
#: steps cut shard 1 and make shard 3 the owner.
MULTICARD_MISTRAL_PROMPT = 6143


def _shard_case(pos, window, start, cap_l):
    """The sp step's case of the shard at ``start`` for the token at pos."""
    from clusterfusion_tpu_torch.parallel.sp_decode import shard_window_lo
    seq = min(max(pos - start, 0), cap_l)
    lo = shard_window_lo(pos, window, start)
    kind = ("empty" if seq == 0 else "below" if lo >= seq
            else "inside" if lo <= 0 else "cut")
    return kind + ("+owner" if start <= pos < start + cap_l else "")


def _multicard_mistral(rank, world, dev, mesh, n=16, n_sp=8):
    """Phase 16, fourth part: Mistral-7B (window 4096, capacity 8192, seed
    0, head group 1) on every rank, a 6143-token prefill (kernel 4's
    window), then ``n`` greedy steps of the fused tp step (kernel 7's mode
    5 with the window, 8L+3 kernels) and of the NCCL tp step (kernel 6
    with its default bound), then ``n_sp`` steps of the sp step at sp =
    the card count (kernel 6 in partials mode with each shard's bound; at
    4 cards every shard case occurs: ``MULTICARD_MISTRAL_PROMPT``).  Rank 0
    holds each stream against kernel 7's one-card window step
    teacher-forced under the top-2-gap rule; every rank's logits are held
    against rank 0's bits (the fused step's must be equal)."""
    import torch.distributed as dist
    from clusterfusion_tpu_torch import parallel as par
    from clusterfusion_tpu_torch.config import LlamaConfig, MeshConfig
    from clusterfusion_tpu_torch.models import llama as model
    from clusterfusion_tpu_torch.ops import decoder_layer as dl
    from clusterfusion_tpu_torch.ops import stack_kernel as sk
    from clusterfusion_tpu_torch.parallel import collective as col
    t0 = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.mistral_7b(),
                              max_seq_len=MISTRAL_CAP)
    L, W = cfg.n_layers, cfg.sliding_window
    full = model.init_params(cfg, seed=0, head_group=1, device=dev)
    prompt = [(i * 37 + 11) % cfg.vocab_size
              for i in range(MULTICARD_MISTRAL_PROMPT)]
    k0, v0 = model.init_cache(cfg, device=dev)
    lg, k0, v0 = model.prefill(full, k0, v0, prompt, cfg)
    first, pos0 = int(torch.argmax(lg[-1])), len(prompt)
    sp_mesh = par.build_mesh(MeshConfig(sp=world))
    out = {}
    for name, m, fused, steps in (("mistral_fused", mesh, True, n),
                                  ("mistral_nccl", mesh, False, n),
                                  ("mistral_sp", sp_mesh, None, n_sp)):
        axis = "tp" if fused is not None else "sp"
        spec = par.cache_pspec() if axis == "tp" else par.cache_pspec_2d()
        params = par.shard_params(full, cfg, m)
        step = par.make_sp_sharded_decode_step(cfg, m) if fused is None \
            else par.make_sharded_decode_step(cfg, m, fused_collectives=fused)
        kc = par.shard_cache(k0.clone(), m, spec)
        vc = par.shard_cache(v0.clone(), m, spec)
        for i in range(2):                       # warm-up, rows rewritten
            step(params, kc, vc, first, pos0 + i)
        dist.barrier()
        torch.cuda.synchronize()
        for k in col.launches:
            col.launches[k] = col.standalone[k] = 0
        sk.launches = dl.launches = dl.window_launches = 0
        sk.last_step_kernels = 0
        tok, toks, logs = torch.tensor(first, device=dev), [], []
        t1 = time.perf_counter()
        for i in range(steps):
            lg, kc, vc = step(params, kc, vc, tok, pos0 + i)
            tok = torch.argmax(lg)
            toks.append(tok)
            logs.append(lg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        mine = torch.stack(logs)
        every = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(every, mine, group=m.groups[axis])
        same = all(_bits_equal(e, every[0]) for e in every)
        launched = dict(kernel7=sk.launches, kernel6=dl.launches,
                        kernel6_window=dl.window_launches,
                        kernel13=col.launches["all_reduce"],
                        kernel14=col.launches["all_gather"],
                        kernel7_kernels_per_step=sk.last_step_kernels)
        want = (dict(kernel7=steps, kernel6=0, kernel6_window=0,
                     kernel13=2 * L * steps, kernel14=steps,
                     kernel7_kernels_per_step=8 * L + 3) if fused else
                dict(kernel7=0, kernel6=L * steps, kernel6_window=L * steps,
                     kernel13=0, kernel14=0, kernel7_kernels_per_step=0))
        toks = [int(t) for t in toks]
        bad = []
        if rank == 0:
            ref, gaps, bad = check_against_stack(full, cfg, k0, v0, pos0,
                                                 first, toks)
            cases = {}
            if axis == "sp":
                cap_l = MISTRAL_CAP // world
                cases = dict(shard_cases=[
                    [_shard_case(pos0 + i, W, s * cap_l, cap_l)
                     for i in range(steps)] for s in range(world)])
            say("multicard", step=name, tp=world if axis == "tp" else 1,
                sp=world if axis == "sp" else 1, window=W,
                prompt_tokens=pos0, new_tokens=steps,
                ms_per_step=f"{dt * 1e3 / steps:.3f}",
                tokens_per_s=f"{steps / dt:.2f}", **launched,
                ranks_logits_bit_identical=same, tokens=toks[:8],
                kernel7_tokens=ref[:8],
                agree=f"{sum(a == b for a, b in zip(ref, toks))}/{steps}",
                disagree_where_gap_gt_0_1=bad,
                min_top2_gap=f"{min(gaps):.3g}", **cases)
        dist.barrier()
        if launched != want or bad or (fused and not same):
            raise AssertionError(f"rank {rank}, the {name} step: launches "
                                 f"{launched} (want {want}), tokens {bad} or "
                                 f"ranks' logits identical: {same}")
        out[f"{name}_ms_per_step"] = dt * 1e3 / steps
        del params, kc, vc, step
        torch.cuda.empty_cache()
    if rank == 0:
        say("multicard_mistral", seconds=f"{time.perf_counter() - t0:.1f}")
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
        out.update(_multicard_hd64(rank, world, dev, mesh))
        out.update(_multicard_mistral(rank, world, dev, mesh))
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
    and the NCCL tp steps end to end, and Mistral-7B's windowed fused, NCCL
    and sp steps (``_multicard_mistral``).  A failure in any rank fails
    the run.  On one card it prints that it did not run."""
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
    from clusterfusion_tpu_torch.config import KernelConfig, LlamaConfig
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
    pa_launches, layer_launches, serving_bf16 = phase_serving(eng, dev)
    verify, verify_cases = phase_verify(eng, dev, hbm, peak, stack["ms"])
    verify_launches = phase_spec(eng, dev)
    phase_verify_device(verify_cases)
    del verify_cases
    norm_rows, norm_launches = phase_norms_gemv(eng, dev, hbm, peak)
    layer_row = phase_layer(eng, dev, hbm, peak)
    layer_launches_tp_sp, fadd_launches = phase_sharded(eng, dev)
    coll_rows = phase_collectives(dev, hbm)
    shards = phase_mode5(eng, dev)
    k13_launches, k14_launches = phase_fused_step(eng, dev, shards)
    del shards
    torch.cuda.empty_cache()
    stack8, w8, heads8 = phase_int8_stack(eng, dev, hbm, peak)
    verify8 = phase_int8_verify(eng, dev, hbm, peak, w8, heads8)
    del w8, heads8
    torch.cuda.empty_cache()
    stack8_launches, eng8 = phase_int8_e2e(dev)
    verify8_launches = phase_spec(eng8, dev, "spec_int8")
    layer8 = phase_quant_paged_layer(eng8, eng, dev, hbm, peak, "int8")
    products8 = phase_quant_products(eng8, dev, hbm, peak, "int8")
    serving8_launches = phase_int8_serving(eng8, eng, dev, serving_bf16)
    t24 = time.perf_counter()
    tree8 = int8_head_tree(eng8.params)
    layer8_row = phase_int8_layer(eng8, eng, dev, hbm, peak)
    layer8_launches = phase_int8_sharded(eng8, dev, tree8)
    phase_mode5(eng8, dev, params=dict(tree8, layers={
        k: w[:4] for k, w in tree8["layers"].items()}),
        phase="mode5_int8_4layers")
    shards8 = phase_mode5(eng8, dev, params=tree8, phase="mode5_int8",
                          drift=FIGURES.get("mode5_drift"))
    phase_fused_step(eng8, dev, shards8, params=tree8,
                     phase="fused_step_int8")
    say("phases_24_26", seconds=f"{time.perf_counter() - t24:.1f}")
    del tree8, shards8
    torch.cuda.empty_cache()
    t27 = time.perf_counter()
    eng4 = int4_engine(dev)
    stack4 = phase_int4_stack(eng4, eng, eng8, dev, hbm, peak)
    stack4_launches = phase_int4_e2e(eng4, dev)
    verify4, verify4_launches = phase_int4_verify(eng4, eng, dev, hbm, peak)
    layer4 = phase_quant_paged_layer(eng4, eng, dev, hbm, peak, "int4")
    products4 = phase_quant_products(eng4, dev, hbm, peak, "int4")
    serving4_launches = phase_int4_serving(eng4, eng, dev, serving_bf16)
    say("phases_27_31", seconds=f"{time.perf_counter() - t27:.1f}")
    torch.cuda.empty_cache()
    t35 = time.perf_counter()
    stack_kv8 = phase_kv8_stack(eng, eng8, eng4, dev, hbm, peak)
    verify_kv8 = phase_kv8_verify(eng, eng8, eng4, dev, hbm, peak)
    kv8_launches = phase_kv8_e2e(eng, dev)
    say("phases_35_37", seconds=f"{time.perf_counter() - t35:.1f}")
    t38 = time.perf_counter()
    layer_kv8 = phase_kv8_layer(eng, eng8, eng4, dev, hbm, peak)
    mode5_kv8, fused_kv8_launches = phase_kv8_mode5(eng, eng8, dev, hbm, peak)
    sharded_kv8_launches = phase_kv8_sharded(eng, dev)
    say("phases_38_40", seconds=f"{time.perf_counter() - t38:.1f}")
    t41 = time.perf_counter()
    paged_fp8 = phase_fp8_paged_attention(dev, hbm, peak)
    t42 = time.perf_counter()
    layer_fp8 = phase_fp8_paged_layer(eng, eng8, eng4, dev, hbm, peak)
    t43 = time.perf_counter()
    serving_fp8_launches = phase_fp8_serving(eng, dev)
    t44 = time.perf_counter()
    say("phases_41_43", seconds=f"{t44 - t41:.1f}",
        phase41_s=f"{t42 - t41:.1f}", phase42_s=f"{t43 - t42:.1f}",
        phase43_s=f"{t44 - t43:.1f}")
    eng_t, eng_t4, tree_t8 = tinyllama_engines(dev)
    hd64_rows = phase_hd64_stack(eng, eng_t, eng_t4, tree_t8, dev, hbm, peak)
    t45 = time.perf_counter()
    hd64_launches = phase_hd64_e2e(eng_t, eng_t4, dev)
    t46 = time.perf_counter()
    phase_hd64_mode5(eng_t, dev, hbm, peak)
    t47 = time.perf_counter()
    say("phases_44_46", seconds=f"{t47 - t44:.1f}",
        phase44_s=f"{t45 - t44:.1f}", phase45_s=f"{t46 - t45:.1f}",
        phase46_s=f"{t47 - t46:.1f}")
    del eng_t, eng_t4, tree_t8
    torch.cuda.empty_cache()
    t32 = time.perf_counter()
    layer4_rows = phase_int4_layer(eng4, eng8, eng, dev, hbm, peak)
    del eng, eng8
    torch.cuda.empty_cache()
    layer4_launches = phase_int4_sharded(eng4, dev)
    mode5_rows, shards4 = phase_int4_mode5(eng4, dev, hbm)
    mode5_launches = {}
    for mode, a8 in INT4_MODES:
        phase_fused_step(eng4, dev, shards4, n=4, params=eng4.params,
                         phase=f"fused_step_int4_{mode}",
                         kcfg=KernelConfig(int4_w4a8=a8), stack_check=not a8)
        mode5_launches[mode] = FIGURES[f"fused_step_int4_{mode}_launches"]
    say("phases_32_34", seconds=f"{time.perf_counter() - t32:.1f}")
    del eng4, shards4
    torch.cuda.empty_cache()
    ds_rows = phase_deepseek_kernels(dev, hbm, peak)
    mla_launches, ffn_launches = phase_deepseek_e2e(dev)
    torch.cuda.empty_cache()
    mistral_rows, mistral_launches = phase_mistral(dev, hbm, peak)
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
        *(dict(name=name, route="cuda",
               source="clusterfusion_tpu_torch/csrc/stack_kernel.cu",
               replaces="clusterfusion_tpu/ops/stack_kernel.py:524",
               launches=hd64_launches[run], **hd64_rows[run])
          for name, run in HD64_ROWS),
        dict(name="fused_decoder_stack (int8 weights)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/stack_kernel.cu",
             replaces="clusterfusion_tpu/ops/stack_kernel.py:604",
             launches=stack8_launches, **stack8),
        *(dict(name=name, route="cuda",
               source="clusterfusion_tpu_torch/csrc/" + src,
               replaces="clusterfusion_tpu/ops/" + tpu,
               launches=mistral_launches[key], **mistral_rows[key])
          for name, key, src, tpu in MISTRAL_ROWS),
        *(dict(name=f"fused_decoder_stack ({fmt} KV cache)", route="cuda",
               source="clusterfusion_tpu_torch/csrc/stack_kernel.cu",
               replaces="clusterfusion_tpu/ops/stack_kernel.py:"
                        + ("593" if fmt == "int8" else "303"),
               launches=kv8_launches[fmt][0], **stack_kv8[fmt])
          for fmt in ("int8", "fp8")),
        *(dict(name=f"fused_verify_stack ({fmt} KV cache)", route="cuda",
               source="clusterfusion_tpu_torch/csrc/stack_verify.cu",
               replaces="clusterfusion_tpu/ops/stack_verify.py:"
                        + ("470" if fmt == "int8" else "264"),
               launches=kv8_launches[fmt][1], **verify_kv8[fmt])
          for fmt in ("int8", "fp8")),
        dict(name="paged_attention", route="cuda",
             source="clusterfusion_tpu_torch/csrc/paged_attention.cu",
             replaces="clusterfusion_tpu/ops/paged_decoder_layer.py:932",
             launches=pa_launches, **paged),
        dict(name="llama_decoder_layer_paged", route="cuda",
             source="clusterfusion_tpu_torch/csrc/paged_decoder_layer.cu",
             replaces="clusterfusion_tpu/ops/paged_decoder_layer.py:399",
             launches=layer_launches, **layer),
        dict(name="paged_attention (fp8 KV pool)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/paged_attention.cu",
             replaces="clusterfusion_tpu/ops/paged_decoder_layer.py:932",
             launches=serving_fp8_launches["paged_attention"], **paged_fp8),
        dict(name="llama_decoder_layer_paged (fp8 KV pool)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/paged_decoder_layer.cu",
             replaces="clusterfusion_tpu/ops/paged_decoder_layer.py:399",
             launches=serving_fp8_launches["layer"], **layer_fp8),
        dict(name="fused_verify_stack", route="cuda",
             source="clusterfusion_tpu_torch/csrc/stack_verify.cu",
             replaces="clusterfusion_tpu/ops/stack_verify.py:432",
             launches=verify_launches, **verify),
        dict(name="fused_verify_stack (int8 weights)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/stack_verify.cu",
             replaces="clusterfusion_tpu/ops/stack_verify.py:432",
             launches=verify8_launches, **verify8),
        dict(name="fused_decoder_stack (int4 weights, W4A8)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/stack_kernel.cu",
             replaces="clusterfusion_tpu/ops/stack_kernel.py:204",
             launches=stack4_launches["w4a8"], **stack4["w4a8"]),
        dict(name="fused_decoder_stack (int4 weights, exact)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/stack_kernel.cu",
             replaces="clusterfusion_tpu/ops/stack_kernel.py:204",
             launches=stack4_launches["exact"], **stack4["exact"]),
        dict(name="fused_verify_stack (int4 weights, W4A8)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/stack_verify.cu",
             replaces="clusterfusion_tpu/ops/stack_verify.py:168",
             launches=verify4_launches["w4a8"], **verify4["w4a8"]),
        dict(name="fused_verify_stack (int4 weights, exact)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/stack_verify.cu",
             replaces="clusterfusion_tpu/ops/stack_verify.py:168",
             launches=verify4_launches["exact"], **verify4["exact"]),
        dict(name="llama_decoder_layer_paged (int4 weights)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/paged_decoder_layer.cu",
             replaces="clusterfusion_tpu/ops/paged_decoder_layer.py:166",
             launches=serving4_launches["layer"], **layer4),
        dict(name="_gemv_int4 (int4 serving QKV and O products)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/gemv.cu",
             replaces="clusterfusion_tpu/runtime/serving.py:178",
             launches=serving4_launches["gemv"], **products4["gemv"]),
        dict(name="_ffn_int4 (int4 serving FFN)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/gemv.cu",
             replaces="clusterfusion_tpu/models/llama.py:208",
             launches=serving4_launches["ffn"], **products4["ffn"]),
        dict(name="llama_decoder_layer_paged (int8 weights)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/paged_decoder_layer.cu",
             replaces="clusterfusion_tpu/ops/paged_decoder_layer.py:399",
             launches=serving8_launches["layer"], **layer8),
        dict(name="_gemv_int8 (int8 serving QKV and O products)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/gemv.cu",
             replaces="clusterfusion_tpu/runtime/serving.py:164",
             launches=serving8_launches["gemv"], **products8["gemv"]),
        dict(name="_ffn_int8 (int8 serving FFN)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/gemv.cu",
             replaces="clusterfusion_tpu/runtime/serving.py:199",
             launches=serving8_launches["ffn"], **products8["ffn"]),
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
        dict(name="_fused_decoder_layer (fp8 KV cache)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/decoder_layer.cu",
             replaces="clusterfusion_tpu/ops/decoder_layer.py:421",
             launches=sharded_kv8_launches["k6_fp8"], **layer_kv8),
        *(dict(name=f"fused_decoder_stack mode 5 ({fmt} KV cache)",
               route="cuda",
               source="clusterfusion_tpu_torch/csrc/stack_kernel.cu",
               replaces="clusterfusion_tpu/ops/stack_kernel.py:524",
               launches=fused_kv8_launches[fmt], **mode5_kv8[fmt])
          for fmt in ("int8", "fp8")),
        dict(name="_fused_decoder_layer (int8 weights)", route="cuda",
             source="clusterfusion_tpu_torch/csrc/decoder_layer.cu",
             replaces="clusterfusion_tpu/ops/decoder_layer.py:421",
             launches=layer8_launches, **layer8_row),
        *(dict(name=f"_fused_decoder_layer (int4 weights, {label})",
               route="cuda",
               source="clusterfusion_tpu_torch/csrc/decoder_layer.cu",
               replaces="clusterfusion_tpu/ops/decoder_layer.py:421",
               launches=layer4_launches[mode], **layer4_rows[mode])
          for mode, label in (("w4a8", "W4A8"), ("exact", "exact"))),
        *(dict(name=f"fused_decoder_stack mode 5 (int4 weights, {label})",
               route="cuda",
               source="clusterfusion_tpu_torch/csrc/stack_kernel.cu",
               replaces="clusterfusion_tpu/ops/stack_kernel.py:524",
               launches=mode5_launches[mode], **mode5_rows[mode])
          for mode, label in (("w4a8", "W4A8"), ("exact", "exact"))),
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
        if k["ms"] < k["bound_ms"]:
            raise AssertionError(f"{k['name']}: {k['ms']} ms is below its "
                                 f"bound of {k['bound_ms']} ms")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
