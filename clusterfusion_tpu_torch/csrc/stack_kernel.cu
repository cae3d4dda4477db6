// Whole-stack bf16 decode step for Hopper (sm_90a): every layer of one
// bs=1 decode step, then the final RMSNorm and the LM head.
//
// Replaces the TPU kernel `fused_decoder_stack`
// (clusterfusion_tpu/ops/stack_kernel.py, `_stack_kernel`) for bf16
// weights, a bf16 KV cache, no window, no bias and no sandwich norms, with
// the same layouts:
//   wqkv_f [L, G, hidden, hg*(g+2)*hd]  columns per kv head [q_0..q_{g-1}|k|v]
//   wo_f   [L, G, hg*g*hd, hidden]
//   w13    [L, 2, hidden, f_pad]        w2 [L, f_pad, hidden]
//   caches [L, kv_heads, cap, hd]       lm_head [hidden, vocab]
//
// What bounds it: a bs=1 step reads every weight once (13.4 GB at
// Llama-2-7B) and does two operations per weight byte, far under the
// card's ~295 operations per byte, so it is bound by bytes.  The design
// streams each weight matrix once through shared memory with bulk copies
// (cp.async.bulk) across enough blocks to keep every SM's copies in
// flight, and reads only cache rows < pos, the same way.
//
// The TPU kernel walks a sequential (layer, phase) grid and carries the
// hidden pair in VMEM scratch from step to step.  Hopper blocks run in
// parallel and in no order, so here each phase is its own kernel, launched
// in a fixed order on one stream by `cf_decoder_stack`, and the carry
// lives in a float32 scratch buffer the caller allocates.  Per layer:
//   resnorm   r1 = hx + res; xn = bf16(rmsnorm(r1) * attn_norm)
//   gemv      qkv = xn @ wqkv_f[l]             (raw f32, split over K)
//   split     flash-decode over cache rows < pos, one partial (m, l, acc)
//             per (kv head, split); q is roped, pre-scaled by
//             1/sqrt(hd)*log2(e) and rounded to bf16 for these dots
//   merge     merge the partials, fold in the current token from the f32
//             q/k/v, append bf16 k/v at row pos, o = bf16(acc / l)
//   gemv      aout = o @ wo_f[l]               (f32 over head groups)
//   resnorm   r2 = aout + r1; xn = bf16(rmsnorm(r2) * ffn_norm)
//   gemv      gu = xn @ w13[l]                 (gate and up, f32)
//   gemv      hx = bf16(silu(gate) * up) @ w2[l]
// and once per token: resnorm over hx + res with the final norm (or the
// bf16 outputs without an LM head), then gemv logits = xn @ lm_head.
// The hidden pair stays float32 across layers, as in the TPU kernel.
//
// Mode 5, reduce_axis (the JAX package's fused_collectives=True): with a
// communicator (collective.cuh; null at tp 1) the caller holds this rank's
// tp shards (kv_heads/tp heads, f_pad/tp FFN columns), and kernel 13's
// all-reduce runs twice per layer on the same stream, in place on the f32
// partial sums: on aout after the O-projection (Stage.ATTN, before the FFN
// resnorm) and on hx after the down projection (Stage.LINEAR, before the
// next layer's resnorm), as `ring_reduce_scratch` runs inside the TPU
// kernel.  The GEMVs write aout and hx whole, so each reduce sees one
// rank's whole partial; every rank then carries the same bits of the
// hidden pair.  The sequence gains 2L launches.
//
// The split and merge passes are common.cuh's attn_split_kernel and
// attn_merge_kernel, shared with the single layer (decoder_layer.cu): the
// split pass bulk-copies each split's K and V rows into shared memory and
// works on a tile's rows at once.  The GEMVs are common.cuh's ring GEMV at
// one row (ring_gemv_kernel): a producer warp bulk-copies 256-column weight tiles
// through a ring of shared-memory stages, consumer warps do the FMAs, and
// the K chunks of a tile meet inside a thread-block cluster in a fixed
// order, so one step on the same inputs gives the same bits every time
// (atomic adds would let the last bits move from run to run, and the bf16
// roundings they flip compound over the layers).  Each GEMV is launched
// with programmatic dependent launch: it streams its first weight stages
// while the kernel before it (resnorm, merge or the previous GEMV, which
// let it start at once) still runs, and reads its input after that
// kernel has completed.

#include <algorithm>

#include "collective.cuh"
#include "common.cuh"

namespace {

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Launch the norms, the split pass and the merge with programmatic
// dependent launch too, so their launch latency hides under the kernel
// before them (the GEMVs always are).
constexpr bool PDL_CHAIN = true;

struct Scratch {
  float *hx, *res_a, *res_b, *aout, *qkv, *gu, *part_ml, *part_acc;
  __nv_bfloat16 *xn, *o;
  size_t floats;
};

Scratch layout(float* base, int hidden, int kv_heads, int group, int hd, int cap,
               int f_pad, int kv_split) {
  const size_t ns_max = (size_t)(cap + kv_split - 1) / kv_split;
  size_t off = 0;
  Scratch s;
  auto take = [&](size_t n) {
    float* p = base ? base + off : nullptr;
    off += align16(n);
    return p;
  };
  s.hx = take(hidden);
  s.res_a = take(hidden);
  s.res_b = take(hidden);
  s.aout = take(hidden);
  s.qkv = take((size_t)kv_heads * (group + 2) * hd);
  s.gu = take(2 * (size_t)f_pad);
  s.part_ml = take((size_t)kv_heads * ns_max * group * 2);
  s.part_acc = take((size_t)kv_heads * ns_max * group * hd);
  s.xn = reinterpret_cast<__nv_bfloat16*>(take((hidden + 1) / 2));
  s.o = reinterpret_cast<__nv_bfloat16*>(take(((size_t)kv_heads * group * hd + 1) / 2));
  s.floats = off;
  return s;
}

}  // namespace

// Floats of f32 scratch `cf_decoder_stack` needs for this geometry.
extern "C" long long cf_stack_scratch_floats(int hidden, int kv_heads, int hg,
                                             int group, int hd, int cap, int f_pad,
                                             int kv_split, int vocab) {
  (void)hg;
  (void)vocab;
  return (long long)layout(nullptr, hidden, kv_heads, group, hd, cap, f_pad, kv_split)
      .floats;
}

// One decode step at position pos through all L layers, on `stream`.
// lm_head == nullptr: writes out_x/out_res (bf16 [hidden]); otherwise writes
// logits (f32 [vocab]) and out_res.  K/V rows land in kc/vc at row pos.
// *n_launches receives the number of kernels launched.  comm: a CfComm*
// for mode 5 (the all-reduces over tp), or null.  Returns a cudaError_t (0
// on success).
extern "C" int cf_decoder_stack(
    const void* x, const void* attn_norm, const void* ffn_norm, const void* cos,
    const void* sin, const void* wqkv, const void* wo, const void* w13,
    const void* w2, void* kc, void* vc, const void* final_norm,
    const void* lm_head, void* out_x, void* out_res, void* logits,
    void* scratch, int L, int hidden, int kv_heads, int hg, int group, int hd,
    int cap, int f_pad, int vocab, int pos, int neox, float eps, int kv_split,
    int threads, int* n_launches, const void* comm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const CfComm* cc = static_cast<const CfComm*>(comm);
  *n_launches = 0;
  if (group > ATT_MAX_GROUP || hd % 32 != 0 || hd > 4 * 32 || threads % 32 != 0 ||
      threads < 32 || threads > G1_MAX_THREADS || pos < 0 || pos >= cap ||
      kv_heads % hg != 0 || (cc && hidden % 4 != 0))
    return (int)cudaErrorInvalidValue;
  Scratch s = layout(static_cast<float*>(scratch), hidden, kv_heads, group, hd, cap,
                     f_pad, kv_split);
  const int G = kv_heads / hg;
  const long long C = (long long)hg * (group + 2) * hd;   // qkv columns per group
  const long long Ko = (long long)hg * group * hd;       // wo rows per group
  const float* cosf = static_cast<const float*>(cos);
  const float* sinf = static_cast<const float*>(sin);
  int n = 0;

  for (int l = 0; l < L; ++l) {
    const __nv_bfloat16* an = static_cast<const __nv_bfloat16*>(attn_norm) + (size_t)l * hidden;
    const __nv_bfloat16* fn = static_cast<const __nv_bfloat16*>(ffn_norm) + (size_t)l * hidden;
    const __nv_bfloat16* wq = static_cast<const __nv_bfloat16*>(wqkv) + (size_t)l * G * hidden * C;
    const __nv_bfloat16* wol = static_cast<const __nv_bfloat16*>(wo) + (size_t)l * G * Ko * hidden;
    const __nv_bfloat16* w13l = static_cast<const __nv_bfloat16*>(w13) + (size_t)l * 2 * hidden * f_pad;
    const __nv_bfloat16* w2l = static_cast<const __nv_bfloat16*>(w2) + (size_t)l * f_pad * hidden;
    __nv_bfloat16* kcl = static_cast<__nv_bfloat16*>(kc) + (size_t)l * kv_heads * cap * hd;
    __nv_bfloat16* vcl = static_cast<__nv_bfloat16*>(vc) + (size_t)l * kv_heads * cap * hd;

    // residual add + attention RMSNorm
    CF_CHECK(launch_kernel(resnorm_kernel, dim3(1), dim3(NORM_THREADS), 0, st, PDL_CHAIN,
        l == 0 ? nullptr : s.hx,
        l == 0 ? static_cast<const __nv_bfloat16*>(x) : nullptr,
        l == 0 ? nullptr : s.res_a, nullptr, an, s.res_b, nullptr, s.xn, nullptr,
        nullptr, hidden, eps, nullptr, 0, nullptr, 0));
    ++n;
    CF_CHECK(launch_gemv1<false>(s.xn, 0, wq, s.qkv, hidden, (int)C, G,
                                 (long long)hidden * C, C, threads, true, st));
    ++n;
    // split-KV attention over rows < pos, then the merge with the current
    // token, which appends its bf16 k/v at row pos
    CF_CHECK(launch_attention(s.qkv, kcl, vcl, cosf, sinf, s.part_ml, s.part_acc,
                              kcl, vcl, nullptr, nullptr, s.o, nullptr, nullptr,
                              kv_heads, group, hd, cap, pos, kv_split, 1, neox,
                              st, &n, PDL_CHAIN));
    // wo_f[l] is [G * Ko, hidden] row-major: one product sums the groups
    CF_CHECK(launch_gemv1<false>(s.o, 0, wol, s.aout, (int)(G * Ko), hidden, 1, 0, 0,
                                 threads, true, st));
    ++n;
    if (cc) {   // Stage.ATTN: sum the ranks' O-projection partials
      CF_CHECK(cf_launch_all_reduce(cc, s.aout, s.aout, hidden, 0, st));
      ++n;
    }
    // attention-out residual add + FFN RMSNorm
    CF_CHECK(launch_kernel(resnorm_kernel, dim3(1), dim3(NORM_THREADS), 0, st, PDL_CHAIN,
        s.aout, nullptr, s.res_b, nullptr, fn, s.res_a, nullptr, s.xn, nullptr,
        nullptr, hidden, eps, nullptr, 0, nullptr, 0));
    ++n;
    CF_CHECK(launch_gemv1<false>(s.xn, 0, w13l, s.gu, hidden, f_pad, 2,
                                 (long long)hidden * f_pad, f_pad, threads, true, st));
    ++n;
    CF_CHECK(launch_gemv1<true>(s.gu, f_pad, w2l, s.hx, f_pad, hidden, 1, 0, 0, threads,
                                true, st));
    ++n;
    if (cc) {   // Stage.LINEAR: sum the ranks' down-projection partials
      CF_CHECK(cf_launch_all_reduce(cc, s.hx, s.hx, hidden, 0, st));
      ++n;
    }
  }

  if (lm_head) {
    CF_CHECK(launch_kernel(resnorm_kernel, dim3(1), dim3(NORM_THREADS), 0, st, PDL_CHAIN,
        s.hx, nullptr, s.res_a, nullptr, static_cast<const __nv_bfloat16*>(final_norm),
        nullptr, nullptr, s.xn, nullptr, static_cast<__nv_bfloat16*>(out_res), hidden,
        eps, nullptr, 0, nullptr, 0));
    ++n;
    CF_CHECK(launch_gemv1<false>(s.xn, 0, static_cast<const __nv_bfloat16*>(lm_head),
                                 static_cast<float*>(logits), hidden, vocab, 1, 0, 0,
                                 threads, true, st));
    ++n;
  } else {
    CF_CHECK(launch_kernel(resnorm_kernel, dim3(1), dim3(NORM_THREADS), 0, st, PDL_CHAIN,
        s.hx, nullptr, s.res_a, nullptr, nullptr, nullptr, nullptr, nullptr,
        static_cast<__nv_bfloat16*>(out_x), static_cast<__nv_bfloat16*>(out_res),
        hidden, eps, nullptr, 0, nullptr, 0));
    ++n;
  }
  *n_launches = n;
  return 0;
}
