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
// streams each weight matrix once with 16-byte coalesced loads across
// enough blocks to keep every SM's loads in flight, and reads only cache
// rows < pos.
//
// The TPU kernel walks a sequential (layer, phase) grid and carries the
// hidden pair in VMEM scratch from step to step.  Hopper blocks run in
// parallel and in no order, so here each phase is its own kernel, launched
// in a fixed order on one stream by `cf_decoder_stack`, and the carry
// lives in a float32 scratch buffer the caller allocates.  Per layer:
//   resnorm   r1 = hx + res; xn = bf16(rmsnorm(r1) * attn_norm)
//   gemv      qkv += xn @ wqkv_f[l]            (raw f32, split over K)
//   split     flash-decode over cache rows < pos, one partial (m, l, acc)
//             per (kv head, split); q is roped, pre-scaled by
//             1/sqrt(hd)*log2(e) and rounded to bf16 for these dots
//   merge     merge the partials, fold in the current token from the f32
//             q/k/v, append bf16 k/v at row pos, o = bf16(acc / l)
//   gemv      aout += o @ wo_f[l]              (f32 over head groups)
//   resnorm   r2 = aout + r1; xn = bf16(rmsnorm(r2) * ffn_norm)
//   gemv      gu += xn @ w13[l]                (gate and up, f32)
//   gemv      hx += bf16(silu(gate) * up) @ w2[l]
// and once per token: resnorm over hx + res with the final norm (or the
// bf16 outputs without an LM head), then gemv logits += xn @ lm_head.
// The hidden pair stays float32 across layers, as in the TPU kernel.
//
// Mode 5, reduce_axis (the JAX package's fused_collectives=True): with a
// communicator (collective.cuh; null at tp 1) the caller holds this rank's
// tp shards (kv_heads/tp heads, f_pad/tp FFN columns), and kernel 13's
// all-reduce runs twice per layer on the same stream, in place on the f32
// partial sums: on aout after the O-projection (Stage.ATTN, before the FFN
// resnorm) and on hx after the down projection (Stage.LINEAR, before the
// next layer's resnorm), as `ring_reduce_scratch` runs inside the TPU
// kernel.  The resnorms zero aout and hx before the GEMVs add into them, so
// each reduce sees one rank's whole partial; every rank then carries the
// same bits of the hidden pair.  The sequence gains 2L launches.
//
// The split and merge passes are common.cuh's attn_split_kernel and
// attn_merge_kernel, shared with the single layer (decoder_layer.cu).
// The GEMVs are common.cuh's rows_gemv_kernel at one row: each warp covers
// 256 adjacent columns (8 per lane, one 16-byte load per weight row), the
// warps of a block split its K range, and blocks split K further until the
// grid holds about two blocks per SM.  The blocks' partial sums meet in a
// fixed order (the GEMV's `part` mode) in an output the preceding kernel
// zeroed, so one step on the same inputs gives the same bits every time
// (atomicAdd would let the last bits move from run to run, and the bf16
// roundings they flip compound over the layers).  The GEMVs share one
// partial-sum buffer and one set of tile counters; the counters are zeroed
// once per step and each GEMV leaves them at zero.

#include <algorithm>

#include "collective.cuh"
#include "common.cuh"

namespace {

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

struct Scratch {
  float *hx, *res_a, *res_b, *aout, *qkv, *gu, *part_ml, *part_acc, *gemv_part;
  __nv_bfloat16 *xn, *o;
  unsigned* gemv_cnt;
  size_t floats, n_cnt;
};

Scratch layout(float* base, int hidden, int kv_heads, int hg, int group, int hd,
               int cap, int f_pad, int kv_split, int vocab) {
  const size_t ns_max = (size_t)(cap + kv_split - 1) / kv_split;
  const int G = kv_heads / hg, C = hg * (group + 2) * hd;
  // the GEMVs' partial sums and tile counters: the largest of the step's
  size_t n_part = 0, n_cnt = 0;
  auto gemv = [&](int N, int nmat) {
    n_part = std::max(n_part, rows_gemv_part_floats(1, 1, N, nmat));
    n_cnt = std::max(n_cnt, rows_gemv_counters(1, 1, N, nmat));
  };
  gemv(C, G);
  gemv(hidden, 1);
  gemv(f_pad, 2);
  if (vocab > 0) gemv(vocab, 1);
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
  s.gemv_part = take(n_part);
  s.gemv_cnt = reinterpret_cast<unsigned*>(take(n_cnt));
  s.n_cnt = n_cnt;
  s.floats = off;
  return s;
}

}  // namespace

// Floats of f32 scratch `cf_decoder_stack` needs for this geometry.
extern "C" long long cf_stack_scratch_floats(int hidden, int kv_heads, int hg,
                                             int group, int hd, int cap, int f_pad,
                                             int kv_split, int vocab) {
  return (long long)layout(nullptr, hidden, kv_heads, hg, group, hd, cap, f_pad,
                           kv_split, vocab).floats;
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
      pos < 0 || pos >= cap || kv_heads % hg != 0 || (cc && hidden % 4 != 0))
    return (int)cudaErrorInvalidValue;
  int dev = 0, num_sms = 0;
  CF_CHECK((int)cudaGetDevice(&dev));
  CF_CHECK((int)cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev));
  Scratch s = layout(static_cast<float*>(scratch), hidden, kv_heads, hg, group, hd,
                     cap, f_pad, kv_split, lm_head ? vocab : 0);
  CF_CHECK((int)cudaMemsetAsync(s.gemv_cnt, 0, sizeof(unsigned) * s.n_cnt, st));
  const int G = kv_heads / hg;
  const long long C = (long long)hg * (group + 2) * hd;   // qkv columns per group
  const long long Ko = (long long)hg * group * hd;       // wo rows per group
  const int qkv_n = kv_heads * (group + 2) * hd;
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

    // residual add + attention RMSNorm; zero the qkv and attn-out sums
    resnorm_kernel<<<1, NORM_THREADS, 0, st>>>(
        l == 0 ? nullptr : s.hx,
        l == 0 ? static_cast<const __nv_bfloat16*>(x) : nullptr,
        l == 0 ? nullptr : s.res_a, nullptr, an, s.res_b, nullptr, s.xn, nullptr,
        nullptr, hidden, eps, s.qkv, qkv_n, s.aout, hidden);
    CF_CHECK((int)cudaGetLastError());
    ++n;
    CF_CHECK((launch_rows_gemv_nb<1, false>(s.xn, 0, 0, wq, s.qkv, 1, hidden, (int)C, G,
                                            (long long)hidden * C, 0, C, threads,
                                            num_sms, st, s.gemv_part, s.gemv_cnt)));
    ++n;
    // split-KV attention over rows < pos, then the merge with the current
    // token, which appends its bf16 k/v at row pos
    CF_CHECK(launch_attention(s.qkv, kcl, vcl, cosf, sinf, s.part_ml, s.part_acc,
                              kcl, vcl, nullptr, nullptr, s.o, nullptr, nullptr,
                              kv_heads, group, hd, cap, pos, kv_split, 1, neox,
                              st, &n));
    // wo_f[l] is [G * Ko, hidden] row-major: one product sums the groups
    CF_CHECK((launch_rows_gemv_nb<1, false>(s.o, 0, 0, wol, s.aout, 1, (int)(G * Ko),
                                            hidden, 1, 0, 0, 0, threads, num_sms,
                                            st, s.gemv_part, s.gemv_cnt)));
    ++n;
    if (cc) {   // Stage.ATTN: sum the ranks' O-projection partials
      CF_CHECK(cf_launch_all_reduce(cc, s.aout, s.aout, hidden, 0, st));
      ++n;
    }
    // attention-out residual add + FFN RMSNorm; zero the gate/up and down sums
    resnorm_kernel<<<1, NORM_THREADS, 0, st>>>(
        s.aout, nullptr, s.res_b, nullptr, fn, s.res_a, nullptr, s.xn, nullptr,
        nullptr, hidden, eps, s.gu, 2 * f_pad, s.hx, hidden);
    CF_CHECK((int)cudaGetLastError());
    ++n;
    CF_CHECK((launch_rows_gemv_nb<1, false>(s.xn, 0, 0, w13l, s.gu, 1, hidden, f_pad, 2,
                                            (long long)hidden * f_pad, 0, f_pad,
                                            threads, num_sms, st, s.gemv_part,
                                            s.gemv_cnt)));
    ++n;
    CF_CHECK((launch_rows_gemv_nb<1, true>(s.gu, 0, f_pad, w2l, s.hx, 1, f_pad, hidden,
                                           1, 0, 0, 0, threads, num_sms, st,
                                           s.gemv_part, s.gemv_cnt)));
    ++n;
    if (cc) {   // Stage.LINEAR: sum the ranks' down-projection partials
      CF_CHECK(cf_launch_all_reduce(cc, s.hx, s.hx, hidden, 0, st));
      ++n;
    }
  }

  if (lm_head) {
    resnorm_kernel<<<1, NORM_THREADS, 0, st>>>(
        s.hx, nullptr, s.res_a, nullptr, static_cast<const __nv_bfloat16*>(final_norm),
        nullptr, nullptr, s.xn, nullptr, static_cast<__nv_bfloat16*>(out_res), hidden,
        eps, static_cast<float*>(logits), vocab, nullptr, 0);
    CF_CHECK((int)cudaGetLastError());
    ++n;
    CF_CHECK((launch_rows_gemv_nb<1, false>(s.xn, 0, 0,
                                            static_cast<const __nv_bfloat16*>(lm_head),
                                            static_cast<float*>(logits), 1, hidden,
                                            vocab, 1, 0, 0, 0, threads, num_sms, st,
                                            s.gemv_part, s.gemv_cnt)));
    ++n;
  } else {
    resnorm_kernel<<<1, NORM_THREADS, 0, st>>>(
        s.hx, nullptr, s.res_a, nullptr, nullptr, nullptr, nullptr, nullptr,
        static_cast<__nv_bfloat16*>(out_x), static_cast<__nv_bfloat16*>(out_res),
        hidden, eps, nullptr, 0, nullptr, 0);
    CF_CHECK((int)cudaGetLastError());
    ++n;
  }
  *n_launches = n;
  return 0;
}
