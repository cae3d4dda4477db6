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
// The GEMVs are common.cuh's rows_gemv_kernel at one row: each warp covers
// 256 adjacent columns (8 per lane, one 16-byte load per weight row), the
// warps of a block split its K range, and blocks split K further until the
// grid holds about two blocks per SM; partial sums meet by atomicAdd in an
// output the preceding kernel zeroed.

#include "common.cuh"

namespace {

constexpr int ATT_THREADS = 128;
constexpr int MAX_GROUP = 8;

// Split-KV flash-decode over cache rows [s*split, min((s+1)*split, pos)) of
// kv head h = blockIdx.x, s = blockIdx.y.  Writes part_ml [kv, ns, g, 2]
// (max, sum) and part_acc [kv, ns, g, hd].
__global__ void __launch_bounds__(ATT_THREADS)
attn_split_kernel(const float* __restrict__ qkv,
                  const __nv_bfloat16* __restrict__ kc,
                  const __nv_bfloat16* __restrict__ vc,
                  const float* __restrict__ cos, const float* __restrict__ sin,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int group, int hd, int cap, int pos, int split, int neox) {
  extern __shared__ float sm[];
  float* raw = sm;                       // [group][hd]
  float* qb = raw + group * hd;          // [group][hd] roped, scaled, bf16-rounded
  float* sc = qb + group * hd;           // [group][split]
  const int h = blockIdx.x, s = blockIdx.y, ns = gridDim.y;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int nw = blockDim.x / 32;
  const float* qh = qkv + (size_t)h * (group + 2) * hd;
  for (int e = tid; e < group * hd; e += blockDim.x) raw[e] = qh[e];
  __syncthreads();
  const float scale = LOG2E / sqrtf((float)hd);
  for (int e = tid; e < group * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    qb[e] = bf16_round(rope_at(raw + i * hd, d, hd, cos, sin, neox) * scale);
  }
  __syncthreads();

  const int j0 = s * split;
  const int n = min(split, pos - j0);
  const __nv_bfloat16* kh = kc + (size_t)h * cap * hd;
  const __nv_bfloat16* vh = vc + (size_t)h * cap * hd;
  const int per_lane = hd / 32;          // 2 or 4 elements
  for (int j = wid; j < n; j += nw) {
    const __nv_bfloat16* krow = kh + (size_t)(j0 + j) * hd + lane * per_lane;
    float kf[4];
    for (int c = 0; c < per_lane; ++c) kf[c] = __bfloat162float(krow[c]);
    for (int i = 0; i < group; ++i) {
      float part = 0.f;
      for (int c = 0; c < per_lane; ++c) part = fmaf(qb[i * hd + lane * per_lane + c], kf[c], part);
      part = warp_sum(part);
      if (lane == 0) sc[i * split + j] = part;
    }
  }
  __syncthreads();

  // softmax statistics per query row: warp i handles rows i, i+nw, ...
  for (int i = wid; i < group; i += nw) {
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sc[i * split + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = exp2f(sc[i * split + j] - mx);
      sum += p;
      sc[i * split + j] = bf16_round(p);   // the p.V dot takes bf16 p
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      float* ml = part_ml + (((size_t)h * ns + s) * group + i) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  __syncthreads();

  for (int d = tid; d < hd; d += blockDim.x) {
    float acc[MAX_GROUP];
    for (int i = 0; i < group; ++i) acc[i] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float vv = __bfloat162float(vh[(size_t)(j0 + j) * hd + d]);
      for (int i = 0; i < group; ++i) acc[i] = fmaf(sc[i * split + j], vv, acc[i]);
    }
    for (int i = 0; i < group; ++i)
      part_acc[(((size_t)h * ns + s) * group + i) * hd + d] = acc[i];
  }
}

// Merge the split partials of kv head h = blockIdx.x, fold in the current
// token from the f32 q/k/v, append bf16 k/v at row pos, and write
// o[(h*group + i)*hd + d] = bf16(acc / l).
__global__ void __launch_bounds__(ATT_THREADS)
attn_merge_kernel(const float* __restrict__ qkv,
                  const float* __restrict__ part_ml,
                  const float* __restrict__ part_acc,
                  const float* __restrict__ cos, const float* __restrict__ sin,
                  __nv_bfloat16* __restrict__ kc, __nv_bfloat16* __restrict__ vc,
                  __nv_bfloat16* __restrict__ o, int group, int hd, int cap,
                  int pos, int ns, int neox) {
  extern __shared__ float sm[];
  float* raw = sm;                       // [(group+2)][hd]: q rows, k, v
  float* qr = raw + (group + 2) * hd;    // [group][hd] roped, scaled
  float* kr = qr + group * hd;           // [hd] roped k
  float* scur = kr + hd;                 // [group]
  __shared__ float red[32];
  const int h = blockIdx.x, tid = threadIdx.x;
  const float* src = qkv + (size_t)h * (group + 2) * hd;
  for (int e = tid; e < (group + 2) * hd; e += blockDim.x) raw[e] = src[e];
  __syncthreads();
  const float scale = LOG2E / sqrtf((float)hd);
  const float* vraw = raw + (group + 1) * hd;
  for (int d = tid; d < hd; d += blockDim.x) {
    for (int i = 0; i < group; ++i)
      qr[i * hd + d] = rope_at(raw + i * hd, d, hd, cos, sin, neox) * scale;
    const float kd = rope_at(raw + group * hd, d, hd, cos, sin, neox);
    kr[d] = kd;
    const size_t row = ((size_t)h * cap + pos) * hd + d;
    kc[row] = __float2bfloat16(kd);
    vc[row] = __float2bfloat16(vraw[d]);
  }
  __syncthreads();
  for (int i = 0; i < group; ++i) {
    float part = 0.f;
    for (int d = tid; d < hd; d += blockDim.x) part += qr[i * hd + d] * kr[d];
    part = block_sum(part, red);
    if (tid == 0) scur[i] = part;
  }
  __syncthreads();
  for (int d = tid; d < hd; d += blockDim.x) {
    for (int i = 0; i < group; ++i) {
      const float sc = scur[i];
      float mx = sc;
      for (int s = 0; s < ns; ++s)
        mx = fmaxf(mx, part_ml[(((size_t)h * ns + s) * group + i) * 2]);
      const float pc = exp2f(sc - mx);
      float l = pc, acc = pc * vraw[d];
      for (int s = 0; s < ns; ++s) {
        const size_t idx = ((size_t)h * ns + s) * group + i;
        const float e = exp2f(part_ml[idx * 2] - mx);
        l = fmaf(part_ml[idx * 2 + 1], e, l);
        acc = fmaf(part_acc[idx * hd + d], e, acc);
      }
      o[((size_t)h * group + i) * hd + d] = __float2bfloat16(acc / l);
    }
  }
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

struct Scratch {
  float *hx, *res_a, *res_b, *aout, *qkv, *gu, *part_ml, *part_acc;
  __nv_bfloat16 *xn, *o;
  size_t floats;
};

Scratch layout(float* base, int hidden, int kv_heads, int group, int hd,
               int cap, int f_pad, int kv_split) {
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
extern "C" long long cf_stack_scratch_floats(int hidden, int kv_heads, int group,
                                             int hd, int cap, int f_pad,
                                             int kv_split) {
  return (long long)layout(nullptr, hidden, kv_heads, group, hd, cap, f_pad,
                           kv_split).floats;
}

// One decode step at position pos through all L layers, on `stream`.
// lm_head == nullptr: writes out_x/out_res (bf16 [hidden]); otherwise writes
// logits (f32 [vocab]) and out_res.  K/V rows land in kc/vc at row pos.
// *n_launches receives the number of kernels launched.  Returns a
// cudaError_t (0 on success).
extern "C" int cf_decoder_stack(
    const void* x, const void* attn_norm, const void* ffn_norm, const void* cos,
    const void* sin, const void* wqkv, const void* wo, const void* w13,
    const void* w2, void* kc, void* vc, const void* final_norm,
    const void* lm_head, void* out_x, void* out_res, void* logits,
    void* scratch, int L, int hidden, int kv_heads, int hg, int group, int hd,
    int cap, int f_pad, int vocab, int pos, int neox, float eps, int kv_split,
    int threads, int* n_launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *n_launches = 0;
  if (group > MAX_GROUP || hd % 32 != 0 || hd > 4 * 32 || threads % 32 != 0 ||
      pos < 0 || pos >= cap || kv_heads % hg != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, num_sms = 0;
  CF_CHECK((int)cudaGetDevice(&dev));
  CF_CHECK((int)cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev));
  static bool attrs_set = false;
  if (!attrs_set) {
    CF_CHECK((int)cudaFuncSetAttribute(attn_split_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       96 * 1024));
    attrs_set = true;
  }
  Scratch s = layout(static_cast<float*>(scratch), hidden, kv_heads, group, hd,
                     cap, f_pad, kv_split);
  const int G = kv_heads / hg;
  const long long C = (long long)hg * (group + 2) * hd;   // qkv columns per group
  const long long Ko = (long long)hg * group * hd;       // wo rows per group
  const int qkv_n = kv_heads * (group + 2) * hd;
  const int ns = (pos + kv_split - 1) / kv_split;
  const float* cosf = static_cast<const float*>(cos);
  const float* sinf = static_cast<const float*>(sin);
  const size_t split_smem = sizeof(float) * ((size_t)2 * group * hd + (size_t)group * kv_split);
  const size_t merge_smem = sizeof(float) * ((size_t)(2 * group + 3) * hd + group);
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
                                            num_sms, st)));
    ++n;
    if (ns > 0) {
      attn_split_kernel<<<dim3(kv_heads, ns), ATT_THREADS, split_smem, st>>>(
          s.qkv, kcl, vcl, cosf, sinf, s.part_ml, s.part_acc, group, hd, cap,
          pos, kv_split, neox);
      CF_CHECK((int)cudaGetLastError());
      ++n;
    }
    attn_merge_kernel<<<kv_heads, ATT_THREADS, merge_smem, st>>>(
        s.qkv, s.part_ml, s.part_acc, cosf, sinf, kcl, vcl, s.o, group, hd, cap,
        pos, ns, neox);
    CF_CHECK((int)cudaGetLastError());
    ++n;
    // wo_f[l] is [G * Ko, hidden] row-major: one product sums the groups
    CF_CHECK((launch_rows_gemv_nb<1, false>(s.o, 0, 0, wol, s.aout, 1, (int)(G * Ko),
                                            hidden, 1, 0, 0, 0, threads, num_sms,
                                            st)));
    ++n;
    // attention-out residual add + FFN RMSNorm; zero the gate/up and down sums
    resnorm_kernel<<<1, NORM_THREADS, 0, st>>>(
        s.aout, nullptr, s.res_b, nullptr, fn, s.res_a, nullptr, s.xn, nullptr,
        nullptr, hidden, eps, s.gu, 2 * f_pad, s.hx, hidden);
    CF_CHECK((int)cudaGetLastError());
    ++n;
    CF_CHECK((launch_rows_gemv_nb<1, false>(s.xn, 0, 0, w13l, s.gu, 1, hidden, f_pad, 2,
                                            (long long)hidden * f_pad, 0, f_pad,
                                            threads, num_sms, st)));
    ++n;
    CF_CHECK((launch_rows_gemv_nb<1, true>(s.gu, 0, f_pad, w2l, s.hx, 1, f_pad, hidden,
                                           1, 0, 0, 0, threads, num_sms, st)));
    ++n;
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
                                            vocab, 1, 0, 0, 0, threads, num_sms, st)));
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
