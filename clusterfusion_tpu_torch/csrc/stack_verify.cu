// Whole-stack bf16 verify of n rows for Hopper (sm_90a): every layer of one
// speculative-decoding verify, then the final RMSNorm and the LM head.
//
// Replaces the TPU kernel `fused_verify_stack`
// (clusterfusion_tpu/ops/stack_verify.py, `_verify_kernel`) for bf16
// weights, a bf16 KV cache, no window, no bias and no sandwich norms, with
// the layouts of stack_kernel.cu.  Row t of x is the token at position
// pos + t; it attends every cached row < pos and the fresh rows 0..t, and
// all n K/V rows are appended at pos..pos+n-1 of every layer.  Cache rows
// at and above pos are never read: they may hold rows of rejected drafts.
//
// What bounds it: the products read every weight once for up to 16 rows
// (13.4 GB at Llama-2-7B) and do 2n operations per weight byte, far under
// the card's ~295 operations per byte, so bytes bound it, as they bound the
// one-row stack.  The GEMVs are common.cuh's ring GEMV in its tensor-core
// form: weights stream through shared memory, mma.sync takes up to 16 rows
// of x at once, and the K chunks of a column tile meet inside a
// thread-block cluster in a fixed order, so one call on the same inputs
// gives the same bits every time and the products write their outputs
// whole.  The attention reads the cache rows < pos once per kv head and
// tile of up to 16 query rows.
//
// The sequence per layer is stack_kernel.cu's at M = n rows, on one stream:
//   resnorm  grid n: r1 = hx + res; xn = bf16(rmsnorm(r1) * attn_norm)
//   gemv     qkv[t] = xn[t] @ wqkv_f[l]
//   split    verify_split_kernel: per (kv head, split of cache rows < pos,
//            tile of query rows), q roped, scaled by 1/sqrt(hd)*log2(e) and
//            rounded to bf16; one thread per cache row forms the q.k dots of
//            the tile; bf16(p) . V; one partial (m, l, acc) per query row
//   merge    verify_merge_kernel: per (kv head, q head row), merge the
//            partials, fold in the n x n causal block of fresh rows (scores
//            from the float32 q and k, then bf16(p) . bf16(v), as the TPU
//            kernel rounds them), append the n bf16 K/V rows,
//            o[t] = bf16(acc / l), token-major
//   gemv     aout[t] = o[t] @ wo_f[l]
//   resnorm  r2 = aout + r1; xn = bf16(rmsnorm(r2) * ffn_norm)
//   gemv     gu[t] = xn[t] @ w13[l]
//   gemv     hx[t] = bf16(silu(gate) * up) @ w2[l]
// and once per call the final resnorm and the LM-head GEMV (or the bf16
// outputs without an LM head).  The hidden pair stays float32 across layers.
//
// Query row r of kv head h is (head row i, token t) with r = i*n + t, the
// TPU kernel's panel order.  What bounds the attention kernels: a split
// block keeps ROW_TILE accumulators per thread in its p.V loop, so more
// query rows (group * n > ROW_TILE) take more tiles, each reading the
// split's K/V rows again (from L2); the merge keeps the n fresh q, k and v
// rows of its head in shared memory, so n <= MAX_N.

#include "common.cuh"

namespace {

constexpr int ROW_TILE = 16;
constexpr int MAX_N = 32;
constexpr int ATT_SMEM_MAX = 96 * 1024;

// Split-KV pass over cache rows [s*split, min((s+1)*split, pos)) of kv head
// h = blockIdx.x, s = blockIdx.y, for query rows blockIdx.z*ROW_TILE.. .
// Writes part_ml [kv, ns, group*n, 2] (max, sum) and part_acc
// [kv, ns, group*n, hd].  qkv is [n, kv*(group+2)*hd]; cos/sin [n, hd].
__global__ void __launch_bounds__(ATT_THREADS)
verify_split_kernel(const float* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    const float* __restrict__ cos, const float* __restrict__ sin,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int n, int group, int hd, int cap, int pos, int split,
                    int neox) {
  extern __shared__ float sm[];
  float* qb = sm;                        // [ROW_TILE][hd] roped, scaled, bf16-rounded
  float* sc = qb + ROW_TILE * hd;        // [ROW_TILE][split] scores, then bf16(p)
  const int h = blockIdx.x, s = blockIdx.y, ns = gridDim.y;
  const int rows = group * n;
  const int r0 = blockIdx.z * ROW_TILE;
  const int nr = min(ROW_TILE, rows - r0);
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int nw = blockDim.x / 32;
  const size_t qkv_n = (size_t)gridDim.x * (group + 2) * hd;
  const float scale = LOG2E / sqrtf((float)hd);
  for (int e = tid; e < nr * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd;
    const int i = (r0 + r) / n, t = (r0 + r) % n;
    const float* raw = qkv + t * qkv_n + ((size_t)h * (group + 2) + i) * hd;
    qb[e] = bf16_round(rope_at(raw, d, hd, cos + (size_t)t * hd,
                               sin + (size_t)t * hd, neox) * scale);
  }
  __syncthreads();

  const int j0 = s * split;
  const int nj = min(split, pos - j0);
  const __nv_bfloat16* kh = kc + (size_t)h * cap * hd;
  const __nv_bfloat16* vh = vc + (size_t)h * cap * hd;
  // one thread per cache row: 16-byte loads of its K row, all the tile's
  // dots at once (q is read from shared memory as a broadcast)
  for (int j = tid; j < nj; j += blockDim.x) {
    const uint4* krow = reinterpret_cast<const uint4*>(kh + (size_t)(j0 + j) * hd);
    float acc[ROW_TILE];
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) acc[r] = 0.f;
    for (int c = 0; c < hd / 8; c += 4) {
      uint4 u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = __ldg(krow + c + q);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[8];
        unpack8(u[q], f);
        const float* qd = qb + (c + q) * 8;
#pragma unroll
        for (int r = 0; r < ROW_TILE; ++r) {
          if (r < nr) {
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r] = fmaf(qd[r * hd + e], f[e], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r)
      if (r < nr) sc[r * split + j] = acc[r];
  }
  __syncthreads();

  // softmax statistics per query row: warp w handles rows w, w+nw, ...
  for (int r = wid; r < nr; r += nw) {
    float mx = NEG_INF;
    for (int j = lane; j < nj; j += 32) mx = fmaxf(mx, sc[r * split + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nj; j += 32) {
      const float p = exp2f(sc[r * split + j] - mx);
      sum += p;
      sc[r * split + j] = bf16_round(p);   // the p.V dot takes bf16 p
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      float* ml = part_ml + (((size_t)h * ns + s) * rows + r0 + r) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  __syncthreads();

  for (int d = tid; d < hd; d += blockDim.x) {
    float acc[ROW_TILE];
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int j = 0; j < nj; ++j) {
      const float vv = __bfloat162float(vh[(size_t)(j0 + j) * hd + d]);
#pragma unroll
      for (int r = 0; r < ROW_TILE; ++r)
        if (r < nr) acc[r] = fmaf(sc[r * split + j], vv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r)
      if (r < nr) part_acc[(((size_t)h * ns + s) * rows + r0 + r) * hd + d] = acc[r];
  }
}

// Merge of kv head h = blockIdx.x, q head row i = blockIdx.y over its n
// query rows: the split partials plus the causal block of the n fresh rows,
// o[t*kv*group*hd + (h*group + i)*hd + d] = bf16(acc / l).  The blocks with
// i = 0 append the fresh bf16 K/V rows of head h at pos..pos+n-1.
__global__ void __launch_bounds__(ATT_THREADS)
verify_merge_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ part_ml,
                    const float* __restrict__ part_acc,
                    const float* __restrict__ cos, const float* __restrict__ sin,
                    __nv_bfloat16* __restrict__ kc, __nv_bfloat16* __restrict__ vc,
                    __nv_bfloat16* __restrict__ o, int n, int group, int hd,
                    int cap, int pos, int ns, int neox) {
  extern __shared__ float sm[];
  float* qr = sm;                        // [n][hd] roped, scaled f32 q of row i
  float* kr = qr + n * hd;               // [n][hd] roped f32 fresh k
  float* vb = kr + n * hd;               // [n][hd] bf16-rounded fresh v
  float* scur = vb + n * hd;             // [n][n] fresh scores, j <= t
  const int h = blockIdx.x, i = blockIdx.y, kv_heads = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int nw = blockDim.x / 32;
  const int rows = group * n;
  const size_t qkv_n = (size_t)kv_heads * (group + 2) * hd;
  const float scale = LOG2E / sqrtf((float)hd);
  for (int e = tid; e < n * hd; e += blockDim.x) {
    const int t = e / hd, d = e % hd;
    const float* head = qkv + t * qkv_n + (size_t)h * (group + 2) * hd;
    const float* ct = cos + (size_t)t * hd;
    const float* st = sin + (size_t)t * hd;
    qr[e] = rope_at(head + i * hd, d, hd, ct, st, neox) * scale;
    const float kd = rope_at(head + group * hd, d, hd, ct, st, neox);
    const float vd = head[(group + 1) * hd + d];
    kr[e] = kd;
    vb[e] = bf16_round(vd);
    if (i == 0) {
      const size_t row = ((size_t)h * cap + pos + t) * hd + d;
      kc[row] = __float2bfloat16(kd);
      vc[row] = __float2bfloat16(vd);
    }
  }
  __syncthreads();
  for (int pr = wid; pr < n * n; pr += nw) {
    const int t = pr / n, j = pr % n;
    if (j > t) continue;                 // uniform over the warp
    float part = 0.f;
    for (int d = lane; d < hd; d += 32) part = fmaf(qr[t * hd + d], kr[j * hd + d], part);
    part = warp_sum(part);
    if (lane == 0) scur[pr] = part;
  }
  __syncthreads();
  for (int d = tid; d < hd; d += blockDim.x) {
    for (int t = 0; t < n; ++t) {
      const size_t qrow = (size_t)h * ns * rows + (size_t)i * n + t;   // split 0
      float mx = NEG_INF;
      for (int j = 0; j <= t; ++j) mx = fmaxf(mx, scur[t * n + j]);
      for (int s = 0; s < ns; ++s) mx = fmaxf(mx, part_ml[(qrow + (size_t)s * rows) * 2]);
      float l = 0.f, acc = 0.f;
      for (int s = 0; s < ns; ++s) {
        const size_t idx = qrow + (size_t)s * rows;
        const float e = exp2f(part_ml[idx * 2] - mx);
        l = fmaf(part_ml[idx * 2 + 1], e, l);
        acc = fmaf(part_acc[idx * hd + d], e, acc);
      }
      for (int j = 0; j <= t; ++j) {
        const float p = exp2f(scur[t * n + j] - mx);
        l += p;
        acc = fmaf(bf16_round(p), vb[j * hd + d], acc);
      }
      o[(size_t)t * kv_heads * group * hd + ((size_t)h * group + i) * hd + d] =
          __float2bfloat16(acc / l);
    }
  }
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

struct Scratch {
  float *hx, *res_a, *res_b, *aout, *qkv, *gu, *part_ml, *part_acc;
  __nv_bfloat16 *xn, *o;
  size_t floats;
};

Scratch layout(float* base, int n, int hidden, int kv_heads, int group, int hd,
               int cap, int f_pad, int kv_split) {
  const size_t ns_max = (size_t)(cap + kv_split - 1) / kv_split;
  const size_t rows = (size_t)kv_heads * group * n;   // query rows in all
  size_t off = 0;
  Scratch s;
  auto take = [&](size_t count) {
    float* p = base ? base + off : nullptr;
    off += align16(count);
    return p;
  };
  s.hx = take((size_t)n * hidden);
  s.res_a = take((size_t)n * hidden);
  s.res_b = take((size_t)n * hidden);
  s.aout = take((size_t)n * hidden);
  s.qkv = take((size_t)n * kv_heads * (group + 2) * hd);
  s.gu = take((size_t)n * 2 * f_pad);
  s.part_ml = take(rows * ns_max * 2);
  s.part_acc = take(rows * ns_max * hd);
  s.xn = reinterpret_cast<__nv_bfloat16*>(take(((size_t)n * hidden + 1) / 2));
  s.o = reinterpret_cast<__nv_bfloat16*>(take((rows * hd + 1) / 2));
  s.floats = off;
  return s;
}

}  // namespace

// Floats of f32 scratch `cf_verify_stack` needs for this geometry.
extern "C" long long cf_verify_scratch_floats(int n, int hidden, int kv_heads,
                                              int group, int hd, int cap,
                                              int f_pad, int kv_split) {
  return (long long)layout(nullptr, n, hidden, kv_heads, group, hd, cap, f_pad,
                           kv_split).floats;
}

// One n-row verify at positions pos..pos+n-1 through all L layers, on
// `stream`.  x is bf16 [n, hidden], cos/sin f32 [n, hd].  lm_head ==
// nullptr: writes out_x/out_res (bf16 [n, hidden]); otherwise writes logits
// (f32 [n, vocab]) and out_res.  K/V rows land in kc/vc at rows
// pos..pos+n-1.  *n_launches receives the number of kernels launched.
// Returns a cudaError_t (0 on success).
extern "C" int cf_verify_stack(
    const void* x, const void* attn_norm, const void* ffn_norm, const void* cos,
    const void* sin, const void* wqkv, const void* wo, const void* w13,
    const void* w2, void* kc, void* vc, const void* final_norm,
    const void* lm_head, void* out_x, void* out_res, void* logits,
    void* scratch, int n, int L, int hidden, int kv_heads, int hg, int group,
    int hd, int cap, int f_pad, int vocab, int pos, int neox, float eps,
    int kv_split, int threads, int* n_launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *n_launches = 0;
  const size_t split_smem = sizeof(float) * ((size_t)ROW_TILE * hd + (size_t)ROW_TILE * kv_split);
  const size_t merge_smem = sizeof(float) * ((size_t)3 * n * hd + (size_t)n * n);
  if (n < 1 || n > MAX_N || hd % 32 != 0 || threads % 32 != 0 || threads < 32 ||
      threads > G1_MAX_THREADS || kv_split < 1 ||
      pos < 0 || pos + n > cap || kv_heads % hg != 0 ||
      split_smem > ATT_SMEM_MAX || merge_smem > ATT_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  static bool attrs_set = false;
  if (!attrs_set) {
    CF_CHECK((int)cudaFuncSetAttribute(verify_split_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ATT_SMEM_MAX));
    CF_CHECK((int)cudaFuncSetAttribute(verify_merge_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ATT_SMEM_MAX));
    attrs_set = true;
  }
  Scratch s = layout(static_cast<float*>(scratch), n, hidden, kv_heads, group, hd,
                     cap, f_pad, kv_split);
  const int G = kv_heads / hg;
  const long long C = (long long)hg * (group + 2) * hd;   // qkv columns per group
  const long long Ko = (long long)hg * group * hd;       // wo rows per group
  const int qkv_n = kv_heads * (group + 2) * hd;
  const int o_n = kv_heads * group * hd;
  const int ns = (pos + kv_split - 1) / kv_split;
  const int tiles = (group * n + ROW_TILE - 1) / ROW_TILE;
  const float* cosf = static_cast<const float*>(cos);
  const float* sinf = static_cast<const float*>(sin);
  int k = 0;

  for (int l = 0; l < L; ++l) {
    const __nv_bfloat16* an = static_cast<const __nv_bfloat16*>(attn_norm) + (size_t)l * hidden;
    const __nv_bfloat16* fn = static_cast<const __nv_bfloat16*>(ffn_norm) + (size_t)l * hidden;
    const __nv_bfloat16* wq = static_cast<const __nv_bfloat16*>(wqkv) + (size_t)l * G * hidden * C;
    const __nv_bfloat16* wol = static_cast<const __nv_bfloat16*>(wo) + (size_t)l * G * Ko * hidden;
    const __nv_bfloat16* w13l = static_cast<const __nv_bfloat16*>(w13) + (size_t)l * 2 * hidden * f_pad;
    const __nv_bfloat16* w2l = static_cast<const __nv_bfloat16*>(w2) + (size_t)l * f_pad * hidden;
    __nv_bfloat16* kcl = static_cast<__nv_bfloat16*>(kc) + (size_t)l * kv_heads * cap * hd;
    __nv_bfloat16* vcl = static_cast<__nv_bfloat16*>(vc) + (size_t)l * kv_heads * cap * hd;

    // residual add + attention RMSNorm per row
    resnorm_kernel<<<n, NORM_THREADS, 0, st>>>(
        l == 0 ? nullptr : s.hx,
        l == 0 ? static_cast<const __nv_bfloat16*>(x) : nullptr,
        l == 0 ? nullptr : s.res_a, nullptr, an, s.res_b, nullptr, s.xn, nullptr,
        nullptr, hidden, eps, nullptr, 0, nullptr, 0);
    CF_CHECK((int)cudaGetLastError());
    ++k;
    CF_CHECK((launch_ring_gemv<false>(s.xn, hidden, 0, wq, s.qkv, n, hidden, (int)C, G,
                                      (long long)hidden * C, qkv_n, C, threads, false,
                                      st)));
    ++k;
    if (ns > 0) {
      verify_split_kernel<<<dim3(kv_heads, ns, tiles), ATT_THREADS, split_smem, st>>>(
          s.qkv, kcl, vcl, cosf, sinf, s.part_ml, s.part_acc, n, group, hd, cap,
          pos, kv_split, neox);
      CF_CHECK((int)cudaGetLastError());
      ++k;
    }
    verify_merge_kernel<<<dim3(kv_heads, group), ATT_THREADS, merge_smem, st>>>(
        s.qkv, s.part_ml, s.part_acc, cosf, sinf, kcl, vcl, s.o, n, group, hd, cap,
        pos, ns, neox);
    CF_CHECK((int)cudaGetLastError());
    ++k;
    // wo_f[l] is [G * Ko, hidden] row-major: one product sums the groups
    CF_CHECK((launch_ring_gemv<false>(s.o, o_n, 0, wol, s.aout, n, (int)(G * Ko), hidden,
                                      1, 0, hidden, 0, threads, false, st)));
    ++k;
    // attention-out residual add + FFN RMSNorm
    resnorm_kernel<<<n, NORM_THREADS, 0, st>>>(
        s.aout, nullptr, s.res_b, nullptr, fn, s.res_a, nullptr, s.xn, nullptr,
        nullptr, hidden, eps, nullptr, 0, nullptr, 0);
    CF_CHECK((int)cudaGetLastError());
    ++k;
    CF_CHECK((launch_ring_gemv<false>(s.xn, hidden, 0, w13l, s.gu, n, hidden, f_pad, 2,
                                      (long long)hidden * f_pad, 2LL * f_pad, f_pad,
                                      threads, false, st)));
    ++k;
    CF_CHECK((launch_ring_gemv<true>(s.gu, 2LL * f_pad, f_pad, w2l, s.hx, n, f_pad,
                                     hidden, 1, 0, hidden, 0, threads, false, st)));
    ++k;
  }

  if (lm_head) {
    resnorm_kernel<<<n, NORM_THREADS, 0, st>>>(
        s.hx, nullptr, s.res_a, nullptr, static_cast<const __nv_bfloat16*>(final_norm),
        nullptr, nullptr, s.xn, nullptr, static_cast<__nv_bfloat16*>(out_res), hidden,
        eps, nullptr, 0, nullptr, 0);
    CF_CHECK((int)cudaGetLastError());
    ++k;
    CF_CHECK((launch_ring_gemv<false>(s.xn, hidden, 0,
                                      static_cast<const __nv_bfloat16*>(lm_head),
                                      static_cast<float*>(logits), n, hidden, vocab, 1,
                                      0, vocab, 0, threads, false, st)));
    ++k;
  } else {
    resnorm_kernel<<<n, NORM_THREADS, 0, st>>>(
        s.hx, nullptr, s.res_a, nullptr, nullptr, nullptr, nullptr, nullptr,
        static_cast<__nv_bfloat16*>(out_x), static_cast<__nv_bfloat16*>(out_res),
        hidden, eps, nullptr, 0, nullptr, 0);
    CF_CHECK((int)cudaGetLastError());
    ++k;
  }
  *n_launches = k;
  return 0;
}
