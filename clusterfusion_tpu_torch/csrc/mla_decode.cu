// DeepSeek-V2 MLA decode layer of one bs=1 token for Hopper (sm_90a):
// RMSNorm, the fused q_nope | q_pe | ckv | k_pe projection, the q @ W_UK
// absorption, attention over the compressed cache, the @ W_UV expansion and
// the O-projection.
//
// Replaces both TPU kernels built on `_mla_kernel`
// (clusterfusion_tpu/ops/deepseek_layer.py): `deepseek_decoder_layer_fused`
// (one layer, every cache row < seq read, the current row returned) and
// `deepseek_decoder_stack_layer` (the [L, ...] weight stacks, the layer
// picked by `layer`, the current row appended in place at row seq of the
// [L, cap, stride] cache), for bf16 weights and a bf16 cache.  Layouts:
//   wproj [L, hidden, n_proj]  n_proj = heads*(nope+rope) + lora + rope
//   wuk [L, heads, nope, lora]   wuv [L, heads, lora, nope]
//   wo_t [L, heads*nope, hidden]   cache [L, cap, stride], stride >= mla
// with mla = lora + rope (576 at V2-Lite; the model's cache pads rows to
// 640 columns, which are never read and are written as zeros).
//
// What bounds it: at DeepSeek-V2-Lite a layer reads 27.5 MB of weights
// plus 1152 bytes per cached row, and does about two operations per byte,
// so bytes bound it.  The TPU kernel walks a sequential grid of cache
// chunks with a running (m, l) in VMEM; Hopper blocks run in parallel and
// in no order, so here the layer is a fixed sequence of kernels on one
// stream, with a split pass and a merge:
//   resnorm   xn = bf16(rmsnorm(x) * rms_in); zero proj and oacc
//   gemv      proj += xn @ wproj[l]          (f32; common.cuh)
//   absorb    per head: q = [bf16(q_nope[h]) @ wuk[h] | rope(q_pe[h])] *
//             scale * log2(e), kept in f32 (qs) and rounded to bf16 (qb)
//   split     per block of `split` rows < seq and 4 heads: scores of qb over
//             the mla columns, p = exp2(s - m_split) rounded to bf16 against
//             the first lora columns (the compressed row doubles as V); one
//             partial (m, l, acc[lora]) per (split, head)
//   merge     per head: cur = [rmsnorm(ckv) | rope(k_pe)] in f32, the current
//             token folded in f32 (qs . cur), o = bf16(acc / l), then
//             o_nope[h] = bf16(o @ wuv[h]); block 0 writes bf16(cur) to the
//             cache row (append) or to ckv_new
//   gemv      oacc += o_nope @ wo_t[l]
//   to_bf16   out = bf16(oacc)
// Every head scores the same compressed rows (MQA-like): a split block
// stages its rows in shared memory once for a group of SPLIT_HEADS heads
// (the other groups' blocks read them again, from L2), with four 16-byte
// loads in flight per thread.  Cache rows at and above seq are never read.

#include "common.cuh"

namespace {

constexpr int MLA_THREADS = 256;
constexpr int MAX_HEADS = 32;
constexpr int MAX_SPLIT = 128;
constexpr int SPLIT_HEADS = 4;     // heads per block of the split pass
constexpr int HG_MAX_K = 2048;     // depth of the per-head products
constexpr int HG_RED = MLA_THREADS * 8;

// y[n] = scale * sum_k xs[k] * w[k * ld + n] for n < N, in one block: xs
// holds K floats in shared memory, w is bf16.  Threads take 8 adjacent
// columns each (one 16-byte load per weight row) and split K into
// blockDim / (N/8) phases, which meet in `red` (HG_RED floats).  Writes y
// to out_f (f32) and bf16(y) to out_b, where given.  Needs N % 8 == 0 and
// N <= 8 * blockDim.
__device__ void head_gemv_block(const float* xs, const __nv_bfloat16* __restrict__ w,
                                int K, int N, int ld, float scale, float* red,
                                float* out_f, __nv_bfloat16* out_b) {
  const int tid = threadIdx.x;
  const int ngrp = N / 8, P = blockDim.x / ngrp;
  const int cg = tid % ngrp, ph = tid / ngrp;
  if (ph < P) {
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    const __nv_bfloat16* wc = w + cg * 8;
    int k = ph;
    for (; k + 3 * P < K; k += 4 * P) {
      uint4 u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        u[q] = __ldg(reinterpret_cast<const uint4*>(wc + (size_t)(k + q * P) * ld));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[8];
        unpack8(u[q], f);
        const float xk = xs[k + q * P];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] = fmaf(xk, f[c], acc[c]);
      }
    }
    for (; k < K; k += P) {
      float f[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(wc + (size_t)k * ld)), f);
      const float xk = xs[k];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(xk, f[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) red[ph * N + cg * 8 + c] = acc[c];
  }
  __syncthreads();
  for (int n = tid; n < N; n += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < P; ++q) s += red[q * N + n];
    s *= scale;
    if (out_f) out_f[n] = s;
    if (out_b) out_b[n] = __float2bfloat16(s);
  }
}

// The scaled q of head h = blockIdx.x, row h of qs (f32) and qb (bf16)
// [heads, lora + rope]: columns cb*nb .. of bf16(q_nope[h]) @ wuk[h] for
// column block cb = blockIdx.y of nb columns (q_nope[h] is proj[h*nope ..]),
// and, in the blocks with cb = 0, rope(q_pe[h]) in the last rope columns.
// cos/sin are full-dim [rope] tables.
__global__ void __launch_bounds__(MLA_THREADS)
mla_absorb_kernel(const float* __restrict__ proj, const __nv_bfloat16* __restrict__ wuk,
                  const float* __restrict__ cos, const float* __restrict__ sin,
                  float* __restrict__ qs, __nv_bfloat16* __restrict__ qb, int heads,
                  int nope, int rope, int lora, int nb, float scale) {
  __shared__ float xs[HG_MAX_K];
  __shared__ float red[HG_RED];
  const int h = blockIdx.x, c0 = blockIdx.y * nb, mla = lora + rope;
  for (int k = threadIdx.x; k < nope; k += blockDim.x)
    xs[k] = bf16_round(proj[(size_t)h * nope + k]);
  if (blockIdx.y == 0) {
    const float* qpe = proj + (size_t)heads * nope + (size_t)h * rope;
    for (int d = threadIdx.x; d < rope; d += blockDim.x) {
      const float v = rope_at(qpe, d, rope, cos, sin, 1) * scale;
      qs[(size_t)h * mla + lora + d] = v;
      qb[(size_t)h * mla + lora + d] = __float2bfloat16(v);
    }
  }
  __syncthreads();
  head_gemv_block(xs, wuk + (size_t)h * nope * lora + c0, nope, nb, lora, scale, red,
                  qs + (size_t)h * mla + c0, qb + (size_t)h * mla + c0);
}

// Split pass over compressed rows [s*split, min((s+1)*split, seq)) for
// heads g*SPLIT_HEADS .. of all heads, s = blockIdx.x, g = blockIdx.y, with
// qb the bf16 scaled q [heads, mla].  Writes part_ml [ns, heads, 2] (max,
// sum) and part_acc [ns, heads, lora].
__global__ void __launch_bounds__(MLA_THREADS)
mla_split_kernel(const __nv_bfloat16* __restrict__ qb_g,
                 const __nv_bfloat16* __restrict__ cache, int stride,
                 float* __restrict__ part_ml, float* __restrict__ part_acc, int heads,
                 int rope, int lora, int seq, int split) {
  extern __shared__ float sm[];
  const int mla = lora + rope, c8 = mla / 8;
  const int rs = mla + 8;                // row stride in shared memory: the pad
                                         // spreads rows over the banks
  const int g0 = blockIdx.y * SPLIT_HEADS, nh = min(SPLIT_HEADS, heads - g0);
  float* sc = sm;                        // [nh][split] scores, then bf16(p)
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(sc + SPLIT_HEADS * split);  // [nh][mla]
  __nv_bfloat16* rows = qb + SPLIT_HEADS * mla;                                   // [split][rs]
  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32, nw = blockDim.x / 32;
  const int j0 = s * split, nj = min(split, seq - j0);
  const int nq = nh * c8, nr = nj * c8;
  const uint4* qsrc = reinterpret_cast<const uint4*>(qb_g + (size_t)g0 * mla);
  // stage q and the rows, four 16-byte loads in flight per thread
  for (int e0 = tid; e0 < nq + nr; e0 += 4 * blockDim.x) {
    uint4 u[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * blockDim.x;
      if (e < nq)
        u[q] = __ldg(qsrc + e);
      else if (e < nq + nr)
        u[q] = __ldg(reinterpret_cast<const uint4*>(
                         cache + (size_t)(j0 + (e - nq) / c8) * stride) + (e - nq) % c8);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * blockDim.x;
      if (e < nq)
        reinterpret_cast<uint4*>(qb)[e] = u[q];
      else if (e < nq + nr)
        *reinterpret_cast<uint4*>(rows + ((e - nq) / c8) * rs + ((e - nq) % c8) * 8) = u[q];
    }
  }
  __syncthreads();

  // scores: a thread takes one (head, row); the warps of a head read its q
  // as a broadcast
  for (int it = tid; it < split * nh; it += blockDim.x) {
    const int j = it % split, h = it / split;
    if (j >= nj) continue;
    const __nv_bfloat16* row = rows + j * rs;
    const __nv_bfloat16* qh = qb + h * mla;
    float acc = 0.f;
    for (int c = 0; c < c8; ++c) {
      float f[8], q[8];
      unpack8(*reinterpret_cast<const uint4*>(row + c * 8), f);
      unpack8(*reinterpret_cast<const uint4*>(qh + c * 8), q);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(q[e], f[e], acc);
    }
    sc[h * split + j] = acc;
  }
  __syncthreads();

  // softmax statistics: warp w takes heads w, w+nw, ...
  for (int h = wid; h < nh; h += nw) {
    float mx = NEG_INF;
    for (int j = lane; j < nj; j += 32) mx = fmaxf(mx, sc[h * split + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nj; j += 32) {
      const float p = exp2f(sc[h * split + j] - mx);
      sum += p;
      sc[h * split + j] = bf16_round(p);   // the p.V dot takes bf16 p
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_ml[((size_t)s * heads + g0 + h) * 2] = mx;
      part_ml[((size_t)s * heads + g0 + h) * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // p.V over the first lora columns: a thread takes one column of all nh
  // heads
  for (int c = tid; c < lora; c += blockDim.x) {
    float acc[SPLIT_HEADS];
#pragma unroll
    for (int t = 0; t < SPLIT_HEADS; ++t) acc[t] = 0.f;
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      const float v = __bfloat162float(rows[j * rs + c]);
#pragma unroll
      for (int t = 0; t < SPLIT_HEADS; ++t)
        if (t < nh) acc[t] = fmaf(sc[t * split + j], v, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < SPLIT_HEADS; ++t)
      if (t < nh) part_acc[((size_t)s * heads + g0 + t) * lora + c] = acc[t];
  }
}

// Merge of head h = blockIdx.x: the ns split partials and the current token
// (f32 qs[h] . f32 cur), o = bf16(acc / l), then columns cb*nc .. of
// o_nope[h] = bf16(o @ wuv[h]) for cb = blockIdx.y (the expansion's weight
// reads spread over gridDim.y blocks per head, each merging o anew).  Block
// (0, 0) writes bf16(cur) to `row` (row_cols columns, zero past mla) and to
// ckv_new (mla columns) where they are given.
__global__ void __launch_bounds__(MLA_THREADS)
mla_merge_kernel(const float* __restrict__ proj, const float* __restrict__ qs,
                 const __nv_bfloat16* __restrict__ rms_ckv, const float* __restrict__ cos,
                 const float* __restrict__ sin, const float* __restrict__ part_ml,
                 const float* __restrict__ part_acc, const __nv_bfloat16* __restrict__ wuv,
                 __nv_bfloat16* __restrict__ o_nope, __nv_bfloat16* __restrict__ row,
                 int row_cols, __nv_bfloat16* __restrict__ ckv_new, int heads, int nope,
                 int rope, int lora, int ns, float eps) {
  extern __shared__ float sm[];
  __shared__ float red[HG_RED];
  __shared__ float red32[32];
  __shared__ float stat[2];
  const int mla = lora + rope;
  float* cur = sm;                       // [mla] current row, f32
  float* o = cur + mla;                  // [lora] bf16-rounded output
  const int h = blockIdx.x, tid = threadIdx.x;
  const float* ckv = proj + (size_t)heads * (nope + rope);
  const float* kpe = ckv + lora;
  const float* q = qs + (size_t)h * mla;
  float ss = 0.f;
  for (int c = tid; c < lora; c += blockDim.x) ss += ckv[c] * ckv[c];
  const float inv = rsqrtf(block_sum(ss, red32) / lora + eps);
  for (int c = tid; c < mla; c += blockDim.x)
    cur[c] = c < lora ? ckv[c] * inv * __bfloat162float(rms_ckv[c])
                      : rope_at(kpe, c - lora, rope, cos, sin, 1);
  __syncthreads();
  float part = 0.f;
  for (int c = tid; c < mla; c += blockDim.x) part += q[c] * cur[c];
  const float s_cur = block_sum(part, red32);
  if (tid == 0) {
    float mx = s_cur;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, part_ml[((size_t)s * heads + h) * 2]);
    float l = exp2f(s_cur - mx);
    for (int s = 0; s < ns; ++s) {
      const float* ml = part_ml + ((size_t)s * heads + h) * 2;
      l = fmaf(ml[1], exp2f(ml[0] - mx), l);
    }
    stat[0] = mx;
    stat[1] = l;
  }
  __syncthreads();
  const float mx = stat[0], l = stat[1], pc = exp2f(s_cur - mx);
  for (int c = tid; c < lora; c += blockDim.x) {
    float acc = pc * cur[c];
    for (int s = 0; s < ns; ++s) {
      const size_t idx = (size_t)s * heads + h;
      acc = fmaf(part_acc[idx * lora + c], exp2f(part_ml[idx * 2] - mx), acc);
    }
    o[c] = bf16_round(acc / l);
  }
  if (h == 0 && blockIdx.y == 0) {
    for (int c = tid; c < row_cols; c += blockDim.x) {
      const __nv_bfloat16 v = __float2bfloat16(c < mla ? cur[c] : 0.f);
      if (row) row[c] = v;
      if (ckv_new && c < mla) ckv_new[c] = v;
    }
  }
  __syncthreads();
  const int nc = nope / gridDim.y, c0 = blockIdx.y * nc;
  head_gemv_block(o, wuv + (size_t)h * lora * nope + c0, lora, nc, nope, 1.f, red, nullptr,
                  o_nope + (size_t)h * nope + c0);
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

struct MlaScratch {
  float *proj, *qs, *oacc, *part_ml, *part_acc;
  __nv_bfloat16 *xn, *qb, *o_nope;
  size_t floats;
};

MlaScratch mla_layout(float* base, int hidden, int heads, int nope, int rope, int lora,
                      int seq, int split) {
  const size_t n_proj = (size_t)heads * (nope + rope) + lora + rope;
  const size_t ns = seq > 0 ? (size_t)(seq + split - 1) / split : 0;
  size_t off = 0;
  MlaScratch s;
  auto take = [&](size_t n) {
    float* p = base ? base + off : nullptr;
    off += align16(n);
    return p;
  };
  s.proj = take(n_proj);
  s.qs = take((size_t)heads * (lora + rope));
  s.oacc = take(hidden);
  s.part_ml = take(ns * heads * 2);
  s.part_acc = take(ns * heads * lora);
  s.xn = reinterpret_cast<__nv_bfloat16*>(take((hidden + 1) / 2));
  s.qb = reinterpret_cast<__nv_bfloat16*>(take(((size_t)heads * (lora + rope) + 1) / 2));
  s.o_nope = reinterpret_cast<__nv_bfloat16*>(take(((size_t)heads * nope + 1) / 2));
  s.floats = off;
  return s;
}

}  // namespace

// Floats of f32 scratch `cf_mla_decode` needs for `seq` cached rows.
extern "C" long long cf_mla_scratch_floats(int hidden, int heads, int nope, int rope,
                                           int lora, int seq, int split) {
  return (long long)mla_layout(nullptr, hidden, heads, nope, rope, lora, seq, split).floats;
}

// One MLA decode layer on `stream`, reading cache rows < seq of layer
// `layer` (7 launches, 6 at seq 0).  append != 0: bf16(cur) is written to
// row seq of that layer (stride columns, zero past mla; seq < cap);
// ckv_new (bf16 [mla], or nullptr) receives the same row.  out is bf16
// [hidden].  *n_launches receives the number of kernels launched.  Returns
// a cudaError_t (0 on success).
extern "C" int cf_mla_decode(const void* x, const void* rms_in, const void* rms_ckv,
                             const void* cos, const void* sin, const void* wproj,
                             const void* wuk, const void* wuv, const void* wo, void* cache,
                             void* out, void* ckv_new, void* scratch, int hidden, int heads,
                             int nope, int rope, int lora, int cap, int stride, int seq,
                             int layer, int append, float eps, float softmax_scale,
                             int split, int threads, int* n_launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *n_launches = 0;
  const int mla = lora + rope;
  const int n_proj = heads * (nope + rope) + mla;
  if (heads < 1 || heads > MAX_HEADS || nope % 8 != 0 || lora % 8 != 0 || rope % 8 != 0 ||
      nope > HG_MAX_K || lora > HG_MAX_K || nope > 8 * MLA_THREADS || hidden % 8 != 0 ||
      stride < mla || stride % 8 != 0 || split < 4 || split > MAX_SPLIT || split % 4 != 0 ||
      seq < 0 || seq > cap || (append && seq >= cap) || layer < 0 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, num_sms = 0;
  CF_CHECK((int)cudaGetDevice(&dev));
  CF_CHECK((int)cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev));
  MlaScratch s = mla_layout(static_cast<float*>(scratch), hidden, heads, nope, rope, lora,
                            seq, split);
  const __nv_bfloat16* rin = static_cast<const __nv_bfloat16*>(rms_in) + (size_t)layer * hidden;
  const __nv_bfloat16* rckv = static_cast<const __nv_bfloat16*>(rms_ckv) + (size_t)layer * lora;
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(wproj) + (size_t)layer * hidden * n_proj;
  const __nv_bfloat16* wk = static_cast<const __nv_bfloat16*>(wuk) + (size_t)layer * heads * nope * lora;
  const __nv_bfloat16* wv = static_cast<const __nv_bfloat16*>(wuv) + (size_t)layer * heads * lora * nope;
  const __nv_bfloat16* wol = static_cast<const __nv_bfloat16*>(wo) + (size_t)layer * heads * nope * hidden;
  __nv_bfloat16* cl = static_cast<__nv_bfloat16*>(cache) + (size_t)layer * cap * stride;
  const float* cosf = static_cast<const float*>(cos);
  const float* sinf = static_cast<const float*>(sin);
  const float scale = softmax_scale * LOG2E;
  const int ns = (seq + split - 1) / split;

  resnorm_kernel<<<1, NORM_THREADS, 0, st>>>(
      nullptr, static_cast<const __nv_bfloat16*>(x), nullptr, nullptr, rin, nullptr, nullptr,
      s.xn, nullptr, nullptr, hidden, eps, s.proj, n_proj, s.oacc, hidden);
  CF_CHECK((int)cudaGetLastError());
  ++*n_launches;
  CF_CHECK((launch_rows_gemv_nb<1, false>(s.xn, 0, 0, wp, s.proj, 1, hidden, n_proj, 1, 0, 0,
                                          0, threads, num_sms, st)));
  ++*n_launches;
  const int nb = lora % 64 == 0 ? 64 : lora;
  mla_absorb_kernel<<<dim3(heads, lora / nb), MLA_THREADS, 0, st>>>(
      s.proj, wk, cosf, sinf, s.qs, s.qb, heads, nope, rope, lora, nb, scale);
  CF_CHECK((int)cudaGetLastError());
  ++*n_launches;
  if (ns > 0) {
    const size_t smem = sizeof(float) * (size_t)SPLIT_HEADS * split +
                        sizeof(__nv_bfloat16) * ((size_t)SPLIT_HEADS * mla +
                                                 (size_t)split * (mla + 8));
    static size_t smem_set = 48 * 1024;
    if (smem > smem_set) {
      CF_CHECK((int)cudaFuncSetAttribute(mla_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem));
      smem_set = smem;
    }
    const dim3 grid(ns, (heads + SPLIT_HEADS - 1) / SPLIT_HEADS);
    mla_split_kernel<<<grid, MLA_THREADS, smem, st>>>(s.qb, cl, stride, s.part_ml, s.part_acc,
                                                      heads, rope, lora, seq, split);
    CF_CHECK((int)cudaGetLastError());
    ++*n_launches;
  }
  const size_t merge_smem = sizeof(float) * (size_t)(mla + lora);
  const dim3 merge_grid(heads, nope % 32 == 0 ? nope / 32 : 1);
  mla_merge_kernel<<<merge_grid, MLA_THREADS, merge_smem, st>>>(
      s.proj, s.qs, rckv, cosf, sinf, s.part_ml, s.part_acc, wv, s.o_nope,
      append ? cl + (size_t)seq * stride : nullptr, append ? stride : mla,
      static_cast<__nv_bfloat16*>(ckv_new), heads, nope, rope, lora, ns, eps);
  CF_CHECK((int)cudaGetLastError());
  ++*n_launches;
  CF_CHECK((launch_rows_gemv_nb<1, false>(s.o_nope, 0, 0, wol, s.oacc, 1, heads * nope, hidden,
                                          1, 0, 0, 0, threads, num_sms, st)));
  ++*n_launches;
  to_bf16_kernel<<<(hidden + 255) / 256, 256, 0, st>>>(s.oacc, static_cast<__nv_bfloat16*>(out),
                                                       hidden);
  CF_CHECK((int)cudaGetLastError());
  ++*n_launches;
  return 0;
}
