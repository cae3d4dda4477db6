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
// The GEMV: each warp covers 256 adjacent columns (8 per lane, one 16-byte
// load per weight row), the warps of a block split its K range, and blocks
// split K further until the grid holds about two blocks per SM; partial
// sums meet by atomicAdd in an output the preceding kernel zeroed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;
constexpr int COLS = 256;       // GEMV columns per block (8 per lane)
constexpr int ATT_THREADS = 128;
constexpr int NORM_THREADS = 1024;
constexpr int MAX_GROUP = 8;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Sum over the block; every thread gets the result.  `red` holds 32 floats.
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int nw = (blockDim.x + 31) / 32;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) red[wid] = x;
  __syncthreads();
  float t = lane < nw ? red[lane] : 0.f;
  return warp_sum(t);
}

// Rope of element d of a head row held in shared memory.
__device__ __forceinline__ float rope_at(const float* x, int d, int hd,
                                         const float* cos, const float* sin,
                                         int neox) {
  int p;
  float sgn;
  if (neox) {
    p = (d + hd / 2) % hd;
    sgn = d < hd / 2 ? -1.f : 1.f;
  } else {
    p = d ^ 1;
    sgn = (d & 1) ? 1.f : -1.f;
  }
  return x[d] * cos[d] + sgn * x[p] * sin[d];
}

// r = a + b (a from a_bf16 when given, b optional); r_out = r;
// xn = bf16(r * rsqrt(mean(r^2) + eps) * w) when w is given;
// x_out = bf16(a), res_out = bf16(b) when given; zero z1[n1] and z2[n2].
__global__ void __launch_bounds__(NORM_THREADS)
resnorm_kernel(const float* a, const __nv_bfloat16* a_bf16, const float* b,
               const __nv_bfloat16* w, float* r_out, __nv_bfloat16* xn,
               __nv_bfloat16* x_out, __nv_bfloat16* res_out, int hidden,
               float eps, float* z1, int n1, float* z2, int n2) {
  __shared__ float red[32];
  float ss = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float av = a_bf16 ? __bfloat162float(a_bf16[i]) : a[i];
    const float r = av + (b ? b[i] : 0.f);
    ss += r * r;
    if (r_out) r_out[i] = r;
    if (x_out) x_out[i] = __float2bfloat16(av);
    if (res_out) res_out[i] = __float2bfloat16(b ? b[i] : 0.f);
  }
  const float inv = rsqrtf(block_sum(ss, red) / hidden + eps);
  if (w) {
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float av = a_bf16 ? __bfloat162float(a_bf16[i]) : a[i];
      const float r = av + (b ? b[i] : 0.f);
      xn[i] = __float2bfloat16(r * inv * __bfloat162float(w[i]));
    }
  }
  for (int i = threadIdx.x; i < n1; i += blockDim.x) z1[i] = 0.f;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) z2[i] = 0.f;
}

// y[b*ys + n] += sum_{k in this block's chunk} x_b[k] * W[b*ws + k*N + n].
// SWIGLU: x_b[k] = bf16(silu(gu[k]) * gu[f_off + k]) from f32 gate/up.
template <bool SWIGLU>
__global__ void gemv_kernel(const void* __restrict__ xv,
                            const __nv_bfloat16* __restrict__ w,
                            float* __restrict__ y, int K, int N, int k_chunk,
                            long long xs, long long ws, long long ys, int f_off) {
  extern __shared__ float sm[];
  const int nw = blockDim.x / 32;
  float* xsm = sm;               // [k_chunk]
  float* red = sm + k_chunk;     // [nw][COLS]
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int bz = blockIdx.z;
  const int k0 = blockIdx.y * k_chunk;
  const int k1 = min(K, k0 + k_chunk);
  for (int i = threadIdx.x; i < k1 - k0; i += blockDim.x) {
    const int kk = k0 + i;
    float x;
    if (SWIGLU) {
      const float* gu = static_cast<const float*>(xv) + bz * xs;
      const float g = gu[kk], u = gu[f_off + kk];
      x = bf16_round(g / (1.f + expf(-g)) * u);
    } else {
      x = __bfloat162float(static_cast<const __nv_bfloat16*>(xv)[bz * xs + kk]);
    }
    xsm[i] = x;
  }
  __syncthreads();

  const int n0 = blockIdx.x * COLS + lane * 8;
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  if (n0 < N) {
    const __nv_bfloat16* wp = w + bz * ws + n0;
    int k = k0 + wid;
    for (; k + 3 * nw < k1; k += 4 * nw) {
      uint4 u[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        u[r] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(k + r * nw) * N));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float f[8];
        unpack8(u[r], f);
        const float xk = xsm[k + r * nw - k0];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] = fmaf(xk, f[c], acc[c]);
      }
    }
    for (; k < k1; k += nw) {
      float f[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(wp + (size_t)k * N)), f);
      const float xk = xsm[k - k0];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(xk, f[c], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) red[wid * COLS + lane * 8 + c] = acc[c];
  __syncthreads();
  for (int t = threadIdx.x; t < COLS; t += blockDim.x) {
    const int n = blockIdx.x * COLS + t;
    if (n >= N) continue;
    float s = 0.f;
    for (int r = 0; r < nw; ++r) s += red[r * COLS + t];
    atomicAdd(&y[bz * ys + n], s);
  }
}

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

struct Gemv {
  int threads;
  int num_sms;
};

template <bool SWIGLU>
int launch_gemv(const Gemv& g, const void* x, const __nv_bfloat16* w, float* y,
                int K, int N, int batch, long long xs, long long ws,
                long long ys, int f_off, cudaStream_t st) {
  const int nw = g.threads / 32;
  const int tiles = (N + COLS - 1) / COLS;
  int ks = (2 * g.num_sms + tiles * batch - 1) / (tiles * batch);
  const int max_ks = K / (4 * nw) > 0 ? K / (4 * nw) : 1;  // >= 4 rows per warp
  if (ks > max_ks) ks = max_ks;
  const int min_ks = (K + 8191) / 8192;                    // x chunk <= 32 KB
  if (ks < min_ks) ks = min_ks;
  if (ks < 1) ks = 1;
  const int k_chunk = (K + ks - 1) / ks;
  ks = (K + k_chunk - 1) / k_chunk;
  const size_t smem = sizeof(float) * ((size_t)k_chunk + (size_t)nw * COLS);
  dim3 grid(tiles, ks, batch);
  gemv_kernel<SWIGLU><<<grid, g.threads, smem, st>>>(x, w, y, K, N, k_chunk,
                                                     xs, ws, ys, f_off);
  return (int)cudaGetLastError();
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

#define CF_CHECK(expr)             \
  do {                             \
    int _e = (expr);               \
    if (_e != 0) return _e;        \
  } while (0)

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
    const int big = 96 * 1024;
    CF_CHECK((int)cudaFuncSetAttribute(gemv_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, big));
    CF_CHECK((int)cudaFuncSetAttribute(gemv_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, big));
    CF_CHECK((int)cudaFuncSetAttribute(attn_split_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, big));
    attrs_set = true;
  }
  const Gemv gv{threads, num_sms};
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
        l == 0 ? nullptr : s.res_a, an, s.res_b, s.xn, nullptr, nullptr, hidden,
        eps, s.qkv, qkv_n, s.aout, hidden);
    CF_CHECK((int)cudaGetLastError());
    ++n;
    CF_CHECK(launch_gemv<false>(gv, s.xn, wq, s.qkv, hidden, (int)C, G, 0,
                                (long long)hidden * C, C, 0, st));
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
    CF_CHECK(launch_gemv<false>(gv, s.o, wol, s.aout, (int)Ko, hidden, G, Ko,
                                Ko * hidden, 0, 0, st));
    ++n;
    // attention-out residual add + FFN RMSNorm; zero the gate/up and down sums
    resnorm_kernel<<<1, NORM_THREADS, 0, st>>>(
        s.aout, nullptr, s.res_b, fn, s.res_a, s.xn, nullptr, nullptr, hidden,
        eps, s.gu, 2 * f_pad, s.hx, hidden);
    CF_CHECK((int)cudaGetLastError());
    ++n;
    CF_CHECK(launch_gemv<false>(gv, s.xn, w13l, s.gu, hidden, f_pad, 2, 0,
                                (long long)hidden * f_pad, f_pad, 0, st));
    ++n;
    CF_CHECK(launch_gemv<true>(gv, s.gu, w2l, s.hx, f_pad, hidden, 1, 0, 0, 0,
                               f_pad, st));
    ++n;
  }

  if (lm_head) {
    resnorm_kernel<<<1, NORM_THREADS, 0, st>>>(
        s.hx, nullptr, s.res_a, static_cast<const __nv_bfloat16*>(final_norm),
        nullptr, s.xn, nullptr, static_cast<__nv_bfloat16*>(out_res), hidden,
        eps, static_cast<float*>(logits), vocab, nullptr, 0);
    CF_CHECK((int)cudaGetLastError());
    ++n;
    CF_CHECK(launch_gemv<false>(gv, s.xn, static_cast<const __nv_bfloat16*>(lm_head),
                                static_cast<float*>(logits), hidden, vocab, 1, 0,
                                0, 0, 0, st));
    ++n;
  } else {
    resnorm_kernel<<<1, NORM_THREADS, 0, st>>>(
        s.hx, nullptr, s.res_a, nullptr, nullptr, nullptr,
        static_cast<__nv_bfloat16*>(out_x), static_cast<__nv_bfloat16*>(out_res),
        hidden, eps, nullptr, 0, nullptr, 0);
    CF_CHECK((int)cudaGetLastError());
    ++n;
  }
  *n_launches = n;
  return 0;
}
