// Device helpers shared by the port's kernels (stack_kernel.cu,
// stack_verify.cu, paged_attention.cu, paged_decoder_layer.cu,
// fused_ffn.cu, mla_decode.cu), among them the decode GEMV of the stacks,
// the paged layer, the fused FFN and the MLA layer.  Everything sits in an
// unnamed namespace: each translation unit gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight bf16 values packed in 16 bytes -> eight floats.
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

// Rope of element d of a head row x (full-dim cos/sin tables of the row's
// position): neox rotates halves, gptj interleaved pairs.
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

}  // namespace

#define CF_CHECK(expr)             \
  do {                             \
    int _e = (expr);               \
    if (_e != 0) return _e;        \
  } while (0)

namespace {

constexpr int NORM_THREADS = 1024;

// Residual add + RMSNorm of row blockIdx.x (every row pointer is offset by
// row*hidden, z1 and z2 by row*n1 and row*n2): r = a + b, with a from `a`
// (f32) or `a_bf16`, b from `b` (f32) or `b_bf16` or 0; r_out = r and
// r_bf16 = bf16(r) when given; xn = bf16(r * rsqrt(mean(r^2) + eps) * w)
// when w is given; x_out = bf16(a), res_out = bf16(b) when given; zero
// z1[n1] and z2[n2].
__global__ void __launch_bounds__(NORM_THREADS)
resnorm_kernel(const float* a, const __nv_bfloat16* a_bf16, const float* b,
               const __nv_bfloat16* b_bf16, const __nv_bfloat16* w, float* r_out,
               __nv_bfloat16* r_bf16, __nv_bfloat16* xn, __nv_bfloat16* x_out,
               __nv_bfloat16* res_out, int hidden, float eps, float* z1, int n1,
               float* z2, int n2) {
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * hidden;
  auto a_at = [&](int i) {
    return a_bf16 ? __bfloat162float(a_bf16[row + i]) : a[row + i];
  };
  auto b_at = [&](int i) {
    return b_bf16 ? __bfloat162float(b_bf16[row + i]) : (b ? b[row + i] : 0.f);
  };
  float ss = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float av = a_at(i), bv = b_at(i), r = av + bv;
    ss += r * r;
    if (r_out) r_out[row + i] = r;
    if (r_bf16) r_bf16[row + i] = __float2bfloat16(r);
    if (x_out) x_out[row + i] = __float2bfloat16(av);
    if (res_out) res_out[row + i] = __float2bfloat16(bv);
  }
  const float inv = rsqrtf(block_sum(ss, red) / hidden + eps);
  if (w) {
    for (int i = threadIdx.x; i < hidden; i += blockDim.x)
      xn[row + i] = __float2bfloat16((a_at(i) + b_at(i)) * inv * __bfloat162float(w[i]));
  }
  for (int i = threadIdx.x; i < n1; i += blockDim.x) z1[(size_t)blockIdx.x * n1 + i] = 0.f;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) z2[(size_t)blockIdx.x * n2 + i] = 0.f;
}

// out[i] = bf16(a[i]) for i < n (the f32 sums of a GEMV into its bf16 output).
__global__ void to_bf16_kernel(const float* a, __nv_bfloat16* out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(a[i]);
}

// ---- The decode GEMV: M <= 8 rows of x against a bf16 [K, N] matrix ----
//
// y[r*y_row + mat*yz + n] += sum_{k in this block's K chunk} x[r, k] * W[k, n]
// for the NB batch rows r0.. of blockIdx.z's row chunk and the matrix
// mat = blockIdx.z / nrc, W = w + mat*ws.  x row r starts at xv + r*x_row:
// bf16, or (SWIGLU) the float32 gate/up row, x[r, k] = bf16(silu(gate[k]) *
// up[k]) with up at f_off past gate.  At 1-8 rows the product does 2*NB
// operations per weight byte, so it is bound by bytes: each warp covers 256
// adjacent columns (8 per lane, one 16-byte load per weight row) for all NB
// rows at once, so a weight byte is read once per NB rows, and issues the
// loads of its next four weight rows before the arithmetic on the current
// four (left to itself the compiler let a load wait on the one before).
// The warps of a block split its K chunk and meet in shared memory; blocks
// split K until the grid holds about two blocks per SM, never more than fit
// at once, and meet by atomicAdd in an output the caller zeroed.
constexpr int GEMV_COLS = 256;
constexpr int GEMV_X_FLOATS = 8192;   // x chunks in shared memory <= 32 KB

template <int NB, bool SWIGLU>
__global__ void rows_gemv_kernel(const void* __restrict__ xv, long long x_row,
                                 int f_off, const __nv_bfloat16* __restrict__ w,
                                 float* __restrict__ y, int M, int K, int N,
                                 int k_chunk, int nrc, long long ws,
                                 long long y_row, long long yz) {
  extern __shared__ float sm[];
  const int nw = blockDim.x / 32;
  float* xsm = sm;                  // [NB][k_chunk]
  float* red = sm + NB * k_chunk;   // [nw][GEMV_COLS]
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int mat = blockIdx.z / nrc, r0 = (blockIdx.z % nrc) * NB;
  const int nr = min(NB, M - r0);
  const int k0 = blockIdx.y * k_chunk, k1 = min(K, k0 + k_chunk), kn = k1 - k0;
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    float* xs = xsm + r * k_chunk;
    if (r >= nr) {                      // rows past M read as 0
      for (int i = threadIdx.x; i < kn; i += blockDim.x) xs[i] = 0.f;
    } else if (SWIGLU) {
      const float* gu = static_cast<const float*>(xv) + (size_t)(r0 + r) * x_row + k0;
      for (int i = threadIdx.x; i < kn; i += blockDim.x) {
        const float g = gu[i], u = gu[f_off + i];
        xs[i] = bf16_round(g / (1.f + expf(-g)) * u);
      }
    } else {
      const __nv_bfloat16* xb =
          static_cast<const __nv_bfloat16*>(xv) + (size_t)(r0 + r) * x_row + k0;
      for (int i = threadIdx.x; i < kn; i += blockDim.x) xs[i] = __bfloat162float(xb[i]);
    }
  }
  __syncthreads();

  const int n0 = blockIdx.x * GEMV_COLS + lane * 8;
  float acc[NB][8];
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  if (n0 < N) {
    const __nv_bfloat16* wp = w + (size_t)mat * ws + n0;
    auto row = [&](const uint4& u, int k) {
      float f[8];
      unpack8(u, f);
      const float* xk = xsm + (k - k0);
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        const float xk_r = xk[r * k_chunk];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xk_r, f[c], acc[r][c]);
      }
    };
    int k = k0 + wid;
    uint4 u[4];
    if (k + 3 * nw < k1) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        u[q] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(k + q * nw) * N));
    }
    for (; k + 3 * nw < k1; k += 4 * nw) {
      uint4 cur[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[q] = u[q];
      const int k_next = k + 4 * nw;
      if (k_next + 3 * nw < k1) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          u[q] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(k_next + q * nw) * N));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) row(cur[q], k + q * nw);
    }
    for (; k < k1; k += nw) row(__ldg(reinterpret_cast<const uint4*>(wp + (size_t)k * N)), k);
  }
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (r < nr) {                       // uniform over the block
#pragma unroll
      for (int c = 0; c < 8; ++c) red[wid * GEMV_COLS + lane * 8 + c] = acc[r][c];
      __syncthreads();
      for (int t = threadIdx.x; t < GEMV_COLS; t += blockDim.x) {
        const int n = blockIdx.x * GEMV_COLS + t;
        if (n >= N) continue;
        float s = 0.f;
        for (int q = 0; q < nw; ++q) s += red[q * GEMV_COLS + t];
        atomicAdd(&y[(size_t)(r0 + r) * y_row + (size_t)mat * yz + n], s);
      }
      __syncthreads();
    }
  }
}

// Launch rows_gemv_kernel<NB, SWIGLU> over M rows (chunks of NB) and nmat
// matrices with `threads` per block.  Returns a cudaError_t.
template <int NB, bool SWIGLU>
int launch_rows_gemv_nb(const void* x, long long x_row, int f_off,
                        const __nv_bfloat16* w, float* y, int M, int K, int N,
                        int nmat, long long ws, long long y_row, long long yz,
                        int threads, int num_sms, cudaStream_t st) {
  const int nw = threads / 32;
  // blocks per SM that fit with the largest x chunk, once per block size
  const size_t smem_max = sizeof(float) * ((size_t)GEMV_X_FLOATS + (size_t)nw * GEMV_COLS);
  static int occ_threads = 0, occ = 1;
  if (occ_threads != threads) {
    if (smem_max > 48 * 1024)
      CF_CHECK((int)cudaFuncSetAttribute(rows_gemv_kernel<NB, SWIGLU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_max));
    CF_CHECK((int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, rows_gemv_kernel<NB, SWIGLU>, threads, smem_max));
    occ_threads = threads;
  }
  const int tiles = (N + GEMV_COLS - 1) / GEMV_COLS;
  const int nrc = (M + NB - 1) / NB;
  const int z = nmat * nrc;
  int ks = (2 * num_sms + tiles * z - 1) / (tiles * z);   // ~2 blocks per SM
  // but within one wave: a few blocks left over for a second wave would
  // take as long as the first
  const int one_wave = occ * num_sms / (tiles * z);
  if (ks > one_wave && one_wave >= 1) ks = one_wave;
  const int max_ks = K / (4 * nw) > 0 ? K / (4 * nw) : 1;  // >= 4 rows per warp
  if (ks > max_ks) ks = max_ks;
  const int max_chunk = GEMV_X_FLOATS / NB;
  const int min_ks = (K + max_chunk - 1) / max_chunk;
  if (ks < min_ks) ks = min_ks;
  if (ks < 1) ks = 1;
  const int k_chunk = (K + ks - 1) / ks;
  ks = (K + k_chunk - 1) / k_chunk;
  const size_t smem = sizeof(float) * ((size_t)NB * k_chunk + (size_t)nw * GEMV_COLS);
  rows_gemv_kernel<NB, SWIGLU><<<dim3(tiles, ks, z), threads, smem, st>>>(
      x, x_row, f_off, w, y, M, K, N, k_chunk, nrc, ws, y_row, yz);
  return (int)cudaGetLastError();
}

// The same for any M: rows in chunks of 1, 2, 4 or 8.
template <bool SWIGLU>
int launch_rows_gemv(const void* x, long long x_row, int f_off,
                     const __nv_bfloat16* w, float* y, int M, int K, int N,
                     int nmat, long long ws, long long y_row, long long yz,
                     int threads, int num_sms, cudaStream_t st) {
  if (M == 1)
    return launch_rows_gemv_nb<1, SWIGLU>(x, x_row, f_off, w, y, M, K, N, nmat, ws,
                                          y_row, yz, threads, num_sms, st);
  if (M == 2)
    return launch_rows_gemv_nb<2, SWIGLU>(x, x_row, f_off, w, y, M, K, N, nmat, ws,
                                          y_row, yz, threads, num_sms, st);
  if (M <= 4)
    return launch_rows_gemv_nb<4, SWIGLU>(x, x_row, f_off, w, y, M, K, N, nmat, ws,
                                          y_row, yz, threads, num_sms, st);
  return launch_rows_gemv_nb<8, SWIGLU>(x, x_row, f_off, w, y, M, K, N, nmat, ws,
                                        y_row, yz, threads, num_sms, st);
}

}  // namespace
