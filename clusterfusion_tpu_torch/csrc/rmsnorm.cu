// Standalone batched RMSNorm and fused residual-add RMSNorm for Hopper
// (sm_90a).
//
// Replace the TPU kernels `rmsnorm` and `fused_add_rmsnorm`
// (clusterfusion_tpu/ops/rmsnorm.py, `_rmsnorm_kernel` and
// `_fused_add_rmsnorm_kernel`) for bf16 or float32 rows [rows, hidden]
// and a bf16 or float32 weight [hidden]:
//   rmsnorm            y = x * rsqrt(mean(x^2) + eps) * w
//   fused_add_rmsnorm  h = x + r (f32); h_out = h; y = rmsnorm(h) * w
// all in float32, each output rounded once to the input's type; the norm
// of the fused form is taken from the float32 h, not the rounded h_out.
//
// What bounds it: each element is read once and written once (twice for
// the fused form) with a handful of operations, so bytes bound it; at the
// tp step's one row of 4096 its time is that of a launch.  The TPU kernel
// maps row tiles over a grid with the row in VMEM; here one block takes
// one row and its threads hold the row in registers: each thread loads one
// or two 16-byte chunks of x, r and w, so x and r are read from device
// memory once for every row of up to 2048 chunks (hidden 8192 in float32,
// 16384 in bf16: every JAX preset; llama2_70b's 8192 is the widest), sums
// its squares, and after the block-wide sum writes h_out and y from its
// registers.  A wider row runs a two-pass loop in the same kernel (the
// second pass reads the row again, from L1/L2).  It launches with
// programmatic dependent launch: it waits for the kernels before it before
// its first read and lets the next kernel start after its last read, so its
// launch hides under the tail of a kernel before it that lets it start
// early (kernel 6, before kernel 2 on the tp step).

#include "common.cuh"

namespace {

constexpr int RMS_MAX_THREADS = 1024;
constexpr int RMS_ONE_CHUNK = 512;     // rows of at most this many chunks: one a thread

// E consecutive elements (16 bytes of the row's type) <-> floats.
template <int E>
__device__ __forceinline__ void load_n(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    f[4 * i] = v.x; f[4 * i + 1] = v.y; f[4 * i + 2] = v.z; f[4 * i + 3] = v.w;
  }
}

template <int E>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* f) {
  if constexpr (E == 8) {
    unpack8(*reinterpret_cast<const uint4*>(p), f);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(u.x << 16);
    f[1] = __uint_as_float(u.x & 0xffff0000u);
    f[2] = __uint_as_float(u.y << 16);
    f[3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

template <int E>
__device__ __forceinline__ void store_n(float* p, const float* f) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2],
                                                  f[4 * i + 3]);
}

template <int E>
__device__ __forceinline__ void store_n(__nv_bfloat16* p, const float* f) {
  static_assert(E == 8, "16 bytes of bf16");
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(f[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
}

// Row blockIdx.x: h = x (+ r); h_out = h when given; y = h * inv * w.  A
// thread holds chunks threadIdx.x + k * blockDim.x, k < C, of E elements
// (16 bytes of T); a row of more than C * blockDim.x chunks takes the
// two-pass loop.
template <typename T, typename W, int C>
__global__ void __launch_bounds__(RMS_MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const W* __restrict__ w, T* __restrict__ y, T* __restrict__ h_out,
               int hidden, float eps) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * hidden;
  const int nc = hidden / E;
  hopper::grid_dep_wait();
  float ss = 0.f;
  if (nc <= C * (int)blockDim.x) {
    float h[C][E], wf[C][E];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < nc) {
        load_n<E>(x + row + E * c, h[k]);
        if (r) {
          float b[E];
          load_n<E>(r + row + E * c, b);
#pragma unroll
          for (int i = 0; i < E; ++i) h[k][i] += b[i];
        }
        load_n<E>(w + E * c, wf[k]);
#pragma unroll
        for (int i = 0; i < E; ++i) ss = fmaf(h[k][i], h[k][i], ss);
      }
    }
    hopper::grid_dep_launch_dependents();         // every read is done
    const float inv = rsqrtf(block_sum(ss, red) / hidden + eps);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < nc) {
        if (h_out) store_n<E>(h_out + row + E * c, h[k]);
#pragma unroll
        for (int i = 0; i < E; ++i) h[k][i] = h[k][i] * inv * wf[k][i];
        store_n<E>(y + row + E * c, h[k]);
      }
    }
    return;
  }
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    float h[E];
    load_n<E>(x + row + E * c, h);
    if (r) {
      float b[E];
      load_n<E>(r + row + E * c, b);
#pragma unroll
      for (int i = 0; i < E; ++i) h[i] += b[i];
      if (h_out) store_n<E>(h_out + row + E * c, h);
    }
#pragma unroll
    for (int i = 0; i < E; ++i) ss = fmaf(h[i], h[i], ss);
  }
  const float inv = rsqrtf(block_sum(ss, red) / hidden + eps);
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    float h[E], wf[E];
    load_n<E>(x + row + E * c, h);
    if (r) {
      float b[E];
      load_n<E>(r + row + E * c, b);
#pragma unroll
      for (int i = 0; i < E; ++i) h[i] += b[i];
    }
    load_n<E>(w + E * c, wf);
#pragma unroll
    for (int i = 0; i < E; ++i) h[i] = h[i] * inv * wf[i];
    store_n<E>(y + row + E * c, h);
  }
  hopper::grid_dep_launch_dependents();
}

// One chunk a thread up to RMS_ONE_CHUNK chunks, two up to 2048 (1024
// threads), the two-pass loop at 1024 threads beyond.
template <typename T, typename W>
int launch_rmsnorm(const void* x, const void* r, const void* w, void* y, void* h_out,
                   int rows, int hidden, float eps, cudaStream_t st) {
  const int nc = hidden / (16 / (int)sizeof(T));
  const bool one = nc <= RMS_ONE_CHUNK;
  int threads = ((one ? nc : (nc + 1) / 2) + 31) / 32 * 32;
  if (threads > RMS_MAX_THREADS) threads = RMS_MAX_THREADS;
  return launch_kernel(one ? rmsnorm_kernel<T, W, 1> : rmsnorm_kernel<T, W, 2>, dim3(rows),
                       dim3(threads), 0, st, true, static_cast<const T*>(x),
                       static_cast<const T*>(r), static_cast<const W*>(w),
                       static_cast<T*>(y), static_cast<T*>(h_out), hidden, eps);
}

}  // namespace

// RMSNorm of `rows` rows of `hidden` on `stream`: x, r (nullptr: plain
// rmsnorm), y and h_out (the fused form's h) are [rows, hidden], float32
// when x_f32 else bf16; w [hidden] is float32 when w_f32 else bf16.
// Returns a cudaError_t (0 on success).
extern "C" int cf_rmsnorm(const void* x, const void* r, const void* w, void* y,
                          void* h_out, int rows, int hidden, int x_f32, int w_f32,
                          float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || hidden < 8 || hidden % 8 != 0 || (r != nullptr) != (h_out != nullptr))
    return (int)cudaErrorInvalidValue;
  if (x_f32)
    return w_f32 ? launch_rmsnorm<float, float>(x, r, w, y, h_out, rows, hidden, eps, st)
                 : launch_rmsnorm<float, __nv_bfloat16>(x, r, w, y, h_out, rows, hidden,
                                                        eps, st);
  return w_f32 ? launch_rmsnorm<__nv_bfloat16, float>(x, r, w, y, h_out, rows, hidden, eps,
                                                      st)
               : launch_rmsnorm<__nv_bfloat16, __nv_bfloat16>(x, r, w, y, h_out, rows,
                                                              hidden, eps, st);
}
