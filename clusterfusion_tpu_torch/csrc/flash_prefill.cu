// Causal GQA flash-attention prefill for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_prefill_attention`
// (clusterfusion_tpu/ops/flash_prefill.py, `_flash_prefill_kernel`), with
// the same layouts: q [kv_heads, T, group, hd], k/v [kv_heads, S, hd] and
// out [kv_heads, T, group, hd], all bf16.  Query i sits at absolute
// position q_offset + i and attends keys 0 .. q_offset + i; keys past
// q_offset + T - 1 are never read.
//
// What bounds it: at prefill lengths the work is O(T^2 hd) operations on
// O(T hd) bytes, so it is bound by operations.  This first version runs
// them as float32 FMAs out of shared memory (no tensor cores), so it sits
// far under the bf16 tensor-core peak; a wgmma/TMA version is later work.
//
// Design:
// - One block per (kv head, tile of BR panel rows).  The panel of a kv head
//   is q[h] seen as [T*group, hd]: row r is query r / group, so a tile's
//   rows all read the same K/V, which is streamed once per kv head and
//   tile, as in the TPU kernel's GQA panel.
// - The TPU kernel's sequential key-block grid axis becomes a loop over
//   key tiles of BK rows, up to the tile's last diagonal key.  Tiles above
//   the diagonal are neither loaded nor computed; the diagonal tile is
//   masked elementwise.
// - Online softmax in the exp2 domain with 1/sqrt(hd)*log2(e) folded into
//   q once; m, l and the accumulator stay float32 in registers.
// - 256 threads as a 16x16 grid: thread (ty, tx) owns panel rows
//   ty + 16i, key columns tx + 16j and output dims tx + 16j, so a row's
//   softmax statistics live in one half-warp and reduce with shuffles.
//   Shared rows are padded by one float to keep the column walks free of
//   bank conflicts.  The K tile and then the V tile share one buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <int HD, int BR>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BR * (HD + 1) + (size_t)BK * (HD + 1) +
                          (size_t)BR * (BK + 1));
}

template <int HD, int BR>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int T, int group, int S,
                     int q_offset, float qscale) {
  constexpr int RPT = BR / 16;  // panel rows per thread
  constexpr int CPT = BK / 16;  // key columns per thread
  constexpr int DPT = HD / 16;  // output dims per thread
  constexpr int LD = HD + 1;
  constexpr int LP = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;             // [BR][LD]  pre-scaled q
  float* kvs = qs + BR * LD;    // [BK][LD]  K tile, then V tile
  float* ps = kvs + BK * LD;    // [BR][LP]  probabilities

  const int h = blockIdx.y;
  const int rows = T * group;
  const int r0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const __nv_bfloat16* qh = q + (size_t)h * rows * HD;
  const __nv_bfloat16* kh = k + (size_t)h * S * HD;
  const __nv_bfloat16* vh = v + (size_t)h * S * HD;

  for (int e = tid; e < BR * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    float x = 0.f;
    if (r0 + r < rows) x = __bfloat162float(qh[(size_t)(r0 + r) * HD + d]) * qscale;
    qs[r * LD + d] = x;
  }

  int qpos[RPT];
  bool rvalid[RPT];
  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + 16 * i;
    rvalid[i] = r < rows;
    qpos[i] = q_offset + r / group;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }
  const int last_row = min(r0 + BR, rows) - 1;
  const int kmax = q_offset + last_row / group;  // last key any row needs
  const int n_kt = kmax / BK + 1;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int kb0 = kt * BK;
    __syncthreads();  // previous V tile fully consumed (and q tile stored)
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int c = e / HD, d = e % HD;
      const int key = kb0 + c;
      kvs[c * LD + d] = key <= kmax ? __bfloat162float(kh[(size_t)key * HD + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = kvs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int key = kb0 + tx + 16 * j;
        if (!(rvalid[i] && key <= qpos[i])) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = s[i][j] <= NEG_INF ? 0.f : exp2f(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // scores done with K; probabilities stored

    for (int e = tid; e < BK * HD; e += THREADS) {
      const int c = e / HD, d = e % HD;
      const int key = kb0 + c;
      kvs[c * LD + d] = key <= kmax ? __bfloat162float(vh[(size_t)key * HD + d]) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = kvs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!rvalid[i]) continue;
    const float inv = 1.f / l[i];
    __nv_bfloat16* orow = o + ((size_t)h * rows + r0 + ty + 16 * i) * HD;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[tx + 16 * j] = __float2bfloat16(acc[i][j] * inv);
  }
}

template <int HD, int BR>
int launch(const void* q, const void* k, const void* v, void* o, int kv_heads,
           int T, int group, int S, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BR>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<HD, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = T * group;
  dim3 grid((rows + BR - 1) / BR, kv_heads);
  const float qscale = 1.4426950408889634f / sqrtf((float)HD);
  flash_prefill_kernel<HD, BR><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T,
      group, S, q_offset, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success).  block_rows: 32 or 64 panel rows
// per block; head_dim: 64 or 128.
extern "C" int cf_flash_prefill(const void* q, const void* k, const void* v,
                                void* o, int kv_heads, int T, int group, int S,
                                int head_dim, int q_offset, int block_rows,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0) return 0;
  if (head_dim == 128 && block_rows == 64)
    return launch<128, 64>(q, k, v, o, kv_heads, T, group, S, q_offset, st);
  if (head_dim == 128 && block_rows == 32)
    return launch<128, 32>(q, k, v, o, kv_heads, T, group, S, q_offset, st);
  if (head_dim == 64 && block_rows == 64)
    return launch<64, 64>(q, k, v, o, kv_heads, T, group, S, q_offset, st);
  if (head_dim == 64 && block_rows == 32)
    return launch<64, 32>(q, k, v, o, kv_heads, T, group, S, q_offset, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
