// Device helpers shared by the port's kernels (stack_kernel.cu,
// stack_verify.cu, paged_attention.cu, paged_decoder_layer.cu,
// fused_ffn.cu, mla_decode.cu, decoder_layer.cu, gemv.cu): the ring GEMV
// (the bs=1 stack, the verify stack, the standalone gemv, the paged layer
// and the MLA layer), the split-KV attention of the bs=1 stack, and the
// pieces of the one-launch layer halves (the single decoder layer and the
// fused FFN: a ring of weight tiles, a tile's product and the ordered
// fold across blocks).  Everything sits in an unnamed namespace: each
// translation unit gets its own copy.

#pragma once

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// Launch `kernel` on `st`, with programmatic dependent launch when `pdl`:
// the kernel may then start while the one before it on the stream still
// runs, so it must call hopper::grid_dep_wait() before it reads or writes
// anything that kernel (or any before it) touches.  Returns a cudaError_t.
template <typename... Params, typename... Args>
int launch_kernel(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                  cudaStream_t st, bool pdl, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The same in thread-block clusters of `cluster_y` blocks along y (the
// cluster attribute is set even for 1, so cooperative_groups' cluster
// calls work in every launch).
template <typename... Params, typename... Args>
int launch_kernel_cluster(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                          cudaStream_t st, bool pdl, int cluster_y, Args... args) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster_y;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

constexpr int NORM_THREADS = 1024;

// Residual add + RMSNorm of row blockIdx.x (every row pointer is offset by
// row*hidden, z1 and z2 by row*n1 and row*n2): r = a + b, with a from `a`
// (f32) or `a_bf16`, b from `b` (f32) or `b_bf16` or 0; r_out = r and
// r_bf16 = bf16(r) when given; xn = bf16(r * rsqrt(mean(r^2) + eps) * w)
// when w is given; x_out = bf16(a), res_out = bf16(b) when given; zero
// z1[n1] and z2[n2].  With programmatic dependent launch it waits for the
// kernels before it first, and it lets the kernel after it start at once
// (the ring GEMV streams its weights while this kernel runs and reads xn
// only after it has completed).
__global__ void __launch_bounds__(NORM_THREADS)
resnorm_kernel(const float* a, const __nv_bfloat16* a_bf16, const float* b,
               const __nv_bfloat16* b_bf16, const __nv_bfloat16* w, float* r_out,
               __nv_bfloat16* r_bf16, __nv_bfloat16* xn, __nv_bfloat16* x_out,
               __nv_bfloat16* res_out, int hidden, float eps, float* z1, int n1,
               float* z2, int n2) {
  hopper::grid_dep_launch_dependents();
  hopper::grid_dep_wait();
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

// ---- The ring GEMV: rows of x against a bf16 [K, N] matrix, fixed order ----
//
// y[r*y_row + mat*yz + n] = sum_k x[r, k] * W[k, n] for the rows r0.. of
// blockIdx.z's row chunk and the matrix mat = blockIdx.z / nrc, W = w +
// mat*ws a bf16 [K, N] matrix (row-major, N a multiple of 8).  x row r
// starts at xv + r*x_row: bf16, or (SWIGLU) the float32 gate/up row,
// x[r, k] = bf16(silu(gate[k]) * up[k]) with up at f_off past gate, or
// (one row, nw given) the RMSNorm of the bf16 row, x[k] = bf16(x[k] *
// rsqrt(mean(x^2) + eps) * nw[k]), each block summing the whole row's
// squares itself.  y is float32, or bf16(y) goes to yb instead when yb is
// given.  The bs=1
// stack and the standalone gemv run it at one row, the verify stack and
// the paged layer at up to 16 rows a block, the MLA layer at one.  Bound by bytes, so the design keeps as many
// weight bytes in flight as the SMs' shared memory holds:
// - Weights through shared memory.  A block owns one 256-column tile
//   (blockIdx.y) and one K chunk (blockIdx.x).  Its producer warp streams
//   the chunk's rows of the tile, 32 rows (16 KB) per stage, through a ring
//   of G1_STAGES stages (MMA: G1_MMA_STAGES; both measured best on the
//   H100, scripts/tune_torch_gemv.py) behind `full`/`empty` mbarriers, one
//   1-D bulk copy (cp.async.bulk) per 512-byte row segment, one row per
//   lane (MMA: rows sit 528 bytes apart, so the eight rows an ldmatrix
//   reads fall in distinct banks).  x is staged once per block in shared
//   memory: one row as float32 [k], MMA as bf16 [rows][k] (its values are
//   bf16 already, so nothing rounds).
// - One row (MMA false): the consumer warps (`threads` of them, 32 each)
//   take the rows of a stage in turn, each lane 8 adjacent columns of a
//   weight row (one 16-byte shared load), in float32 FMAs; the block sums
//   its warps in order.
// - Up to 16 rows (MMA): eight consumer warps each own 32 columns of the
//   tile and run mma.sync m16n8k16 (bf16 in, float32 sums) over the
//   stage's k rows: x rows as A (rows past M are 0), weight rows as B
//   through ldmatrix.trans.  The weights are read once for all the rows,
//   and the products cost the SMs next to nothing.
// - The K chunks of a tile meet inside a thread-block cluster.  The ks
//   blocks of a tile form one cluster (cluster rank = blockIdx.x).  Each
//   block leaves its [rows][256] f32 sums in its own shared memory; after a
//   cluster barrier rank r adds its share of those sums over ranks
//   0..ks-1, in that order, through distributed shared memory and writes
//   y; a second cluster barrier keeps every block's shared memory alive
//   until its peers have read it.  The sum's order is fixed, so y's bits do
//   not depend on the order in which blocks run, and there is no global
//   scratch, fence or counter; y is written, not added to.
// - Programmatic dependent launch.  The producer issues its first stages,
//   then every thread waits for the grids before it (griddepcontrol.wait):
//   weights depend on nothing earlier in the step, x does.  The kernel
//   lets the next one start at once (launch_dependents).
constexpr int G1_COLS = 256;                       // columns per tile
constexpr int G1_ROW_BYTES = G1_COLS * 2;          // 512 B per weight row
constexpr int G1_ROWS = 32;                        // weight rows per stage
constexpr int G1_STAGES = 4;                       // ring stages (MMA: G1_MMA_STAGES)
constexpr int G1_MMA_STAGES = 3;
constexpr int G1_MMA_PAD = 16;                     // bytes after each MMA ring row
// ring stages, a weight row's pitch in the ring and a stage's bytes
__host__ __device__ constexpr int g1_stages(bool mma) { return mma ? G1_MMA_STAGES : G1_STAGES; }
__host__ __device__ constexpr int g1_row_stride(bool mma) {
  return mma ? G1_ROW_BYTES + G1_MMA_PAD : G1_ROW_BYTES;
}
__host__ __device__ constexpr int g1_stage_bytes(bool mma) { return G1_ROWS * g1_row_stride(mma); }
constexpr int G1_HEAD = 256;                       // barriers, the norm's warp sums
constexpr int G1_SMEM_MAX = 227 * 1024;
constexpr int G1_MAX_THREADS = 1024 - 32;          // consumers beside the producer
constexpr int G1_MAX_CLUSTER = 16;                 // non-portable; 8 is portable
constexpr int G1_MMA_ROWS = 16;                    // x rows per block (the mma M)
constexpr int G1_MMA_WARPS = G1_COLS / 32;         // consumer warps, 32 columns each
static_assert(2 * G1_STAGES * sizeof(uint64_t) + 4 * (G1_MAX_THREADS / 32) <= G1_HEAD &&
                  2 * G1_MMA_STAGES * sizeof(uint64_t) <= G1_HEAD,
              "barriers overflow the head");
static_assert(G1_STAGES * g1_stage_bytes(false) >= 4 * G1_COLS * (G1_MAX_THREADS / 32 + 1) &&
                  G1_MMA_STAGES * g1_stage_bytes(true) >= 4 * G1_COLS * G1_MMA_ROWS,
              "the ring must hold the blocks' sums after the last stage");

// x's row pitch in shared memory (bf16): at 8+ rows a multiple of 16 plus
// 8, so that the eight rows of an mma A fragment fall in distinct banks.
__host__ __device__ inline int ring_gemv_xstride(bool mma, int k_chunk) {
  return mma ? (k_chunk + 15) / 16 * 16 + 8 : k_chunk;
}

inline size_t ring_gemv_smem(bool mma, int xrows, int k_chunk) {
  return (size_t)G1_HEAD + (size_t)g1_stages(mma) * g1_stage_bytes(mma) +
         (mma ? 2 * (size_t)xrows * ring_gemv_xstride(mma, k_chunk) : 4 * (size_t)k_chunk);
}

// The bf16 halves of r whose k (lo: k, hi: k + 1) is below `rem`; the rest
// 0.  Rows of a stage past the chunk's end hold stale bytes.
__device__ __forceinline__ uint32_t keep_k(uint32_t r, int k, int rem) {
  return (k < rem ? r & 0xffffu : 0u) | (k + 1 < rem ? r & 0xffff0000u : 0u);
}

template <bool MMA, bool SWIGLU>
__global__ void ring_gemv_kernel(const void* __restrict__ xv, long long x_row, int f_off,
                                 const __nv_bfloat16* __restrict__ w,
                                 float* __restrict__ y, __nv_bfloat16* __restrict__ yb,
                                 int M, int K, int N, int k_chunk, int nrc, int xrows,
                                 long long ws, long long y_row, long long yz,
                                 const __nv_bfloat16* __restrict__ nw, float eps) {
  namespace cg = cooperative_groups;
  constexpr int RB = MMA ? G1_MMA_ROWS : 1;                 // rows per block
  constexpr int NS = g1_stages(MMA), RS = g1_row_stride(MMA), SB = g1_stage_bytes(MMA);
  extern __shared__ __align__(128) unsigned char g1_sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(g1_sm);     // [NS]
  uint64_t* empty = full + NS;                              // [NS]
  unsigned char* ring = g1_sm + G1_HEAD;                    // [NS][G1_ROWS][RS bytes]
  float* xs1 = reinterpret_cast<float*>(ring + NS * SB);                  // one row: [k_chunk]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(ring + NS * SB);  // MMA: [xrows][xst]
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int ncw = blockDim.x / 32 - 1;                      // consumer warps
  const int rank = blockIdx.x, ks = gridDim.x;
  const int mat = blockIdx.z / nrc, r0 = (blockIdx.z % nrc) * RB;
  const int nr = min(RB, M - r0);
  const int n0 = blockIdx.y * G1_COLS;
  const int cols = min(G1_COLS, N - n0);
  const uint32_t seg = (uint32_t)cols * 2;
  const int k0 = rank * k_chunk, kn = min(k_chunk, K - k0);
  const int nst = (kn + G1_ROWS - 1) / G1_ROWS;
  const int xst = ring_gemv_xstride(MMA, k_chunk);
  const __nv_bfloat16* wp = w + (size_t)mat * ws + (size_t)k0 * N + n0;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], ncw);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // producer: stage st's rows, one bulk copy per row, lanes in parallel
  auto issue = [&](int st) {
    const int s = st % NS;
    const int rows = min(G1_ROWS, kn - st * G1_ROWS);
    if (lane == 0) hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)rows * seg);
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      hopper::bulk_load_1d(ring + s * SB + r * RS,
                           wp + (size_t)(st * G1_ROWS + r) * N, seg, &full[s]);
  };
  if (wid == 0)
    for (int st = 0; st < min(NS, nst); ++st) issue(st);
  hopper::grid_dep_launch_dependents();
  hopper::grid_dep_wait();

  // one row: acc[c] of 8 columns a lane; MMA: d[j] of the warp's n8 tile j
  float acc[8], d[4][4];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[j][c] = 0.f;
  if (wid == 0) {
    for (int st = NS; st < nst; ++st) {
      hopper::mbar_wait(&empty[st % NS], (st / NS - 1) & 1);
      issue(st);
    }
  } else {
    const int ct = blockDim.x - 32;
    if constexpr (MMA) {
      // xs[b][k] = x[r0 + b, k0 + k]; rows past M and k past the chunk are 0
#pragma unroll 4
      for (int i = tid - 32; i < xrows * xst; i += ct) {
        const int b = i / xst, k = i - b * xst;
        __nv_bfloat16 v = __float2bfloat16(0.f);
        if (b < nr && k < kn) {
          const size_t at = (size_t)(r0 + b) * x_row + k0 + k;
          if (SWIGLU) {
            const float* gu = static_cast<const float*>(xv);
            const float g = gu[at], u = gu[at + f_off];
            v = __float2bfloat16(g / (1.f + expf(-g)) * u);
          } else {
            v = static_cast<const __nv_bfloat16*>(xv)[at];
          }
        }
        xs[i] = v;
      }
    } else if (SWIGLU) {
      const float* gu = static_cast<const float*>(xv) + k0;
      for (int i = tid - 32; i < kn; i += ct) {
        const float g = gu[i], u = gu[f_off + i];
        xs1[i] = bf16_round(g / (1.f + expf(-g)) * u);
      }
    } else {
      const __nv_bfloat16* xa = static_cast<const __nv_bfloat16*>(xv);
      float inv = 1.f;
      if (nw) {                        // the row's sum of squares, in a fixed order
        float* nred = reinterpret_cast<float*>(empty + NS);   // [ncw], in the head
        float ss = 0.f;
        for (int i = tid - 32; i < K; i += ct) {
          const float v = __bfloat162float(xa[i]);
          ss = fmaf(v, v, ss);
        }
        ss = warp_sum(ss);
        if (lane == 0) nred[wid - 1] = ss;
        hopper::named_barrier_sync(1, ct);
        float tot = 0.f;
        for (int q = 0; q < ncw; ++q) tot += nred[q];
        inv = rsqrtf(tot / K + eps);
      }
      for (int i = tid - 32; i < kn; i += ct) {
        const float v = __bfloat162float(xa[k0 + i]);
        xs1[i] = nw ? bf16_round(v * inv * __bfloat162float(nw[k0 + i])) : v;
      }
    }
    hopper::named_barrier_sync(1, ct);
    const int g = lane / 4, t = lane % 4;
    const int cw0 = (wid - 1) * 32;                         // MMA: this warp's columns
    const bool live = MMA ? cw0 < cols : lane * 8 < cols;
    for (int st = 0; st < nst; ++st) {
      const int s = st % NS;
      hopper::mbar_wait(&full[s], (st / NS) & 1);
      const int rows = min(G1_ROWS, kn - st * G1_ROWS);
      const unsigned char* stage = ring + s * SB;
      if (live) {
        if constexpr (MMA) {
          for (int kb = 0; kb < rows; kb += 16) {
            const __nv_bfloat16* xa = xs + g * xst + st * G1_ROWS + kb + 2 * t;
            uint32_t a[4];
            a[0] = *reinterpret_cast<const uint32_t*>(xa);
            a[2] = *reinterpret_cast<const uint32_t*>(xa + 8);
            a[1] = a[3] = 0u;
            if (xrows > 8) {
              a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * xst);
              a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * xst + 8);
            }
            const int rem = rows - kb;                    // < 16 only at the chunk's end
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = lane / 8;                     // this lane's ldmatrix row
              const unsigned char* row = stage + (kb + (j & 1) * 8 + lane % 8) * RS +
                                         (cw0 + h * 16 + (j >> 1) * 8) * 2;
              uint32_t bf[4];
              hopper::ldmatrix_x4_trans(bf, row);
              if (rem < 16) {
                bf[0] = keep_k(bf[0], 2 * t, rem);
                bf[1] = keep_k(bf[1], 2 * t + 8, rem);
                bf[2] = keep_k(bf[2], 2 * t, rem);
                bf[3] = keep_k(bf[3], 2 * t + 8, rem);
              }
              // each k step's 16 products sum inside the mma from 0; the
              // steps add in float32 (the tensor core's own accumulation
              // is coarser than an FMA chain's and would flip more bf16
              // roundings downstream)
              float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
              hopper::mma_m16n8k16_bf16(p0, a, bf[0], bf[1]);
              hopper::mma_m16n8k16_bf16(p1, a, bf[2], bf[3]);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                d[2 * h][c] += p0[c];
                d[2 * h + 1][c] += p1[c];
              }
            }
          }
        } else {
          const unsigned char* base = stage + lane * 16;
          const float* xk = xs1 + st * G1_ROWS;
          for (int r = wid - 1; r < rows; r += ncw) {
            float f[8];
            unpack8(*reinterpret_cast<const uint4*>(base + r * RS), f);
            const float xr = xk[r];
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[c] = fmaf(xr, f[c], acc[c]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
  }
  __syncthreads();   // every stage issued has landed and been read: the ring is free
  float* part;                                              // [RB][G1_COLS]
  if constexpr (MMA) {
    part = reinterpret_cast<float*>(ring);
    if (wid > 0 && (wid - 1) * 32 < cols) {
      const int g = lane / 4, t = lane % 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (wid - 1) * 32 + j * 8 + 2 * t;
        part[g * G1_COLS + c] = d[j][0];
        part[g * G1_COLS + c + 1] = d[j][1];
        if (g + 8 < nr) {
          part[(g + 8) * G1_COLS + c] = d[j][2];
          part[(g + 8) * G1_COLS + c + 1] = d[j][3];
        }
      }
    }
  } else {
    float* red = reinterpret_cast<float*>(ring);            // [ncw][G1_COLS]
    part = red + ncw * G1_COLS;
    if (wid > 0) {
#pragma unroll
      for (int c = 0; c < 8; ++c) red[(wid - 1) * G1_COLS + lane * 8 + c] = acc[c];
    }
    __syncthreads();
    for (int c = tid; c < G1_COLS; c += blockDim.x) {
      float s = 0.f;
      for (int q = 0; q < ncw; ++q) s += red[q * G1_COLS + c];
      part[c] = s;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (nr * G1_COLS + ks - 1) / ks;             // (row, column) sums per rank
  for (int i = tid; i < per; i += blockDim.x) {
    const int e = rank * per + i, b = e / G1_COLS, c = e % G1_COLS;
    if (b < nr && c < cols) {
      float v[G1_MAX_CLUSTER];            // all ranks' reads in flight at once
#pragma unroll
      for (int q = 0; q < G1_MAX_CLUSTER; ++q)
        v[q] = q < ks ? cluster.map_shared_rank(part, q)[e] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < G1_MAX_CLUSTER; ++q)
        if (q < ks) s += v[q];
      const size_t at = (size_t)(r0 + b) * y_row + (size_t)mat * yz + n0 + c;
      if (yb)
        yb[at] = __float2bfloat16(s);
      else
        y[at] = s;
    }
  }
  cluster.sync();
}

// Launch ring_gemv_kernel<MMA, SWIGLU> over M rows (one, or MMA: chunks of
// 16) and nmat [K, N] matrices, with one producer warp per block beside
// `threads` consumer threads (a multiple of 32, at most G1_MAX_THREADS;
// MMA: always G1_MMA_WARPS warps); `pdl` adds programmatic dependent
// launch.  The K chunks per tile (the cluster size ks, at most 16 where the
// card allows non-portable clusters, else 8, with at least two stages of
// rows per block) are, at one row, the most for which every cluster of the
// grid is resident at once (cudaOccupancyMaxActiveClusters); under MMA,
// whose x chunk grows as ks falls, the ks of least waves x rows per block.
// Returns a cudaError_t.
template <bool MMA, bool SWIGLU>
int launch_ring_gemv_as(const void* x, long long x_row, int f_off, const __nv_bfloat16* w,
                        float* y, int M, int K, int N, int nmat, long long ws, long long y_row,
                        long long yz, int threads, bool pdl, cudaStream_t st,
                        __nv_bfloat16* yb = nullptr, const __nv_bfloat16* nw = nullptr,
                        float eps = 0.f) {
  if (M < 1 || (!MMA && M != 1) || (nw && (MMA || SWIGLU)) || K < 1 || N < 8 || N % 8 != 0 || nmat < 1 ||
      threads < 32 || threads % 32 != 0 || threads > G1_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (MMA) threads = G1_MMA_WARPS * 32;
  static bool attrs_set = false;
  static int max_cluster = 8;
  struct Occ { int ks, threads; size_t smem; int clusters; };
  static Occ occ_cache[64];
  static int n_occ = 0;
  auto kern = ring_gemv_kernel<MMA, SWIGLU>;
  if (!attrs_set) {
    CF_CHECK((int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       G1_SMEM_MAX));
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
        cudaSuccess)
      max_cluster = G1_MAX_CLUSTER;
    else
      (void)cudaGetLastError();
    attrs_set = true;
  }
  const int rb = MMA ? G1_MMA_ROWS : 1;
  const int nrc = (M + rb - 1) / rb;
  const int xrows = MMA ? (nrc > 1 ? G1_MMA_ROWS : (M + 7) / 8 * 8) : 1;
  const int tiles = (N + G1_COLS - 1) / G1_COLS;
  const int z = nmat * nrc;
  const int want = tiles * z;                  // clusters of the grid
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads + 32, 1, 1);
  cfg.stream = st;
  cfg.attrs = attr;
  // active clusters of size ks at this shared-memory size (cached)
  auto clusters = [&](int ks, size_t smem) {
    for (int i = 0; i < n_occ; ++i)
      if (occ_cache[i].ks == ks && occ_cache[i].threads == threads && occ_cache[i].smem == smem)
        return occ_cache[i].clusters;
    attr[0].val.clusterDim.x = ks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(ks, tiles, z);
    cfg.dynamicSmemBytes = smem;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
      (void)cudaGetLastError();
      n = 0;
    }
    if (n_occ < 64) occ_cache[n_occ++] = Occ{ks, threads, smem, n};
    return n;
  };
  int ks = std::min(max_cluster, std::max(1, K / (2 * G1_ROWS)));
  int k_chunk = K;
  if (MMA) {
    // x's chunk grows as ks falls, so all clusters resident may need ks so
    // small that few SMs work: take the ks of least waves x rows per block,
    // a wave of fewer blocks than SMs counted as its share of the card
    static int num_sms = 0;
    if (num_sms == 0) {
      int dev = 0;
      CF_CHECK((int)cudaGetDevice(&dev));
      CF_CHECK((int)cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev));
    }
    double best = 0.0;
    int best_ks = 0;
    for (int c = ks; c >= 1; --c) {
      const int kc = (K + c - 1) / c;
      if ((K + kc - 1) / kc != c) continue;               // every rank has rows
      const size_t smem = ring_gemv_smem(MMA, xrows, kc);
      if (smem > (size_t)G1_SMEM_MAX) break;
      const int act = clusters(c, smem);
      if (act < 1) continue;
      const int waves = (want + act - 1) / act;
      const int blocks = std::min(want, act) * c;         // in a full wave
      const double cost = (double)waves * kc * num_sms / std::min(num_sms, blocks);
      if (best_ks == 0 || cost < best) {
        best = cost;
        best_ks = c;
      }
    }
    ks = best_ks;
    k_chunk = ks > 0 ? (K + ks - 1) / ks : K;
  } else {
    for (; ks >= 1; --ks) {
      k_chunk = (K + ks - 1) / ks;
      if ((K + k_chunk - 1) / k_chunk != ks) continue;    // every rank has rows
      const size_t smem = ring_gemv_smem(MMA, xrows, k_chunk);
      if (smem > (size_t)G1_SMEM_MAX) { ks = 0; break; }
      if (ks == 1 || clusters(ks, smem) >= want) break;
    }
  }
  if (ks < 1) return (int)cudaErrorInvalidValue;          // x chunk too large
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(ks, tiles, z);
  cfg.dynamicSmemBytes = ring_gemv_smem(MMA, xrows, k_chunk);
  cfg.numAttrs = pdl ? 2 : 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, x, x_row, f_off, w, y, yb, M, K, N, k_chunk,
                                 nrc, xrows, ws, y_row, yz, nw, eps);
}

// Any M: one row on float32 FMAs, more on the tensor cores.
template <bool SWIGLU>
int launch_ring_gemv(const void* x, long long x_row, int f_off, const __nv_bfloat16* w,
                     float* y, int M, int K, int N, int nmat, long long ws, long long y_row,
                     long long yz, int threads, bool pdl, cudaStream_t st,
                     __nv_bfloat16* yb = nullptr) {
  if (M == 1)
    return launch_ring_gemv_as<false, SWIGLU>(x, x_row, f_off, w, y, M, K, N, nmat, ws, y_row,
                                              yz, threads, pdl, st, yb);
  return launch_ring_gemv_as<true, SWIGLU>(x, x_row, f_off, w, y, M, K, N, nmat, ws, y_row, yz,
                                           threads, pdl, st, yb);
}

// One row: y[mat*yz + n] = sum_k x[k] * W[k, n] (the bs=1 stack's GEMVs,
// the standalone gemv and the MLA layer's; nw: x normalised first).
template <bool SWIGLU>
int launch_gemv1(const void* x, int f_off, const __nv_bfloat16* w, float* y, int K, int N,
                 int nmat, long long ws, long long yz, int threads, bool pdl,
                 cudaStream_t st, __nv_bfloat16* yb = nullptr,
                 const __nv_bfloat16* nw = nullptr, float eps = 0.f) {
  return launch_ring_gemv_as<false, SWIGLU>(x, 0, f_off, w, y, 1, K, N, nmat, ws, 0, yz,
                                            threads, pdl, st, yb, nw, eps);
}

// ---- Split-KV flash-decode of one bs=1 layer (the stack's and kernel 6's) ----
//
// qkv holds the layer's raw f32 projection, [kv][(group+2)*hd] per kv head
// (q_0..q_{group-1} | k | v).  The split pass reads cache rows < seq in
// splits of `split` rows: one partial (max, sum, acc) per (kv head, split),
// q roped, pre-scaled by 1/sqrt(hd)*log2(e) and rounded to bf16 for the
// dots, p = exp2(s - split max) rounded to bf16 for the p.V sums.  The
// merge pass folds the partials and (fold) the current token, whose q.k and
// v join in f32 as the TPU kernel folds them.
constexpr int ATT_THREADS = 128;
constexpr int ATT_MAX_GROUP = 8;
constexpr int ATT_TILE = 64;            // cache rows per ring stage
constexpr int ATT_MAX_SPLIT = 1024;

// Shared memory of the split pass: two barriers, a two-stage ring of
// [min(split, ATT_TILE), hd] bf16 tiles, q in bf16 and f32, the split's
// scores, and the P.V slices' sums.
inline size_t attn_split_smem(int group, int hd, int split) {
  const size_t tr = (size_t)std::min(split, ATT_TILE);
  const size_t slices = ATT_THREADS / (hd / 8);
  return 16 + 2 * tr * hd * 2 + (size_t)group * hd * (2 + 4) +
         sizeof(float) * ((size_t)group * split + slices * group * hd);
}
constexpr int ATT_SPLIT_SMEM_MAX = 112 * 1024;   // >= attn_split_smem(8, 128, 1024)

// Split pass over cache rows [s*split, min((s+1)*split, seq)) of kv head
// h = blockIdx.x, s = blockIdx.y.  Writes part_ml [kv, ns, g, 2] (max, sum)
// and part_acc [kv, ns, g, hd].
//
// Bound by bytes (the K and V rows < seq, read once).  The split's n rows
// of K, then of V, are contiguous spans of the [kv, cap, hd] cache, so
// thread 0 loads them as 1-D bulk copies (cp.async.bulk) of up to ATT_TILE
// rows into a two-stage ring behind mbarriers: the tiles K_0.., then V_0..,
// the next tile issued as soon as a stage is read, so a split of one tile
// has its K and V in flight from the block's first instruction.  Only rows
// < seq are copied; whatever lies above them is never read, so NaN there
// is harmless.  Q.K: two threads per row, each over half of hd in 16-byte
// pieces, the pieces' order staggered by thread so the row reads of a
// warp hit distinct banks; q is read as bf16 from shared memory.  P.V:
// each thread owns 8 adjacent columns of hd over a slice of the rows (row
// r goes to slice r % slices); the slices' sums meet in shared memory in
// slice order.
__global__ void __launch_bounds__(ATT_THREADS)
attn_split_kernel(const float* __restrict__ qkv,
                  const __nv_bfloat16* __restrict__ kc,
                  const __nv_bfloat16* __restrict__ vc,
                  const float* __restrict__ cos, const float* __restrict__ sin,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int group, int hd, int cap, int seq, int split, int neox) {
  extern __shared__ __align__(16) unsigned char att_sm[];
  const int tr = min(split, ATT_TILE);
  uint64_t* bar = reinterpret_cast<uint64_t*>(att_sm);                       // [2]
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(att_sm + 16);       // [2][tr][hd]
  __nv_bfloat16* qb = ring + 2 * tr * hd;                                    // [group][hd]
  float* raw = reinterpret_cast<float*>(qb + group * hd);                    // [group][hd]
  float* sc = raw + group * hd;                                              // [group][split]
  float* red = sc + group * split;                                           // [slices][group][hd]
  const int h = blockIdx.x, s = blockIdx.y, ns = gridDim.y;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int nw = blockDim.x / 32;
  const int j0 = s * split;
  const int n = min(split, seq - j0);
  const int nt = (n + tr - 1) / tr;        // tiles of K, then as many of V
  const uint32_t row_bytes = (uint32_t)hd * 2;
  const __nv_bfloat16* kh = kc + ((size_t)h * cap + j0) * hd;
  const __nv_bfloat16* vh = vc + ((size_t)h * cap + j0) * hd;
  // thread 0: tile u of K_0..K_{nt-1}, V_0..V_{nt-1} into stage u % 2
  auto issue = [&](int u) {
    const int t = u < nt ? u : u - nt;
    const int rows = min(tr, n - t * tr);
    uint64_t* b = &bar[u & 1];
    hopper::mbar_arrive_expect_tx(b, (uint32_t)rows * row_bytes);
    hopper::bulk_load_1d(ring + (u & 1) * tr * hd, (u < nt ? kh : vh) + (size_t)t * tr * hd,
                         (uint32_t)rows * row_bytes, b);
  };
  if (tid == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::fence_barrier_init();
  }
  hopper::grid_dep_launch_dependents();
  hopper::grid_dep_wait();       // qkv and the cache rows come from earlier kernels
  __syncthreads();
  if (tid == 0) {
    issue(0);
    issue(1);
  }

  const float* qh = qkv + (size_t)h * (group + 2) * hd;
  for (int e = tid; e < group * hd; e += blockDim.x) raw[e] = qh[e];
  __syncthreads();
  const float scale = LOG2E / sqrtf((float)hd);
  for (int e = tid; e < group * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    qb[e] = __float2bfloat16(rope_at(raw + i * hd, d, hd, cos, sin, neox) * scale);
  }
  __syncthreads();

  // Q.K: row r = tid / 2 of each K tile, half tid % 2 of hd
  const int half = tid & 1, np = hd / 16;  // 16-byte pieces per half row
  for (int t = 0; t < nt; ++t) {
    hopper::mbar_wait(&bar[t & 1], (t >> 1) & 1);
    const int rows = min(tr, n - t * tr), r = tid >> 1;
    float acc[ATT_MAX_GROUP];
#pragma unroll
    for (int i = 0; i < ATT_MAX_GROUP; ++i) acc[i] = 0.f;
    if (r < rows) {
      const __nv_bfloat16* krow = ring + (t & 1) * tr * hd + r * hd + half * (hd / 2);
      const __nv_bfloat16* qhalf = qb + half * (hd / 2);
      for (int c = 0; c < np; ++c) {
        const int pc = (c + tid) % np;
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(krow + pc * 8), kf);
#pragma unroll
        for (int i = 0; i < ATT_MAX_GROUP; ++i) {
          if (i < group) {
            float qf[8];
            unpack8(*reinterpret_cast<const uint4*>(qhalf + i * hd + pc * 8), qf);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[i] = fmaf(qf[e], kf[e], acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ATT_MAX_GROUP; ++i) {
      if (i < group) {
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
        if (half == 0 && r < rows) sc[i * split + t * tr + r] = acc[i];
      }
    }
    __syncthreads();                       // stage t & 1 is read
    if (tid == 0 && t + 2 < 2 * nt) issue(t + 2);
  }

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

  // P.V: thread (slice sl, columns cg*8..cg*8+7) over rows sl, sl+slices, ...
  const int ncg = hd / 8, slices = ATT_THREADS / ncg;
  const int sl = tid / ncg, cg = tid % ncg;
  float pv[ATT_MAX_GROUP][8];
#pragma unroll
  for (int i = 0; i < ATT_MAX_GROUP; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) pv[i][c] = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int u = nt + t;
    hopper::mbar_wait(&bar[u & 1], (u >> 1) & 1);
    const int rows = min(tr, n - t * tr);
    if (sl < slices) {
      const __nv_bfloat16* vt = ring + (u & 1) * tr * hd + cg * 8;
      const float* pt = sc + t * tr;
      for (int r = sl; r < rows; r += slices) {
        float vf[8];
        unpack8(*reinterpret_cast<const uint4*>(vt + r * hd), vf);
#pragma unroll
        for (int i = 0; i < ATT_MAX_GROUP; ++i) {
          if (i < group) {
            const float p = pt[i * split + r];
#pragma unroll
            for (int c = 0; c < 8; ++c) pv[i][c] = fmaf(p, vf[c], pv[i][c]);
          }
        }
      }
    }
    __syncthreads();                       // stage u & 1 is read
    if (tid == 0 && u + 2 < 2 * nt) issue(u + 2);
  }
  if (sl < slices) {
#pragma unroll
    for (int i = 0; i < ATT_MAX_GROUP; ++i) {
      if (i < group) {
#pragma unroll
        for (int c = 0; c < 8; ++c) red[(sl * group + i) * hd + cg * 8 + c] = pv[i][c];
      }
    }
  }
  __syncthreads();
  float* out = part_acc + ((size_t)h * ns + s) * group * hd;
  for (int e = tid; e < group * hd; e += blockDim.x) {
    float a = 0.f;
    for (int q = 0; q < slices; ++q) a += red[q * group * hd + e];
    out[e] = a;
  }
}

// Merge pass of kv head h = blockIdx.x (rows r = h*group + i of R =
// gridDim.x*group): fold the ns split partials and, when `fold`, the
// current token from the f32 q/k/v; the state with nothing folded is
// (m = NEG_INF, l = 0, acc = 0).  Writes the roped current k and v as bf16
// to knew/vnew [kv, hd] (when given) and to row `seq` of kc/vc (when
// given: the append); then either o[r*hd + d] = bf16(acc / l) or, when
// acc_out is given, the unnormalised partials acc_out [R, hd] and
// ml_out [2, R] (max, sum).
__global__ void __launch_bounds__(ATT_THREADS)
attn_merge_kernel(const float* __restrict__ qkv,
                  const float* __restrict__ part_ml,
                  const float* __restrict__ part_acc,
                  const float* __restrict__ cos, const float* __restrict__ sin,
                  __nv_bfloat16* __restrict__ kc, __nv_bfloat16* __restrict__ vc,
                  __nv_bfloat16* __restrict__ knew, __nv_bfloat16* __restrict__ vnew,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ acc_out,
                  float* __restrict__ ml_out, int group, int hd, int cap, int seq,
                  int ns, int fold, int neox) {
  hopper::grid_dep_launch_dependents();   // the O-projection may start
  hopper::grid_dep_wait();
  extern __shared__ float sm[];
  float* raw = sm;                       // [(group+2)][hd]: q rows, k, v
  float* qr = raw + (group + 2) * hd;    // [group][hd] roped, scaled
  float* kr = qr + group * hd;           // [hd] roped k
  float* scur = kr + hd;                 // [group]
  __shared__ float red[32];
  const int h = blockIdx.x, tid = threadIdx.x;
  const int R = gridDim.x * group;
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
    if (knew) {
      knew[(size_t)h * hd + d] = __float2bfloat16(kd);
      vnew[(size_t)h * hd + d] = __float2bfloat16(vraw[d]);
    }
    if (kc) {
      const size_t row = ((size_t)h * cap + seq) * hd + d;
      kc[row] = __float2bfloat16(kd);
      vc[row] = __float2bfloat16(vraw[d]);
    }
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
      float mx = fold ? sc : NEG_INF;
      for (int s = 0; s < ns; ++s)
        mx = fmaxf(mx, part_ml[(((size_t)h * ns + s) * group + i) * 2]);
      const float pc = fold ? exp2f(sc - mx) : 0.f;
      float l = pc, acc = pc * vraw[d];
      for (int s = 0; s < ns; ++s) {
        const size_t idx = ((size_t)h * ns + s) * group + i;
        const float e = exp2f(part_ml[idx * 2] - mx);
        l = fmaf(part_ml[idx * 2 + 1], e, l);
        acc = fmaf(part_acc[idx * hd + d], e, acc);
      }
      const int r = h * group + i;
      if (acc_out) {
        acc_out[(size_t)r * hd + d] = acc;
        if (d == 0) {
          ml_out[r] = mx;
          ml_out[R + r] = l;
        }
      } else {
        o[(size_t)r * hd + d] = __float2bfloat16(acc / l);
      }
    }
  }
}

// f32 scratch of the split pass's partials for `seq` cached rows.
size_t attn_partial_floats(int kv_heads, int group, int hd, int seq, int split) {
  const size_t ns = (size_t)(seq + split - 1) / split;
  return (size_t)kv_heads * ns * group * (2 + (size_t)hd);
}

// Launch the split pass (when seq > 0) and the merge pass of one layer on
// `st`; part_ml/part_acc hold kv*ns*group*2 and kv*ns*group*hd floats.
// *n counts the launches.  Returns a cudaError_t.
int launch_attention(const float* qkv, const __nv_bfloat16* kc_read,
                     const __nv_bfloat16* vc_read, const float* cos,
                     const float* sin, float* part_ml, float* part_acc,
                     __nv_bfloat16* kc_append, __nv_bfloat16* vc_append,
                     __nv_bfloat16* knew, __nv_bfloat16* vnew, __nv_bfloat16* o,
                     float* acc_out, float* ml_out, int kv_heads, int group,
                     int hd, int cap, int seq, int split, int fold, int neox,
                     cudaStream_t st, int* n, bool pdl = false) {
  if (group < 1 || group > ATT_MAX_GROUP || hd % 32 != 0 || hd > 4 * 32 ||
      split < 1 || split > ATT_MAX_SPLIT || seq < 0 || seq > cap)
    return (int)cudaErrorInvalidValue;
  static bool attrs_set = false;
  if (!attrs_set) {
    CF_CHECK((int)cudaFuncSetAttribute(attn_split_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ATT_SPLIT_SMEM_MAX));
    attrs_set = true;
  }
  const int ns = (seq + split - 1) / split;
  const size_t split_smem = attn_split_smem(group, hd, split);
  const size_t merge_smem = sizeof(float) * ((size_t)(2 * group + 3) * hd + group);
  if (split_smem > (size_t)ATT_SPLIT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (ns > 0) {
    CF_CHECK(launch_kernel(attn_split_kernel, dim3(kv_heads, ns), dim3(ATT_THREADS),
                           split_smem, st, pdl, qkv, kc_read, vc_read, cos, sin, part_ml,
                           part_acc, group, hd, cap, seq, split, neox));
    ++*n;
  }
  CF_CHECK(launch_kernel(attn_merge_kernel, dim3(kv_heads), dim3(ATT_THREADS), merge_smem,
                         st, pdl, qkv, part_ml, part_acc, cos, sin, kc_append, vc_append,
                         knew, vnew, o, acc_out, ml_out, group, hd, cap, seq, ns, fold,
                         neox));
  ++*n;
  return 0;
}

// ---- One-launch layer halves (decoder_layer.cu, fused_ffn.cu) ----
//
// Each kernel streams its weight tiles (and cache rows) through one ring
// of OL_STAGE-byte shared-memory stages: the tiles form one sequence fixed
// by the geometry, and the copies depend on nothing the kernel computes,
// so the ring runs ahead across the kernel's phases and cluster barriers.
// A producer warp (the block's last) issues tile u into stage u % stages
// once the consumers (OL_THREADS threads, the rest) have released tile
// u - stages (`empty` mbarriers; a TMA queue that is full stalls only the
// producer), and the consumers wait for each tile's bytes (`full`).  The
// consumers meet at named barrier 1, never at __syncthreads.  The producer
// takes part in the cluster barriers with split arrive/wait (ol_produce).
constexpr int OL_MAX_STAGES = 6;                // the most any kernel uses
constexpr int OL_THREADS = 256;                 // consumer threads per block
constexpr int OL_WARPS = OL_THREADS / 32;
constexpr int OL_BLOCK = OL_THREADS + 32;       // and the producer warp

// A barrier of the consumer threads alone.
__device__ __forceinline__ void ol_cbar() { hopper::named_barrier_sync(1, OL_THREADS); }

// Sum over the consumer threads in a fixed order; every consumer gets the
// result.  `red` holds OL_WARPS floats.
__device__ float ol_block_sum(float x, float* red) {
  x = warp_sum(x);
  ol_cbar();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  ol_cbar();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < OL_WARPS; ++w) t += red[w];
  return t;
}

// The producer warp's loop: tile u after the consumers' release of tile u
// - nst (empty[u % nst]); issue(u) does the copy (lane 0).  The consumers
// pass `nbar` cluster barriers in all and read tile v after `phase(v)` of
// them; a barrier's phase needs this warp's arrival too, so the warp
// arrives at barrier k (waiting for barrier k - 1 first) before it waits
// for a stage that the consumers free only past barrier k, and takes the
// rest of its barriers after the last tile.
template <typename Phase, typename Issue>
__device__ void ol_produce(int total, int nst, uint64_t* empty, int nbar, Phase phase,
                          Issue issue) {
  int arrived = 0;
  auto next_barrier = [&]() {
    if (arrived > 0) hopper::cluster_wait();
    hopper::cluster_arrive();
    ++arrived;
  };
  if (nbar > 0) next_barrier();
  for (int u = 0; u < total; ++u) {
    if (u >= nst) {
      const int need = phase(u - nst);
      while (arrived < need) next_barrier();
      hopper::mbar_wait(&empty[u % nst], (u / nst - 1) & 1);
    }
    issue(u);
    __syncwarp();
  }
  while (arrived < nbar) next_barrier();
  if (arrived > 0) hopper::cluster_wait();
}

// The consumers' side of a cluster barrier (arrive and wait).
__device__ __forceinline__ void ol_cluster_sync() {
  hopper::cluster_arrive();
  hopper::cluster_wait();
}
constexpr int OL_STAGE = 16384;                 // bytes per ring stage
constexpr int OL_HEAD = 256;                    // mbarriers and the fold's flag
constexpr int OL_RED_FLOATS = 8 * OL_THREADS;   // a tile product's row-group sums
constexpr int OL_SMEM_MAX = 227 * 1024;
constexpr int OL_MAX_NP = 4;                    // 8-column pieces per thread
constexpr int OL_MAX_CLUSTER = 16;              // non-portable; 8 is portable
constexpr int OL_MAX_HIDDEN = 8 * OL_MAX_NP * OL_THREADS;   // 8192
static_assert(16 * OL_MAX_STAGES + 4 <= OL_HEAD, "barriers overflow the head");

// The norm's loads, issued before the ring's first copies so that they do
// not queue behind them: h = x (+ res) in f32 for this thread's 8-element
// chunks i = tid, tid + OL_THREADS, ... of the row (hidden <= OL_MAX_HIDDEN,
// a multiple of 8), and w's chunks where w is given.  ol_norm_sum then
// gives the row's sum of squares in a fixed order.
struct OlRow {
  uint4 x[OL_MAX_NP], r[OL_MAX_NP], w[OL_MAX_NP];
};

__device__ __forceinline__ void ol_norm_load(OlRow& row, const __nv_bfloat16* x,
                                             const __nv_bfloat16* res, const __nv_bfloat16* w,
                                             int hidden) {
#pragma unroll
  for (int q = 0; q < OL_MAX_NP; ++q) {
    const int i = threadIdx.x + q * OL_THREADS;
    row.x[q] = row.r[q] = row.w[q] = make_uint4(0u, 0u, 0u, 0u);
    if (8 * i < hidden) {
      row.x[q] = *reinterpret_cast<const uint4*>(x + 8 * i);
      if (res) row.r[q] = *reinterpret_cast<const uint4*>(res + 8 * i);
      if (w) row.w[q] = *reinterpret_cast<const uint4*>(w + 8 * i);
    }
  }
}

// h = x (+ res) of chunk q (f32), and the block's sum of h^2 over the row.
__device__ __forceinline__ void ol_norm_h(const OlRow& row, int q, float* h) {
  float r[8];
  unpack8(row.x[q], h);
  unpack8(row.r[q], r);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] += r[e];
}

__device__ float ol_norm_sum(const OlRow& row, float* red) {
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < OL_MAX_NP; ++q) {
    float h[8];
    ol_norm_h(row, q, h);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(h[e], h[e], ss);
  }
  return ol_block_sum(ss, red);
}

// Shared-memory offset of a region of `bytes` at `off` (128-byte aligned).
__host__ __device__ inline int ol_take(int& off, int bytes) {
  const int at = off;
  off += (bytes + 127) / 128 * 128;
  return at;
}

// Phase boundaries a one-launch kernel stamps when given `stamps`
// (uint64 [blocks][OL_STAMPS], %globaltimer ns, thread 0 of each block;
// nullptr on the normal path: one untaken branch per boundary).
constexpr int OL_STAMPS = 8;
__device__ __forceinline__ void ol_stamp(unsigned long long* stamps, int k) {
  if (stamps != nullptr && threadIdx.x == 0)
    stamps[(size_t)(blockIdx.x + blockIdx.y * gridDim.x) * OL_STAMPS + k] = hopper::global_ns();
}

// The widest box dimension (a multiple of 8, at most 256 elements, TMA's
// limit) that divides both a and b (multiples of 8): a box's inner width
// when a tile of a columns starts at multiples of a in rows of b columns.
inline int ol_box_width(int a, int b) {
  for (int w = 256; w > 8; w -= 8)
    if (a % w == 0 && b % w == 0) return w;
  return 8;
}

// Ring stages, at most `want`, that fit beside `rest` bytes of other shared
// memory (0: none).
inline int ol_stages(int rest, int want) {
  const int ring = (rest + 1023) / 1024 * 1024;
  return std::min(std::min(want, OL_MAX_STAGES), std::max(0, (OL_SMEM_MAX - ring) / OL_STAGE));
}

// One stage of weights against x: this thread's 8-column pieces of a tile
// of `rows` rows, row j of piece p at stage + j*pitch + (p < p1 ? 16p :
// half + 16(p - p1)) (`half` places a second matrix's columns after the
// first's), each summed as acc += x[j] * W[j][piece] in row order.  With
// P <= OL_THREADS pieces a row, thread t takes piece t % P of the rows t /
// P, t / P + RG, ... (RG = OL_THREADS / P row groups); with more, pieces
// t, t + OL_THREADS, ... of every row.
template <int NP>
__device__ __forceinline__ void tile_gemv(const unsigned char* stage, int pitch, int p1,
                                          int half, int rows, const float* x, int P,
                                          float (&acc)[NP][8]) {
  const int t = threadIdx.x;
  auto piece = [&](int p) { return stage + (p < p1 ? p * 16 : half + (p - p1) * 16); };
  if (P <= OL_THREADS) {
    const int RG = OL_THREADS / P, p = t % P, rg = t / P;
    if (rg >= RG) return;
    const unsigned char* base = piece(p);
#pragma unroll 4
    for (int j = rg; j < rows; j += RG) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(base + (size_t)j * pitch), f);
      const float xj = x[j];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[0][c] = fmaf(xj, f[c], acc[0][c]);
    }
  } else {
    for (int j = 0; j < rows; ++j) {
      const float xj = x[j];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int p = t + q * OL_THREADS;
        if (p < P) {
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(piece(p) + (size_t)j * pitch), f);
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[q][c] = fmaf(xj, f[c], acc[q][c]);
        }
      }
    }
  }
}

// out[8p + c] = the sum of tile_gemv's acc over the row groups, in group
// order (red: OL_RED_FLOATS floats of shared memory); out may be global.
// Ends with a barrier of the consumers.
template <int NP>
__device__ void tile_gemv_reduce(const float (&acc)[NP][8], int P, float* red, float* out) {
  const int t = threadIdx.x;
  if (P <= OL_THREADS) {
    const int RG = OL_THREADS / P, p = t % P, rg = t / P;
    if (rg < RG) {
      float4* r = reinterpret_cast<float4*>(red + (size_t)(rg * P + p) * 8);
      r[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      r[1] = make_float4(acc[0][4], acc[0][5], acc[0][6], acc[0][7]);
    }
    ol_cbar();
    for (int e = t; e < P * 8; e += OL_THREADS) {
      float s = red[e];
      for (int q = 1; q < RG; ++q) s += red[(size_t)q * P * 8 + e];
      out[e] = s;
    }
  } else {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = t + q * OL_THREADS;
      if (p < P)
#pragma unroll
        for (int c = 0; c < 8; ++c) out[(size_t)p * 8 + c] = acc[q][c];
    }
  }
  ol_cbar();
}

// The ordered fold across blocks, one launch, no sum by atomics, in two
// levels so that no block reads more than `group` rows at the first: every
// block that wrote row `row` of part[nrows][stride] over the columns [c0,
// c0 + ncols) (a multiple of 4) takes a ticket from its group's counter
// (rows in groups of `group`, OL_FOLD_MIN_GROUP or more); the group's last
// block sums
// the group's rows in row order into row `group` of gpart[groups][stride]
// and takes a ticket from the final counter; the last group's block sums
// the groups' rows in group order and writes out = bf16(sum).  Each
// counter goes back to 0 when its last ticket is taken (the next call on
// the stream starts after this one ends); tickets are taken modulo the
// count, so a count left behind by a launch that died midway misplaces one
// call's fold at most.  ctr: OL_FOLD_STRIDE counters (final, then one per
// group).  Called by every thread of the block; `flag` is one int of
// shared memory.  Called by the consumer threads.
constexpr int OL_FOLD_MIN_GROUP = 4;
constexpr int OL_FOLD_MAX_ROWS = 256;
constexpr int OL_FOLD_STRIDE = 1 + OL_FOLD_MAX_ROWS / OL_FOLD_MIN_GROUP;
constexpr int OL_COUNTERS = OL_MAX_CLUSTER * OL_FOLD_STRIDE;   // one set per cluster rank

__host__ __device__ inline int ol_fold_groups(int nrows, int group) {
  return (nrows + group - 1) / group;
}

// Floats of a fold's scratch: part and gpart rows of `stride` floats, then
// the counters of every cluster rank.
inline long long ol_fold_floats(int nrows, int stride, int group) {
  return (long long)(nrows + ol_fold_groups(nrows, group)) * stride + OL_COUNTERS;
}

// dst[c] = sum of src rows r0..r0+nr-1 (row order) at columns [c0, c0 +
// ncols), eight rows of two column groups a thread in flight at a time;
// bf16 into out or f32 into dst.
__device__ __noinline__ void ol_sum_rows(const float* src, int stride, int r0, int nr, int c0,
                                         int ncols, float* dst, __nv_bfloat16* out) {
  for (int c = threadIdx.x * 4; c < ncols; c += 8 * OL_THREADS) {
    const int cg[2] = {c, c + 4 * OL_THREADS};    // a second column group, if any
    const float* col = src + (size_t)r0 * stride + c0;
    float4 s[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int rb = 0; rb < nr; rb += 8) {
      float4 v[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          v[h][q] = rb + q < nr && cg[h] < ncols
                        ? __ldcg(reinterpret_cast<const float4*>(
                              col + (size_t)(rb + q) * stride + cg[h]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (rb + q < nr) {
            s[h].x += v[h][q].x;
            s[h].y += v[h][q].y;
            s[h].z += v[h][q].z;
            s[h].w += v[h][q].w;
          }
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (cg[h] >= ncols) continue;
      if (out) {
        __nv_bfloat16* o = out + c0 + cg[h];
        o[0] = __float2bfloat16(s[h].x);
        o[1] = __float2bfloat16(s[h].y);
        o[2] = __float2bfloat16(s[h].z);
        o[3] = __float2bfloat16(s[h].w);
      } else {
        __stcg(reinterpret_cast<float4*>(dst + c0 + cg[h]), s[h]);
      }
    }
  }
}

// A ticket from *ctr among n arrivals: true in the block that takes the
// last (the caller then sets *ctr back to 0 after its sums).  The
// consumers' barrier orders their writes before thread 0's release fence
// and ticket; thread 0's acquire fence and the barrier order the others'
// writes before our reads (which go to L2: __ldcg).
__device__ bool ol_ticket(unsigned* ctr, unsigned n, int* flag) {
  ol_cbar();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    const bool last = atomicAdd(ctr, 1u) % n == n - 1u;
    if (last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    *flag = last;
  }
  ol_cbar();
  return *flag != 0;
}

__device__ void ordered_fold(const float* part, int stride, int nrows, int row, int c0,
                             int ncols, unsigned* ctr, __nv_bfloat16* out, int* flag,
                             int group) {
  const int groups = ol_fold_groups(nrows, group), grp = row / group;
  const int members = min(group, nrows - grp * group);
  float* gpart = const_cast<float*>(part) + (size_t)nrows * stride;
  if (!ol_ticket(ctr + 1 + grp, (unsigned)members, flag)) return;
  ol_sum_rows(part, stride, grp * group, members, c0, ncols,
              groups > 1 ? gpart + (size_t)grp * stride : nullptr, groups > 1 ? nullptr : out);
  if (threadIdx.x == 0) atomicExch(ctr + 1 + grp, 0u);
  if (groups == 1 || !ol_ticket(ctr, (unsigned)groups, flag)) return;
  ol_sum_rows(gpart, stride, 0, groups, c0, ncols, nullptr, out);
  if (threadIdx.x == 0) atomicExch(ctr, 0u);
}

// Per device and kernel: the SM count and whether clusters of up to 16
// blocks are allowed for `kern` (its dynamic shared-memory allowance set
// once, to OL_SMEM_MAX).  Returns a cudaError_t.
template <typename Kern>
int ol_device(Kern kern, int* num_sms, int* max_cluster) {
  static struct { const void* kern; int dev, sms, maxc; } done[64];
  static int n_done = 0;
  int dev = 0;
  CF_CHECK((int)cudaGetDevice(&dev));
  for (int i = 0; i < n_done; ++i)
    if (done[i].kern == (const void*)kern && done[i].dev == dev) {
      *num_sms = done[i].sms;
      *max_cluster = done[i].maxc;
      return 0;
    }
  {
    CF_CHECK((int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       OL_SMEM_MAX));
    int c = 8;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
        cudaSuccess)
      c = 16;
    else
      (void)cudaGetLastError();
    int n = 0;
    CF_CHECK((int)cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev));
    if (n_done < 64) done[n_done++] = {(const void*)kern, dev, n, c};
    *num_sms = n;
    *max_cluster = c;
  }
  return 0;
}

// Clusters of `c` blocks (along y, as launch_kernel_cluster lays them) of
// OL_BLOCK threads and `smem` bytes that the card holds at once (0 if
// none or the query fails).
template <typename Kern>
int ol_active_clusters(Kern kern, int c, size_t smem, int blocks) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = c;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, blocks);
  cfg.blockDim = dim3(OL_BLOCK);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
    (void)cudaGetLastError();
    n = 0;
  }
  return n;
}

}  // namespace
