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

#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "collective.cuh"
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

#define CF_CHECK(...)              \
  do {                             \
    int _e = (__VA_ARGS__);        \
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
constexpr int NORM_ROW = 8;          // elements a thread of a reduce's norm holds
// The widest row a reduce of the stack takes: its norm holds the row in
// registers (8192, llama2_70b's hidden).
constexpr int REDUCE_MAX_HIDDEN = NORM_ROW * NORM_THREADS;
static_assert(REDUCE_MAX_HIDDEN <= COMM_FLAG_COLS * COMM_TILE,
              "a reduce's row has more tiles than flag columns");

// Residual add + RMSNorm of row blockIdx.x (every row pointer is offset by
// row*hidden, z1 and z2 by row*n1 and row*n2): r = a + b, with a from `a`
// (f32) or `a_bf16`, b from `b` (f32) or `b_bf16` or 0; r_out = r and
// r_bf16 = bf16(r) when given; xn = bf16(r * rsqrt(mean(r^2) + eps) * w)
// when w is given; x_out = bf16(a), res_out = bf16(b) when given; zero
// z1[n1] and z2[n2].  With programmatic dependent launch it waits for the
// kernels before it first, and it lets the kernel after it start at once
// (the ring GEMV streams its weights while this kernel runs and reads xn
// only after it has completed).
//
// REDUCE (resnorm_reduce_kernel, one row): the consumer of a reduce of the
// stack's mode 5 (collective.cu): a is the sum over the ranks of `cm`'s
// axis of the partials their ring GEMVs pushed (PUSH).  After its
// griddepcontrol.wait it waits for every rank's flag of every 256-column
// tile, then reads the slots in rank order (the bits of kernel 13's sum)
// and advances the rank's epoch.  Only then does it let the kernel after it
// start: launched early, that kernel's blocks would hold SMs while this
// one waits, and a virtual rank on the same card could find none for the
// product this one waits for.
template <bool REDUCE>
__device__ __forceinline__ void resnorm_body(
    const float* a, const __nv_bfloat16* a_bf16, const float* b,
    const __nv_bfloat16* b_bf16, const __nv_bfloat16* w, float* r_out,
    __nv_bfloat16* r_bf16, __nv_bfloat16* xn, __nv_bfloat16* x_out,
    __nv_bfloat16* res_out, int hidden, float eps, float* z1, int n1, float* z2, int n2,
    const CfComm& cm) {
  unsigned e = 0;
  if constexpr (REDUCE) {
    __shared__ unsigned s_e;
    hopper::grid_dep_wait();
    if (threadIdx.x == 0) s_e = comm_next_epoch(cm, cm.rank);
    __syncthreads();
    e = s_e;
    const int tiles = (hidden + COMM_TILE - 1) / COMM_TILE;
    for (int t = threadIdx.x; t < cm.size * tiles; t += blockDim.x)
      comm_wait(cm, cm.rank, t / tiles, t % tiles, e);
    __syncthreads();               // every flag seen
    if (threadIdx.x == 0) comm_set_epoch(cm, cm.rank, e);
    hopper::grid_dep_launch_dependents();
  } else {
    hopper::grid_dep_launch_dependents();
    hopper::grid_dep_wait();
  }
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * hidden;
  auto b_at = [&](int i) {
    return b_bf16 ? __bfloat162float(b_bf16[row + i]) : (b ? b[row + i] : 0.f);
  };
  if constexpr (REDUCE) {
    // The row held in registers (hidden <= NORM_ROW * blockDim.x): each
    // slot is read once, and every load is issued before the first store.
    // Element i = threadIdx.x + k * blockDim.x and the sum of squares in k
    // order, as in the loop below: the same bits.
    float av[NORM_ROW], bv[NORM_ROW];
#pragma unroll
    for (int k = 0; k < NORM_ROW; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      av[k] = i < hidden ? comm_sum<float>(cm, cm.rank, e, i) : 0.f;
      bv[k] = i < hidden ? b_at(i) : 0.f;
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NORM_ROW; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < hidden) {
        const float r = av[k] + bv[k];
        ss += r * r;
        if (r_out) r_out[i] = r;
        if (x_out) x_out[i] = __float2bfloat16(av[k]);
        if (res_out) res_out[i] = __float2bfloat16(bv[k]);
      }
    }
    const float inv = rsqrtf(block_sum(ss, red) / hidden + eps);
    if (w) {
#pragma unroll
      for (int k = 0; k < NORM_ROW; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
        if (i < hidden)
          xn[i] = __float2bfloat16((av[k] + bv[k]) * inv * __bfloat162float(w[i]));
      }
    }
    return;
  }
  auto a_at = [&](int i) {
    return a_bf16 ? __bfloat162float(a_bf16[row + i]) : a[row + i];
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

__global__ void __launch_bounds__(NORM_THREADS)
resnorm_kernel(const float* a, const __nv_bfloat16* a_bf16, const float* b,
               const __nv_bfloat16* b_bf16, const __nv_bfloat16* w, float* r_out,
               __nv_bfloat16* r_bf16, __nv_bfloat16* xn, __nv_bfloat16* x_out,
               __nv_bfloat16* res_out, int hidden, float eps, float* z1, int n1,
               float* z2, int n2) {
  resnorm_body<false>(a, a_bf16, b, b_bf16, w, r_out, r_bf16, xn, x_out, res_out, hidden,
                      eps, z1, n1, z2, n2, CfComm{});
}

// One row: a = the reduce's rank-order sum (REDUCE above), b from `b`.
__global__ void __launch_bounds__(NORM_THREADS)
resnorm_reduce_kernel(CfComm cm, const float* b, const __nv_bfloat16* w, float* r_out,
                      __nv_bfloat16* xn, __nv_bfloat16* x_out, __nv_bfloat16* res_out,
                      int hidden, float eps) {
  resnorm_body<true>(nullptr, nullptr, b, nullptr, w, r_out, nullptr, xn, x_out, res_out,
                     hidden, eps, nullptr, 0, nullptr, 0, cm);
}

// ---- The ring GEMV: one row of x against a bf16 [K, N] matrix, fixed order ----
//
// y[mat*yz + n] = sum_k x[k] * W[k, n] for the matrix mat = blockIdx.z, W =
// w + mat*ws a bf16 [K, N] matrix (row-major, N a multiple of 8).  x is
// bf16, or (SWIGLU) the float32 gate/up row, x[k] = bf16(silu(gate[k]) *
// up[k]) with up at f_off past gate, or (nw given) the RMSNorm of the bf16
// row, x[k] = bf16(x[k] * rsqrt(mean(x^2) + eps) * nw[k]), each block
// summing the whole row's squares itself.  y is float32, or bf16(y) goes to
// yb instead when yb is given.  The bs=1 stack, the standalone gemv and
// the MLA layer run it.  Bound by bytes, so the design keeps as many
// weight bytes in flight as the SMs' shared memory holds:
// - Weights through shared memory.  A block owns one 256-column tile
//   (blockIdx.y) and one K chunk (blockIdx.x).  Its producer warp streams
//   the chunk's rows of the tile, 32 rows (16 KB) per stage, through a ring
//   of G1_STAGES stages (measured best on the H100,
//   scripts/tune_torch_gemv.py) behind `full`/`empty` mbarriers, one 1-D
//   bulk copy (cp.async.bulk) per 512-byte row segment, one row per lane.
//   x is staged once per block in shared memory as float32 [k].
// - The consumer warps (`threads` of them, 32 each) take the rows of a
//   stage in turn, each lane 8 adjacent columns of a weight row (one
//   16-byte shared load), in float32 FMAs; the block sums its warps in
//   order.
// - The K chunks of a tile meet inside a thread-block cluster.  The ks
//   blocks of a tile form one cluster (cluster rank = blockIdx.x).  Each
//   block leaves its [256] f32 sums in its own shared memory; after a
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
// - Where the sums go (PUSH): to y (G1_Y), or, in mode 5 of the stack
//   (collective.cu), into slot `rank` of every rank's symmetric buffer at
//   the tile's columns, each block its share of the tile's sum, and after
//   the cluster barrier the tile's flag is published to every rank:
//   G1_PUSH_SUM for a reduce (the O and down projections' partials, which
//   the norm after them sums), G1_PUSH_GATHER for the logits' gather (this
//   rank's vocab shard of the LM head, which gather_wait_kernel copies out
//   in rank order).  The two push alike; the gather has an instance of its
//   own so that a profile names the step's LM product apart from its O
//   projections.
// - Int8 weights (ring_gemv8_kernel; kernel 7's int8 mode, the TPU
//   kernel's wq_kind == "int8"): W holds int8 codes and sc float32
//   per-column scales, a row of N per scale group.  A stage keeps its 16
//   KB: 64 rows of 256 bytes (G1_ROWS8), so the bytes in flight per SM do
//   not halve, and it arrives as one TMA box of a 3-D tensor map over the
//   stacked matrices (one copy a stage, where a bulk copy per 256-byte row
//   issued twice the bf16 path's copies per byte and streamed at 1.9 TB/s
//   on the H100).  A lane reads its 8 columns of a row as one 8-byte shared
//   load and makes exact floats of them with byte permutes (no int-to-float
//   conversion instruction, which issues at a fraction of the FMA rate), so
//   the consumers' FMA chain and the block's fixed-order sums are the bf16
//   path's.  Scales: kg == 0 scales each sum by sc[mat*N + n] after the
//   cluster sum (QKV per head group, gate/up, down, the LM head); kg > 0
//   (the O projection, a stack of G matrices of kg rows summed as one)
//   scales each block's partial by sc[(k0 / kg)*N + n] before the cluster
//   sum, and the launcher picks K chunks that never straddle a group.
//   Mode 5 of the stack in int8 (PUSH other than G1_Y, the TPU kernel's
//   wq_kind == "int8" with reduce_axis): kg == 0 scales each sum before it
//   is pushed, kg > 0 as above, so every rank pushes scaled partials; the
//   scale is the same on every rank, so it commutes with the sum over the
//   ranks, and the flags and epochs are the bf16 instance's.
// - Int4 weights (ring_gemv4_kernel<SWIGLU, PUSH, A8>; kernel 7's int4 modes, the
//   TPU kernel's wq_kind == "int4"): W holds codes packed two a byte along
//   K through the int8 map over the K/2 packed rows, sc float32 group
//   scales of GS4 k rows.  A stage keeps its 16 KB box: 64 packed rows,
//   128 k rows, one scale group, so K chunks are whole groups.  Exact
//   (W4A16): a byte of a lane's 8-byte load becomes a bf16 pair of codes
//   (s4_bf16_pairs), times the column's bf16 scale rounded once to bf16
//   (the TPU kernels' _dequant_int4_tile), then the bf16 path's FMA chain.
//   A8 (W4A8, KernelConfig.int4_w4a8): x is quantized to int8 against the
//   absmax of its activation block (kg > 0: the block of kg k rows holding
//   the chunk; 0: the row), as the TPU kernel quantizes each x it passes to
//   w4a8_int4_dot; each warp sums a group's products in int32 with dp4a
//   (exact), scales the sums by the column's scale at the group's end, and
//   each block's partial is scaled by x's scale before the cluster sum.
//   Mode 5 in int4 (G1_PUSH_SUM; the TPU kernel's "int4" with
//   reduce_axis): what is pushed is already scaled (the group scales
//   inside the sum, W4A8's x scale on each block's partial before the
//   cluster sum); the group scales are the same on every rank, so the sum
//   over the ranks is the sum of what each would have written.  The LM
//   head is never int4, so there is no int4 G1_PUSH_GATHER instance.
// (M, nrc and xrows are always 1 here; the row arithmetic stays general.)
constexpr int G1_Y = 0, G1_PUSH_SUM = 1, G1_PUSH_GATHER = 2;
constexpr int G1_COLS = 256;                       // columns per tile
constexpr int G1_ROW_BYTES = G1_COLS * 2;          // 512 B per weight row
constexpr int G1_ROWS = 32;                        // weight rows per stage
constexpr int G1_STAGES = 4;                       // ring stages
constexpr int G1_STAGE_BYTES = G1_ROWS * G1_ROW_BYTES;
constexpr int G1_ROWS8 = G1_STAGE_BYTES / G1_COLS; // int8 weight rows per stage (64)
constexpr int G1_HEAD = 256;                       // barriers, the norm's warp sums, epoch
constexpr int G1_SMEM_MAX = 227 * 1024;
constexpr int G1_MAX_THREADS = 1024 - 32;          // consumers beside the producer
constexpr int G1_MAX_CLUSTER = 16;                 // non-portable; 8 is portable
static_assert(G1_COLS == COMM_TILE, "a reduce's flag column is one tile");
static_assert(2 * G1_STAGES * sizeof(uint64_t) + 4 * (G1_MAX_THREADS / 32) + 8 <= G1_HEAD,
              "barriers, the norm's sums, W4A8's x scale and the epoch overflow the head");
static_assert(G1_STAGES * G1_STAGE_BYTES >= 4 * G1_COLS * (G1_MAX_THREADS / 32 + 1),
              "the ring must hold the blocks' sums after the last stage");

inline size_t ring_gemv_smem(int k_chunk) {
  return (size_t)G1_HEAD + (size_t)G1_STAGES * G1_STAGE_BYTES + 4 * (size_t)k_chunk;
}

// Eight int8 codes packed in 8 bytes -> eight floats, exactly: byte b of a
// word, biased by 128 (xor 0x80), becomes the low byte of the float
// 2^23 + 128 + v (one byte permute), and a subtraction leaves v.
__device__ __forceinline__ void unpack8_s8(const uint2& u, float* f) {
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440 + b)) - 8388736.f;
}

// Two words of four int8 codes, k rows r (a) and r + 1 (b) of four
// columns, -> four bf16 pairs, pair i = (bf16(a_i) low, bf16(b_i) high),
// exactly: the codes' exact floats (unpack8_s8) and their high halves by a
// byte permute (an integer of at most 8 significant bits is a bf16).  (A
// form in bf16 pairs, a byte permute, two logic ops and a bf16x2
// subtraction a pair, issues fewer instructions but measured 2-9 % slower
// on the H100, scripts/tune_torch_gemv.py --int8.)
__device__ __forceinline__ void s8_bf16_pairs(uint32_t a, uint32_t b, uint32_t (&p)[4]) {
  float f[8];
  unpack8_s8(make_uint2(a, b), f);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __byte_perm(__float_as_uint(f[i]), __float_as_uint(f[4 + i]), 0x7632);
}

// The weight kinds of the GEMV bodies: bf16, int8 codes, int4 codes with
// the exact product (W4A16) or with x quantized to int8 (W4A8).
constexpr int WK_BF16 = 0, WK_INT8 = 1, WK_INT4 = 2, WK_INT4A8 = 3;
// The int4 scale group (k rows): one 16 KB stage of packed codes.
constexpr int GS4 = 128;

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// Four bytes of int4 codes (byte i: k row 2b in the low nibble, 2b + 1 in
// the high, of column i) -> four bf16 pairs, pair i = (bf16(lo_i) low half,
// bf16(hi_i) high half), exactly: the nibbles, biased by 8 (xor), become
// the low mantissa bits of the bf16 128 + u (a byte permute and a lop3 a
// pair), and a bf16x2 subtraction of 136 leaves the signed code (-8..7).
__device__ __forceinline__ void s4_bf16_pairs(uint32_t w, uint32_t (&p)[4]) {
  const uint32_t b = w ^ 0x88888888u, h = b >> 4;
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t t = (__byte_perm(b, h, i | ((4 + i) << 8)) & 0x000F000Fu) | 0x43004300u;
    p[i] = bf162_bits(__hsub2(bits_bf162(t), bias));
  }
}

// dp4a: d = c + sum of the four byte products of a and b (a's bytes
// unsigned, b's signed; ss: both signed), exact in int32.
__device__ __forceinline__ int dp4a_us(uint32_t a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ int dp4a_ss(int a, int b, int c) {
  int d;
  asm("dp4a.s32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Four columns of two packed int4 rows (w0: k rows 4p, 4p + 1 of columns
// 0-3, a byte each; w1: k rows 4p + 2, 4p + 3) against xw, x8 of those four
// k rows: a_c += sum over the four k rows of (code + 8) * x8.  The codes,
// biased to 0..15 by an xor, are regrouped column by column with byte
// permutes so that one dp4a takes a column's four.
__device__ __forceinline__ void s4_dot4(uint32_t w0, uint32_t w1, int xw, int& a0, int& a1,
                                        int& a2, int& a3) {
  const uint32_t b0 = w0 ^ 0x88888888u, b1 = w1 ^ 0x88888888u;
  const uint32_t l0 = b0 & 0x0F0F0F0Fu, h0 = (b0 >> 4) & 0x0F0F0F0Fu;
  const uint32_t l1 = b1 & 0x0F0F0F0Fu, h1 = (b1 >> 4) & 0x0F0F0F0Fu;
  const uint32_t p0 = __byte_perm(l0, h0, 0x5140), p1 = __byte_perm(l0, h0, 0x7362);
  const uint32_t q0 = __byte_perm(l1, h1, 0x5140), q1 = __byte_perm(l1, h1, 0x7362);
  a0 = dp4a_us(__byte_perm(p0, q0, 0x5410), xw, a0);
  a1 = dp4a_us(__byte_perm(p0, q0, 0x7632), xw, a1);
  a2 = dp4a_us(__byte_perm(p1, q1, 0x5410), xw, a2);
  a3 = dp4a_us(__byte_perm(p1, q1, 0x7632), xw, a3);
}

// A code pair times its column's bf16 scale pair, rounded once to bf16 (the
// TPU kernels' _dequant_int4_tile, a bf16 multiply).
__device__ __forceinline__ uint32_t scale_pair(uint32_t p, uint32_t s2) {
  return bf162_bits(__hmul2(bits_bf162(p), bits_bf162(s2)));
}

// bf16(s) in both halves of a register.
__device__ __forceinline__ uint32_t bf16_pair_of(float s) {
  return bf162_bits(__float2bfloat162_rn(s));
}

// W4A8's activation quantization of one value (the JAX package's
// w4a8_int4_dot): rint(x / xs) in float32, round half to even.
__device__ __forceinline__ float quant_x8(float x, float xs) {
  return rintf(__fdiv_rn(x, xs));
}

// The body of the ring GEMV kernels: bf16 weights w (WK_BF16; wmap, mat0,
// sc and kg unused), int8 codes through wmap with their scales (WK_INT8, w
// unused) or int4 codes through wmap with their group scales (WK_INT4,
// WK_INT4A8; w unused).
template <bool SWIGLU, int PUSH, int WK>
__device__ __forceinline__ void ring_gemv_body(
    const void* __restrict__ xv, long long x_row, int f_off, const void* __restrict__ w,
    float* __restrict__ y, __nv_bfloat16* __restrict__ yb, int M, int K, int N, int k_chunk,
    int nrc, int xrows, long long ws, long long y_row, long long yz,
    const __nv_bfloat16* __restrict__ nw, float eps, CfComm comm,
    const CUtensorMap* wmap, int mat0, const float* __restrict__ sc, int kg) {
  namespace cg = cooperative_groups;
  constexpr int RB = 1;                                     // rows per block
  constexpr int NS = G1_STAGES, SB = G1_STAGE_BYTES;
  constexpr bool W8 = WK == WK_INT8, W4 = WK >= WK_INT4, A8 = WK == WK_INT4A8;
  constexpr int ROWS = W8 || W4 ? G1_ROWS8 : G1_ROWS;      // weight rows per stage
  constexpr int EB = W8 || W4 ? 1 : 2;                      // bytes per weight
  constexpr int KR = W4 ? 2 : 1;                            // k rows per weight row
  constexpr int RS = G1_COLS * EB;                          // bytes per row of a stage
  extern __shared__ __align__(128) unsigned char g1_sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(g1_sm);     // [NS]
  uint64_t* empty = full + NS;                              // [NS]
  unsigned char* ring = g1_sm + G1_HEAD;                    // [NS][ROWS][RS bytes]
  float* xs1 = reinterpret_cast<float*>(ring + NS * SB);   // [k_chunk]
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int ncw = blockDim.x / 32 - 1;                      // consumer warps
  const int rank = blockIdx.x, ks = gridDim.x;
  const int mat = blockIdx.z / nrc, r0 = (blockIdx.z % nrc) * RB;
  const int nr = min(RB, M - r0);
  const int n0 = blockIdx.y * G1_COLS;
  const int cols = min(G1_COLS, N - n0);
  const uint32_t seg = (uint32_t)cols * EB;
  const int k0 = rank * k_chunk, kn = min(k_chunk, K - k0);
  const int nst = (kn + ROWS * KR - 1) / (ROWS * KR);
  const unsigned char* wp =        // bf16: this block's first row segment
      W8 || W4 ? nullptr
         : static_cast<const unsigned char*>(w) + ((size_t)mat * ws + (size_t)k0 * N + n0) * EB;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], ncw);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // producer: stage st's rows, one bulk copy per row, lanes in parallel
  // (int8: the stage's box of the tensor map, rows past K and columns past
  // N zero-filled; rows past the chunk arrive and are not read; int4: the
  // box of packed rows, 128 k rows, one scale group)
  auto issue = [&](int st) {
    const int s = st % NS;
    if constexpr (W8 || W4) {
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)SB);
        hopper::tma_load_3d(ring + s * SB, wmap, &full[s], n0, k0 / KR + st * ROWS,
                            mat0 + mat);
      }
    } else {
      const int rows = min(ROWS, kn - st * ROWS);
      if (lane == 0) hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)rows * seg);
      __syncwarp();
      for (int r = lane; r < rows; r += 32)
        hopper::bulk_load_1d(ring + s * SB + r * RS,
                             wp + (size_t)(st * ROWS + r) * N * EB, seg, &full[s]);
    }
  };
  if (wid == 0)
    for (int st = 0; st < min(NS, nst); ++st) issue(st);
  hopper::grid_dep_launch_dependents();
  hopper::grid_dep_wait();

  float acc[8];                                             // 8 columns a lane
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  if (wid == 0) {
    for (int st = NS; st < nst; ++st) {
      hopper::mbar_wait(&empty[st % NS], (st / NS - 1) & 1);
      issue(st);
    }
  } else {
    const int ct = blockDim.x - 32;
    if constexpr (A8) {
      // W4A8: x quantized to int8 against the absmax of its activation
      // block (kg > 0: the kg rows holding this chunk, which the launcher
      // keeps inside one; 0: the whole row), as the TPU kernels quantize
      // each block they pass to w4a8_int4_dot; xs goes to the head's
      // second-to-last word, and xs1 holds x8, four int8 k rows a word
      auto xval = [&](int k) {
        if constexpr (SWIGLU) {
          const float* gu = static_cast<const float*>(xv);
          const float g = gu[k], u = gu[f_off + k];
          return bf16_round(g / (1.f + expf(-g)) * u);
        } else {
          return __bfloat162float(static_cast<const __nv_bfloat16*>(xv)[k]);
        }
      };
      const int xb = kg > 0 ? kg : K, xb0 = k0 / xb * xb;
      float* nred = reinterpret_cast<float*>(empty + NS);     // [ncw], in the head
      float am = 0.f;
      for (int i = tid - 32; i < xb; i += ct) am = fmaxf(am, fabsf(xval(xb0 + i)));
      am = warp_max(am);
      if (lane == 0) nred[wid - 1] = am;
      hopper::named_barrier_sync(1, ct);
      for (int q = 0; q < ncw; ++q) am = fmaxf(am, nred[q]);
      const float xs = fmaxf(am, 1e-8f) * (1.f / 127.f);
      if (tid == 32) reinterpret_cast<float*>(g1_sm + G1_HEAD)[-2] = xs;
      int* xq = reinterpret_cast<int*>(xs1);    // x8, four k rows a word
      for (int i = tid - 32; i < kn / 4; i += ct) {
        uint32_t w = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          w |= ((uint32_t)(int)quant_x8(xval(k0 + 4 * i + b), xs) & 0xffu) << (8 * b);
        xq[i] = (int)w;
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
    const bool live = lane * 8 < cols;
    if constexpr (W4) {
      // int4: a stage is one scale group; a lane's 8-byte load is 8 columns
      // of packed row r, k rows 2r and 2r + 1.  Exact (W4A16): the weights
      // bf16(code * bf16(s)), the bf16 path's FMA chain.  W4A8: a warp takes
      // packed rows in pairs (k rows 4p .. 4p + 3) and sums each column's
      // four products in one dp4a of its biased codes against x8, exact in
      // int32; at the stage's end the warp's integer sums of the group, less
      // 8 * sum(x8) for the bias, are scaled by bf16(s) into acc.  The
      // lane's scales are read before the stage's wait.
      const float* sg = sc + ((size_t)mat * (K / GS4) + k0 / GS4) * N + n0 + lane * 8;
      for (int st = 0; st < nst; ++st) {
        const int s = st % NS;
        float scl[8];
        if (live) {
          const float4* s4 = reinterpret_cast<const float4*>(sg + (size_t)st * N);
          const float4 a = __ldg(s4), b = __ldg(s4 + 1);
          scl[0] = a.x; scl[1] = a.y; scl[2] = a.z; scl[3] = a.w;
          scl[4] = b.x; scl[5] = b.y; scl[6] = b.z; scl[7] = b.w;
        }
        hopper::mbar_wait(&full[s], (st / NS) & 1);
        const int rows = min(ROWS, (kn - st * GS4) / 2);
        if (live) {
          const unsigned char* base = ring + s * SB + lane * 8;
          if constexpr (A8) {
            const int* xk = reinterpret_cast<const int*>(xs1) + st * (GS4 / 4);
            int part[8], sx = 0;
#pragma unroll
            for (int c = 0; c < 8; ++c) part[c] = 0;
            for (int q = wid - 1; q < rows / 2; q += ncw) {
              const uint2 u0 = *reinterpret_cast<const uint2*>(base + 2 * q * RS);
              const uint2 u1 = *reinterpret_cast<const uint2*>(base + (2 * q + 1) * RS);
              const int xw = xk[q];
              sx = dp4a_ss(xw, 0x01010101, sx);
              s4_dot4(u0.x, u1.x, xw, part[0], part[1], part[2], part[3]);
              s4_dot4(u0.y, u1.y, xw, part[4], part[5], part[6], part[7]);
            }
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[c] = fmaf((float)(part[c] - 8 * sx), bf16_round(scl[c]), acc[c]);
          } else {
            const float* xk = xs1 + st * GS4;
            uint32_t s2[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) s2[c] = bf16_pair_of(scl[c]);
            for (int r = wid - 1; r < rows; r += ncw) {
              const uint2 u = *reinterpret_cast<const uint2*>(base + r * RS);
              uint32_t p[2][4];
              s4_bf16_pairs(u.x, p[0]);
              s4_bf16_pairs(u.y, p[1]);
              const float x0 = xk[2 * r], x1 = xk[2 * r + 1];
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                const uint32_t w2 = scale_pair(p[c / 4][c % 4], s2[c]);
                acc[c] = fmaf(x0, __uint_as_float(w2 << 16), acc[c]);
                acc[c] = fmaf(x1, __uint_as_float(w2 & 0xffff0000u), acc[c]);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
    } else {
    for (int st = 0; st < nst; ++st) {
      const int s = st % NS;
      hopper::mbar_wait(&full[s], (st / NS) & 1);
      const int rows = min(ROWS, kn - st * ROWS);
      const unsigned char* stage = ring + s * SB;
      if (live) {
        const unsigned char* base = stage + lane * 8 * EB;
        const float* xk = xs1 + st * ROWS;
        for (int r = wid - 1; r < rows; r += ncw) {
          float f[8];
          if constexpr (W8)
            unpack8_s8(*reinterpret_cast<const uint2*>(base + r * RS), f);
          else
            unpack8(*reinterpret_cast<const uint4*>(base + r * RS), f);
          const float xr = xk[r];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[c] = fmaf(xr, f[c], acc[c]);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    }
  }
  __syncthreads();   // every stage issued has landed and been read: the ring is free
  float* red = reinterpret_cast<float*>(ring);              // [ncw][G1_COLS]
  float* part = red + ncw * G1_COLS;                        // [RB][G1_COLS]
  if (wid > 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) red[(wid - 1) * G1_COLS + lane * 8 + c] = acc[c];
  }
  __syncthreads();
  for (int c = tid; c < G1_COLS; c += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < ncw; ++q) s += red[q * G1_COLS + c];
    if constexpr (W8)      // the block's scale group (K chunks never straddle one)
      if (kg > 0 && c < cols) s *= sc[(size_t)(k0 / kg) * N + n0 + c];
    if constexpr (A8)      // the block's activation scale (W4A8)
      s *= reinterpret_cast<const float*>(g1_sm + G1_HEAD)[-2];
    part[c] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // (row, column) sums per rank; PUSH: whole 16-byte units of columns
  const int per = PUSH != G1_Y ? 4 * ((G1_COLS / 4 + ks - 1) / ks) : (nr * G1_COLS + ks - 1) / ks;
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
      if constexpr (PUSH != G1_Y) {
        if constexpr (W8)                 // the per-column scale, before the push
          if (kg == 0) s *= sc[(size_t)mat * N + n0 + c];
        red[i] = s;                       // red is free once the cluster has met
      } else {
        if constexpr (W8)                 // the matrix's per-column scale
          if (kg == 0) s *= sc[(size_t)mat * N + n0 + c];
        const size_t at = (size_t)(r0 + b) * y_row + (size_t)mat * yz + n0 + c;
        if (yb)
          yb[at] = __float2bfloat16(s);
        else
          y[at] = s;
      }
    }
  }
  if constexpr (PUSH != G1_Y) {
    // mode 5's producer (collective.cu): this block's share of the tile's
    // sums, 16 bytes a store, into slot comm.rank of every rank's buffer;
    // after the cluster barrier (which orders every block's stores before
    // it) rank 0 of the cluster publishes the tile's flag to every rank.
    // One thread a block reads the epoch into the head's last word.
    unsigned* s_ep = reinterpret_cast<unsigned*>(g1_sm + G1_HEAD) - 1;   // the head's last word
    if (tid == 0) *s_ep = comm_next_epoch(comm, comm.rank);
    const int units = per / 4;
    __syncthreads();
    const unsigned ep = *s_ep;
    for (int u = tid; u < units * comm.size; u += blockDim.x) {
      const int p = u / units, j = u % units, c = rank * per + 4 * j;
      if (c < cols)
        comm_push(comm, comm.rank, p, ep, (n0 + c) / 4,
                  *reinterpret_cast<const uint4*>(red + 4 * j));
    }
    cluster.sync();
    if (rank == 0 && tid < comm.size) comm_publish(comm, comm.rank, tid, blockIdx.y, ep);
  } else {
    cluster.sync();
  }
}

template <bool SWIGLU, int PUSH>
__global__ void ring_gemv_kernel(const void* __restrict__ xv, long long x_row, int f_off,
                                 const __nv_bfloat16* __restrict__ w,
                                 float* __restrict__ y, __nv_bfloat16* __restrict__ yb,
                                 int M, int K, int N, int k_chunk, int nrc, int xrows,
                                 long long ws, long long y_row, long long yz,
                                 const __nv_bfloat16* __restrict__ nw, float eps,
                                 CfComm comm) {
  ring_gemv_body<SWIGLU, PUSH, WK_BF16>(xv, x_row, f_off, w, y, yb, M, K, N, k_chunk, nrc,
                                        xrows, ws, y_row, yz, nw, eps, comm, nullptr, 0,
                                        nullptr, 0);
}

// The int8 instance: the codes through wmap (int8 [nmats][K][N], boxes of
// G1_ROWS8 x G1_COLS; matrix mat0 + blockIdx.z), sc float32 scales, kg as
// above; PUSH and comm as the bf16 instance's.
template <bool SWIGLU, int PUSH>
__global__ void ring_gemv8_kernel(const void* __restrict__ xv, long long x_row, int f_off,
                                  const __grid_constant__ CUtensorMap wmap, int mat0,
                                  float* __restrict__ y, __nv_bfloat16* __restrict__ yb,
                                  int M, int K, int N, int k_chunk, int nrc, int xrows,
                                  long long y_row, long long yz,
                                  const __nv_bfloat16* __restrict__ nw, float eps,
                                  const float* __restrict__ sc, int kg, CfComm comm) {
  ring_gemv_body<SWIGLU, PUSH, WK_INT8>(xv, x_row, f_off, nullptr, y, yb, M, K, N, k_chunk,
                                        nrc, xrows, 0, y_row, yz, nw, eps, comm, &wmap, mat0,
                                        sc, kg);
}

// The int4 instance (kernels 7 and 8 at one row, kernel 9 at B 1, the int4
// serving products at M 1; the TPU kernels' wq_kind == "int4"): the packed
// codes through wmap (int8 [nmats][K/2][N], boxes of G1_ROWS8 packed rows,
// 128 k rows, x G1_COLS; matrix mat0 + blockIdx.z), sc float32 group
// scales [nmat][K/GS4][N] (the TPU kernels stream them rounded to bf16; so
// does this kernel's exact mode, and quantize_int4 makes them bf16 values),
// y written (G1_Y), or the sums pushed (G1_PUSH_SUM: mode 5's O and down
// products; every sum is already scaled, so the ranks' partials add).  A8
// (W4A8, KernelConfig.int4_w4a8): x quantized to int8 per activation block
// of kg rows (0: the whole row).
template <bool SWIGLU, int PUSH, bool A8>
__global__ void ring_gemv4_kernel(const void* __restrict__ xv, long long x_row, int f_off,
                                  const __grid_constant__ CUtensorMap wmap, int mat0,
                                  float* __restrict__ y, __nv_bfloat16* __restrict__ yb,
                                  int M, int K, int N, int k_chunk, int nrc, int xrows,
                                  long long y_row, long long yz,
                                  const __nv_bfloat16* __restrict__ nw, float eps,
                                  const float* __restrict__ sc, int kg, CfComm comm) {
  ring_gemv_body<SWIGLU, PUSH, A8 ? WK_INT4A8 : WK_INT4>(
      xv, x_row, f_off, nullptr, y, yb, M, K, N, k_chunk, nrc, xrows, 0, y_row, yz, nw, eps,
      comm, &wmap, mat0, sc, kg);
}

// The tensor map ring_gemv8_kernel reads: nmats int8 [K, N] matrices
// (row-major, K*N bytes apart) from w, in boxes of G1_ROWS8 rows of
// G1_COLS columns.  N must be a multiple of 16 and w 16-byte aligned.
inline bool make_int8_weight_map(CUtensorMap* map, const void* w, int K, int N,
                                 long long nmats) {
  return hopper::make_tensor_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, nmats,
                                    (uint64_t)N, (uint64_t)K * N, G1_COLS, G1_ROWS8, 1,
                                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Launch ring_gemv_kernel<SWIGLU, PUSH> over one row and nmat [K, N] matrices,
// with one producer warp per block beside `threads` consumer threads (a
// multiple of 32, at most G1_MAX_THREADS); `pdl` adds programmatic
// dependent launch.  The K chunks per tile (the cluster size ks, at most 16
// where the card allows non-portable clusters, else 8, with at least two
// stages of rows per block) are the most for which every cluster of the
// grid is resident at once (cudaOccupancyMaxActiveClusters).  nw: x is
// normalised first.  PUSH other than G1_Y (mode 5's producer; comm given,
// one matrix): y is not written; the sums go to the ranks' slots instead,
// one flag column per tile (at most COMM_FLAG_COLS tiles, 4N bytes at most
// a slot).  WK_INT8: w is unused; ring_gemv8_kernel reads the
// matrices mat0.. of wmap (make_int8_weight_map; N a multiple of 16) with
// the scales sc and the scale group kg; kg > 0 keeps only the chunkings
// whose chunks divide kg, and where none of those has every cluster
// resident, the one of them with the most chunks.  WK_INT4 / WK_INT4A8
// (G1_Y or G1_PUSH_SUM, no nw): ring_gemv4_kernel over the packed matrices of wmap
// (make_int4_map at one row), K a multiple of GS4, chunks multiples of GS4
// (one scale group a stage), sc the group scales, kg W4A8's activation
// block (chunks kept inside one, as above).  Returns a cudaError_t.
template <bool SWIGLU, int PUSH = G1_Y, int WK = WK_BF16>
int launch_gemv1(const void* x, int f_off, const void* w, float* y, int K, int N,
                 int nmat, long long ws, long long yz, int threads, bool pdl,
                 cudaStream_t st, __nv_bfloat16* yb = nullptr,
                 const __nv_bfloat16* nw = nullptr, float eps = 0.f,
                 const CfComm* comm = nullptr, const CUtensorMap* wmap = nullptr,
                 int mat0 = 0, const float* sc = nullptr, int kg = 0) {
  if ((nw && SWIGLU) || K < 1 || N < 8 || N % 8 != 0 || nmat < 1 || threads < 32 ||
      threads % 32 != 0 || threads > G1_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  constexpr bool W8 = WK == WK_INT8, W4 = WK >= WK_INT4;
  if (W8 && (!wmap || !sc || N % 16 != 0 || kg < 0 ||
             (kg > 0 && (K % kg != 0 || nmat != 1))))
    return (int)cudaErrorInvalidValue;
  if (W4 && (!wmap || !sc || nw || PUSH == G1_PUSH_GATHER || N % 16 != 0 || K % GS4 != 0 ||
             kg < 0 || (kg > 0 && (K % kg != 0 || kg % GS4 != 0))))
    return (int)cudaErrorInvalidValue;
  if (PUSH != G1_Y && (!comm || nmat != 1 || (N + G1_COLS - 1) / G1_COLS > COMM_FLAG_COLS ||
                       4LL * N > comm->slot_bytes))
    return (int)cudaErrorInvalidValue;
  constexpr int ROWS = W4 ? GS4 : W8 ? G1_ROWS8 : G1_ROWS;  // k rows per stage
  static bool attrs_set = false;
  static int max_cluster = 8;
  struct Occ { int ks, threads; size_t smem; int clusters; };
  static Occ occ_cache[64];
  static int n_occ = 0;
  auto kern = [] {
    if constexpr (W4) return ring_gemv4_kernel<SWIGLU, PUSH, WK == WK_INT4A8>;
    else if constexpr (W8) return ring_gemv8_kernel<SWIGLU, PUSH>;
    else return ring_gemv_kernel<SWIGLU, PUSH>;
  }();
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
  const int tiles = (N + G1_COLS - 1) / G1_COLS;
  const int want = tiles * nmat;               // clusters of the grid
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
    cfg.gridDim = dim3(ks, tiles, nmat);
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
  int ks = 0, k_chunk = K;
  // at least two stages a block, but W4A8 chunks inside activation blocks
  // of one scale group take one
  int cmax = std::max(1, K / (2 * ROWS));
  if (W4 && kg > 0) cmax = std::max(cmax, K / kg);
  for (int c = std::min(max_cluster, cmax); c >= 1; --c) {
    // int4: chunks of whole scale groups
    const int kc = W4 ? ((K + c - 1) / c + GS4 - 1) / GS4 * GS4 : (K + c - 1) / c;
    if ((K + kc - 1) / kc != c) continue;               // every rank has rows
    if (kg > 0 && kg % kc != 0) continue;               // a chunk inside one scale group
    const size_t smem = ring_gemv_smem(kc);
    if (smem > (size_t)G1_SMEM_MAX) break;              // x chunk too large
    ks = c;
    k_chunk = kc;
    if (c == 1 || clusters(c, smem) >= want) break;
  }
  if (ks < 1) return (int)cudaErrorInvalidValue;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(ks, tiles, nmat);
  cfg.dynamicSmemBytes = ring_gemv_smem(k_chunk);
  cfg.numAttrs = pdl ? 2 : 1;
  if constexpr (W8 || W4)
    return (int)cudaLaunchKernelEx(&cfg, kern, x, 0LL, f_off, *wmap, mat0, y, yb, 1, K, N,
                                   k_chunk, 1, 1, 0LL, yz, nw, eps, sc, kg,
                                   comm ? *comm : CfComm{});
  else
    return (int)cudaLaunchKernelEx(&cfg, kern, x, 0LL, f_off,
                                   static_cast<const __nv_bfloat16*>(w), y, yb, 1, K, N,
                                   k_chunk, 1, 1, ws, 0LL, yz, nw, eps,
                                   comm ? *comm : CfComm{});
}

// ---- The rows GEMV: 2..16 rows of x per block against bf16 [K, N] matrices ----
//
// y[r*y_row + mat*yz + n] = sum_k x[r, k] * W[k, n] for the rows r0.. of
// blockIdx.z's row chunk (up to RG_MAX_ROWS rows) and the matrix mat =
// blockIdx.z / nrc, W the [K, N] bf16 slab `mat` of the weight tensor map
// (rows N*2 bytes apart; N a multiple of 8); x bf16 rows x_row apart (a
// multiple of 8).  y is float32, or bf16(y) goes to yb when yb is given.
// PAIR (the SwiGLU FFN's gate/up product): W holds two slabs, gate and up,
// and yb[r*y_row + n] = bf16(silu(gate[r, n]) * up[r, n]), the x of the
// down projection, computed once per element where the down product's
// blocks would each compute their chunk of it.  The verify stack (kernel
// 8) and the paged layer (kernel 9) run it at n and B rows.  Bound by
// bytes (2 rows' operations per weight byte at most 32, far under the
// card's ~295), so the design is a weight stream with the products riding
// on it:
// - Weights and x as TMA boxes.  A block owns one tile of 256 columns
//   (blockIdx.y; PAIR: 128 columns of gate and the same of up) and one K
//   chunk (blockIdx.x, a multiple of RG_ROWS rows).  Its producer warp's
//   lane 0 copies each stage as four boxes of weights [RG_ROWS][64]
//   (128-byte rows, 128-byte swizzle) and one box of x [rows][RG_ROWS]
//   (64-byte rows, 64-byte swizzle) into a ring of RG_STAGES stages behind
//   `full`/`empty` mbarriers: four weight copies a stage where a bulk copy
//   per 512-byte row took 32, and no pad.  The weight boxes of the first
//   stages go out before griddepcontrol.wait (weights depend on nothing
//   earlier), x's after it; no thread stages x, so no bubble opens while
//   the ring is full.  Rows past K and x rows past M come back zero (TMA's
//   out-of-bounds fill), so no stage needs a mask.
// - Products on mma.sync m16n8k16 with the weights as A: a warp owns two
//   16-column fragments (ldmatrix.trans on the swizzled rows) and takes x
//   rows 0-7 (and 8-15) as B (ldmatrix on the x box), so at up to 8 rows
//   no product is wasted on padding.  The inner loop has no branch: columns
//   past N are computed on stale bytes and never written.  Each k step's
//   16 products sum inside the mma from 0 and the steps add in float32 (as
//   the rows of an FMA chain would meet; the tensor core's own
//   accumulation is coarser).
// - The K chunks of a tile meet inside a thread-block cluster, as in the
//   one-row GEMV: rank order, distributed shared memory, y written whole.
// - ks (the cluster size) is the most for which every cluster of the grid
//   is resident in one wave (cudaOccupancyMaxActiveClusters), as at one
//   row: three blocks share an SM (registers and shared memory are sized
//   for it), so a block whose stages wait on the consumers leaves the
//   others streaming.
// With `stamps` (uint64 [blocks][8], %globaltimer ns from the first
// consumer thread; null on the normal path) a launch records its phase
// boundaries: start, griddepcontrol.wait returned, first stage landed,
// half the stages read, the last read, cluster partials ready, y written,
// end.
// Int8 weights (rows_gemv8_kernel; kernels 8 and 9 in their int8 modes and
// the int8 serving step's M=B products, the TPU kernels' wq_kind ==
// "int8"): W holds int8 codes, matrices mat0.. of a tensor map over the
// stacked matrices (make_int8_rows_map), and sc float32 per-column scales.
// Each product is x_bf16 @ bf16(code) summed in float32, the TPU kernels'
// jnp.dot(xn, q.astype(bf16), preferred_element_type=f32); an mma on s8
// operands would quantize x (W8A8), which this is not.
// - A stage keeps its 16 KB of weights: 64 k rows (RG8_ROWS) as two boxes
//   of [64][128] int8 (128-byte rows, 128-byte swizzle), and x as two boxes
//   of [rows][32] (one 64-byte swizzle span each), so the bytes in flight
//   per SM are the bf16 instance's and three blocks still share an SM.
// - ldmatrix has no 8-bit transpose on sm_90, so the A fragments are built
//   from lane loads: each lane owns four adjacent columns (its rows g and
//   g + 8 of both of its warp's fragments) and reads them as one 32-bit
//   word of each of its four k rows (2t, 2t+1, 2t+8, 2t+9 of a 16-row
//   step; conflict-free under the swizzle); byte permutes and a
//   subtraction make exact floats of the codes (unpack8_s8), and a byte
//   permute takes their high halves as bf16 pairs, exact for |code| <= 128.
//   The mma, the float32 step sums and the cluster's fixed-order sum are
//   the bf16 instance's.
// - Scales where the TPU kernels apply them: kg == 0 scales each sum by
//   sc[mat*N + n] after the cluster sum (QKV per head group, down, the LM
//   head; PAIR: gate by sc[n] and up by sc[N + n] before the SwiGLU);
//   kg > 0 (the O projection, G matrices of kg rows summed as one) scales
//   each block's partial by sc[(k0 / kg)*N + n] before the cluster sum,
//   and the launcher picks K chunks that never straddle a group.
// Int4 weights (rows_gemv4_kernel<PAIR, A8>; kernels 8 and 9 in their int4
// modes and the int4 serving step's M=B products, the TPU kernels' wq_kind
// == "int4"): W holds packed codes (int8 [K/2, N], byte b = k rows 2b low
// nibble, 2b + 1 high) through a map over the packed rows (make_int4_map),
// sc float32 group scales [nmat][K/GS4][N].
// - A stage keeps its 16 KB of codes: two boxes of [64][128] bytes, now
//   128 k rows, one scale group, and x as four boxes of [rows][32] to cover
//   them.  Three stages (RG4_STAGES), so three blocks still share an SM.
// - An mma A register is one column's k rows 2t, 2t + 1: one byte of
//   codes.  A lane owns four columns (its 32-bit word of a box row) and
//   reads packed rows t and t + 4 of each 16-row step; its warp's two
//   16-byte chunks of a box row are f % 4 and f % 4 + 4, so that under the
//   swizzle its 32 lanes' words fall in 32 banks.  s4_bf16_pairs makes the
//   bf16 pairs of the codes.
// - Exact (W4A16, kernel 9 and the serving products; kernels 7 and 8 with
//   int4_w4a8 False): each pair times its column's bf16 scale, rounded
//   once (the TPU kernels' _dequant_int4_tile), then the bf16 instance's
//   mma and float32 sums.
// - W4A8 (A8; kernels 7 and 8's default): x is quantized to int8 per row
//   against the absmax of its activation block (kg > 0: the kg k rows that
//   hold this chunk, the launcher keeps chunks inside one; 0: the whole
//   row) by quant_x8_kernel, launched just before under programmatic
//   dependent launch: it writes bf16(rint(x / xs)) and the scales, and the
//   GEMV streams that x8 as it streams a bf16 x.  (Quantizing inside the
//   GEMV, each block reading its rows' whole activation blocks and
//   rewriting each stage's x in place behind one more barrier, measured
//   kernel 8's W4A8 products 1.5x as slow as the exact ones on the H100.)
//   Codes and x8 are exact in bf16 and a group's sums stay under 2^17, so
//   each group's mma sums are its exact integer dot (the JAX package's
//   int32 group dot); at the group's end they are scaled by the column's s
//   into the running sums, and each row's partial by its xs before the
//   cluster sum.
constexpr int RG_COLS = 256;                       // columns per tile
constexpr int RG_BOX = 64;                         // weight columns per box (128 bytes)
constexpr int RG_ROWS = 32;                        // k rows per stage
constexpr int RG_STAGES = 4;                       // ring stages
constexpr int RG_BOX_BYTES = RG_ROWS * RG_BOX * 2;
constexpr int RG_MAX_ROWS = 16;                    // x rows per block (the mma N, twice)
constexpr int RG_XOFF = RG_COLS / RG_BOX * RG_BOX_BYTES;    // x's box in a stage
constexpr int RG_STAGE_BYTES = RG_XOFF + RG_MAX_ROWS * RG_ROWS * 2;
constexpr int RG_WARPS = 8;                        // consumer warps, two fragments each
constexpr int RG_BLOCK = 32 * (RG_WARPS + 1);      // and the producer warp
constexpr int RG_PITCH = RG_COLS + 4;              // f32 pitch of a row of the block's sums
constexpr int RG_HEAD = 1024;                      // barriers; the ring starts 1024-aligned
constexpr int RG_SMEM = 1024 + RG_HEAD + RG_STAGES * RG_STAGE_BYTES;   // and alignment slack
constexpr int RG_STAMPS = 8;
static_assert(RG_ROWS == 32, "an x box row is one 64-byte swizzle span");
static_assert(RG_COLS == 16 * 2 * RG_WARPS, "two 16-column fragments a warp");
static_assert(RG_STAGES * RG_STAGE_BYTES >= 4 * RG_PITCH * RG_MAX_ROWS,
              "the ring must hold the block's sums after the last stage");
constexpr int RG8_ROWS = 2 * RG_ROWS;              // int8: k rows per stage
constexpr int RG8_BOX = 128;                       // int8 weight columns per box (128 bytes)
constexpr int RG8_BOX_BYTES = RG8_ROWS * RG8_BOX;
constexpr int RG8_XOFF = RG_COLS / RG8_BOX * RG8_BOX_BYTES;  // x's two boxes in a stage
constexpr int RG8_XBOX = RG_MAX_ROWS * RG_ROWS * 2;          // one x box (32 k)
constexpr int RG8_STAGE_BYTES = RG8_XOFF + 2 * RG8_XBOX;
constexpr int RG8_SMEM = 1024 + RG_HEAD + RG_STAGES * RG8_STAGE_BYTES;
static_assert(RG8_BOX_BYTES * RG_COLS / RG8_BOX == RG_COLS / RG_BOX * RG_BOX_BYTES,
              "an int8 stage streams the bf16 stage's weight bytes");
static_assert(RG8_XBOX % 512 == 0 && RG8_XOFF % 1024 == 0 && RG8_STAGE_BYTES % 1024 == 0,
              "the swizzled boxes keep their alignment");
constexpr int RG4_KROWS = 2 * RG8_ROWS;            // int4: k rows per stage
constexpr int RG4_STAGES = 3;
constexpr int RG4_STAGE_BYTES = RG8_XOFF + 4 * RG8_XBOX;     // codes and four x boxes
constexpr int RG4_SMEM = 1024 + RG_HEAD + RG4_STAGES * RG4_STAGE_BYTES;
static_assert(RG4_KROWS == GS4, "an int4 stage is one scale group");
static_assert(RG4_STAGE_BYTES % 1024 == 0, "the swizzled boxes keep their alignment");
static_assert(3 * (RG4_SMEM + 1024) <= 228 * 1024, "three int4 blocks share an SM");
static_assert(RG4_STAGES * RG4_STAGE_BYTES >= 4 * RG_PITCH * RG_MAX_ROWS,
              "the ring must hold the block's sums after the last stage");

// The body of the rows GEMV kernels: bf16 weights (WK_BF16; mat0, sc, kg
// and xs unused), int8 codes, matrices mat0.. of wmap, with their scales
// (WK_INT8), or int4 codes with their group scales (WK_INT4, WK_INT4A8; in
// W4A8 x holds x8 and xs the activation scales, [M][K / kg] or [M] at kg
// 0, as quant_x8_kernel writes them).
template <bool PAIR, int WK>
__device__ __forceinline__ void rows_gemv_body(
    const CUtensorMap* wmap, const CUtensorMap* xmap, float* __restrict__ y,
    __nv_bfloat16* __restrict__ yb, int M, int K, int N, int k_chunk, int nrc, int xrows,
    long long y_row, long long yz, unsigned long long* __restrict__ stamps, int mat0,
    const float* __restrict__ sc, int kg, const float* __restrict__ xs) {
  namespace cg = cooperative_groups;
  constexpr bool W8 = WK == WK_INT8, W4 = WK >= WK_INT4, A8 = WK == WK_INT4A8;
  constexpr int NS = W4 ? RG4_STAGES : RG_STAGES;
  constexpr int SB = W4 ? RG4_STAGE_BYTES : W8 ? RG8_STAGE_BYTES : RG_STAGE_BYTES;
  constexpr int HALF = PAIR ? RG_COLS / 2 : RG_COLS;        // columns per slab
  extern __shared__ unsigned char rg_raw[];
  unsigned char* sm = rg_raw + ((1024u - (hopper::smem_u32(rg_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);                       // [NS]
  uint64_t* empty = full + NS;                                            // [NS]
  unsigned char* ring = sm + RG_HEAD;                                     // [NS][SB]
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int rank = blockIdx.x, ks = gridDim.x;
  const int mat = PAIR ? 0 : blockIdx.z / nrc, r0 = (blockIdx.z % nrc) * RG_MAX_ROWS;
  const int nr = min(RG_MAX_ROWS, M - r0);
  const int n0 = blockIdx.y * HALF;
  const int cols = min(HALF, N - n0);                       // per slab
  constexpr int BOX = W8 || W4 ? RG8_BOX : RG_BOX;
  constexpr int ROWS = W4 ? RG4_KROWS : W8 ? RG8_ROWS : RG_ROWS;   // k rows per stage
  constexpr int KR = W4 ? 2 : 1;                                     // k rows per code row
  const int nb = (cols + BOX - 1) / BOX;                    // boxes per slab
  const int k0 = rank * k_chunk, kn = min(k_chunk, K - k0);
  const int nst = (kn + ROWS - 1) / ROWS;
  unsigned long long* my_stamps =
      stamps != nullptr && tid == 32
          ? stamps + ((size_t)blockIdx.x + gridDim.x * ((size_t)blockIdx.y + gridDim.y * blockIdx.z)) * RG_STAMPS
          : nullptr;
  auto stamp = [&](int k) {
    if (my_stamps != nullptr) my_stamps[k] = hopper::global_ns();
  };
  stamp(0);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 2);              // the weights' arrival and x's
      hopper::mbar_init(&empty[s], RG_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // producer (lane 0): stage st's weight boxes (PAIR: gate's, then up's
  // at column HALF of the tile), then its x box (int8: two x boxes; int4:
  // four, and its code boxes are of packed rows)
  auto issue_w = [&](int st) {
    unsigned char* stage = ring + (st % NS) * SB;
    uint64_t* bar = &full[st % NS];
    if constexpr (W8 || W4) {
      hopper::mbar_arrive_expect_tx(bar, (uint32_t)((PAIR ? 2 : 1) * nb * RG8_BOX_BYTES));
      for (int j = 0; j < nb; ++j) {
        hopper::tma_load_3d(stage + j * RG8_BOX_BYTES, wmap, bar, n0 + j * RG8_BOX,
                            k0 / KR + st * RG8_ROWS, mat0 + mat);
        if (PAIR)
          hopper::tma_load_3d(stage + (HALF / RG8_BOX + j) * RG8_BOX_BYTES, wmap, bar,
                              n0 + j * RG8_BOX, k0 / KR + st * RG8_ROWS, mat0 + 1);
      }
    } else {
      hopper::mbar_arrive_expect_tx(bar, (uint32_t)((PAIR ? 2 : 1) * nb * RG_BOX_BYTES));
      for (int j = 0; j < nb; ++j) {
        hopper::tma_load_3d(stage + j * RG_BOX_BYTES, wmap, bar, n0 + j * RG_BOX,
                            k0 + st * RG_ROWS, mat);
        if (PAIR)
          hopper::tma_load_3d(stage + (HALF / RG_BOX + j) * RG_BOX_BYTES, wmap, bar,
                              n0 + j * RG_BOX, k0 + st * RG_ROWS, 1);
      }
    }
  };
  auto issue_x = [&](int st) {
    uint64_t* bar = &full[st % NS];
    if constexpr (W4) {
      unsigned char* xs = ring + (st % NS) * SB + RG8_XOFF;
      hopper::mbar_arrive_expect_tx(bar, (uint32_t)(4 * xrows * RG_ROWS * 2));
      for (int i = 0; i < 4; ++i)
        hopper::tma_load_3d(xs + i * RG8_XBOX, xmap, bar, k0 + st * RG4_KROWS + i * RG_ROWS, r0,
                            0);
    } else if constexpr (W8) {
      unsigned char* xs = ring + (st % NS) * SB + RG8_XOFF;
      hopper::mbar_arrive_expect_tx(bar, (uint32_t)(2 * xrows * RG_ROWS * 2));
      hopper::tma_load_3d(xs, xmap, bar, k0 + st * RG8_ROWS, r0, 0);
      hopper::tma_load_3d(xs + RG8_XBOX, xmap, bar, k0 + st * RG8_ROWS + RG_ROWS, r0, 0);
    } else {
      hopper::mbar_arrive_expect_tx(bar, (uint32_t)(xrows * RG_ROWS * 2));
      hopper::tma_load_3d(ring + (st % NS) * SB + RG_XOFF, xmap, bar, k0 + st * RG_ROWS, r0, 0);
    }
  };
  if (tid == 0)
    for (int st = 0; st < min(NS, nst); ++st) issue_w(st);
  hopper::grid_dep_launch_dependents();
  hopper::grid_dep_wait();
  stamp(1);

  // acc[h][rh]: fragment h (tile columns 16(wid - 1) + 128h ..) against x
  // rows 8rh ..; mma fragment c: column + g (+8 for c >= 2), row 2t (+1 odd c)
  float acc[2][2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[h][rh][c] = 0.f;
  const bool two = xrows > 8;
  if (wid == 0) {
    if (lane == 0)
      for (int st = 0; st < min(NS, nst); ++st) issue_x(st);
    for (int st = NS; st < nst; ++st) {
      hopper::mbar_wait(&empty[st % NS], (st / NS - 1) & 1);
      if (lane == 0) {
        issue_w(st);
        issue_x(st);
      }
      __syncwarp();
    }
  } else {
    // this lane's ldmatrix rows.  Weights: matrix j = lane / 8 is k rows
    // (j >> 1) * 8.. and columns (j & 1) * 8.. of a 16 x 16 block; 16-byte
    // chunk c of box row k sits at chunk c ^ (k & 7).  x: matrix j is x
    // rows (j >> 1) * 8.. and k (j & 1) * 8..; chunk c of x row r sits at
    // chunk c ^ ((r >> 1) & 3).
    const int j = lane / 8, row = (j >> 1) * 8 + lane % 8;
    const int f = wid - 1;                                   // fragments f and f + 8
    const int x_sw = (row >> 1) & 3;
    int s = 0;
    uint32_t phase = 0;
    if constexpr (W4) {
      // int4: this lane's four tile columns c4 .. c4 + 3 are rows g and
      // g + 8 of fragment 0, then of fragment 1: its word of 16-byte chunk
      // ch of box f / 4; its k rows 2t + d and 2t + 8 + d of a 16-row step
      // are packed rows t and t + 4 (chunk ^ (t + 4e) under the swizzle)
      const int g = lane / 4, t = lane % 4, ch = f % 4 + 4 * (g / 4);
      const int c4 = (f / 4) * RG8_BOX + 16 * ch + 4 * (g % 4);
      int w_off[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        w_off[e] = (f / 4) * RG8_BOX_BYTES + (t + 4 * e) * 128 + ((ch ^ (t + 4 * e)) << 4) +
                   4 * (g % 4);
      const int x_off = RG8_XOFF + row * 64;
      // the lane's scales: gate's or up's slab (PAIR), else the tile's
      // matrix; columns past N read none
      const int scol = c4 - (PAIR ? (f / 4) * RG8_BOX : 0);
      const bool s_live = scol < cols;
      const float* sg = sc + ((size_t)(PAIR ? f / 4 : mat) * (K / GS4) + k0 / GS4) * N + n0 +
                        scol;
      for (int st = 0; st < nst; ++st) {
        const float4 s4 = s_live ? __ldg(reinterpret_cast<const float4*>(sg + (size_t)st * N))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        const float scl[4] = {s4.x, s4.y, s4.z, s4.w};
        hopper::mbar_wait(&full[s], phase);
        if (st == 0) stamp(2);
        if (st == nst / 2) stamp(3);
        const unsigned char* stage = ring + s * SB;
        uint32_t s2[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) s2[q] = A8 ? 0u : bf16_pair_of(scl[q]);
        float gacc[2][2][4];              // W4A8: the group's integer sums
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
#pragma unroll
            for (int c = 0; c < 4; ++c) gacc[h][rh][c] = 0.f;
#pragma unroll
        for (int kb = 0; kb < RG4_KROWS; kb += 16) {
          uint32_t b[4], lo[4], hi[4];
          const unsigned char* xa = stage + x_off + (kb / RG_ROWS) * RG8_XBOX +
                                    ((((kb % RG_ROWS) / 8 + (j & 1)) ^ x_sw) << 4);
          if (two) {
            hopper::ldmatrix_x4(b, xa);
          } else {
            uint32_t b2[2];
            hopper::ldmatrix_x2(b2, xa);
            b[0] = b2[0];
            b[1] = b2[1];
            b[2] = b[3] = 0u;
          }
          const unsigned char* wk = stage + (kb / 2) * 128;
          s4_bf16_pairs(*reinterpret_cast<const uint32_t*>(wk + w_off[0]), lo);
          s4_bf16_pairs(*reinterpret_cast<const uint32_t*>(wk + w_off[1]), hi);
          if constexpr (!A8) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              lo[q] = scale_pair(lo[q], s2[q]);
              hi[q] = scale_pair(hi[q], s2[q]);
            }
          }
          const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
          const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
          float p[2][2][4];
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
#pragma unroll
            for (int c = 0; c < 4; ++c) p[0][rh][c] = p[1][rh][c] = 0.f;
          hopper::mma_m16n8k16_bf16(p[0][0], a0, b[0], b[1]);
          hopper::mma_m16n8k16_bf16(p[1][0], a1, b[0], b[1]);
          if (two) {
            hopper::mma_m16n8k16_bf16(p[0][1], a0, b[2], b[3]);
            hopper::mma_m16n8k16_bf16(p[1][1], a1, b[2], b[3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if constexpr (A8)
                  gacc[h][rh][c] += p[h][rh][c];
                else
                  acc[h][rh][c] += p[h][rh][c];
              }
        }
        if constexpr (A8) {   // the group's sums, scaled by their columns' s
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[h][rh][c] = fmaf(gacc[h][rh][c], bf16_round(scl[2 * h + c / 2]),
                                     acc[h][rh][c]);
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
        if (++s == NS) {
          s = 0;
          phase ^= 1u;
        }
      }
      stamp(4);
    } else if constexpr (W8) {
      // int8: this lane's four tile columns 32f + 4g .. +3 are rows g and
      // g + 8 of fragment 0, then of fragment 1 (box f / 4, 16-byte chunk
      // 2(f % 4) + g / 4 at chunk ^ (k & 7) of box row k); its k rows in a
      // 16-row step are 2t + d and 2t + 8 + d (d = 0, 1)
      const int g = lane / 4, t = lane % 4, chunk = 2 * (f % 4) + g / 4;
      int w_off[2];
#pragma unroll
      for (int d = 0; d < 2; ++d)
        w_off[d] = (f / 4) * RG8_BOX_BYTES + (2 * t + d) * 128 +
                   ((chunk ^ (2 * t + d)) << 4) + 4 * (g % 4);
      const int x_off = RG8_XOFF + row * 64;
      for (int st = 0; st < nst; ++st) {
        hopper::mbar_wait(&full[s], phase);
        if (st == 0) stamp(2);
        if (st == nst / 2) stamp(3);
        const unsigned char* stage = ring + s * SB;
#pragma unroll
        for (int kb = 0; kb < RG8_ROWS; kb += 16) {
          uint32_t b[4], lo[4], hi[4];
          const unsigned char* xa = stage + x_off + (kb / RG_ROWS) * RG8_XBOX +
                                    ((((kb % RG_ROWS) / 8 + (j & 1)) ^ x_sw) << 4);
          if (two) {
            hopper::ldmatrix_x4(b, xa);
          } else {
            uint32_t b2[2];
            hopper::ldmatrix_x2(b2, xa);
            b[0] = b2[0];
            b[1] = b2[1];
            b[2] = b[3] = 0u;
          }
          const unsigned char* wk = stage + kb * 128;
          s8_bf16_pairs(*reinterpret_cast<const uint32_t*>(wk + w_off[0]),
                        *reinterpret_cast<const uint32_t*>(wk + w_off[1]), lo);
          s8_bf16_pairs(*reinterpret_cast<const uint32_t*>(wk + w_off[0] + 8 * 128),
                        *reinterpret_cast<const uint32_t*>(wk + w_off[1] + 8 * 128), hi);
          const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
          const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
          float p[2][2][4];
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
#pragma unroll
            for (int c = 0; c < 4; ++c) p[0][rh][c] = p[1][rh][c] = 0.f;
          hopper::mma_m16n8k16_bf16(p[0][0], a0, b[0], b[1]);
          hopper::mma_m16n8k16_bf16(p[1][0], a1, b[0], b[1]);
          if (two) {
            hopper::mma_m16n8k16_bf16(p[0][1], a0, b[2], b[3]);
            hopper::mma_m16n8k16_bf16(p[1][1], a1, b[2], b[3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[h][rh][c] += p[h][rh][c];
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
        if (++s == NS) {
          s = 0;
          phase ^= 1u;
        }
      }
      stamp(4);
    } else {
    int a_off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int fh = f + 8 * h, chunk = (fh % 4) * 2 + (j & 1);
      a_off[h] = (fh / 4) * RG_BOX_BYTES + row * 128 + ((chunk ^ (lane & 7)) << 4);
    }
    const int x_off = RG_XOFF + row * 64;
    for (int st = 0; st < nst; ++st) {
      hopper::mbar_wait(&full[s], phase);
      if (st == 0) stamp(2);
      if (st == nst / 2) stamp(3);
      const unsigned char* stage = ring + s * SB;
#pragma unroll
      for (int kb = 0; kb < RG_ROWS; kb += 16) {
        uint32_t b[4], a0[4], a1[4];
        const unsigned char* xa = stage + x_off + (((kb / 8 + (j & 1)) ^ x_sw) << 4);
        if (two) {
          hopper::ldmatrix_x4(b, xa);
        } else {
          uint32_t b2[2];
          hopper::ldmatrix_x2(b2, xa);
          b[0] = b2[0];
          b[1] = b2[1];
          b[2] = b[3] = 0u;
        }
        hopper::ldmatrix_x4_trans(a0, stage + a_off[0] + kb * 128);
        hopper::ldmatrix_x4_trans(a1, stage + a_off[1] + kb * 128);
        float p[2][2][4];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
#pragma unroll
          for (int c = 0; c < 4; ++c) p[0][rh][c] = p[1][rh][c] = 0.f;
        hopper::mma_m16n8k16_bf16(p[0][0], a0, b[0], b[1]);
        hopper::mma_m16n8k16_bf16(p[1][0], a1, b[0], b[1]);
        if (two) {
          hopper::mma_m16n8k16_bf16(p[0][1], a0, b[2], b[3]);
          hopper::mma_m16n8k16_bf16(p[1][1], a1, b[2], b[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[h][rh][c] += p[h][rh][c];
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      if (++s == NS) {
        s = 0;
        phase ^= 1u;
      }
    }
    stamp(4);
    }
  }
  __syncthreads();   // every stage issued has landed and been read: the ring is free
  float* part = reinterpret_cast<float*>(ring);             // [RG_MAX_ROWS][RG_PITCH]
  if (wid > 0) {
    const int g = lane / 4, t = lane % 4;
    if constexpr (W4) {
      // tile columns c4 + 2h (rows g) and + 1 (rows g + 8), as the
      // consumer loop owns them; W4A8: each x row's partial times its xs
      // (rows past M: 0, never written)
      const int f = wid - 1, c4 = (f / 4) * RG8_BOX + 16 * (f % 4 + 4 * (g / 4)) + 4 * (g % 4);
      const int nbk = kg > 0 ? K / kg : 1, blk = kg > 0 ? k0 / kg : 0;
      auto xs_of = [&](int r) {
        return r < nr ? xs[(size_t)(r0 + r) * nbk + blk] : 0.f;
      };
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          if (rh == 1 && !two) break;
          const int r = 8 * rh + 2 * t;
          const float x0 = A8 ? xs_of(r) : 1.f, x1 = A8 ? xs_of(r + 1) : 1.f;
          float* p = part + r * RG_PITCH + c4 + 2 * h;
          p[0] = acc[h][rh][0] * x0;
          p[RG_PITCH] = acc[h][rh][1] * x1;
          p[1] = acc[h][rh][2] * x0;
          p[RG_PITCH + 1] = acc[h][rh][3] * x1;
        }
    } else if constexpr (W8) {
      // tile columns 32(wid - 1) + 4g + 2h (rows g) and + 1 (rows g + 8);
      // kg > 0: each partial scaled by its column's scale in the block's
      // group first (PAIR has kg 0)
      const int col = 32 * (wid - 1) + 4 * g;
      float scl[4] = {1.f, 1.f, 1.f, 1.f};
      if (kg > 0) {
        const float* sg = sc + (size_t)(k0 / kg) * N + n0 + col;
#pragma unroll
        for (int q = 0; q < 4; ++q) scl[q] = col + q < cols ? sg[q] : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          if (rh == 1 && !two) break;
          float* p = part + (8 * rh + 2 * t) * RG_PITCH + col + 2 * h;
          p[0] = acc[h][rh][0] * scl[2 * h];
          p[RG_PITCH] = acc[h][rh][1] * scl[2 * h];
          p[1] = acc[h][rh][2] * scl[2 * h + 1];
          p[RG_PITCH + 1] = acc[h][rh][3] * scl[2 * h + 1];
        }
    } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        if (rh == 1 && !two) break;
        float* p = part + (8 * rh + 2 * t) * RG_PITCH + 16 * (wid - 1 + 8 * h) + g;
        p[0] = acc[h][rh][0];
        p[RG_PITCH] = acc[h][rh][1];
        p[8] = acc[h][rh][2];
        p[RG_PITCH + 8] = acc[h][rh][3];
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  stamp(5);
  const int q4 = cols / 4;                                  // float4 pieces per row
  const int per = (nr * q4 + ks - 1) / ks;                  // pieces per rank
  for (int i = tid; i < per; i += blockDim.x) {
    const int e = rank * per + i;
    if (e >= nr * q4) continue;
    const int b = e / q4, c = (e - b * q4) * 4;
    // the ranks' sums in rank order, all reads of a slab in flight at once
    auto rank_sum = [&](int off) {
      float4 v[G1_MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < G1_MAX_CLUSTER; ++q)
        v[q] = q < ks ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) +
                                                          b * RG_PITCH + off + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < G1_MAX_CLUSTER; ++q)
        if (q < ks) {
          sum.x += v[q].x;
          sum.y += v[q].y;
          sum.z += v[q].z;
          sum.w += v[q].w;
        }
      return sum;
    };
    // int8 with kg == 0: each column's scale after the cluster sum (PAIR:
    // gate's at sc[n], up's at sc[N + n], before the SwiGLU)
    auto scaled = [&](float4 v, int m) {
      if constexpr (W8) {
        if (kg == 0) {
          const float* s4 = sc + (size_t)m * N + n0 + c;
          v.x *= s4[0];
          v.y *= s4[1];
          v.z *= s4[2];
          v.w *= s4[3];
        }
      }
      return v;
    };
    const float4 sv = scaled(rank_sum(0), mat);
    const size_t at = (size_t)(r0 + b) * y_row + (size_t)mat * yz + n0 + c;
    if constexpr (PAIR) {
      const float4 su = scaled(rank_sum(HALF), 1);
      const float g4[4] = {sv.x, sv.y, sv.z, sv.w}, u4[4] = {su.x, su.y, su.z, su.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        yb[at + q] = __float2bfloat16(g4[q] / (1.f + expf(-g4[q])) * u4[q]);
    } else if (yb) {
      yb[at] = __float2bfloat16(sv.x);
      yb[at + 1] = __float2bfloat16(sv.y);
      yb[at + 2] = __float2bfloat16(sv.z);
      yb[at + 3] = __float2bfloat16(sv.w);
    } else {
      y[at] = sv.x;
      y[at + 1] = sv.y;
      y[at + 2] = sv.z;
      y[at + 3] = sv.w;
    }
  }
  stamp(6);
  cluster.sync();
  stamp(7);
}

template <bool PAIR>
__global__ void __launch_bounds__(RG_BLOCK, 3)
rows_gemv_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap, float* __restrict__ y,
                 __nv_bfloat16* __restrict__ yb, int M, int K, int N, int k_chunk, int nrc,
                 int xrows, long long y_row, long long yz,
                 unsigned long long* __restrict__ stamps) {
  rows_gemv_body<PAIR, WK_BF16>(&wmap, &xmap, y, yb, M, K, N, k_chunk, nrc, xrows, y_row, yz,
                                stamps, 0, nullptr, 0, nullptr);
}

// The int8 instance: the codes through wmap (int8 [nmats][K][N], boxes of
// RG8_ROWS x RG8_BOX, 128-byte swizzle; matrices mat0 + blockIdx.z / nrc,
// PAIR: gate mat0 and up mat0 + 1), sc float32 scales, kg as above.
template <bool PAIR>
__global__ void __launch_bounds__(RG_BLOCK, 3)
rows_gemv8_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap, float* __restrict__ y,
                  __nv_bfloat16* __restrict__ yb, int M, int K, int N, int k_chunk, int nrc,
                  int xrows, long long y_row, long long yz,
                  unsigned long long* __restrict__ stamps, int mat0,
                  const float* __restrict__ sc, int kg) {
  rows_gemv_body<PAIR, WK_INT8>(&wmap, &xmap, y, yb, M, K, N, k_chunk, nrc, xrows, y_row, yz,
                                stamps, mat0, sc, kg, nullptr);
}

// The int4 instance: the packed codes through wmap (int8 [nmats][K/2][N],
// boxes of RG8_ROWS packed rows x RG8_BOX, 128-byte swizzle; matrices as
// rows_gemv8_kernel's), sc float32 group scales [nmat][K/GS4][N]; A8: x is
// x8 and xs its scales per activation block of kg k rows (0: the row).
template <bool PAIR, bool A8>
__global__ void __launch_bounds__(RG_BLOCK, 3)
rows_gemv4_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap, float* __restrict__ y,
                  __nv_bfloat16* __restrict__ yb, int M, int K, int N, int k_chunk, int nrc,
                  int xrows, long long y_row, long long yz,
                  unsigned long long* __restrict__ stamps, int mat0,
                  const float* __restrict__ sc, int kg, const float* __restrict__ xs) {
  rows_gemv_body<PAIR, A8 ? WK_INT4A8 : WK_INT4>(&wmap, &xmap, y, yb, M, K, N, k_chunk, nrc,
                                                 xrows, y_row, yz, stamps, mat0, sc, kg, xs);
}

// W4A8's activation quantization of M rows for the rows GEMV (JAX's
// w4a8_int4_dot, its x per row): block (row, b) takes the b-th block of xb
// values of row `row` of x (rows x_row apart), xs[row * nb + b] =
// max(absmax, 1e-8) / 127 (nb = K / xb) and x8[row * K + k] =
// bf16(rint(x / xs)), integers of at most 127 that bf16 holds exactly.
// Under programmatic dependent launch it lets the GEMV after it start (the
// GEMV streams its weights and reads x8 and xs after its own wait).  A
// template, so that only the translation units that launch it emit it: a
// copy emitted beside kernels 5 and 6 changed their SASS
// (scripts/compare_sass.py).
constexpr int QX_THREADS = 256;

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
quant_x8_kernel(const __nv_bfloat16* __restrict__ x, long long x_row, int K, int xb,
                __nv_bfloat16* __restrict__ x8, float* __restrict__ xs) {
  hopper::grid_dep_launch_dependents();
  hopper::grid_dep_wait();
  __shared__ float red[32];
  const __nv_bfloat16* xr = x + (size_t)blockIdx.x * x_row + (size_t)blockIdx.y * xb;
  float am = 0.f;
  for (int i = threadIdx.x * 8; i < xb; i += THREADS * 8) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + i), v);
#pragma unroll
    for (int c = 0; c < 8; ++c) am = fmaxf(am, fabsf(v[c]));
  }
  am = warp_max(am);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = am;
  __syncthreads();
  am = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) am = fmaxf(am, red[w]);
  const float s = fmaxf(am, 1e-8f) * (1.f / 127.f);
  if (threadIdx.x == 0) xs[(size_t)blockIdx.x * gridDim.y + blockIdx.y] = s;
  __nv_bfloat16* out = x8 + (size_t)blockIdx.x * K + (size_t)blockIdx.y * xb;
  for (int i = threadIdx.x * 8; i < xb; i += THREADS * 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    uint32_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = hopper::pack_bf16(quant_x8(__uint_as_float(w[j] << 16), s),
                               quant_x8(__uint_as_float(w[j] & 0xffff0000u), s));
    *reinterpret_cast<uint4*>(out + i) = make_uint4(q[0], q[1], q[2], q[3]);
  }
}

// A measurement hook (chip_smoke.py phase 9): while rg_probe.at >= 0, the
// rows-GEMV launch numbered `at` (counted from when it was set, in this
// translation unit) records its phase stamps into rg_probe.stamps.
struct RgProbe {
  unsigned long long* stamps;
  int at, count;
};
RgProbe rg_probe = {nullptr, -1, 0};

// The tensor map rows_gemv8_kernel reads: nmats int8 [K, N] matrices
// (row-major, K*N bytes apart) from w, in boxes of RG8_ROWS rows of RG8_BOX
// columns with the 128-byte swizzle.  N must be a multiple of 16 and w
// 16-byte aligned.
inline bool make_int8_rows_map(CUtensorMap* map, const void* w, int K, int N,
                               long long nmats) {
  return hopper::make_tensor_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, nmats,
                                    (uint64_t)N, (uint64_t)K * N, RG8_BOX, RG8_ROWS, 1,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// An int8 weight map, the row count it was encoded for and its kind: the
// one-row GEMV's boxes at one row, the rows GEMV's from 2; int8 codes, or
// int4 codes two a byte (a map over the K/2 packed rows).  for_rows(M,
// int4) is the map for a launch over M rows of that kind, or nullptr
// (which every quantized launcher refuses) when the map was encoded for
// the other layout or the other kind.
struct Int8Map {
  CUtensorMap map;
  bool one_row;
  bool int4 = false;
  const CUtensorMap* for_rows(int M, bool packed = false) const {
    return (M == 1) == one_row && packed == int4 ? &map : nullptr;
  }
};

// The map launch_ring_gemv8 reads for M rows of x.
inline bool make_int8_map(Int8Map* m, const void* w, int K, int N, long long nmats, int M) {
  m->one_row = M == 1;
  m->int4 = false;
  return m->one_row ? make_int8_weight_map(&m->map, w, K, N, nmats)
                    : make_int8_rows_map(&m->map, w, K, N, nmats);
}

// The map launch_ring_gemv4 reads for M rows of x: nmats int4 [K, N]
// matrices packed along K (int8 [K/2, N] each, K*N/2 bytes apart; K a
// multiple of GS4).
inline bool make_int4_map(Int8Map* m, const void* w, int K, int N, long long nmats, int M) {
  if (K % GS4 != 0) return false;
  const bool ok = make_int8_map(m, w, K / 2, N, nmats, M);
  m->int4 = true;
  return ok;
}

// Launch rows_gemv_kernel<PAIR> (W8: rows_gemv8_kernel<PAIR>) over M >= 2
// rows (in chunks of RG_MAX_ROWS) of bf16 x (rows x_row apart, x_row a
// multiple of 8, x 16-byte aligned) and the matrices mat0 .. mat0 + nmat -
// 1 of wmap (PAIR: nmat 2, gate then up, and yb takes the product); W8:
// the scales sc and the scale group kg (kg > 0: nmat 1, not PAIR, K a
// multiple of kg).  `pdl` adds programmatic dependent launch.  x's tensor
// map is encoded here, per call.  ks (the cluster size): the most K chunks
// (multiples of a stage's rows, at least two stages a block, at most 16
// where the card allows non-portable clusters, else 8; with kg > 0 only
// chunks that divide kg) for which every cluster of the grid is resident
// in one wave (cudaOccupancyMaxActiveClusters), else one chunk (with kg >
// 0 where that straddles a group, the most chunks allowed).  Returns a
// cudaError_t.
template <bool PAIR, int WK>
int launch_rows(const __nv_bfloat16* x, long long x_row, const CUtensorMap* wmap, int mat0,
                const float* sc, int kg, float* y, int M, int K, int N, int nmat,
                long long y_row, long long yz, bool pdl, cudaStream_t st,
                __nv_bfloat16* yb, const float* xs = nullptr) {
  constexpr bool W8 = WK == WK_INT8, W4 = WK >= WK_INT4;
  constexpr int ROWS = W4 ? RG4_KROWS : W8 ? RG8_ROWS : RG_ROWS;
  constexpr int SMEM = W4 ? RG4_SMEM : W8 ? RG8_SMEM : RG_SMEM;
  static bool attrs_set = false;
  static int max_cluster = 8;
  static int occ[G1_MAX_CLUSTER + 1];          // active clusters by size (0: not asked)
  auto kern = [] {
    if constexpr (W4) return rows_gemv4_kernel<PAIR, WK == WK_INT4A8>;
    else if constexpr (W8) return rows_gemv8_kernel<PAIR>;
    else return rows_gemv_kernel<PAIR>;
  }();
  if (!attrs_set) {
    CF_CHECK((int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM));
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
        cudaSuccess)
      max_cluster = G1_MAX_CLUSTER;
    else
      (void)cudaGetLastError();
    attrs_set = true;
  }
  const int nrc = (M + RG_MAX_ROWS - 1) / RG_MAX_ROWS;
  const int xrows = nrc > 1 ? RG_MAX_ROWS : (M + 7) / 8 * 8;
  const int half = PAIR ? RG_COLS / 2 : RG_COLS;
  const int tiles = (N + half - 1) / half;
  const int z = (PAIR ? 1 : nmat) * nrc;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(RG_BLOCK, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  auto set_cluster = [&](int ks) {
    attr[0].val.clusterDim.x = ks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(ks, tiles, z);
  };
  auto chunk_of = [&](int c) { return ((K + c - 1) / c + ROWS - 1) / ROWS * ROWS; };
  int ks = 0, most = 0;
  for (int c = std::min(max_cluster, std::max(1, K / (2 * ROWS))); c > 1; --c) {
    const int kc = chunk_of(c);
    if ((K + kc - 1) / kc != c) continue;                 // every rank has rows
    if (kg > 0 && kg % kc != 0) continue;                 // a chunk inside one scale group
    if (most == 0) most = c;
    if (occ[c] == 0) {                                    // active clusters (cached)
      set_cluster(c);
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
        (void)cudaGetLastError();
        n = 0;
      }
      occ[c] = std::max(n, 0) + 1;
    }
    if (occ[c] - 1 >= tiles * z) {
      ks = c;
      break;
    }
  }
  if (ks == 0) ks = kg > 0 && kg % chunk_of(1) != 0 ? most : 1;
  if (ks == 0) return (int)cudaErrorInvalidValue;
  const int k_chunk = chunk_of(ks);
  CUtensorMap xmap;
  if (!hopper::make_tensor_map_bf16_3d(&xmap, x, K, M, 1, (uint64_t)x_row * 2,
                                       (uint64_t)x_row * 2 * M, RG_ROWS, xrows, 1,
                                       CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  unsigned long long* stamps = nullptr;
  if (rg_probe.at >= 0 && rg_probe.count++ == rg_probe.at) stamps = rg_probe.stamps;
  set_cluster(ks);
  cfg.numAttrs = pdl ? 2 : 1;
  if constexpr (W4)
    return (int)cudaLaunchKernelEx(&cfg, kern, *wmap, xmap, y, yb, M, K, N, k_chunk, nrc,
                                   xrows, y_row, yz, stamps, mat0, sc, kg, xs);
  else if constexpr (W8)
    return (int)cudaLaunchKernelEx(&cfg, kern, *wmap, xmap, y, yb, M, K, N, k_chunk, nrc,
                                   xrows, y_row, yz, stamps, mat0, sc, kg);
  else
    return (int)cudaLaunchKernelEx(&cfg, kern, *wmap, xmap, y, yb, M, K, N, k_chunk, nrc,
                                   xrows, y_row, yz, stamps);
}

// The bf16 rows GEMV over nmat [K, N] matrices ws elements apart from w
// (ws a multiple of 8), their tensor map encoded here; the rest as
// launch_rows.
template <bool PAIR>
int launch_rows_gemv(const __nv_bfloat16* x, long long x_row, const __nv_bfloat16* w,
                     float* y, int M, int K, int N, int nmat, long long ws, long long y_row,
                     long long yz, bool pdl, cudaStream_t st, __nv_bfloat16* yb = nullptr) {
  if (M < 2 || K < 1 || N < 8 || N % 8 != 0 || nmat < 1 || (nmat > 1 && ws % 8 != 0) ||
      x_row % 8 != 0 || (uintptr_t)x % 16 != 0 || (PAIR && (nmat != 2 || yb == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap;
  if (!hopper::make_tensor_map_bf16_3d(&wmap, w, N, K, nmat, (uint64_t)N * 2,
                                       (uint64_t)(nmat > 1 ? ws : (long long)K * N) * 2,
                                       RG_BOX, RG_ROWS, 1, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  return launch_rows<PAIR, WK_BF16>(x, x_row, &wmap, 0, nullptr, 0, y, M, K, N, nmat, y_row,
                                    yz, pdl, st, yb);
}

// The int8 rows GEMV over the matrices mat0.. of wmap (make_int8_map with
// M >= 2; N a multiple of 16) with the scales sc and the scale group kg, as
// launch_rows.
template <bool PAIR>
int launch_rows_gemv8(const __nv_bfloat16* x, long long x_row, const Int8Map* wmap,
                      int mat0, const float* sc, int kg, float* y, int M, int K, int N,
                      int nmat, long long y_row, long long yz, bool pdl, cudaStream_t st,
                      __nv_bfloat16* yb = nullptr) {
  if (M < 2 || K < 1 || N < 16 || N % 16 != 0 || nmat < 1 || x_row % 8 != 0 ||
      (uintptr_t)x % 16 != 0 || !wmap || !wmap->for_rows(M) || !sc || kg < 0 ||
      (kg > 0 && (PAIR || nmat != 1 || K % kg != 0)) ||
      (PAIR && (nmat != 2 || yb == nullptr)))
    return (int)cudaErrorInvalidValue;
  return launch_rows<PAIR, WK_INT8>(x, x_row, wmap->for_rows(M), mat0, sc, kg, y, M, K, N,
                                    nmat, y_row, yz, pdl, st, yb);
}

// The int4 rows GEMV over the packed matrices mat0.. of wmap (make_int4_map
// with M >= 2; K a multiple of GS4, N of 16) with the group scales sc
// [nmat][K/GS4][N]; A8 (W4A8): quant_x8_kernel first quantizes x per
// activation block of kg k rows (0: the whole row; kg > 0: K and kg
// multiples of it and of GS4, chunks kept inside one block) into the
// caller's scratch x8 (bf16 [M][K]) and xs (float32 [M][K / kg or 1]),
// and the GEMV reads those; as launch_rows otherwise.
template <bool PAIR, bool A8>
int launch_rows_gemv4(const __nv_bfloat16* x, long long x_row, const Int8Map* wmap,
                      int mat0, const float* sc, int kg, float* y, int M, int K, int N,
                      int nmat, long long y_row, long long yz, bool pdl, cudaStream_t st,
                      __nv_bfloat16* yb = nullptr, __nv_bfloat16* x8 = nullptr,
                      float* xs = nullptr) {
  if (M < 2 || K < GS4 || K % GS4 != 0 || N < 16 || N % 16 != 0 || nmat < 1 ||
      x_row % 8 != 0 || (uintptr_t)x % 16 != 0 || !wmap || !wmap->for_rows(M, true) || !sc ||
      kg < 0 || (kg > 0 && (K % kg != 0 || kg % GS4 != 0)) ||
      (PAIR && (nmat != 2 || yb == nullptr)) ||
      (A8 && (!x8 || !xs || (uintptr_t)x8 % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  if constexpr (A8) {
    const int xb = kg > 0 ? kg : K;
    CF_CHECK(launch_kernel(quant_x8_kernel<QX_THREADS>, dim3(M, K / xb), dim3(QX_THREADS), 0,
                           st, pdl, x, x_row, K, xb, x8, xs));
    return launch_rows<PAIR, WK_INT4A8>(x8, K, wmap->for_rows(M, true), mat0, sc, kg, y, M, K,
                                        N, nmat, y_row, yz, true, st, yb, xs);
  }
  return launch_rows<PAIR, WK_INT4>(x, x_row, wmap->for_rows(M, true), mat0, sc, 0, y, M, K, N,
                                    nmat, y_row, yz, pdl, st, yb);
}

// Any M of bf16 x: one row on float32 FMAs (x_row and y_row unused), more
// on the rows GEMV.
inline int launch_ring_gemv(const __nv_bfloat16* x, long long x_row, const __nv_bfloat16* w,
                            float* y, int M, int K, int N, int nmat, long long ws,
                            long long y_row, long long yz, int threads, bool pdl,
                            cudaStream_t st, __nv_bfloat16* yb = nullptr) {
  if (M == 1) return launch_gemv1<false>(x, 0, w, y, K, N, nmat, ws, yz, threads, pdl, st, yb);
  return launch_rows_gemv<false>(x, x_row, w, y, M, K, N, nmat, ws, y_row, yz, pdl, st, yb);
}

// Any M of bf16 x against int8 matrices mat0.. of wmap (make_int8_map(...,
// M); a map encoded for another M is refused), scaled by sc with the scale
// group kg: one row on the one-row GEMV's int8 instance (x_row and y_row
// unused), more on the rows GEMV's.
inline int launch_ring_gemv8(const __nv_bfloat16* x, long long x_row, const Int8Map* wmap,
                             int mat0, const float* sc, int kg, float* y, int M, int K, int N,
                             int nmat, long long y_row, long long yz, int threads, bool pdl,
                             cudaStream_t st, __nv_bfloat16* yb = nullptr) {
  if (M == 1)
    return launch_gemv1<false, G1_Y, true>(x, 0, nullptr, y, K, N, nmat, 0, yz, threads, pdl,
                                           st, yb, nullptr, 0.f, nullptr,
                                           wmap ? wmap->for_rows(1) : nullptr, mat0, sc, kg);
  return launch_rows_gemv8<false>(x, x_row, wmap, mat0, sc, kg, y, M, K, N, nmat, y_row, yz,
                                  pdl, st, yb);
}

// Any M of bf16 x against the int4 matrices mat0.. of wmap (make_int4_map(...,
// M); a map encoded for another M or kind is refused) with the group
// scales sc; A8: W4A8 with activation blocks of kg k rows (0: the row):
// one row on the one-row GEMV's int4 instance, more on the rows GEMV's.
template <bool A8>
int launch_ring_gemv4(const __nv_bfloat16* x, long long x_row, const Int8Map* wmap, int mat0,
                      const float* sc, int kg, float* y, int M, int K, int N, int nmat,
                      long long y_row, long long yz, int threads, bool pdl, cudaStream_t st,
                      __nv_bfloat16* yb = nullptr, __nv_bfloat16* x8 = nullptr,
                      float* xs = nullptr) {
  if (M == 1)
    return launch_gemv1<false, G1_Y, A8 ? WK_INT4A8 : WK_INT4>(
        x, 0, nullptr, y, K, N, nmat, 0, yz, threads, pdl, st, yb, nullptr, 0.f, nullptr,
        wmap ? wmap->for_rows(1, true) : nullptr, mat0, sc, A8 ? kg : 0);
  return launch_rows_gemv4<false, A8>(x, x_row, wmap, mat0, sc, kg, y, M, K, N, nmat, y_row,
                                      yz, pdl, st, yb, x8, xs);
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
//
// 8-bit caches (the TPU kernel's kv_kind, ops/quant.py's formats): the cache
// kind KV is a template parameter of the split pass and of both merges.
// KV_INT8 (Int8KV): int8 rows [kv, cap, hd] and float32 scales, position
// p's of kv head h at ks[h * srow + p] of the layer's flattened [R, 128]
// plane (srow = R * 128); a score is (bf16(q) . code) * sk, and p enters
// the P.V dot as bf16(p * sv), the TPU kernel's order.  KV_FP8 (e4m3, no
// scale): a row decodes exactly, e4m3 denormals (magnitude bits < 8, |v| <=
// 0.0137) flushed to 0 as the TPU kernel's bit-twiddle decode flushes them
// (ops/quant.py fp8_decode_scaled).  The rows stream as bytes (a 128-wide
// row is 128 bytes, a 64-wide one 64: every bulk copy stays a whole number
// of 16-byte units); the current token's fold stays float32 and only its
// stored copy is 8-bit: int8 codes rint(x / s) with s = max(|x|, 1e-8) *
// (1/127) of the float32 row, or e4m3 straight from float32, saturating
// (the one-token stack at hd 64: of the row rounded to bf16 first, as the
// TPU kernel's deferred append stores it).
//
// Head dims: the one-token split and both merges take hd as a runtime
// argument (a multiple of 32 up to 128; the stack runs 64 and 128): the
// Q.K halves are hd / 16 pieces of 16 bytes (8 bytes of an 8-bit row),
// and the P.V pass has ATT_THREADS / (hd / 8) slices of rows (16 at hd
// 64, 8 at 128), so the slices' sums take the same shared memory at
// either width.
constexpr int ATT_THREADS = 128;
constexpr int ATT_MAX_GROUP = 8;        // query rows of one token's kv head
constexpr int ATT_MAX_ROWS = 16;        // query rows of a tile of n tokens (the verify)
constexpr int ATT_TILE = 64;            // cache rows per ring stage
constexpr int ATT_MAX_SPLIT = 1024;
constexpr int KV_BF16 = 0, KV_INT8 = 1, KV_FP8 = 2;   // the cache kinds

// Shared memory of the split pass for `nq` query rows a block: two
// barriers, a two-stage ring of [min(split, ATT_TILE), hd] tiles (bf16, or
// bytes of an 8-bit cache, which the n-token form converts to one bf16
// tile), q in bf16 and f32, the split's scores, (one token) the P.V
// slices' sums, and (int8) the split's K and V scales.
inline size_t attn_split_smem(int nq, int hd, int split, bool tokens = false,
                              int kv = KV_BF16) {
  const size_t tr = (size_t)std::min(split, ATT_TILE);
  const size_t slices = tokens ? 0 : ATT_THREADS / (hd / 8);
  const size_t ring = kv == KV_BF16 ? 2 * tr * hd * 2 : 2 * tr * hd + (tokens ? tr * hd * 2 : 0);
  return 16 + ring + (size_t)nq * hd * (2 + 4) +
         sizeof(float) * ((size_t)nq * split + slices * nq * hd +
                          (kv == KV_INT8 ? 2 * (size_t)split : 0));
}
constexpr int ATT_SPLIT_SMEM_MAX = 112 * 1024;   // >= attn_split_smem(8, 128, 1024, false, kv)

// Eight e4m3 codes of one byte each -> eight floats, exactly, denormals
// flushed to 0: the magnitude bits placed at bit 20 with 120 added to the
// exponent are the float (the TPU kernel's decode, re-biased to 2^0).
__device__ __forceinline__ void unpack8_e4m3(const uint2& u, float* f) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t c = (w[i] >> (8 * b)) & 0xffu, mag = c & 0x7fu;
      f[4 * i + b] = __uint_as_float((mag < 8 ? 0u : (mag << 20) + 0x3C000000u) |
                                     ((c & 0x80u) << 24));
    }
}

// Eight codes of an 8-bit cache row (KV_INT8 or KV_FP8) -> eight floats.
template <int KV>
__device__ __forceinline__ void unpack8_kv(const uint2& u, float* f) {
  if constexpr (KV == KV_INT8)
    unpack8_s8(u, f);
  else
    unpack8_e4m3(u, f);
}

// Maximum over the block; every thread gets the result.  `red` holds 32 floats.
__device__ __forceinline__ float block_max(float x, float* red) {
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int nw = (blockDim.x + 31) / 32;
  x = warp_max(x);
  __syncthreads();
  if (lane == 0) red[wid] = x;
  __syncthreads();
  return warp_max(lane < nw ? red[lane] : NEG_INF);
}

// The stored copy of one float32 cache row of hd values (x: the block's
// row in shared memory or registers, read as x(d)) in an 8-bit cache:
// KV_INT8 writes codes rint(x / s) at dst and s = max(|x|, 1e-8) * (1/127)
// at *scale (ops/quant.py quantize_kv_rows: an IEEE division, ties to
// even); KV_FP8 writes e4m3 straight from float32, saturating at +-448.
// Every thread of the block calls it (the int8 maximum is a block's).
template <int KV, typename Row>
__device__ __forceinline__ void store_row8(Row x, int hd, uint8_t* dst, float* scale,
                                           float* red) {
  if constexpr (KV == KV_INT8) {
    float a = 0.f;
    for (int d = threadIdx.x; d < hd; d += blockDim.x) a = fmaxf(a, fabsf(x(d)));
    const float s = fmaxf(block_max(a, red), 1e-8f) * (1.0f / 127.0f);
    for (int d = threadIdx.x; d < hd; d += blockDim.x)
      dst[d] = (uint8_t)(int8_t)rintf(x(d) / s);
    if (threadIdx.x == 0) *scale = s;
    __syncthreads();                       // red may be reused
  } else {
    for (int d = threadIdx.x; d < hd; d += blockDim.x)
      dst[d] = __nv_cvt_float_to_fp8(x(d), __NV_SATFINITE, __NV_E4M3);
  }
}

// Split pass over cache rows [s*split, min((s+1)*split, seq)) of kv head
// h = blockIdx.x, s = blockIdx.y (counted from the first live split under
// a window, see below).  One token (the stack; MAXR =
// ATT_MAX_GROUP): the group's q rows of qkv [kv][(group+2)*hd], cos/sin
// one row; writes part_ml [kv, ns, g, 2] (max, sum) and part_acc [kv, ns,
// g, hd].  TOKENS (n_tok tokens, the verify stack; hd 128): qkv is
// [n_tok][kv*(group+2)*hd], cos/sin [n_tok, hd]; query row r = i*n_tok + t
// of kv head h is q head row i of token t (roped with row t of cos/sin),
// the rows R = group*n_tok in tiles of up to MAXR (blockIdx.z; more tiles
// read the split's rows again, from L2); writes part_ml [kv, ns, R, 2] and
// part_acc [kv, ns, R, hd].  The row bound is a template parameter: the
// one-token instance keeps its short code, and the verify takes the
// 8-row instance where its rows fit.
//
// Bound by bytes (the K and V rows < seq, read once).  The split's n rows
// of K, then of V, are contiguous spans of the [kv, cap, hd] cache, so
// thread 0 loads them as 1-D bulk copies (cp.async.bulk) of up to ATT_TILE
// rows into a two-stage ring behind mbarriers: the tiles K_0.., then V_0..,
// the next tile issued as soon as a stage is read, so a split of one tile
// has its K and V in flight from the block's first instruction.  Only rows
// < seq are copied; whatever lies above them is never read, so NaN there
// is harmless.  One token: Q.K two threads per row, each over half of hd
// in 16-byte pieces, the pieces' order staggered by thread so the row
// reads of a warp hit distinct banks; q is read as bf16 from shared
// memory; P.V: each thread owns 8 adjacent columns of hd over a slice of
// the rows (row r goes to slice r % slices); the slices' sums meet in
// shared memory in slice order.  TOKENS: both products on mma.sync (see
// the note in the kernel), and the copies go out before the PDL wait.
// KV (the cache kind, see above): an 8-bit tile streams as bytes; the
// one-token form decodes each 8-byte piece of a row to floats where it
// reads the bf16 one, and the n-token form converts each tile to one bf16
// tile (exact) before its mma.sync reads it.  KV_INT8 reads the split's
// scales (ks/vs, row stride srow) into shared memory once.
//
// Sliding window (`window` > 0, Mistral's semantics): the token at
// position p attends cached rows >= p + 1 - window (one token: p = seq;
// TOKENS: token t at seq + t, each row its own bound).  The splits keep
// their boundaries (multiples of `split` from row 0); the grid's blockIdx.y
// counts from the first split that holds a row at or above token 0's
// bound (the lowest), and the launcher sizes the grid to the live splits
// alone, so rows of earlier splits are neither copied nor computed.  Rows
// below a q row's bound in a live split are masked: they take no part in
// its max, and their p is 0; a split with no live row for a q row writes
// (max NEG_INF, sum 0) and zeros, which the merges fold as nothing.
// part_ml/part_acc are indexed by the live split (blockIdx.y, of
// gridDim.y).  window 0 (or >= seq + n_tok) masks nothing and runs the
// arithmetic of no window, bit for bit.
template <int MAXR, bool TOKENS, int KV = KV_BF16>
__global__ void __launch_bounds__(ATT_THREADS)
attn_split_kernel(const float* __restrict__ qkv,
                  const void* __restrict__ kc,
                  const void* __restrict__ vc,
                  const float* __restrict__ cos, const float* __restrict__ sin,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int group, int hd, int cap, int seq, int split, int neox, int n_tok,
                  const float* __restrict__ ks, const float* __restrict__ vs, int srow,
                  int window) {
  using KT = std::conditional_t<KV == KV_BF16, __nv_bfloat16, uint8_t>;   // a row element
  extern __shared__ __align__(16) unsigned char att_sm[];
  const int tr = min(split, ATT_TILE);
  // q rows: this block's, all of them, and the first's index
  const int qrows = TOKENS ? group * n_tok : group;
  const int r0 = TOKENS ? blockIdx.z * MAXR : 0;
  const int nq = TOKENS ? min(MAXR, qrows - r0) : group;
  uint64_t* bar = reinterpret_cast<uint64_t*>(att_sm);                       // [2]
  KT* ring = reinterpret_cast<KT*>(att_sm + 16);                             // [2][tr][hd]
  // an 8-bit n-token tile converted to bf16 for the mma.sync: [tr][hd]
  __nv_bfloat16* cvt = reinterpret_cast<__nv_bfloat16*>(ring + 2 * tr * hd);
  __nv_bfloat16* qb = cvt + (KV != KV_BF16 && TOKENS ? tr * hd : 0);        // [nq][hd]
  float* raw = reinterpret_cast<float*>(qb + nq * hd);                       // [nq][hd]
  float* sc = raw + nq * hd;                                                 // [nq][split]
  float* red = sc + nq * split;                                              // [slices][nq][hd]
  const int h = blockIdx.x, s = blockIdx.y, ns = gridDim.y;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int nw = blockDim.x / 32;
  // the first cached row q row r (of all qrows) attends: its token's bound
  auto row_lo = [&](int r) {
    return window > 0 ? max(0, seq + (TOKENS ? r % n_tok : 0) + 1 - window) : 0;
  };
  const int j0 = (row_lo(0) / split + s) * split;
  const int n = min(split, seq - j0);
  const int nt = (n + tr - 1) / tr;        // tiles of K, then as many of V
  const uint32_t row_bytes = (uint32_t)hd * sizeof(KT);
  const KT* kh = static_cast<const KT*>(kc) + ((size_t)h * cap + j0) * hd;
  const KT* vh = static_cast<const KT*>(vc) + ((size_t)h * cap + j0) * hd;
  // KV_INT8: the split's K and V scales, after the slices' sums
  float* sks = red + (TOKENS ? 0 : (ATT_THREADS / (hd / 8)) * nq * hd);     // [split]
  float* svs = sks + split;                                                  // [split]
  // KV_INT8: p enters the P.V dot as bf16(p * sv)
  auto p_in = [&](float p, int j) {
    if constexpr (KV == KV_INT8)
      return bf16_round(p * svs[j]);
    else
      return bf16_round(p);
  };
  // KV_INT8: a score is the dot times the row's K scale
  auto score = [&](float dot, int j) {
    if constexpr (KV == KV_INT8)
      return dot * sks[j];
    else
      return dot;
  };
  // the n-token products' bf16 tile of stage `u`: the ring's own, or
  // (8-bit) its rows converted into cvt by to_bf16, every thread taking part
  auto bf16_tile = [&](int u) -> const __nv_bfloat16* {
    if constexpr (KV == KV_BF16)
      return ring + (u & 1) * tr * hd;
    else
      return cvt;
  };
  auto to_bf16 = [&](int u, int trows) {
    const uint2* src = reinterpret_cast<const uint2*>(ring + (u & 1) * tr * hd);
    uint4* dst = reinterpret_cast<uint4*>(cvt);
    for (int e = tid; e < trows * hd / 8; e += blockDim.x) {
      float f[8];
      unpack8_kv<KV>(src[e], f);
      dst[e] = make_uint4(hopper::pack_bf16(f[0], f[1]), hopper::pack_bf16(f[2], f[3]),
                          hopper::pack_bf16(f[4], f[5]), hopper::pack_bf16(f[6], f[7]));
    }
    __syncthreads();
  };
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
  if constexpr (TOKENS) {
    // the verify's first kernel waits for all earlier work, so its cache
    // rows < seq are final before any of its kernels starts: their copies
    // go out before the wait, under the QKV product's tail
    __syncthreads();
    if (tid == 0) {
      issue(0);
      issue(1);
    }
    hopper::grid_dep_launch_dependents();
    hopper::grid_dep_wait();     // qkv comes from the kernel before
  } else {
    hopper::grid_dep_launch_dependents();
    hopper::grid_dep_wait();     // qkv and the cache rows come from earlier kernels
    __syncthreads();
    if (tid == 0) {
      issue(0);
      issue(1);
    }
  }

  const float scale = LOG2E / sqrtf((float)hd);
  if constexpr (TOKENS) {
    const size_t qkv_tok = (size_t)gridDim.x * (group + 2) * hd;
    for (int e = tid; e < nq * hd; e += blockDim.x) {
      const int r = r0 + e / hd;
      raw[e] = qkv[(r % n_tok) * qkv_tok + ((size_t)h * (group + 2) + r / n_tok) * hd + e % hd];
    }
    __syncthreads();
    for (int e = tid; e < nq * hd; e += blockDim.x) {
      const int i = e / hd, d = e % hd, t = (r0 + i) % n_tok;
      qb[e] = __float2bfloat16(rope_at(raw + i * hd, d, hd, cos + (size_t)t * hd,
                                       sin + (size_t)t * hd, neox) * scale);
    }
  } else {
    const float* qh = qkv + (size_t)h * (group + 2) * hd;
    for (int e = tid; e < group * hd; e += blockDim.x) raw[e] = qh[e];
    __syncthreads();
    for (int e = tid; e < group * hd; e += blockDim.x) {
      const int i = e / hd, d = e % hd;
      qb[e] = __float2bfloat16(rope_at(raw + i * hd, d, hd, cos, sin, neox) * scale);
    }
  }
  if constexpr (KV == KV_INT8) {
    for (int j = tid; j < n; j += blockDim.x) {
      sks[j] = ks[(size_t)h * srow + j0 + j];
      svs[j] = vs[(size_t)h * srow + j0 + j];
    }
  }
  __syncthreads();

  // TOKENS (hd 128): Q.K and P.V on mma.sync m16n8k16, the q rows as M
  // (padded to 16 with zeros), each k step's products summed from 0 and
  // the steps added in float32; a warp owns 16 keys of a K tile, then 32
  // columns of P.V, so no slices meet at the end.
  const int g = lane / 4, tq = lane % 4;
  uint32_t qa[TOKENS ? 8 : 1][4];          // Q as A fragments, hd / 16 k steps
  if constexpr (TOKENS) {
#pragma unroll
    for (int kd = 0; kd < 8; ++kd) {
      const __nv_bfloat16* q0 = qb + g * hd + kd * 16 + 2 * tq;
      auto ld = [&](const __nv_bfloat16* p, bool ok) {
        return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      };
      qa[kd][0] = ld(q0, g < nq);
      qa[kd][1] = ld(q0 + 8 * hd, g + 8 < nq);
      qa[kd][2] = ld(q0 + 8, g < nq);
      qa[kd][3] = ld(q0 + 8 * hd + 8, g + 8 < nq);
    }
    for (int t = 0; t < nt; ++t) {
      hopper::mbar_wait(&bar[t & 1], (t >> 1) & 1);
      const int trows = min(tr, n - t * tr), kb0 = wid * 16;
      if constexpr (KV != KV_BF16) to_bf16(t, trows);
      if (kb0 < trows) {
        // lane's ldmatrix row: keys kb0 + (lane / 16) * 8 .., d (lane / 8 & 1) * 8 ..
        const __nv_bfloat16* krow =
            bf16_tile(t) +
            min(kb0 + (lane / 16) * 8 + lane % 8, tr - 1) * hd + ((lane / 8) & 1) * 8;
        float sk[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kd = 0; kd < 8; ++kd) {
          uint32_t kf[4];
          hopper::ldmatrix_x4(kf, krow + kd * 16);
          float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
          hopper::mma_m16n8k16_bf16(p0, qa[kd], kf[0], kf[1]);
          hopper::mma_m16n8k16_bf16(p1, qa[kd], kf[2], kf[3]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sk[0][c] += p0[c];
            sk[1][c] += p1[c];
          }
        }
        // fragment c: q row g (+8 for c >= 2), key kb0 + 8j + 2tq (+1 odd c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = g + (c >> 1) * 8, k = kb0 + 8 * j + 2 * tq + (c & 1);
            if (row < nq && k < trows) sc[row * split + t * tr + k] = score(sk[j][c], t * tr + k);
          }
      }
      __syncthreads();                     // stage t & 1 is read
      if (tid == 0 && t + 2 < 2 * nt) issue(t + 2);
    }
  } else {
    // Q.K: row r = tid / 2 of each K tile, half tid % 2 of hd
    const int half = tid & 1, np = hd / 16;  // 16-byte pieces per half row
    for (int t = 0; t < nt; ++t) {
      hopper::mbar_wait(&bar[t & 1], (t >> 1) & 1);
      const int trows = min(tr, n - t * tr), r = tid >> 1;
      float acc[MAXR];
#pragma unroll
      for (int i = 0; i < MAXR; ++i) acc[i] = 0.f;
      if (r < trows) {
        const KT* krow = ring + (t & 1) * tr * hd + r * hd + half * (hd / 2);
        const __nv_bfloat16* qhalf = qb + half * (hd / 2);
        for (int c = 0; c < np; ++c) {
          const int pc = (c + tid) % np;
          float kf[8];
          if constexpr (KV == KV_BF16)
            unpack8(*reinterpret_cast<const uint4*>(krow + pc * 8), kf);
          else
            unpack8_kv<KV>(*reinterpret_cast<const uint2*>(krow + pc * 8), kf);
#pragma unroll
          for (int i = 0; i < MAXR; ++i) {
            if (i < nq) {
              float qf[8];
              unpack8(*reinterpret_cast<const uint4*>(qhalf + i * hd + pc * 8), qf);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[i] = fmaf(qf[e], kf[e], acc[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MAXR; ++i) {
        if (i < nq) {
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
          if (half == 0 && r < trows) sc[i * split + t * tr + r] = score(acc[i], t * tr + r);
        }
      }
      __syncthreads();                       // stage t & 1 is read
      if (tid == 0 && t + 2 < 2 * nt) issue(t + 2);
    }
  }

  // softmax statistics per query row: warp i handles rows i, i+nw, ...
  // (the window: rows j < jlo of this split are masked for row i)
  for (int i = wid; i < nq; i += nw) {
    const int jlo = row_lo(r0 + i) - j0;
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32)
      if (j >= jlo) mx = fmaxf(mx, sc[i * split + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = j >= jlo ? exp2f(sc[i * split + j] - mx) : 0.f;
      sum += p;
      sc[i * split + j] = p_in(p, j);      // the p.V dot takes bf16 p
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      float* ml = part_ml + (((size_t)h * ns + s) * qrows + r0 + i) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  __syncthreads();

  if constexpr (TOKENS) {
    float o[4][4];                         // columns 32 wid + 8j .., fragment c
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
    for (int t = 0; t < nt; ++t) {
      const int u = nt + t;
      hopper::mbar_wait(&bar[u & 1], (u >> 1) & 1);
      const int trows = min(tr, n - t * tr);
      if constexpr (KV != KV_BF16) to_bf16(u, trows);
      const float* pt = sc + t * tr;
      for (int k0 = 0; k0 < trows; k0 += 16) {
        // P rows g, g + 8 and keys k0 + 2tq (+1, +8, +9) as A; 0 past nq / trows
        auto p_at = [&](int row, int k) {
          return row < nq && k < trows ? pt[row * split + k] : 0.f;
        };
        const int ka = k0 + 2 * tq;
        const uint32_t pa[4] = {hopper::pack_bf16(p_at(g, ka), p_at(g, ka + 1)),
                                hopper::pack_bf16(p_at(g + 8, ka), p_at(g + 8, ka + 1)),
                                hopper::pack_bf16(p_at(g, ka + 8), p_at(g, ka + 9)),
                                hopper::pack_bf16(p_at(g + 8, ka + 8), p_at(g + 8, ka + 9))};
        const __nv_bfloat16* vrow = bf16_tile(u) +
                                    min(k0 + ((lane / 8) & 1) * 8 + lane % 8, tr - 1) * hd +
                                    32 * wid + (lane / 16) * 8;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t vf[4];
          hopper::ldmatrix_x4_trans(vf, vrow + 16 * nb);
          if (k0 + 16 > trows) {           // rows past the split's end: stale bytes
            auto keep = [&](uint32_t r, int k) {
              return (k < trows ? r & 0xffffu : 0u) | (k + 1 < trows ? r & 0xffff0000u : 0u);
            };
            vf[0] = keep(vf[0], ka);
            vf[1] = keep(vf[1], ka + 8);
            vf[2] = keep(vf[2], ka);
            vf[3] = keep(vf[3], ka + 8);
          }
          float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
          hopper::mma_m16n8k16_bf16(p0, pa, vf[0], vf[1]);
          hopper::mma_m16n8k16_bf16(p1, pa, vf[2], vf[3]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            o[2 * nb][c] += p0[c];
            o[2 * nb + 1][c] += p1[c];
          }
        }
      }
      __syncthreads();                     // stage u & 1 is read
      if (tid == 0 && u + 2 < 2 * nt) issue(u + 2);
    }
    // fragment c: q row g (+8 for c >= 2), column 32 wid + 8j + 2tq (+1 odd c)
    float* out = part_acc + (((size_t)h * ns + s) * qrows + r0) * hd;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = g + (c >> 1) * 8;
        if (row < nq) out[row * hd + 32 * wid + 8 * j + 2 * tq + (c & 1)] = o[j][c];
      }
  } else {
    // P.V: thread (slice sl, columns cg*8..cg*8+7) over rows sl, sl+slices, ...
    const int ncg = hd / 8, slices = ATT_THREADS / ncg;
    const int sl = tid / ncg, cg = tid % ncg;
    float pv[MAXR][8];
#pragma unroll
    for (int i = 0; i < MAXR; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) pv[i][c] = 0.f;
    for (int t = 0; t < nt; ++t) {
      const int u = nt + t;
      hopper::mbar_wait(&bar[u & 1], (u >> 1) & 1);
      const int trows = min(tr, n - t * tr);
      if (sl < slices) {
        const KT* vt = ring + (u & 1) * tr * hd + cg * 8;
        const float* pt = sc + t * tr;
        for (int r = sl; r < trows; r += slices) {
          float vf[8];
          if constexpr (KV == KV_BF16)
            unpack8(*reinterpret_cast<const uint4*>(vt + r * hd), vf);
          else
            unpack8_kv<KV>(*reinterpret_cast<const uint2*>(vt + r * hd), vf);
#pragma unroll
          for (int i = 0; i < MAXR; ++i) {
            if (i < nq) {
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
      for (int i = 0; i < MAXR; ++i) {
        if (i < nq) {
#pragma unroll
          for (int c = 0; c < 8; ++c) red[(sl * nq + i) * hd + cg * 8 + c] = pv[i][c];
        }
      }
    }
    __syncthreads();
    float* out = part_acc + (((size_t)h * ns + s) * qrows + r0) * hd;
    for (int e = tid; e < nq * hd; e += blockDim.x) {
      float a = 0.f;
      for (int q = 0; q < slices; ++q) a += red[q * nq * hd + e];
      out[e] = a;
    }
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

// The splits of `split` rows the split pass runs over `seq` cached rows
// under a window (0: none) for the token at position seq (the verify's
// first, whose bound is the lowest): from the first that holds a row at or
// above seq + 1 - window to the last, none where no row is in the window.
inline int attn_live_splits(int seq, int split, int window) {
  const int wlo = window > 0 ? std::max(0, seq + 1 - window) : 0;
  return wlo < seq ? (seq + split - 1) / split - wlo / split : 0;
}

// Launch the split pass (when a cached row is in the window) and the merge
// pass of one layer on `st`; part_ml/part_acc hold kv*ns*group*2 and
// kv*ns*group*hd floats.  window: 0, or the sliding window (the split pass's
// note).  *n counts the launches.  Returns a cudaError_t.
int launch_attention(const float* qkv, const __nv_bfloat16* kc_read,
                     const __nv_bfloat16* vc_read, const float* cos,
                     const float* sin, float* part_ml, float* part_acc,
                     __nv_bfloat16* kc_append, __nv_bfloat16* vc_append,
                     __nv_bfloat16* knew, __nv_bfloat16* vnew, __nv_bfloat16* o,
                     float* acc_out, float* ml_out, int kv_heads, int group,
                     int hd, int cap, int seq, int split, int fold, int neox,
                     cudaStream_t st, int* n, bool pdl = false, int window = 0) {
  if (group < 1 || group > ATT_MAX_GROUP || hd % 32 != 0 || hd > 4 * 32 ||
      split < 1 || split > ATT_MAX_SPLIT || seq < 0 || seq > cap || window < 0)
    return (int)cudaErrorInvalidValue;
  static bool attrs_set = false;
  if (!attrs_set) {
    CF_CHECK((int)cudaFuncSetAttribute(attn_split_kernel<ATT_MAX_GROUP, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ATT_SPLIT_SMEM_MAX));
    attrs_set = true;
  }
  const int ns = attn_live_splits(seq, split, window);
  const size_t split_smem = attn_split_smem(group, hd, split);
  const size_t merge_smem = sizeof(float) * ((size_t)(2 * group + 3) * hd + group);
  if (split_smem > (size_t)ATT_SPLIT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (ns > 0) {
    CF_CHECK(launch_kernel(attn_split_kernel<ATT_MAX_GROUP, false>, dim3(kv_heads, ns),
                           dim3(ATT_THREADS), split_smem, st, pdl, qkv, kc_read, vc_read, cos,
                           sin, part_ml, part_acc, group, hd, cap, seq, split, neox, 1,
                           (const float*)nullptr, (const float*)nullptr, 0, window));
    ++*n;
  }
  CF_CHECK(launch_kernel(attn_merge_kernel, dim3(kv_heads), dim3(ATT_THREADS), merge_smem,
                         st, pdl, qkv, part_ml, part_acc, cos, sin, kc_append, vc_append,
                         knew, vnew, o, acc_out, ml_out, group, hd, cap, seq, ns, fold,
                         neox));
  ++*n;
  return 0;
}

// The merge pass of the stack on an 8-bit cache (KV): attn_merge_kernel's
// fold of the ns split partials and the current token from the f32 q/k/v,
// and o[r*hd + d] = bf16(acc / l); the append stores the float32 k and v
// rows at row `seq` as store_row8 does (int8: their scales at ks/vs[h *
// srow + seq]), or with `row_bf16` those rows rounded to bf16 first (the
// TPU kernel's hd-64 form, whose deferred append lands the bf16 rows:
// int8 codes and scale of the bf16 row, e4m3 of the bf16 row); the fold
// takes the float32 rows either way.  A template, so that only the unit
// that launches it (stack_kernel.cu) emits it; the bf16 kernel above keeps
// its own body.
template <int KV>
__global__ void __launch_bounds__(ATT_THREADS)
attn_merge8_kernel(const float* __restrict__ qkv,
                   const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc,
                   const float* __restrict__ cos, const float* __restrict__ sin,
                   uint8_t* __restrict__ kc, uint8_t* __restrict__ vc,
                   __nv_bfloat16* __restrict__ o, int group, int hd, int cap, int seq,
                   int ns, int neox, float* __restrict__ ks, float* __restrict__ vs,
                   int srow, int row_bf16) {
  hopper::grid_dep_launch_dependents();   // the O-projection may start
  hopper::grid_dep_wait();
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
    kr[d] = rope_at(raw + group * hd, d, hd, cos, sin, neox);
  }
  __syncthreads();
  const size_t row = ((size_t)h * cap + seq) * hd;
  const size_t at = (size_t)h * srow + seq;   // int8: the row's scale
  store_row8<KV>([&](int d) { return row_bf16 ? bf16_round(kr[d]) : kr[d]; }, hd, kc + row,
                 ks ? ks + at : nullptr, red);
  store_row8<KV>([&](int d) { return row_bf16 ? bf16_round(vraw[d]) : vraw[d]; }, hd, vc + row,
                 vs ? vs + at : nullptr, red);
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

// The split pass (when a cached row is in the window) and
// attn_merge8_kernel of one layer of the stack on an 8-bit cache (KV) on
// `st`, as launch_attention launches the bf16 ones: kc/vc the layer's
// 8-bit rows, read below seq and appended at
// seq (from the bf16-rounded rows when row_bf16); KV_INT8: ks/vs the
// layer's scale planes, row stride srow; window: 0 or the sliding window.
// *n counts the launches.  Returns a cudaError_t.
template <int KV>
int launch_attention8(const float* qkv, uint8_t* kc, uint8_t* vc, const float* cos,
                      const float* sin, float* part_ml, float* part_acc, __nv_bfloat16* o,
                      float* ks, float* vs, int srow, int kv_heads, int group, int hd,
                      int cap, int seq, int split, int neox, cudaStream_t st, int* n,
                      bool pdl, bool row_bf16, int window) {
  if (group < 1 || group > ATT_MAX_GROUP || hd % 32 != 0 || hd > 4 * 32 ||
      split < 1 || split > ATT_MAX_SPLIT || seq < 0 || seq > cap || window < 0 ||
      (KV == KV_INT8 && (!ks || !vs || srow < cap)))
    return (int)cudaErrorInvalidValue;
  static bool attrs_set = false;
  if (!attrs_set) {
    CF_CHECK((int)cudaFuncSetAttribute(attn_split_kernel<ATT_MAX_GROUP, false, KV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       ATT_SPLIT_SMEM_MAX));
    attrs_set = true;
  }
  const int ns = attn_live_splits(seq, split, window);
  const size_t split_smem = attn_split_smem(group, hd, split, false, KV);
  const size_t merge_smem = sizeof(float) * ((size_t)(2 * group + 3) * hd + group);
  if (split_smem > (size_t)ATT_SPLIT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (ns > 0) {
    CF_CHECK(launch_kernel(attn_split_kernel<ATT_MAX_GROUP, false, KV>, dim3(kv_heads, ns),
                           dim3(ATT_THREADS), split_smem, st, pdl, qkv, (const void*)kc,
                           (const void*)vc, cos, sin, part_ml, part_acc, group, hd, cap, seq,
                           split, neox, 1, (const float*)ks, (const float*)vs, srow,
                           window));
    ++*n;
  }
  CF_CHECK(launch_kernel(attn_merge8_kernel<KV>, dim3(kv_heads), dim3(ATT_THREADS), merge_smem,
                         st, pdl, qkv, part_ml, part_acc, cos, sin, kc, vc, o, group, hd, cap,
                         seq, ns, neox, ks, vs, srow, (int)row_bf16));
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

// The widest box dimension (a multiple of `unit`, at most 256 elements,
// TMA's limit) that divides both a and b (multiples of unit): a box's inner
// width when a tile of a columns starts at multiples of a in rows of b
// columns.  TMA wants a box's inner extent in whole 16-byte units: 8 bf16
// elements, 16 int8 ones.
inline int ol_box_width(int a, int b, int unit = 8) {
  for (int w = 256; w > unit; w -= unit)
    if (a % w == 0 && b % w == 0) return w;
  return unit;
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
// t, t + OL_THREADS, ... of every row.  W8: the weights are int8 codes, a
// piece 8 bytes (one 8-byte shared load, made exact floats by unpack8_s8),
// and the FMA chain and its order are the bf16 product's.
template <int NP, bool W8 = false>
__device__ __forceinline__ void tile_gemv(const unsigned char* stage, int pitch, int p1,
                                          int half, int rows, const float* x, int P,
                                          float (&acc)[NP][8]) {
  const int t = threadIdx.x;
  constexpr int PB = W8 ? 8 : 16;                 // bytes per piece
  auto piece = [&](int p) { return stage + (p < p1 ? p * PB : half + (p - p1) * PB); };
  auto load8 = [](const unsigned char* at, float* f) {
    if constexpr (W8)
      unpack8_s8(*reinterpret_cast<const uint2*>(at), f);
    else
      unpack8(*reinterpret_cast<const uint4*>(at), f);
  };
  if (P <= OL_THREADS) {
    const int RG = OL_THREADS / P, p = t % P, rg = t / P;
    if (rg >= RG) return;
    const unsigned char* base = piece(p);
#pragma unroll 4
    for (int j = rg; j < rows; j += RG) {
      float f[8];
      load8(base + (size_t)j * pitch, f);
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
          load8(piece(p) + (size_t)j * pitch, f);
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[q][c] = fmaf(xj, f[c], acc[q][c]);
        }
      }
    }
  }
}

// out[8p + c] = the sum of tile_gemv's acc over the row groups, in group
// order (red: OL_RED_FLOATS floats of shared memory); out may be global.
// SC: each sum times scale[8p + c] (an int8 product's per-column scale).
// Ends with a barrier of the consumers.
template <int NP, bool SC>
__device__ __forceinline__ void tile_gemv_reduce_body(const float (&acc)[NP][8], int P,
                                                      float* red, float* out,
                                                      const float* scale) {
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
      out[e] = SC ? s * scale[e] : s;
    }
  } else {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = t + q * OL_THREADS;
      if (p < P)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          out[(size_t)p * 8 + c] = SC ? acc[q][c] * scale[(size_t)p * 8 + c] : acc[q][c];
    }
  }
  ol_cbar();
}

template <int NP>
__device__ void tile_gemv_reduce(const float (&acc)[NP][8], int P, float* red, float* out) {
  tile_gemv_reduce_body<NP, false>(acc, P, red, out, nullptr);
}

// The same, each sum scaled by scale[8p + c].
template <int NP>
__device__ void tile_gemv_reduce_scaled(const float (&acc)[NP][8], int P, float* red,
                                        float* out, const float* scale) {
  tile_gemv_reduce_body<NP, true>(acc, P, red, out, scale);
}

// One 8-column piece of a stage of int4 codes (kernel 6's int4 instances):
// packed rows r0, r0 + rstep, ... (A8: pairs of them) of `rows`, `pitch`
// bytes apart from base (the piece's first byte), row j holding k rows 2j
// (low nibbles) and 2j + 1 (high) of 8 columns, a byte each.  The stage's
// k rows are kr0.. of the matrix; k row k falls in scale group (kr0 + k) /
// GS4, whose float32 scales of the piece's columns are sc[group * sstride
// + 0..7] (reloaded, and rounded to bf16 as the TPU kernel streams them,
// when the rows enter a new group).  Exact (A8 false): x holds the stage's
// k rows as floats; the weights are bf16(code * bf16(s)) and the chain the
// ring GEMV's exact one.  A8 (W4A8): x8 holds them as int8, four k rows a
// word; a pair of packed rows (four k rows) is one dp4a a column on the
// biased codes, summed in int32 within a group, and at the group's end
// (sum - 8 * sum(x8)) * bf16(s) joins acc (x's scale is the caller's).
template <bool A8>
__device__ __forceinline__ void gemv4_piece(const unsigned char* base, int pitch, int rows,
                                            int r0, int rstep, int kr0, const float* x,
                                            const int* x8, const float* sc, size_t sstride,
                                            float (&acc)[8]) {
  int cur = -1;
  float scl[8];
  auto load = [&](int grp) {
    const float4* s4 = reinterpret_cast<const float4*>(sc + (size_t)grp * sstride);
    const float4 a = __ldg(s4), b = __ldg(s4 + 1);
    scl[0] = a.x; scl[1] = a.y; scl[2] = a.z; scl[3] = a.w;
    scl[4] = b.x; scl[5] = b.y; scl[6] = b.z; scl[7] = b.w;
  };
  if constexpr (A8) {
    int part[8], sx = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) part[c] = 0;
    auto flush = [&]() {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[c] = fmaf((float)(part[c] - 8 * sx), bf16_round(scl[c]), acc[c]);
        part[c] = 0;
      }
      sx = 0;
    };
    for (int q = r0; q < rows / 2; q += rstep) {
      const int grp = (kr0 + 4 * q) / GS4;
      if (grp != cur) {
        if (cur >= 0) flush();
        load(grp);
        cur = grp;
      }
      const uint2 u0 = *reinterpret_cast<const uint2*>(base + (size_t)(2 * q) * pitch);
      const uint2 u1 = *reinterpret_cast<const uint2*>(base + (size_t)(2 * q + 1) * pitch);
      const int xw = x8[q];
      sx = dp4a_ss(xw, 0x01010101, sx);
      s4_dot4(u0.x, u1.x, xw, part[0], part[1], part[2], part[3]);
      s4_dot4(u0.y, u1.y, xw, part[4], part[5], part[6], part[7]);
    }
    if (cur >= 0) flush();
  } else {
    uint32_t s2[8];
#pragma unroll 2
    for (int j = r0; j < rows; j += rstep) {
      const int grp = (kr0 + 2 * j) / GS4;
      if (grp != cur) {
        load(grp);
#pragma unroll
        for (int c = 0; c < 8; ++c) s2[c] = bf16_pair_of(scl[c]);
        cur = grp;
      }
      const uint2 u = *reinterpret_cast<const uint2*>(base + (size_t)j * pitch);
      uint32_t pr[2][4];
      s4_bf16_pairs(u.x, pr[0]);
      s4_bf16_pairs(u.y, pr[1]);
      const float x0 = x[2 * j], x1 = x[2 * j + 1];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t w2 = scale_pair(pr[c / 4][c % 4], s2[c]);
        acc[c] = fmaf(x0, __uint_as_float(w2 << 16), acc[c]);
        acc[c] = fmaf(x1, __uint_as_float(w2 & 0xffff0000u), acc[c]);
      }
    }
  }
}

// tile_gemv for a stage of int4 codes: thread t's pieces as tile_gemv
// takes them (P pieces of 8 columns, 8 bytes, a row; with P <= OL_THREADS
// row groups of packed rows, A8: of pairs of them), each through
// gemv4_piece; sc points at the scales of the tile's first column.
template <int NP, bool A8>
__device__ __forceinline__ void tile_gemv4(const unsigned char* stage, int pitch, int rows,
                                           int kr0, const float* x, const int* x8, int P,
                                           const float* sc, size_t sstride,
                                           float (&acc)[NP][8]) {
  const int t = threadIdx.x;
  if (P <= OL_THREADS) {
    const int RG = OL_THREADS / P, p = t % P, rg = t / P;
    if (rg < RG)
      gemv4_piece<A8>(stage + 8 * p, pitch, rows, rg, RG, kr0, x, x8, sc + 8 * p, sstride,
                      acc[0]);
  } else {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = t + q * OL_THREADS;
      if (p < P)
        gemv4_piece<A8>(stage + 8 * p, pitch, rows, 0, 1, kr0, x, x8, sc + 8 * p, sstride,
                        acc[q]);
    }
  }
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
