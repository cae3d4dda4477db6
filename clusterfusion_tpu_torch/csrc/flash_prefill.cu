// Causal GQA flash-attention prefill for Hopper (sm_90a): wgmma tensor
// cores fed by TMA.
//
// Replaces the TPU kernel `flash_prefill_attention`
// (clusterfusion_tpu/ops/flash_prefill.py, `_flash_prefill_kernel`), with
// the same layouts: q [kv_heads, T, group, hd] (contiguous), k/v
// [kv_heads, S, hd] with rows of hd contiguous elements and any head
// stride (a view of a cache is read where it lies), out [kv_heads, T,
// group, hd], all bf16.  Query i sits at absolute position q_offset + i
// and attends keys 0 .. q_offset + i; keys past q_offset + T - 1 are never
// read.
//
// What bounds it: a causal prefill does 4 hd kv group T(T+1)/2 operations
// on (2 T group + 2 (q_offset + T)) kv hd bf16 values.  At short prompts
// (a few hundred tokens) the bytes and the launch bound it: every K/V row
// is copied once per row tile by TMA, in 64-key tiles through a two-stage
// ring, so the copy of tile j+1 runs under the products of tile j.  From
// about a thousand tokens on, operations bound it, and both products run
// on the tensor cores (wgmma, bf16 in, float32 accumulators), never as
// scalar FMAs.
//
// Design:
// - One block per (kv head, tile of BR = 64 x NWG panel rows).  The panel
//   of kv head h is q[h] seen as [T*group, hd]: row r is query r / group,
//   so every row of a tile reads the same K/V (the TPU kernel's GQA
//   panel).  Blocks are launched with the row tiles that need the most key
//   tiles first, so the causal triangle leaves no tail of long blocks.
// - Warp roles: NWG consumer warpgroups, each owning 64 panel rows (the
//   wgmma M), and one producer warp whose lane 0 issues every TMA copy.
//   Q's tile is loaded once; K and V tiles of BK = 64 keys go into a ring
//   of STAGES = 2 stages, each with a "full" mbarrier (TMA bytes landed)
//   and an "empty" one (every consumer warp is done with it), K and V
//   apart, so S = Q K^T can start before V has landed.
// - All tiles use the 128-byte swizzle: a tile of R rows x hd is hd/64
//   column blocks of R x 128 bytes, each copied by one TMA box.
// - S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory,
//   float32 accumulators in registers (32 per thread).
// - Online softmax in registers in the exp2 domain, 1/sqrt(hd) * log2(e)
//   folded into one multiplier; a row's max reduces over the four lanes
//   that hold it; the row sum stays per thread until the epilogue.
// - P is rounded to bf16 in registers (as the TPU kernel's
//   p.astype(v.dtype)) and is already in the A-operand layout of the next
//   wgmma: O += P V is wgmma m64n{hd}k16 with A from registers and V read
//   as B in its natural [keys, hd] layout through the descriptor's
//   transpose (MN-major) mode.  V is never transposed in memory.
// - Causality: key tiles wholly above a row tile's diagonal are neither
//   copied nor computed (a warpgroup whose rows end earlier than its
//   block's also skips the block's last tiles); only tiles crossing the
//   diagonal are masked elementwise.
// - Ragged edges: T*group off the row tile and q_offset + T off the key
//   tile are zero-filled by TMA (the K/V maps end at key q_offset + T - 1)
//   and masked; the output store clips rows past T*group.
// - Epilogue: divide by l, round to bf16, write the warpgroup's rows over
//   its own (consumed) Q rows in shared memory, one TMA store per column
//   block.
// - hd 64 and 128 (templates); BR 64 or 128 (one or two consumer
//   warpgroups).  No persistent scheduler, no ping-pong between
//   warpgroups: later work.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BK = 64;       // keys per K/V tile
constexpr int STAGES = 2;    // depth of the K/V ring
constexpr int ROWB = 128;    // bytes of one swizzled tile row (64 bf16)

template <int HD, int NWG>
struct Cfg {
  static constexpr int BR = 64 * NWG;            // panel rows per block
  static constexpr int CB = HD / 64;             // 64-column blocks
  static constexpr int Q_BYTES = BR * HD * 2;    // Q tile (later: O)
  static constexpr int KV_BYTES = BK * HD * 2;   // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int THREADS = NWG * 128 + 32;
};

template <int HD, int NWG>
__global__ void __launch_bounds__(Cfg<HD, NWG>::THREADS, NWG == 1 ? 2 : 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap, int T,
                     int group, int q_offset, float qscale) {
  using C = Cfg<HD, NWG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q;
  __shared__ uint64_t full_k[STAGES], full_v[STAGES];
  __shared__ uint64_t empty_k[STAGES], empty_v[STAGES];
  // tiles start on a 1024-byte boundary, as the 128-byte swizzle needs
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + C::Q_BYTES;                  // [STAGES][CB][BK rows]
  uint8_t* vs = ks + STAGES * C::KV_BYTES;

  const int h = blockIdx.x;
  const int rows = T * group;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * C::BR;  // longest first
  const int n_kt = (q_offset + (min(r0 + C::BR, rows) - 1) / group) / BK + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 4 * NWG);
      mbar_init(&empty_v[s], 4 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: one thread issues every copy ----
    if (lane == 0) {
      mbar_arrive_expect_tx(&bar_q, C::Q_BYTES);
#pragma unroll
      for (int j = 0; j < C::CB; ++j)
        tma_load_3d(qs + j * C::BR * ROWB, &qmap, &bar_q, 64 * j, r0, h);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        const uint32_t ph = (kt / STAGES) & 1;
        mbar_wait(&empty_k[s], ph ^ 1);
        mbar_arrive_expect_tx(&full_k[s], C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < C::CB; ++j)
          tma_load_3d(ks + s * C::KV_BYTES + j * BK * ROWB, &kmap, &full_k[s],
                      64 * j, kt * BK, h);
        mbar_wait(&empty_v[s], ph ^ 1);
        mbar_arrive_expect_tx(&full_v[s], C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < C::CB; ++j)
          tma_load_3d(vs + s * C::KV_BYTES + j * BK * ROWB, &vmap, &full_v[s],
                      64 * j, kt * BK, h);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns panel rows rw0 .. rw0 + 63 ----
  const int wg = warp / 4, wl = warp % 4;
  const int rw0 = r0 + 64 * wg;
  const bool wg_rows = rw0 < rows;
  // key tiles this warpgroup needs, and the first that crosses its diagonal
  const int n_kt_w =
      wg_rows ? (q_offset + (min(rw0 + 64, rows) - 1) / group) / BK + 1 : 0;
  const int diag_lo = q_offset + rw0 / group;
  // accumulator rows of this thread: rq (slots 0, 1) and rq + 8 (2, 3)
  const int rq = rw0 + 16 * wl + lane / 4;
  const int qpos0 = q_offset + rq / group;
  const int qpos1 = q_offset + (rq + 8) / group;
  const int c2 = 2 * (lane % 4);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const uint32_t q_base = smem_u32(qs) + wg * 64 * ROWB;
  const uint32_t k_base = smem_u32(ks), v_base = smem_u32(vs);

  mbar_wait(&bar_q, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES;
    const uint32_t ph = (kt / STAGES) & 1;
    const bool active = kt < n_kt_w;
    float sacc[32];
    uint32_t pa[BK / 16][4];

    mbar_wait(&full_k[s], ph);
    if (active) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < C::CB; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss(
              sacc, desc_sw128(q_base + j * C::BR * ROWB + kk * 32, 16, 1024),
              desc_sw128(k_base + s * C::KV_BYTES + j * BK * ROWB + kk * 32,
                         16, 1024),
              (j | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_k[s]);

    if (active) {
      if (kt * BK + BK - 1 > diag_lo) {        // tile crosses the diagonal
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int key = kt * BK + 8 * nb + c2 + j;
            if (key > qpos0) sacc[4 * nb + j] = -INFINITY;
            if (key > qpos1) sacc[4 * nb + 2 + j] = -INFINITY;
          }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * nb], sacc[4 * nb + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * nb + 2], sacc[4 * nb + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // key 0 lies in tile 0 and is live for every row: mx is finite
      const float alpha0 = fast_exp2((m0 - mx0) * qscale);
      const float alpha1 = fast_exp2((m1 - mx1) * qscale);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = mx0 * qscale, mb1 = mx1 * qscale;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p0 = fast_exp2(fmaf(sacc[4 * nb + j], qscale, -mb0));
          const float p1 = fast_exp2(fmaf(sacc[4 * nb + 2 + j], qscale, -mb1));
          sacc[4 * nb + j] = p0;
          sacc[4 * nb + 2 + j] = p1;
          rs0 += p0;
          rs1 += p1;
        }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n] *= alpha0;
        o[4 * n + 1] *= alpha0;
        o[4 * n + 2] *= alpha1;
        o[4 * n + 3] *= alpha1;
      }
      // the S accumulator of keys 16kk..16kk+15 is the A fragment of P
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    }

    mbar_wait(&full_v[s], ph);
    if (active) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc_sw128(
            v_base + s * C::KV_BYTES + kk * 16 * ROWB, BK * ROWB, 1024);
        if constexpr (HD == 128)
          wgmma_m64n128k16_rs_tb(o, pa[kk], db, 1);
        else
          wgmma_m64n64k16_rs_tb(o, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_v[s]);
  }

  if (!wg_rows) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  // the warpgroup's Q rows are consumed: they take its output rows
  uint8_t* slab = qs + wg * 64 * ROWB;
  named_barrier_sync(1 + wg, 128);
  const int rl = 16 * wl + lane / 4;          // (rl % 8) == lane / 4
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    uint8_t* cell = slab + (n / 8) * C::BR * ROWB +
                    (((n % 8) ^ (lane / 4)) << 4) + 2 * c2;
    *reinterpret_cast<uint32_t*>(cell + rl * ROWB) =
        pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(cell + (rl + 8) * ROWB) =
        pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int j = 0; j < C::CB; ++j)
      tma_store_3d(&omap, slab + j * C::BR * ROWB, 64 * j, rw0, h);
    tma_store_commit_and_wait();
  }
}

template <int HD, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, int kv_heads,
           int T, int group, int q_offset, long long k_hs, long long v_hs,
           cudaStream_t stream) {
  using C = Cfg<HD, NWG>;
  const uint64_t rows = (uint64_t)T * group;
  const uint64_t keys = (uint64_t)q_offset + T;   // the maps end at the
  const uint64_t rb = HD * 2;                     // last key any row reads
  CUtensorMap qm, km, vm, om;
  if (!make_tensor_map_bf16(&qm, q, HD, rows, kv_heads, rb, rows * rb, 64,
                            C::BR) ||
      !make_tensor_map_bf16(&km, k, HD, keys, kv_heads, rb,
                            (uint64_t)k_hs * 2, 64, BK) ||
      !make_tensor_map_bf16(&vm, v, HD, keys, kv_heads, rb,
                            (uint64_t)v_hs * 2, 64, BK) ||
      !make_tensor_map_bf16(&om, o, HD, rows, kv_heads, rb, rows * rb, 64, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<HD, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kv_heads, (unsigned)((rows + C::BR - 1) / C::BR));
  const float qscale = 1.4426950408889634f / sqrtf((float)HD);
  flash_prefill_kernel<HD, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, om, T, group, q_offset, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for a shape,
// stride or alignment the tensor maps refuse).  block_rows: 64 or 128
// panel rows per block; head_dim: 64 or 128.  k/v rows are head_dim
// contiguous elements; k_head_stride / v_head_stride are in elements
// (multiples of 8, base addresses 16-byte aligned).
extern "C" int cf_flash_prefill(const void* q, const void* k, const void* v,
                                void* o, int kv_heads, int T, int group, int S,
                                int head_dim, int q_offset, int block_rows,
                                long long k_head_stride,
                                long long v_head_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || kv_heads <= 0) return 0;
  if (group <= 0 || q_offset < 0 || q_offset + T > S)
    return (int)cudaErrorInvalidValue;
  if (head_dim == 128 && block_rows == 128)
    return launch<128, 2>(q, k, v, o, kv_heads, T, group, q_offset,
                          k_head_stride, v_head_stride, st);
  if (head_dim == 128 && block_rows == 64)
    return launch<128, 1>(q, k, v, o, kv_heads, T, group, q_offset,
                          k_head_stride, v_head_stride, st);
  if (head_dim == 64 && block_rows == 128)
    return launch<64, 2>(q, k, v, o, kv_heads, T, group, q_offset,
                         k_head_stride, v_head_stride, st);
  if (head_dim == 64 && block_rows == 64)
    return launch<64, 1>(q, k, v, o, kv_heads, T, group, q_offset,
                         k_head_stride, v_head_stride, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
