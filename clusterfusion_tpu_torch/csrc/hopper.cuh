// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA tensor copies and 1-D bulk copies, programmatic dependent launch,
// wgmma shared-memory descriptors and the wgmma instructions themselves,
// and the warp-level ldmatrix / mma.sync pair.  Each helper is a thin wrapper over one PTX instruction (or a short fixed
// sequence) and says which.
//
// Conventions:
// - Shared-memory addresses are 32-bit `.shared` addresses (smem_u32).
// - Tiles that TMA or wgmma touch use the 128-byte swizzle: a tile is a
//   stack of 128-byte rows (64 bf16), 8 rows form a 1024-byte swizzle
//   atom, and every tile base is 1024-byte aligned, so TMA's swizzle and
//   the descriptor's agree on every address.
// - Tensor maps are passed to kernels as `const __grid_constant__
//   CUtensorMap` parameters and encoded on the host through the driver
//   entry point (make_tensor_map_bf16 below); the shared library links no
//   libcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Addresses
// ---------------------------------------------------------------------------

// Generic pointer -> 32-bit shared-state-space address (cvta.to.shared).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

// mbarrier.init: a barrier whose phase completes after `count` arrivals
// (plus whatever transaction bytes are expected).  One thread initialises;
// call fence_barrier_init() and a block barrier before any use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// fence.mbarrier_init: makes the initialised barriers visible to the async
// proxy (TMA) and to the other threads after the following block barrier.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// mbarrier.arrive.expect_tx: one arrival that also announces `bytes` of
// transactions (TMA copies) that must land before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// mbarrier.arrive: one plain arrival.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// mbarrier.try_wait.parity: true once the phase of parity `parity` has
// completed (the phase before the first one counts as completed, so a
// wait on parity 1 of a fresh barrier passes at once).
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin on mbar_try_wait.  A wait that lasts longer than 4 s (a protocol
// fault, never a slow copy) executes `trap`, so the launch fails with an
// error the caller sees at its next synchronisation instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint64_t t0 = global_ns();
  uint32_t spins = 0;
  while (!mbar_try_wait(a, parity)) {
    if ((++spins & 1023u) == 0 && global_ns() - t0 > 4000000000ull)
      asm volatile("trap;");
  }
}

// ---------------------------------------------------------------------------
// TMA (cp.async.bulk.tensor)
// ---------------------------------------------------------------------------

// cp.async.bulk.tensor.2d global -> shared: copies the box at coordinates
// (c0 innermost, c1) of a 2-D `map` to `dst`; the bytes complete on `bar`.
// Out-of-bounds parts of the box are filled with zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// cp.async.bulk.tensor.3d global -> shared: copies the box at coordinates
// (c0 innermost, c1, c2) of `map` to `dst`; the bytes complete on `bar`.
// Out-of-bounds parts of the box are filled with zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// cp.async.bulk global -> shared (no tensor map): copies `bytes` contiguous
// bytes from `src` to `dst`; the bytes complete on `bar`.  Both addresses
// 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// cp.async.bulk.tensor.3d shared -> global (bulk group): stores the box at
// (c0, c1, c2) from `src`; parts outside the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cp.async.bulk.commit_group + wait_group.read 0: the issuing thread waits
// until its TMA stores have read their shared-memory source.
__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// fence.proxy.async.shared::cta: orders this thread's ordinary shared
// stores before later async-proxy accesses (a TMA store or a wgmma read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Programmatic dependent launch.  griddepcontrol.wait: wait until the
// grids this one depends on have completed and their writes are visible
// (returns at once in a kernel launched without the attribute).
// griddepcontrol.launch_dependents: let the next kernel on the stream, if
// launched with cudaLaunchAttributeProgrammaticStreamSerialization, start
// once every block of this grid has executed it or exited.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Split cluster barrier: barrier.cluster.arrive (release) and
// barrier.cluster.wait (acquire), each executed by whole warps.  A thread
// arrives once per phase and waits for that phase before it arrives again;
// between the two it may keep working (cg::this_cluster().sync() is the
// pair back to back).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// bar.sync on a named barrier shared by `threads` threads (a warpgroup:
// 128).  Id 0 is __syncthreads'.
__device__ __forceinline__ void named_barrier_sync(uint32_t id,
                                                   uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor for a 128-byte-swizzled tile (layout
// type 1 in bits 62-63).  Offsets are in bytes; the descriptor stores
// them in 16-byte units.  K-major operand (the reduction dimension
// contiguous): `sbo` = 1024, the stride between 8-row groups; `lbo` is
// unused (1 unit).  MN-major operand (the output dimension contiguous):
// `lbo` = stride between 64-element column blocks, `sbo` = stride between
// groups of 8 rows along the reduction dimension (1024).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// wgmma.fence: orders earlier register and shared-memory writes before the
// next wgmma.mma_async of this warpgroup.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// wgmma.commit_group: closes the group of wgmma.mma_async issued so far.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wgmma.wait_group N: waits until at most N groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// An empty asm that claims to read and write `r`: keeps the compiler from
// moving uses of a wgmma accumulator across the wait that completes it.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(d[i]);
}

#define CF_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CF_F16(d, i) CF_F4(d, i), CF_F4(d, i + 4), CF_F4(d, i + 8), CF_F4(d, i + 12)
#define CF_F32(d, i) CF_F16(d, i), CF_F16(d, i + 16)

// wgmma.mma_async m64n64k16 f32 += bf16 x bf16, A and B from shared memory
// (both K-major).  d: the 64x64 float32 accumulator, 32 per thread.
// scale_d 0 overwrites d with A*B, 1 accumulates.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : CF_F32(d, 0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma.mma_async m64n64k16 f32 += bf16 x bf16, A from registers (four
// bf16 pairs per thread in the accumulator-row layout), B from shared
// memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : CF_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The same with N = 128: d holds the 64x128 accumulator, 64 per thread.
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n"
      "}\n"
      : CF_F32(d, 0), CF_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef CF_F32
#undef CF_F16
#undef CF_F4

// ---------------------------------------------------------------------------
// Small math
// ---------------------------------------------------------------------------

// ex2.approx.ftz.f32: 2^x, with 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats -> one register of two bf16 (lo in the low half), rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ldmatrix.sync.aligned.m8n8.x4.shared.b16: four 8x8 bf16 matrices, lane
// i giving the 16-byte row (i % 8) of matrix i / 8; register j holds
// matrix j, lane l its elements [l/4][2*(l%4)] and [l/4][2*(l%4)+1] (the
// layout of an mma.sync A fragment, and of a B fragment when the matrix's
// rows are n and its columns k).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// The same with two matrices (lanes 0-15 give the rows; the rest are
// ignored).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(row)));
}

// ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16: four 8x8 bf16 matrices,
// lane i giving the 16-byte row (i % 8) of matrix i / 8; register j holds
// matrix j transposed, lane l its elements [2*(l%4)][l/4] and
// [2*(l%4)+1][l/4] (the layout of an mma.sync B fragment when the matrix's
// rows are k).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// mma.sync m16n8k16 f32 += bf16 x bf16 (A row-major in four registers, B
// in two, d the 16x8 float32 accumulator, four per lane: rows l/4 and
// l/4 + 8, columns 2*(l%4) and 2*(l%4)+1).
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's driver entry
// point, so the library needs no -lcuda at link time.  nullptr if absent.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D tensor map of `type` elements over [d2][d1][d0] (d0 contiguous)
// with byte strides s1 (between d1 rows) and s2 (between d2 slabs), copied
// in boxes of box0 x box1 x box2 with the given swizzle.  Returns false
// when cuTensorMapEncodeTiled refuses the map.  The bf16 form follows.
inline bool make_tensor_map_3d(CUtensorMap* map, CUtensorMapDataType type,
                               const void* base, uint64_t d0, uint64_t d1,
                               uint64_t d2, uint64_t s1, uint64_t s2,
                               uint32_t box0, uint32_t box1, uint32_t box2,
                               CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {box0, box1, box2};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool make_tensor_map_bf16_3d(CUtensorMap* map, const void* base,
                                    uint64_t d0, uint64_t d1, uint64_t d2,
                                    uint64_t s1, uint64_t s2, uint32_t box0,
                                    uint32_t box1, uint32_t box2,
                                    CUtensorMapSwizzle swizzle) {
  return make_tensor_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, d0,
                            d1, d2, s1, s2, box0, box1, box2, swizzle);
}

// The same in boxes of box0 x box1 x 1 with the 128-byte swizzle (box0 * 2
// must be <= 128).
inline bool make_tensor_map_bf16(CUtensorMap* map, const void* base,
                                 uint64_t d0, uint64_t d1, uint64_t d2,
                                 uint64_t s1, uint64_t s2, uint32_t box0,
                                 uint32_t box1) {
  return make_tensor_map_bf16_3d(map, base, d0, d1, d2, s1, s2, box0, box1, 1,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace hopper
