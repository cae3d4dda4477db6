// bs=1 GEMV for Hopper (sm_90a): y [1, N] f32 = x [1, K] bf16 @ w [K, N] bf16.
//
// Replaces the TPU kernel `gemv` (clusterfusion_tpu/ops/gemv.py,
// `_gemv_kernel`), which grids N in lane-aligned blocks so that an M=1 dot
// reaches the TPU's memory rate.  What bounds it here: every weight byte is
// read once for two operations, far under the card's ~295 operations per
// byte, so bytes bound it.  It is common.cuh's ring GEMV at one row
// (ring_gemv_kernel, the stacks'): a producer warp per block bulk-copies 256-column weight
// tiles through a ring of shared-memory stages, consumer warps do the
// FMAs, and the K chunks of a tile meet inside a thread-block cluster in a
// fixed order, so y is written whole (no zeroing first) and its bits are
// the same on every call.  N must be a multiple of 8; a last tile of 128
// columns copies and sums only its own columns.

#include "common.cuh"

// y [M, N] f32 = x [M, K] bf16 @ w on `stream` (one launch; M, K >= 1, N a
// multiple of 8, threads a multiple of 32 in [32, 992]).  The op takes
// M = 1; more rows run the ring GEMV's tensor-core form, the verify
// stack's.  Returns a cudaError_t (0 on success).
extern "C" int cf_gemv(const void* x, const void* w, void* y, int M, int K, int N,
                       int threads, void* stream) {
  return launch_ring_gemv<false>(x, K, 0, static_cast<const __nv_bfloat16*>(w),
                                 static_cast<float*>(y), M, K, N, 1, 0, N, 0, threads, false,
                                 static_cast<cudaStream_t>(stream));
}
