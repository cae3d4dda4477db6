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
// M = 1; more rows run the rows GEMV, the verify stack's.  Returns a
// cudaError_t (0 on success).
extern "C" int cf_gemv(const void* x, const void* w, void* y, int M, int K, int N,
                       int threads, void* stream) {
  return launch_ring_gemv(static_cast<const __nv_bfloat16*>(x), K,
                          static_cast<const __nv_bfloat16*>(w), static_cast<float*>(y), M, K, N,
                          1, 0, N, 0, threads, false, static_cast<cudaStream_t>(stream));
}

// y [M, N] = x @ w (or bf16 into yb when yb is given) through the GEMV the
// stacks and the paged layer run (one launch), x bf16 rows x_row apart.
// pair 1 (M >= 2): w is [2, K, N], gate then up, and yb [M, N] receives
// bf16(silu(x @ gate) * (x @ up)), the verify stack's gate/up product.
// M = 1 runs the one-row GEMV (256 consumer threads), M >= 2 the rows
// GEMV.  The card tests and scripts/tune_torch_gemv.py call it.  Returns a
// cudaError_t (0 on success).
extern "C" int cf_gemv_rows(const void* x, long long x_row, int pair, const void* w, void* y,
                            void* yb, int M, int K, int N, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  float* yf = static_cast<float*>(y);
  __nv_bfloat16* ybf = static_cast<__nv_bfloat16*>(yb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 1)
    return pair ? (int)cudaErrorInvalidValue
                : launch_gemv1<false>(x, 0, wb, yf, K, N, 1, 0, 0, 256, false, st, ybf);
  return pair ? launch_rows_gemv<true>(xb, x_row, wb, yf, M, K, N, 2, (long long)K * N, N, 0,
                                       false, st, ybf)
              : launch_rows_gemv<false>(xb, x_row, wb, yf, M, K, N, 1, 0, N, 0, false, st, ybf);
}
