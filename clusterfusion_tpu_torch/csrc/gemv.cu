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

// Int8 weights: y [M, nmat*N] = x @ bf16(w[mat]) * sc[mat] (per column,
// after the sum), or with kg > 0 (nmat 1) each K chunk's partial scaled by
// sc[k / kg] before the chunks meet (the O projection's per-group scale);
// bf16 into yb instead of float32 y when yb is given.  w int8 [nmat, K,
// N], sc float32 [nmat or K / kg, N], N a multiple of 16.  pair 1 (M >= 2,
// nmat 2, kg 0): yb [M, N] receives bf16(silu(x @ w0 * sc[0]) * (x @ w1 *
// sc[1])).  M = 1 runs the one-row GEMV's int8 instance, M >= 2 the rows
// GEMV's; the tensor map is encoded here.  The int8 serving step's M=B
// products, the card tests and scripts call it.  Returns a cudaError_t.
extern "C" int cf_gemv_rows8(const void* x, long long x_row, int pair, const void* w,
                             const void* sc, int kg, void* y, void* yb, int M, int K, int N,
                             int nmat, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const float* s = static_cast<const float*>(sc);
  float* yf = static_cast<float*>(y);
  __nv_bfloat16* ybf = static_cast<__nv_bfloat16*>(yb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || (pair && (M < 2 || nmat != 2 || kg != 0)))
    return (int)cudaErrorInvalidValue;
  Int8Map map;
  if (!make_int8_map(&map, w, K, N, nmat, M)) return (int)cudaErrorInvalidValue;
  if (pair)
    return launch_rows_gemv8<true>(xb, x_row, &map, 0, s, 0, nullptr, M, K, N, 2, N, 0, false,
                                   st, ybf);
  return launch_ring_gemv8(xb, x_row, &map, 0, s, kg, yf, M, K, N, nmat, (long long)nmat * N,
                           N, 256, false, st, ybf);
}

// The int8 SwiGLU FFN of M rows (two launches): out [M, hidden] bf16 =
// bf16((bf16(silu(gate) * up) @ bf16(w2)) * s2), gate and up = x @
// bf16(w13[i]) * s13[i] in float32.  w13 int8 [2, hidden, f], s13 float32
// [2, f], w2 int8 [f, hidden], s2 float32 [hidden]; act: scratch of 2*M*f
// floats (M = 1: the float32 gate/up, whose SwiGLU the down product's x
// stages; M >= 2: the bf16 product of the rows GEMV's pair form).  Returns
// a cudaError_t.
extern "C" int cf_ffn8(const void* x, const void* w13, const void* s13, const void* w2,
                       const void* s2, void* act, void* out, int M, int hidden, int f,
                       void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1) return (int)cudaErrorInvalidValue;
  Int8Map m13, m2;
  if (!make_int8_map(&m13, w13, hidden, f, 2, M) || !make_int8_map(&m2, w2, f, hidden, 1, M))
    return (int)cudaErrorInvalidValue;
  if (M == 1) {
    float* gu = static_cast<float*>(act);
    CF_CHECK((launch_gemv1<false, G1_Y, true>(xb, 0, nullptr, gu, hidden, f, 2, 0, f, 256,
                                              false, st, nullptr, nullptr, 0.f, nullptr,
                                              m13.for_rows(1), 0,
                                              static_cast<const float*>(s13), 0)));
    return launch_gemv1<true, G1_Y, true>(gu, f, nullptr, nullptr, f, hidden, 1, 0, 0, 256,
                                          true, st, ob, nullptr, 0.f, nullptr, m2.for_rows(1), 0,
                                          static_cast<const float*>(s2), 0);
  }
  __nv_bfloat16* a = static_cast<__nv_bfloat16*>(act);
  CF_CHECK(launch_rows_gemv8<true>(xb, hidden, &m13, 0, static_cast<const float*>(s13), 0,
                                   nullptr, M, hidden, f, 2, f, 0, false, st, a));
  return launch_rows_gemv8<false>(a, f, &m2, 0, static_cast<const float*>(s2), 0, nullptr, M,
                                  f, hidden, 1, hidden, 0, true, st, ob);
}

// Int4 weights: y [M, nmat*N] = x @ bf16(code * s) (a8 0, the exact W4A16
// product) or the W4A8 product (a8 1: x quantized to int8 per row and per
// activation block of kg k rows, 0 the whole row; each group's integer sum
// scaled by s, each row's sum by its xs), bf16 into yb instead of float32
// y when yb is given.  w int8 [nmat, K/2, N] (codes packed two a byte
// along K), sc float32 [nmat, K/128, N], K a multiple of 128, N of 16.
// pair 1 (M >= 2, nmat 2): yb [M, N] receives bf16(silu(x @ w0) * (x @
// w1)).  M = 1 runs the one-row GEMV's int4 instance, M >= 2 the rows
// GEMV's (W4A8: after quant_x8_kernel, into the scratch x8, bf16 [M, K],
// and xs, float32 [M, K / kg or 1]); the tensor map is encoded here.  The
// int4 serving step's M=B products, the card tests and scripts call it.
// Returns a cudaError_t.
extern "C" int cf_gemv_rows4(const void* x, long long x_row, int pair, const void* w,
                             const void* sc, int kg, void* y, void* yb, int M, int K, int N,
                             int nmat, int a8, void* x8, void* xs, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const float* s = static_cast<const float*>(sc);
  float* yf = static_cast<float*>(y);
  __nv_bfloat16* ybf = static_cast<__nv_bfloat16*>(yb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || (pair && (M < 2 || nmat != 2)))
    return (int)cudaErrorInvalidValue;
  Int8Map map;
  if (!make_int4_map(&map, w, K, N, nmat, M)) return (int)cudaErrorInvalidValue;
  __nv_bfloat16* q8 = static_cast<__nv_bfloat16*>(x8);
  float* qs = static_cast<float*>(xs);
  if (pair)
    return a8 ? launch_rows_gemv4<true, true>(xb, x_row, &map, 0, s, kg, nullptr, M, K, N, 2,
                                              N, 0, false, st, ybf, q8, qs)
              : launch_rows_gemv4<true, false>(xb, x_row, &map, 0, s, 0, nullptr, M, K, N, 2,
                                               N, 0, false, st, ybf);
  return a8 ? launch_ring_gemv4<true>(xb, x_row, &map, 0, s, kg, yf, M, K, N, nmat,
                                      (long long)nmat * N, N, 256, false, st, ybf, q8, qs)
            : launch_ring_gemv4<false>(xb, x_row, &map, 0, s, 0, yf, M, K, N, nmat,
                                       (long long)nmat * N, N, 256, false, st, ybf);
}

// The int4 SwiGLU FFN of M rows in the exact mode (two launches; the
// serving step's, whose products the JAX package leaves to XLA over the
// dequantized weights): out [M, hidden] bf16 = bf16(act @ bf16(w2 * s2)),
// act = bf16(silu(gate) * up), gate and up = x @ bf16(w13[i] * s13[i]) in
// float32.  w13 int8 [2, hidden/2, f], s13 float32 [2, hidden/128, f], w2
// int8 [f/2, hidden], s2 float32 [f/128, hidden]; act: scratch of 2*M*f
// floats, as cf_ffn8's.  Returns a cudaError_t.
extern "C" int cf_ffn4(const void* x, const void* w13, const void* s13, const void* w2,
                       const void* s2, void* act, void* out, int M, int hidden, int f,
                       void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1) return (int)cudaErrorInvalidValue;
  Int8Map m13, m2;
  if (!make_int4_map(&m13, w13, hidden, f, 2, M) || !make_int4_map(&m2, w2, f, hidden, 1, M))
    return (int)cudaErrorInvalidValue;
  const float* sg = static_cast<const float*>(s13);
  const float* sd = static_cast<const float*>(s2);
  if (M == 1) {
    float* gu = static_cast<float*>(act);
    CF_CHECK((launch_gemv1<false, G1_Y, WK_INT4>(xb, 0, nullptr, gu, hidden, f, 2, 0, f, 256,
                                                 false, st, nullptr, nullptr, 0.f, nullptr,
                                                 m13.for_rows(1, true), 0, sg, 0)));
    return launch_gemv1<true, G1_Y, WK_INT4>(gu, f, nullptr, nullptr, f, hidden, 1, 0, 0, 256,
                                             true, st, ob, nullptr, 0.f, nullptr,
                                             m2.for_rows(1, true), 0, sd, 0);
  }
  __nv_bfloat16* a = static_cast<__nv_bfloat16*>(act);
  CF_CHECK((launch_rows_gemv4<true, false>(xb, hidden, &m13, 0, sg, 0, nullptr, M, hidden, f, 2,
                                           f, 0, false, st, a)));
  return launch_rows_gemv4<false, false>(a, f, &m2, 0, sd, 0, nullptr, M, f, hidden, 1, hidden,
                                         0, true, st, ob);
}
