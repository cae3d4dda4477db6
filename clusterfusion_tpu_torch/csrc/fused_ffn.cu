// Fused SwiGLU FFN of one bs=1 token for Hopper (sm_90a): residual add,
// RMSNorm, the gate/up product, SiLU(gate) * up and the down product.
//
// Replaces the TPU kernel `fused_ffn` (clusterfusion_tpu/ops/ffn.py,
// `_ffn_kernel`) for bf16 weights and the SiLU gate, with its layouts:
//   w13 [L, 2, hidden, f_pad]   w2 [L, f_pad, hidden]   norm_w [L, hidden]
// (or one layer of each, L = 1).  The layer is picked by offset
// (`layer`); no layer's slice is copied.
//
// What bounds it: one token reads 3 * hidden * f_pad weights once (138 MB
// at DeepSeek-V2-Lite's hidden 2048, f_pad 11264) and does two operations
// per weight byte, far under the card's ~295 operations per byte, so bytes
// bound it.  The TPU kernel walks f-blocks on a sequential grid with the
// down product accumulating in VMEM scratch; Hopper blocks run in parallel
// and in no order, so here the FFN is four kernels on one stream, each
// reading the one before from a scratch buffer the caller allocates:
//   resnorm   h = x (+ residual) in f32; res_out = bf16(h);
//             xn = bf16(rmsnorm(h) * norm_w); zero gu and acc
//   gemv      gu += xn @ w13[l]          (gate and up, f32; common.cuh)
//   gemv      acc += bf16(silu(gate) * up) @ w2[l]   (SiLU in the x load)
//   to_bf16   out = bf16(acc)
// The GEMVs stream every weight once with 16-byte loads over enough
// blocks to keep each SM's loads in flight (common.cuh's rows_gemv_kernel
// at one row, shared with the decode stacks).

#include "common.cuh"

// One fused FFN on `stream` (four launches).  x, residual (nullptr: no
// residual add), out and res_out are bf16 [hidden]; xn bf16 [hidden], gu
// f32 [2 * f_pad] and acc f32 [hidden] are scratch.  *n_launches receives
// the number of kernels launched.  Returns a cudaError_t (0 on success).
extern "C" int cf_fused_ffn(const void* x, const void* residual, const void* norm_w,
                            const void* w13, const void* w2, void* out, void* res_out,
                            void* xn, void* gu, void* acc, int hidden, int f_pad,
                            int layer, float eps, int threads, int* n_launches,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *n_launches = 0;
  if (hidden % 8 != 0 || f_pad % 8 != 0 || layer < 0 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, num_sms = 0;
  CF_CHECK((int)cudaGetDevice(&dev));
  CF_CHECK((int)cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev));
  const __nv_bfloat16* nw = static_cast<const __nv_bfloat16*>(norm_w) + (size_t)layer * hidden;
  const __nv_bfloat16* w13l =
      static_cast<const __nv_bfloat16*>(w13) + (size_t)layer * 2 * hidden * f_pad;
  const __nv_bfloat16* w2l = static_cast<const __nv_bfloat16*>(w2) + (size_t)layer * f_pad * hidden;
  __nv_bfloat16* xnb = static_cast<__nv_bfloat16*>(xn);
  float* guf = static_cast<float*>(gu);
  float* accf = static_cast<float*>(acc);

  resnorm_kernel<<<1, NORM_THREADS, 0, st>>>(
      nullptr, static_cast<const __nv_bfloat16*>(x), nullptr,
      static_cast<const __nv_bfloat16*>(residual), nw, nullptr,
      static_cast<__nv_bfloat16*>(res_out), xnb, nullptr, nullptr, hidden, eps, guf,
      2 * f_pad, accf, hidden);
  CF_CHECK((int)cudaGetLastError());
  ++*n_launches;
  CF_CHECK((launch_rows_gemv_nb<1, false>(xnb, 0, 0, w13l, guf, 1, hidden, f_pad, 2,
                                          (long long)hidden * f_pad, 0, f_pad, threads,
                                          num_sms, st)));
  ++*n_launches;
  CF_CHECK((launch_rows_gemv_nb<1, true>(guf, 0, f_pad, w2l, accf, 1, f_pad, hidden, 1, 0,
                                         0, 0, threads, num_sms, st)));
  ++*n_launches;
  to_bf16_kernel<<<(hidden + 255) / 256, 256, 0, st>>>(accf, static_cast<__nv_bfloat16*>(out),
                                                       hidden);
  CF_CHECK((int)cudaGetLastError());
  ++*n_launches;
  return 0;
}
