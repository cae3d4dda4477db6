// Paged batch-decode attention half of a Llama layer for Hopper (sm_90a):
// residual add + RMSNorm, the M=B QKV product, RoPE, the paged walk with
// the in-place append, and the M=B O-projection.
//
// Replaces the TPU kernel `llama_decoder_layer_paged`
// (clusterfusion_tpu/ops/paged_decoder_layer.py, `_paged_kernel`), which
// the fused serving step runs once per layer, for bf16, int8 or int4
// weights, a bf16 or fp8 e4m3 pool, with or without Mistral's sliding
// window (no bias or softcap).  Layouts as there:
//   wqkv_f [L, G, hidden, hg*(g+2)*hd]  columns per kv head [q_0..q_{g-1}|k|v]
//   wo_f   [L, G, hg*g*hd, hidden]      pools [L, n_pages, kv, page, hd]
// The layer of the weight stacks is picked by offset (`w_layer`); no
// layer's slice is copied.
//
// What bounds it: at 7B the layer reads 134 MB of weights once for all B
// rows (2*B operations per weight byte, B <= 8 in serving) plus the KV rows
// of the walk, so it is bound by bytes.  The TPU kernel walks a sequential
// (group, request, page) grid with the batch's projections resident in
// VMEM; Hopper blocks run in no order, so here the layer is a fixed
// sequence of five kernels on one stream, each reading the last one's
// output from a scratch buffer the caller allocates, every one after the
// first launched with programmatic dependent launch (it starts while the
// one before it runs and waits inside before it reads that one's output):
//   resnorm    r = x + res (f32); res_out = bf16(r);
//              xn = bf16(rmsnorm(r) * w)   (common.cuh, one block per row)
//   ring gemv  qkv[b] = xn[b] @ wqkv_f[l]  (f32; every weight row read once
//              for all B rows: from 2 rows common.cuh's rows GEMV, weights
//              as TMA boxes into a ring, mma.sync, K chunks summed in a
//              fixed order in a cluster; shared with kernel 8)
//   split      per (split, kv head, request): the split's cached rows,
//              bulk-copied; q roped from qkv (paged_attention.cuh)
//   merge      the current token and the splits in order; o; the append of
//              bf16 k/v, or on an e4m3 pool e4m3 of the float32 k/v (of
//              their bf16 rounding at hd 64 or page % 8 != 0, where the
//              TPU wrapper scatters the bf16 rows; paged_attention.cuh)
//   ring gemv  out[b] = bf16(o[b] @ wo_f[l])  (summed over head groups)
// Every sum has a fixed order, so a call's bits repeat.
//
// Int8 weights (the TPU kernel's wq_kind == "int8"): the two products
// stream int8 codes through the GEMVs' int8 instances (rows_gemv8_kernel
// from 2 rows, ring_gemv8_kernel at one; common.cuh), with float32 scales:
// QKV per head group and column after the sum over hidden; the O
// projection per group on each group's partial, before the groups are
// summed and before out's bf16 rounding (the TPU kernel scales each group's
// M=B dot, adds it to its float32 accumulator and rounds at the end).
//
// Int4 weights (the TPU kernel's wq_kind == "int4", which always takes the
// exact tile dequant here, never W4A8): the two products stream the packed
// codes through the GEMVs' int4 instances in their exact mode
// (rows_gemv4_kernel<false, false> from 2 rows, ring_gemv4_kernel at one),
// each weight bf16(code * s) with s the float32 group scale of its 128 k
// rows; the O projection's scales vary along K ([G, Ko/G/128, hidden]), so
// they sit inside the dequant and the groups need no scale of their own.

#include "paged_attention.cuh"

namespace {

constexpr int GEMV_THREADS = 256;

}  // namespace

// Floats of f32 scratch `cf_paged_decoder_layer` needs for B requests:
// the QKV projection and the split pass's partials.
extern "C" long long cf_paged_layer_scratch_floats(int B, int kv, int group, int hd,
                                                   int page, int max_pages, int split) {
  return (long long)((size_t)B * kv * (group + 2) * hd +
                     paged_partial_floats(B, kv, group, hd,
                                          paged_splits(max_pages, page, split)));
}

// One paged decode layer for B requests on `stream` (five launches).
// Scratch, allocated by the caller: xn bf16 [B, hidden], o bf16
// [B, kv*g*hd], and `scratch` of cf_paged_layer_scratch_floats(...) floats.
// Writes out and res_out (bf16 [B, hidden]) and appends each request's K/V
// row into the pools.  *n_launches receives the number of kernels
// launched.  wq_kind (common.cuh's WK_*): WK_BF16, WK_INT8 (wqkv and wo
// hold int8 codes and wqkv_s [.., G, C] and wo_s [.., G, hidden] their
// float32 scales, the layer's at w_layer, wo's applied per group before the
// groups' sum) or WK_INT4 (codes packed two a byte along K, float32 group
// scales wqkv_s [.., G, hidden/128, C] and wo_s [.., G, Ko/G/128,
// hidden]).  kv_kind (common.cuh's KV_*): KV_BF16 or KV_FP8 (e4m3) pools.
// window > 0: each request attends its cached rows >= lens[b] + 1 - window
// and the current token (0: all rows; paged_attention.cuh).  Returns a
// cudaError_t (0 on success).
extern "C" int cf_paged_decoder_layer(
    const void* x, const void* res, const void* wqkv, const void* wo,
    const void* rms_w, const void* cos, const void* sin, const void* positions,
    const void* table, const void* lens, void* k_pool, void* v_pool, void* out,
    void* res_out, void* xn, void* o, void* scratch, int B, int hidden,
    int kv, int hg, int group, int hd, int page, int n_pages, int max_pages,
    int max_pos, int layer, int w_layer, int neox, float eps, int split,
    int* n_launches, void* stream, const void* wqkv_s, const void* wo_s, int wq_kind,
    int kv_kind, int window) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *n_launches = 0;
  if (B < 1 || hg < 1 || kv % hg != 0 || hidden % 8 != 0 || w_layer < 0 || split < 1 ||
      (kv_kind != KV_BF16 && kv_kind != KV_FP8))
    return (int)cudaErrorInvalidValue;
  const int G = kv / hg;
  const long long C = (long long)hg * (group + 2) * hd;   // qkv columns per group
  const long long Ko = (long long)kv * group * hd;        // wo rows in all
  const int qkv_n = (int)(G * C);
  const bool w8 = wq_kind == WK_INT8, w4 = wq_kind == WK_INT4;
  if ((wq_kind != WK_BF16 && !w8 && !w4) || (wq_kind != WK_BF16) != (wqkv_s != nullptr))
    return (int)cudaErrorInvalidValue;
  // bytes of a layer's weights: bf16 2 a weight, int8 1, int4 1/2
  const size_t num = w4 ? 1 : w8 ? 1 : 2, den = w4 ? 2 : 1;
  const void* wq = static_cast<const char*>(wqkv) + (size_t)w_layer * G * hidden * C * num / den;
  const void* wol = static_cast<const char*>(wo) + (size_t)w_layer * Ko * hidden * num / den;
  const int gq = w4 ? hidden / GS4 : 1, go = w4 ? (int)(Ko / G / GS4) : 1;   // scale rows
  const float* sq = w8 || w4 ? static_cast<const float*>(wqkv_s) + (size_t)w_layer * G * gq * C
                             : nullptr;
  const float* so = w8 || w4 ? static_cast<const float*>(wo_s) +
                                   (size_t)w_layer * G * go * hidden
                             : nullptr;
  __nv_bfloat16* xnb = static_cast<__nv_bfloat16*>(xn);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
  float* qkvf = static_cast<float*>(scratch);
  if (C % 8 != 0 || ((w8 || w4) && (!wo_s || C % 16 != 0 || hidden % 16 != 0)) ||
      (w4 && (hidden % GS4 != 0 || (Ko / G) % GS4 != 0)))
    return (int)cudaErrorInvalidValue;
  // int8 and int4: the layer's matrices as tensor maps (the one-row GEMV's
  // at B 1)
  auto qmap = w4 ? make_int4_map : make_int8_map;
  Int8Map mq, mo;
  if ((w8 || w4) && (!qmap(&mq, wq, hidden, (int)C, G, B) ||
                     !qmap(&mo, wol, (int)Ko, hidden, 1, B)))
    return (int)cudaErrorInvalidValue;

  // the first kernel waits for everything before it on the stream (no
  // PDL), so the later ones may read the inputs, the table and the pool
  // rows < lens before their own wait
  resnorm_kernel<<<B, NORM_THREADS, 0, st>>>(
      nullptr, static_cast<const __nv_bfloat16*>(x), nullptr,
      static_cast<const __nv_bfloat16*>(res), static_cast<const __nv_bfloat16*>(rms_w),
      nullptr, static_cast<__nv_bfloat16*>(res_out), xnb, nullptr, nullptr, hidden, eps,
      nullptr, 0, nullptr, 0);
  CF_CHECK((int)cudaGetLastError());
  ++*n_launches;
  if (w4)
    CF_CHECK(launch_ring_gemv4<false>(xnb, hidden, &mq, 0, sq, 0, qkvf, B, hidden, (int)C, G,
                                      qkv_n, C, GEMV_THREADS, true, st));
  else if (w8)
    CF_CHECK(launch_ring_gemv8(xnb, hidden, &mq, 0, sq, 0, qkvf, B, hidden, (int)C, G, qkv_n, C,
                               GEMV_THREADS, true, st));
  else
    CF_CHECK(launch_ring_gemv(xnb, hidden, static_cast<const __nv_bfloat16*>(wq), qkvf, B,
                              hidden, (int)C, G, (long long)hidden * C, qkv_n, C, GEMV_THREADS,
                              true, st));
  ++*n_launches;

  // the split pass and the merge on pools of the kind's element type
  auto walk = [&](auto kind) {
    constexpr int KV = decltype(kind)::value;
    PagedArgsT<KV> a{};
    a.qkv = qkvf;
    a.cos = static_cast<const float*>(cos);
    a.sin = static_cast<const float*>(sin);
    a.positions = static_cast<const int*>(positions);
    a.k_pool = static_cast<pa_row_t<KV>*>(k_pool);
    a.v_pool = static_cast<pa_row_t<KV>*>(v_pool);
    a.table = static_cast<const int*>(table);
    a.lens = static_cast<const int*>(lens);
    a.o = ob;
    a.kv = kv;
    a.group = group;
    a.page = page;
    a.n_pages = n_pages;
    a.max_pages = max_pages;
    a.layer = layer;
    a.max_pos = max_pos;
    a.neox = neox;
    a.split = split;
    a.ns = paged_splits(max_pages, page, split);
    a.window = window;
    a.part_ml = qkvf + (size_t)B * qkv_n;
    a.part_acc = a.part_ml + (size_t)B * kv * a.ns * group * 2;
    return launch_paged_attn<true>(a, B, hd, true, st);
  };
  CF_CHECK(kv_kind == KV_FP8 ? walk(std::integral_constant<int, KV_FP8>())
                             : walk(std::integral_constant<int, KV_BF16>()));
  *n_launches += 2;

  if (w4)      // the group scales inside the dequant, then rounded to bf16
    CF_CHECK(launch_ring_gemv4<false>(ob, Ko, &mo, 0, so, 0, nullptr, B, (int)Ko, hidden, 1,
                                      hidden, 0, GEMV_THREADS, true, st,
                                      static_cast<__nv_bfloat16*>(out)));
  else if (w8)      // each group's partial scaled, summed, then rounded to bf16
    CF_CHECK(launch_ring_gemv8(ob, Ko, &mo, 0, so, (int)(Ko / G), nullptr, B, (int)Ko, hidden,
                               1, hidden, 0, GEMV_THREADS, true, st,
                               static_cast<__nv_bfloat16*>(out)));
  else
    CF_CHECK(launch_ring_gemv(ob, Ko, static_cast<const __nv_bfloat16*>(wol), nullptr, B,
                              (int)Ko, hidden, 1, 0, hidden, 0, GEMV_THREADS, true, st,
                              static_cast<__nv_bfloat16*>(out)));
  ++*n_launches;
  return 0;
}
