// Batched paged flash-decode attention with the in-place K/V append, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attention`
// (clusterfusion_tpu/ops/paged_decoder_layer.py, `_paged_attn_kernel`),
// which the batched serving step runs once per layer between its M=B
// projections, for a bf16 or fp8 e4m3 pool, with or without Mistral's
// sliding window (no softcap).
// Layouts as there: q [B, kv, g, hd] (scaled by log2(e)/sqrt(hd) and
// rounded to bf16 inside the kernels, as the TPU wrapper does before its
// kernel), k_new/v_new [B, kv, hd] bf16 (an fp8 pool stores and folds
// their e4m3, as the TPU wrapper hands its kernel k_new.astype(pool
// dtype)), pools [L, n_pages, kv, page, hd] bf16 or e4m3, block table
// [B, max_pages] and lens [B] int32, output [B, kv*g*hd] bf16.
//
// What bounds it: the walk reads each cached K and V row once and does
// about 4*g operations per pair of pool values read (a score and a p.V
// product per query row), far under the card's ~295 operations per byte,
// so it is bound by bytes (an e4m3 pool halves them; at group 1 its
// decode's integer ops may bound the split pass instead).  The design (paged_attention.cuh) splits each
// request's rows into splits of `split` rows, one block per (split, kv
// head, request), so a long request's rows stream through as many blocks
// as it has splits; each block bulk-copies its split's K and V runs into
// shared memory at once, and a merge kernel folds the splits in a fixed
// order and appends the current row.

#include <cmath>

#include "paged_attention.cuh"

// Floats of f32 scratch the split pass needs for B requests.
extern "C" long long cf_paged_scratch_floats(int B, int kv, int group, int hd, int page,
                                             int max_pages, int split) {
  return (long long)paged_partial_floats(B, kv, group, hd,
                                         paged_splits(max_pages, page, split));
}

template <int KV>
static int paged_attention_kind(const void* q, const void* k_new, const void* v_new,
                                void* k_pool, void* v_pool, const void* table,
                                const void* lens, void* o, void* scratch, int B, int kv,
                                int group, int hd, int page, int n_pages, int max_pages,
                                int layer, int split, void* stream, int window) {
  PagedArgsT<KV> a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.k_pool = static_cast<pa_row_t<KV>*>(k_pool);
  a.v_pool = static_cast<pa_row_t<KV>*>(v_pool);
  a.table = static_cast<const int*>(table);
  a.lens = static_cast<const int*>(lens);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.kv = kv;
  a.group = group;
  a.page = page;
  a.n_pages = n_pages;
  a.max_pages = max_pages;
  a.layer = layer;
  a.split = split;
  a.ns = paged_splits(max_pages, page, split);
  a.window = window;
  a.qscale = (float)(1.4426950408889634 / std::sqrt((double)hd));
  a.part_ml = static_cast<float*>(scratch);
  a.part_acc = a.part_ml + (size_t)B * kv * a.ns * group * 2;
  return launch_paged_attn<false>(a, B, hd, false, static_cast<cudaStream_t>(stream));
}

// Attend each request's lens[b] cached rows of layer `layer` plus the
// current token, write o, and append k_new/v_new at row lens[b] (two
// launches).  kv_kind (common.cuh's KV_*): KV_BF16 pools, or KV_FP8 e4m3
// pools.  window > 0: each request attends its cached rows >= lens[b] + 1 -
// window and the current token (0: all rows).  `scratch` holds cf_paged_scratch_floats(...) floats.  Returns a
// cudaError_t (0 on success).
extern "C" int cf_paged_attention(const void* q, const void* k_new,
                                  const void* v_new, void* k_pool, void* v_pool,
                                  const void* table, const void* lens, void* o,
                                  void* scratch, int B, int kv, int group, int hd,
                                  int page, int n_pages, int max_pages, int layer,
                                  int split, void* stream, int kv_kind, int window) {
  if (kv_kind == KV_FP8)
    return paged_attention_kind<KV_FP8>(q, k_new, v_new, k_pool, v_pool, table, lens, o,
                                        scratch, B, kv, group, hd, page, n_pages, max_pages,
                                        layer, split, stream, window);
  if (kv_kind != KV_BF16) return (int)cudaErrorInvalidValue;
  return paged_attention_kind<KV_BF16>(q, k_new, v_new, k_pool, v_pool, table, lens, o,
                                       scratch, B, kv, group, hd, page, n_pages, max_pages,
                                       layer, split, stream, window);
}
