// Batched paged flash-decode attention with the in-place K/V append, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attention`
// (clusterfusion_tpu/ops/paged_decoder_layer.py, `_paged_attn_kernel`),
// which the batched serving step runs once per layer between its M=B
// projections, for a bf16 pool and no window or softcap.  Layouts as
// there: q [B, kv, g, hd] (scaled by log2(e)/sqrt(hd) and rounded to bf16 by
// the wrapper, as the TPU wrapper does), k_new/v_new [B, kv, hd] bf16, pools
// [L, n_pages, kv, page, hd] bf16, block table [B, max_pages] and lens [B]
// int32, output [B, kv*g*hd] bf16.
//
// What bounds it: the walk reads each cached K and V row once and does
// about 4*g operations per pair of bf16 values read (a score and a p.V
// product per query row), far under the card's ~295 operations per byte,
// so it is bound by bytes.  The design (paged_attention.cuh) gives every
// (request, kv head) its own block, so all heads of all requests stream in
// parallel, and copies whole 64-row tiles of K and V with 16-byte loads,
// 16 loads in flight per thread, issuing the next tile's loads before this
// tile's arithmetic.  What it does not do yet: split a long request over
// several blocks (the block of the longest request walks alone at the end).

#include "paged_attention.cuh"

// Attend each request's lens[b] cached rows of layer `layer` plus the
// current token, write o, and append k_new/v_new at row lens[b].  Returns a
// cudaError_t (0 on success).
extern "C" int cf_paged_attention(const void* q, const void* k_new,
                                  const void* v_new, void* k_pool, void* v_pool,
                                  const void* table, const void* lens, void* o,
                                  int B, int kv, int group, int hd, int page,
                                  int n_pages, int max_pages, int layer,
                                  void* stream) {
  PagedArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.k_pool = static_cast<__nv_bfloat16*>(k_pool);
  a.v_pool = static_cast<__nv_bfloat16*>(v_pool);
  a.table = static_cast<const int*>(table);
  a.lens = static_cast<const int*>(lens);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.kv = kv;
  a.group = group;
  a.page = page;
  a.n_pages = n_pages;
  a.max_pages = max_pages;
  a.layer = layer;
  return launch_paged_attn<false>(a, B, hd, static_cast<cudaStream_t>(stream));
}
