// Whole-stack decode step for Hopper (sm_90a), bf16, int8 or int4 weights: every
// layer of one bs=1 decode step, then the final RMSNorm and the LM head.
//
// Replaces the TPU kernel `fused_decoder_stack`
// (clusterfusion_tpu/ops/stack_kernel.py, `_stack_kernel`) for bf16, int8
// or int4 weights, a bf16, int8 (Int8KV) or fp8 e4m3 KV cache (in mode 5
// too), head dim 128 or 64 (its defer_append variant), a sliding window
// (Mistral's, below; in mode 5 too), no bias and no sandwich norms, with the
// same layouts:
//   wqkv_f [L, G, hidden, hg*(g+2)*hd]  columns per kv head [q_0..q_{g-1}|k|v]
//   wo_f   [L, G, hg*g*hd, hidden]
//   w13    [L, 2, hidden, f_pad]        w2 [L, f_pad, hidden]
//   caches [L, kv_heads, cap, hd]       lm_head [hidden, vocab]
//
// What bounds it: a bs=1 step reads every weight once (13.4 GB at
// Llama-2-7B) and does two operations per weight byte, far under the
// card's ~295 operations per byte, so it is bound by bytes.  The design
// streams each weight matrix once through shared memory with bulk copies
// (cp.async.bulk) across enough blocks to keep every SM's copies in
// flight, and reads only cache rows < pos, the same way.
//
// Int8 weights (the TPU kernel's wq_kind == "int8"; ops/quant.py's
// per-output-column QuantizedTensor): the four projections, and the LM
// head on its own, stream int8 codes through the ring GEMV's int8 instance
// (ring_gemv8_kernel, common.cuh) with float32 scales beside them: 7.16 GB
// a 7B step at pos 600 instead of 13.7, never a bf16 copy.  The scales go
// where the TPU kernel applies them: QKV per head group and column after
// the sum over hidden; the O projection per group on each group's partial,
// before the groups are summed (K chunks never straddle a group); gate and
// up per column before the SwiGLU; down after the whole sum over f; the LM
// head after its sum.  The norms, the split and the merge do not change.
//
// Int4 weights (the TPU kernel's wq_kind == "int4"; ops/quant.py's
// group-wise QuantizedTensor, groups of 128 k rows, codes packed two a
// byte along K): the four projections stream their packed codes through
// the ring GEMV's int4 instance (ring_gemv4_kernel, common.cuh; one 16 KB
// stage is one scale group) with their float32 group scales, 3.29 GB of
// codes a 7B step where int8 streams 6.6 GB; the LM head stays bf16 or
// int8 on its own instances.  Two modes, as KernelConfig.int4_w4a8 picks
// (the TPU kernel's _int4_dot): W4A8 quantizes each GEMV's x to int8 per
// activation block (QKV and gate/up: the normed row; O: one head group's o;
// down: one f-block of ffn_block rows), sums each scale group's integer dot
// in float32 (exact) and scales it by its group scale, then by x's scale;
// the exact mode (W4A16) takes bf16(code * s) as the weight.  The launch
// sequence and count are the int8 step's.
//
// The TPU kernel walks a sequential (layer, phase) grid and carries the
// hidden pair in VMEM scratch from step to step.  Hopper blocks run in
// parallel and in no order, so here each phase is its own kernel, launched
// in a fixed order on one stream by `cf_decoder_stack`, and the carry
// lives in a float32 scratch buffer the caller allocates.  Per layer:
//   resnorm   r1 = hx + res; xn = bf16(rmsnorm(r1) * attn_norm)
//   gemv      qkv = xn @ wqkv_f[l]             (raw f32, split over K)
//   split     flash-decode over cache rows < pos, one partial (m, l, acc)
//             per (kv head, split); q is roped, pre-scaled by
//             1/sqrt(hd)*log2(e) and rounded to bf16 for these dots
//   merge     merge the partials, fold in the current token from the f32
//             q/k/v, append bf16 k/v at row pos, o = bf16(acc / l)
//   gemv      aout = o @ wo_f[l]               (f32 over head groups)
//   resnorm   r2 = aout + r1; xn = bf16(rmsnorm(r2) * ffn_norm)
//   gemv      gu = xn @ w13[l]                 (gate and up, f32)
//   gemv      hx = bf16(silu(gate) * up) @ w2[l]
// and once per token: resnorm over hx + res with the final norm (or the
// bf16 outputs without an LM head), then gemv logits = xn @ lm_head.
// The hidden pair stays float32 across layers, as in the TPU kernel.
//
// Mode 5, reduce_axis (the JAX package's fused_collectives=True): with a
// communicator (collective.cuh; null at tp 1) the caller holds this rank's
// tp shards (kv_heads/tp heads, f_pad/tp FFN columns), and the partial
// sums of the O-projection (Stage.ATTN, before the FFN resnorm) and of the
// down projection (Stage.LINEAR, before the next layer's resnorm) are summed
// over the axis inside the step, as `ring_reduce_scratch` runs inside the
// TPU kernel.  No reduce has a launch of its own: each of the two products
// runs the ring GEMV's PUSH instance, whose epilogue stores its tiles'
// fixed-order sums into every rank's symmetric buffer and publishes one
// flag per 256-column tile (hidden at most 8192: 32 flag columns), and the
// resnorm after it (resnorm_reduce_kernel) waits for every rank's flags,
// adds the slots in rank order 0..N-1 (kernel 13's sum, so its bits) and
// then the residual.  The protocol and why its two banks suffice are in
// collective.cu's note.  Every rank carries the same bits of the hidden
// pair, and the sequence has as many launches as at tp 1.
//
// Mode 5 with int8 weights (the TPU kernel's wq_kind == "int8" with
// reduce_axis): the O and down products run ring_gemv8_kernel's PUSH
// instances, which push sums already scaled (the O projection's per group
// on each block's partial, the down projection's per column after the
// cluster sum), and an int8 LM-head shard pushes through its
// G1_PUSH_GATHER instance, scaled per column; the scale is the same on
// every rank, so it commutes with the sum (or the gather) over the ranks.
// The flags, epochs and waits are the bf16 sequence's.
//
// Mode 5 with int4 weights (the TPU kernel's wq_kind == "int4" with
// reduce_axis): the O and down products run ring_gemv4_kernel's
// G1_PUSH_SUM instances, whose pushed sums are already scaled (each
// group's integer dot by its group scale; W4A8: each block's partial by
// x's scale).  The activation blocks are those of this rank's shard: the
// O projection's head group and the down product's f-block of the shard's
// f_pad (ffn_block, JAX's block on a shard), so a sharded W4A8 step is not
// the unsharded one's function.  The LM head stays bf16 or int8.
//
// Mode 5 with the logits gathered (`gather`; the tp step of
// parallel/decode.py): lm_head is this rank's vocab shard of n columns, and
// the step ends in kernel 14's gather, again with no launch of its own
// beyond its wait: after the final norm the LM head's product runs the ring
// GEMV's G1_PUSH_GATHER instance, which stores each tile's fixed-order sum
// into slot `rank` of every rank's buffer and publishes the tile's flag,
// and gather_wait_kernel waits for every rank's flags and copies the slots
// in rank order into logits [size * n].  Every rank gets the same bits, and
// the step is 8L+3 kernels: no plain norm, no torch.mm and no standalone
// gather after the stack.
//
// 8-bit KV caches (the TPU kernel's kv_kind: ops/quant.py's Int8KV, int8
// rows with per-position float32 scales in [L, kv, R, 128] planes, or fp8
// e4m3 rows): the split pass reads the 8-bit rows below pos (int8: and
// their scales) and the merge stores the current token's float32 k and v
// rows as int8 codes with their scales, or as e4m3, at row pos, while the
// token's own fold stays float32 (common.cuh's note on the cache kinds).
// A 7B step at pos 600 then reads 0.16 GB of rows and scales where bf16
// reads 0.31 GB.  The weights and their kinds do not change.  In mode 5
// each rank holds its kv heads' rows (and scale planes); the split and
// merge passes know nothing of the reduces, which ride the products and
// the norms, and run the same PDL chain as on a bf16 cache (the split
// waits for the QKV product, the merge lets the O product start).
//
// Head dim 64 (TinyLlama; the TPU kernel's defer_append variant, which
// emits the new rows as bf16 outputs and lands them after the call): the
// same launches, the split and merge passes taking hd as a runtime
// argument, with the TPU kernel's two hd-64 rules.  An 8-bit cache stores
// the new rows rounded to bf16 first (int8 codes and scale of the bf16
// row, e4m3 of the bf16 row), while the token's fold stays float32; a bf16
// cache stores bf16 of the float32 row either way.  The O projection of
// int4 weights is the exact product (bf16(code * s)) in W4A8 too, since
// the TPU kernel's per-row O contraction at hd 64 dequantizes its tile.
// The split reads only rows below pos, so appending in the merge gives
// what the TPU kernel's deferred update gives.
//
// Sliding window (`window` > 0, Mistral's semantics, the TPU kernel's
// wlo = seq + 1 - window): the token at pos attends cached rows >= pos + 1
// - window and itself.  The split pass keeps its split boundaries
// (multiples of kv_split from row 0) and runs only the splits that hold a
// row in the window, the first of them masked below pos + 1 - window, so
// rows below the window cost no bytes, as the TPU kernel's aliased chunks
// cost none; the merge folds those splits alone.  The window is a runtime
// argument of the same kernels (no template instance of its own); window 0,
// or one that reaches row 0, gives the bits of no window.  window 1 reads
// no cached row and launches no split block, as pos 0 does.  In mode 5
// (comm) each rank runs the same split and merge over its own kv heads:
// the window decides which rows a head reads and nothing of the reduces,
// which ride the O and down products and the norms after them, so the
// PDL chain and the flags are those of no window, with one kernel a
// layer fewer at window 1 (7L+3 with the logits gathered).
//
// The split and merge passes are common.cuh's attn_split_kernel and
// attn_merge_kernel (attn_merge8_kernel for an 8-bit cache): the split
// pass bulk-copies each split's K and V rows into shared memory and works
// on a tile's rows at once.  The GEMVs are common.cuh's ring GEMV at
// one row (ring_gemv_kernel): a producer warp bulk-copies 256-column weight tiles
// through a ring of shared-memory stages, consumer warps do the FMAs, and
// the K chunks of a tile meet inside a thread-block cluster in a fixed
// order, so one step on the same inputs gives the same bits every time
// (atomic adds would let the last bits move from run to run, and the bf16
// roundings they flip compound over the layers).  Each GEMV is launched
// with programmatic dependent launch: it streams its first weight stages
// while the kernel before it (resnorm, merge or the previous GEMV, which
// let it start at once; mode 5's resnorm once its reduce has arrived)
// still runs, and reads its input after that kernel has completed.

#include <algorithm>

#include "collective.cuh"
#include "common.cuh"

namespace {

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Launch the norms, the split pass and the merge with programmatic
// dependent launch too, so their launch latency hides under the kernel
// before them (the GEMVs always are).
constexpr bool PDL_CHAIN = true;

struct Scratch {
  float *hx, *res_a, *res_b, *aout, *qkv, *gu, *part_ml, *part_acc;
  __nv_bfloat16 *xn, *o;
  size_t floats;
};

Scratch layout(float* base, int hidden, int kv_heads, int group, int hd, int cap,
               int f_pad, int kv_split) {
  const size_t ns_max = (size_t)(cap + kv_split - 1) / kv_split;
  size_t off = 0;
  Scratch s;
  auto take = [&](size_t n) {
    float* p = base ? base + off : nullptr;
    off += align16(n);
    return p;
  };
  s.hx = take(hidden);
  s.res_a = take(hidden);
  s.res_b = take(hidden);
  s.aout = take(hidden);
  s.qkv = take((size_t)kv_heads * (group + 2) * hd);
  s.gu = take(2 * (size_t)f_pad);
  s.part_ml = take((size_t)kv_heads * ns_max * group * 2);
  s.part_acc = take((size_t)kv_heads * ns_max * group * hd);
  s.xn = reinterpret_cast<__nv_bfloat16*>(take((hidden + 1) / 2));
  s.o = reinterpret_cast<__nv_bfloat16*>(take(((size_t)kv_heads * group * hd + 1) / 2));
  s.floats = off;
  return s;
}

constexpr int GATHER_THREADS = COMM_TILE / 4;    // one 16-byte unit of a tile each

// Kernel 14 inside the stack, its wait (mode 5, `gather`): block t owns tile
// t of the vocab shard (n columns, n % 4 == 0).  After its
// griddepcontrol.wait it reads the gather's epoch e, waits for every rank's
// flag of tile t (published by the LM head's G1_PUSH_GATHER product on each
// rank), lets the kernel after it start only then (launched early, that
// kernel's blocks could hold SMs a virtual rank's product still needs), and
// copies the tile of slot p into part p of logits, p = 0..size-1: every
// slot's load in flight before the stores, read through L2 (the peers wrote
// these bytes).  The last block to finish stores e as the rank's epoch.
__global__ void __launch_bounds__(GATHER_THREADS)
gather_wait_kernel(CfComm cm, float* logits, int n) {
  __shared__ unsigned s_e;
  hopper::grid_dep_wait();
  if (threadIdx.x == 0) s_e = comm_next_epoch(cm, cm.rank);
  __syncthreads();
  const unsigned e = s_e;
  if (threadIdx.x < cm.size) comm_wait(cm, cm.rank, threadIdx.x, blockIdx.x, e);
  __syncthreads();                 // every rank's flag of this tile seen
  hopper::grid_dep_launch_dependents();
  const int n16 = n / 4;
  const int i = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (i < n16) {
    char* own = comm_buf(cm, cm.rank);
    uint4 v[CF_MAX_RANKS];
#pragma unroll
    for (int p = 0; p < CF_MAX_RANKS; ++p)
      if (p < cm.size) v[p] = __ldcg(comm_slot(own, e & 1, p, cm.size, cm.slot_bytes) + i);
    uint4* out = reinterpret_cast<uint4*>(logits);
#pragma unroll
    for (int p = 0; p < CF_MAX_RANKS; ++p)
      if (p < cm.size) out[(size_t)p * n16 + i] = v[p];
  }
  __syncthreads();
  if (threadIdx.x == 0) comm_block_done(cm, cm.rank, e);
}

// Load mode 5's kernels before the first launch of a step, once per card:
// a virtual rank may spin on the card while another's launch would load
// them (see "Lazy loading" in collective.cu).
int preload_mode5() {
  static bool loaded[64];
  int dev = 0;
  CF_CHECK((int)cudaGetDevice(&dev));
  if (dev < 64 && loaded[dev]) return 0;
  cudaFuncAttributes a;
  CF_CHECK((int)cudaFuncGetAttributes(&a, ring_gemv_kernel<false, G1_PUSH_SUM>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, ring_gemv_kernel<true, G1_PUSH_SUM>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, ring_gemv_kernel<false, G1_PUSH_GATHER>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, ring_gemv8_kernel<false, G1_PUSH_SUM>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, ring_gemv8_kernel<true, G1_PUSH_SUM>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, ring_gemv8_kernel<false, G1_PUSH_GATHER>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, ring_gemv4_kernel<false, G1_PUSH_SUM, false>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, ring_gemv4_kernel<true, G1_PUSH_SUM, false>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, ring_gemv4_kernel<false, G1_PUSH_SUM, true>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, ring_gemv4_kernel<true, G1_PUSH_SUM, true>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, resnorm_reduce_kernel));
  CF_CHECK((int)cudaFuncGetAttributes(&a, gather_wait_kernel));
  // the 8-bit caches' split and merge passes (mode 5 on an 8-bit cache)
  CF_CHECK((int)cudaFuncGetAttributes(&a, attn_split_kernel<ATT_MAX_GROUP, false, KV_INT8>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, attn_split_kernel<ATT_MAX_GROUP, false, KV_FP8>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, attn_merge8_kernel<KV_INT8>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, attn_merge8_kernel<KV_FP8>));
  if (dev < 64) loaded[dev] = true;
  return 0;
}

// One product of the step, of weight kind wk (common.cuh's WK_*): bf16
// weights w, or the int8 matrices mat0.. of wmap scaled by sc as
// ring_gemv8_kernel does (kg > 0: per scale group of kg rows, before the
// cluster sum), or the int4 matrices mat0.. of wmap with their group
// scales sc (W4A8: kg is the activation block, 0 the whole row; the exact
// mode takes none).
template <bool SWIGLU>
int step_gemv(int wk, const void* x, int f_off, const void* w, const CUtensorMap* wmap,
              int mat0, const float* sc, int kg, float* y, int K, int N, int nmat,
              long long ws, long long yz, int threads, cudaStream_t st) {
  if (wk == WK_INT8)
    return launch_gemv1<SWIGLU, G1_Y, WK_INT8>(x, f_off, nullptr, y, K, N, nmat, ws, yz,
                                               threads, true, st, nullptr, nullptr, 0.f,
                                               nullptr, wmap, mat0, sc, kg);
  if (wk == WK_INT4)
    return launch_gemv1<SWIGLU, G1_Y, WK_INT4>(x, f_off, nullptr, y, K, N, nmat, ws, yz,
                                               threads, true, st, nullptr, nullptr, 0.f,
                                               nullptr, wmap, mat0, sc, 0);
  if (wk == WK_INT4A8)
    return launch_gemv1<SWIGLU, G1_Y, WK_INT4A8>(x, f_off, nullptr, y, K, N, nmat, ws, yz,
                                                 threads, true, st, nullptr, nullptr, 0.f,
                                                 nullptr, wmap, mat0, sc, kg);
  return launch_gemv1<SWIGLU>(x, f_off, w, y, K, N, nmat, ws, yz, threads, true, st);
}

// One pushing product of mode 5 (one matrix, comm given), of weight kind
// wk: bf16 w, or the int8 matrix mat0 of wmap scaled as step_gemv's, or
// (G1_PUSH_SUM only: the LM head is never int4) the int4 matrix mat0 of
// wmap with its group scales (W4A8: kg the activation block).
template <bool SWIGLU, int PUSH>
int push_gemv(int wk, const void* x, int f_off, const void* w, const CUtensorMap* wmap,
              int mat0, const float* sc, int kg, int K, int N, int threads, cudaStream_t st,
              const CfComm* cc) {
  if (wk == WK_INT8)
    return launch_gemv1<SWIGLU, PUSH, true>(x, f_off, nullptr, nullptr, K, N, 1, 0, 0, threads,
                                            true, st, nullptr, nullptr, 0.f, cc, wmap, mat0,
                                            sc, kg);
  if constexpr (PUSH == G1_PUSH_SUM) {
    if (wk == WK_INT4)
      return launch_gemv1<SWIGLU, PUSH, WK_INT4>(x, f_off, nullptr, nullptr, K, N, 1, 0, 0,
                                                 threads, true, st, nullptr, nullptr, 0.f, cc,
                                                 wmap, mat0, sc, 0);
    if (wk == WK_INT4A8)
      return launch_gemv1<SWIGLU, PUSH, WK_INT4A8>(x, f_off, nullptr, nullptr, K, N, 1, 0, 0,
                                                   threads, true, st, nullptr, nullptr, 0.f,
                                                   cc, wmap, mat0, sc, kg);
  }
  if (wk != WK_BF16) return (int)cudaErrorInvalidValue;
  return launch_gemv1<SWIGLU, PUSH>(x, f_off, w, nullptr, K, N, 1, 0, 0, threads, true, st,
                                    nullptr, nullptr, 0.f, cc);
}

}  // namespace

// Floats of f32 scratch `cf_decoder_stack` needs for this geometry.
extern "C" long long cf_stack_scratch_floats(int hidden, int kv_heads, int hg,
                                             int group, int hd, int cap, int f_pad,
                                             int kv_split, int vocab) {
  (void)hg;
  (void)vocab;
  return (long long)layout(nullptr, hidden, kv_heads, group, hd, cap, f_pad, kv_split)
      .floats;
}

// One decode step at position pos through all L layers, on `stream`.
// lm_head == nullptr: writes out_x/out_res (bf16 [hidden]); otherwise writes
// logits (f32 [vocab]) and out_res.  K/V rows land in kc/vc at row pos.
// *n_launches receives the number of kernels launched.  comm: a CfComm*
// for mode 5 (the reduces over tp; hidden at most REDUCE_MAX_HIDDEN), or
// null.  gather (mode 5 with lm_head, vocab = this rank's shard, at most
// COMM_FLAG_COLS tiles of 256): logits holds size * vocab floats, every
// rank's shard in rank order.  wq_kind (common.cuh's WK_*) is the kind
// of wqkv/wo/w13/w2.  Int8 weights (WK_INT8, the TPU kernel's wq_kind ==
// "int8"): they hold int8 codes and wqkv_s [L, G, C], wo_s [L, G, hidden],
// w13_s [L, 2, f_pad], w2_s [L, hidden] their float32 per-column scales
// (the O projection's per head group, applied to each group's partial
// before the groups are summed); also with comm (the pushes carry the
// scaled sums).  Int4 weights (WK_INT4 exact, WK_INT4A8 W4A8; the TPU
// kernel's "int4", with or without comm): codes packed two a byte along K ([L, G,
// hidden/2, C] ...) and float32 group scales of GS4 rows, wqkv_s [L, G,
// hidden/GS4, C], wo_s [L, G, Ko/GS4, hidden], w13_s [L, 2, hidden/GS4,
// f_pad], w2_s [L, f_pad/GS4, hidden]; W4A8 quantizes the down product's x
// per ffn_block rows (the TPU kernel's f-block), the O projection's per
// head group, QKV's and gate/up's over the row.  lm_s [vocab] given:
// lm_head holds int8 codes (a bf16 or int8 head beside any kind).
// kv_kind (common.cuh's KV_*): the cache kind of kc/vc; KV_INT8: int8 rows
// and ks/vs their float32 scale planes [L, kv_heads, srow] (srow = R * 128
// >= cap); KV_FP8: e4m3 rows; with comm too (mode 5: this rank's heads).
// window: 0 for full attention, else the sliding window (with comm too).
// Returns a cudaError_t (0 on success); every refusal comes before the
// first launch.
extern "C" int cf_decoder_stack(
    const void* x, const void* attn_norm, const void* ffn_norm, const void* cos,
    const void* sin, const void* wqkv, const void* wo, const void* w13,
    const void* w2, void* kc, void* vc, const void* final_norm,
    const void* lm_head, void* out_x, void* out_res, void* logits,
    void* scratch, int L, int hidden, int kv_heads, int hg, int group, int hd,
    int cap, int f_pad, int vocab, int pos, int neox, float eps, int kv_split,
    int threads, int* n_launches, const void* comm, int gather, void* stream,
    const void* wqkv_s, const void* wo_s, const void* w13_s, const void* w2_s,
    const void* lm_s, int wq_kind, int ffn_block, int kv_kind, void* ks, void* vs,
    int srow, int window) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const CfComm* cc = static_cast<const CfComm*>(comm);
  const bool w8 = wq_kind == WK_INT8, w4 = wq_kind == WK_INT4 || wq_kind == WK_INT4A8;
  *n_launches = 0;
  if (window < 0) return (int)cudaErrorInvalidValue;
  if (wq_kind < WK_BF16 || wq_kind > WK_INT4A8 || (wq_kind != WK_BF16) != (wqkv_s != nullptr))
    return (int)cudaErrorInvalidValue;
  if (kv_kind < KV_BF16 || kv_kind > KV_FP8 ||
      (kv_kind == KV_INT8) != (ks != nullptr) || (ks != nullptr) != (vs != nullptr) ||
      (kv_kind == KV_INT8 && srow < cap))
    return (int)cudaErrorInvalidValue;
  if (w4 && (hidden % GS4 != 0 || f_pad % GS4 != 0 ||
             (wq_kind == WK_INT4A8 && (ffn_block < GS4 || ffn_block % GS4 != 0 ||
                                       f_pad % ffn_block != 0))))
    return (int)cudaErrorInvalidValue;
  // hd 128, or 64 (the TPU kernel's defer_append variant); others
  // (Gemma-2's 256) are not ported yet
  if (group > ATT_MAX_GROUP || (hd != 128 && hd != 64) || threads % 32 != 0 ||
      threads < 32 || threads > G1_MAX_THREADS || pos < 0 || pos >= cap ||
      kv_heads % hg != 0)
    return (int)cudaErrorInvalidValue;
  if (gather && (!cc || !lm_head || vocab % 4 != 0 ||
                 (vocab + COMM_TILE - 1) / COMM_TILE > COMM_FLAG_COLS ||
                 4LL * vocab > cc->slot_bytes))
    return (int)cudaErrorInvalidValue;
  if ((w8 || w4) && (!wo_s || !w13_s || !w2_s))
    return (int)cudaErrorInvalidValue;
  if (lm_s && !lm_head)
    return (int)cudaErrorInvalidValue;
  if (cc) {   // mode 5: one flag column per 256-column tile of hidden
    if (hidden > REDUCE_MAX_HIDDEN || 4LL * hidden > cc->slot_bytes)
      return (int)cudaErrorInvalidValue;
    CF_CHECK(preload_mode5());
  }
  Scratch s = layout(static_cast<float*>(scratch), hidden, kv_heads, group, hd, cap,
                     f_pad, kv_split);
  const int G = kv_heads / hg;
  const long long C = (long long)hg * (group + 2) * hd;   // qkv columns per group
  const long long Ko = (long long)hg * group * hd;       // wo rows per group
  const size_t eb = 2;         // bytes per weight (the pointers below: bf16 only)
  const float* cosf = static_cast<const float*>(cos);
  const float* sinf = static_cast<const float*>(sin);
  // int8 and int4: one tensor map per weight over all its layers'
  // matrices (int4: over the packed rows)
  const int kr = w4 ? 2 : 1;
  CUtensorMap mq, mo, m13, m2, mlm;
  if ((w8 || w4) &&
      (!make_int8_weight_map(&mq, wqkv, hidden / kr, (int)C, (long long)L * G) ||
       !make_int8_weight_map(&mo, wo, (int)(G * Ko) / kr, hidden, L) ||
       !make_int8_weight_map(&m13, w13, hidden / kr, f_pad, 2LL * L) ||
       !make_int8_weight_map(&m2, w2, f_pad / kr, hidden, L)))
    return (int)cudaErrorInvalidValue;
  if (lm_s && !make_int8_weight_map(&mlm, lm_head, hidden, vocab, 1))
    return (int)cudaErrorInvalidValue;
  const int gq = w4 ? hidden / GS4 : 1, go = w4 ? (int)(Ko / GS4) : 1;   // scale rows
  const int gf = w4 ? f_pad / GS4 : 1;
  int n = 0;

  for (int l = 0; l < L; ++l) {
    const __nv_bfloat16* an = static_cast<const __nv_bfloat16*>(attn_norm) + (size_t)l * hidden;
    const __nv_bfloat16* fn = static_cast<const __nv_bfloat16*>(ffn_norm) + (size_t)l * hidden;
    const char* wq = static_cast<const char*>(wqkv) + (size_t)l * G * hidden * C * eb;
    const char* wol = static_cast<const char*>(wo) + (size_t)l * G * Ko * hidden * eb;
    const char* w13l = static_cast<const char*>(w13) + (size_t)l * 2 * hidden * f_pad * eb;
    const char* w2l = static_cast<const char*>(w2) + (size_t)l * f_pad * hidden * eb;
    const float *sq = nullptr, *so = nullptr, *s13 = nullptr, *s2 = nullptr;
    if (w8 || w4) {
      sq = static_cast<const float*>(wqkv_s) + (size_t)l * G * gq * C;
      so = static_cast<const float*>(wo_s) + (size_t)l * G * go * hidden;
      s13 = static_cast<const float*>(w13_s) + (size_t)l * 2 * gq * f_pad;
      s2 = static_cast<const float*>(w2_s) + (size_t)l * gf * hidden;
    }
    // W4A8's activation blocks: the O projection's head group, the down
    // product's f-block (int8: the O projection's scale group); at hd 64
    // the O projection of int4 weights is exact (the TPU kernel's per-row
    // contraction dequantizes its tile)
    const int wk_o = wq_kind == WK_INT4A8 && hd % 128 != 0 ? WK_INT4 : wq_kind;
    const int kg_o = wk_o == WK_INT4 ? 0 : (int)Ko;
    const int kg_d = wq_kind == WK_INT4A8 ? ffn_block : 0;
    __nv_bfloat16* kcl = static_cast<__nv_bfloat16*>(kc) + (size_t)l * kv_heads * cap * hd;
    __nv_bfloat16* vcl = static_cast<__nv_bfloat16*>(vc) + (size_t)l * kv_heads * cap * hd;
    // an 8-bit cache's layer: rows of hd bytes, int8 scales per kv head
    uint8_t* kcl8 = static_cast<uint8_t*>(kc) + (size_t)l * kv_heads * cap * hd;
    uint8_t* vcl8 = static_cast<uint8_t*>(vc) + (size_t)l * kv_heads * cap * hd;
    float* ksl = ks ? static_cast<float*>(ks) + (size_t)l * kv_heads * srow : nullptr;
    float* vsl = vs ? static_cast<float*>(vs) + (size_t)l * kv_heads * srow : nullptr;

    // residual add + attention RMSNorm (mode 5: after layer 0, over the
    // down projection's reduce)
    if (cc && l > 0)
      CF_CHECK(launch_kernel(resnorm_reduce_kernel, dim3(1), dim3(NORM_THREADS), 0, st,
          PDL_CHAIN, *cc, s.res_a, an, s.res_b, s.xn, nullptr, nullptr, hidden, eps));
    else
      CF_CHECK(launch_kernel(resnorm_kernel, dim3(1), dim3(NORM_THREADS), 0, st, PDL_CHAIN,
          l == 0 ? nullptr : s.hx,
          l == 0 ? static_cast<const __nv_bfloat16*>(x) : nullptr,
          l == 0 ? nullptr : s.res_a, nullptr, an, s.res_b, nullptr, s.xn, nullptr,
          nullptr, hidden, eps, nullptr, 0, nullptr, 0));
    ++n;
    // the G head groups' QKV products, each scaled by its own s[G] (int8)
    CF_CHECK(step_gemv<false>(wq_kind, s.xn, 0, wq, &mq, l * G, sq, 0, s.qkv, hidden, (int)C,
                              G, (long long)hidden * C, C, threads, st));
    ++n;
    // split-KV attention over rows < pos (those in the window), then the
    // merge with the current token, which appends its k/v at row pos
    // (bf16, or 8-bit: at hd 64 of the bf16-rounded rows)
    if (kv_kind == KV_INT8)
      CF_CHECK(launch_attention8<KV_INT8>(s.qkv, kcl8, vcl8, cosf, sinf, s.part_ml, s.part_acc,
                                          s.o, ksl, vsl, srow, kv_heads, group, hd, cap, pos,
                                          kv_split, neox, st, &n, PDL_CHAIN, hd % 128 != 0,
                                          window));
    else if (kv_kind == KV_FP8)
      CF_CHECK(launch_attention8<KV_FP8>(s.qkv, kcl8, vcl8, cosf, sinf, s.part_ml, s.part_acc,
                                         s.o, nullptr, nullptr, 0, kv_heads, group, hd, cap,
                                         pos, kv_split, neox, st, &n, PDL_CHAIN, hd % 128 != 0,
                                         window));
    else
      CF_CHECK(launch_attention(s.qkv, kcl, vcl, cosf, sinf, s.part_ml, s.part_acc,
                                kcl, vcl, nullptr, nullptr, s.o, nullptr, nullptr,
                                kv_heads, group, hd, cap, pos, kv_split, 1, neox,
                                st, &n, PDL_CHAIN, window));
    // wo_f[l] is [G * Ko, hidden] row-major: one product sums the groups
    // (int8: each group's partial scaled by its s[G] first); then the
    // attention-out residual add + FFN RMSNorm
    if (cc) {   // Stage.ATTN: the ranks' O-projection partials, summed
      CF_CHECK((push_gemv<false, G1_PUSH_SUM>(wk_o, s.o, 0, wol, &mo, l, so, kg_o,
                                              (int)(G * Ko), hidden, threads, st, cc)));
      CF_CHECK(launch_kernel(resnorm_reduce_kernel, dim3(1), dim3(NORM_THREADS), 0, st,
          PDL_CHAIN, *cc, s.res_b, fn, s.res_a, s.xn, nullptr, nullptr, hidden, eps));
    } else {
      CF_CHECK(step_gemv<false>(wk_o, s.o, 0, wol, &mo, l, so, kg_o, s.aout,
                                (int)(G * Ko), hidden, 1, 0, 0, threads, st));
      CF_CHECK(launch_kernel(resnorm_kernel, dim3(1), dim3(NORM_THREADS), 0, st, PDL_CHAIN,
          s.aout, nullptr, s.res_b, nullptr, fn, s.res_a, nullptr, s.xn, nullptr,
          nullptr, hidden, eps, nullptr, 0, nullptr, 0));
    }
    n += 2;
    // gate and up, each column scaled before the down product's SwiGLU reads it
    CF_CHECK(step_gemv<false>(wq_kind, s.xn, 0, w13l, &m13, 2 * l, s13, 0, s.gu, hidden,
                              f_pad, 2, (long long)hidden * f_pad, f_pad, threads, st));
    ++n;
    if (cc)     // Stage.LINEAR: the down projection's partials go to the reduce
      CF_CHECK((push_gemv<true, G1_PUSH_SUM>(wq_kind, s.gu, f_pad, w2l, &m2, l, s2, kg_d,
                                             f_pad, hidden, threads, st, cc)));
    else        // int8: scaled after the whole sum over f
      CF_CHECK(step_gemv<true>(wq_kind, s.gu, f_pad, w2l, &m2, l, s2, kg_d, s.hx, f_pad,
                               hidden, 1, 0, 0, threads, st));
    ++n;
  }

  // the final norm over hx + res (mode 5: hx is the last reduce)
  const __nv_bfloat16* fnorm = static_cast<const __nv_bfloat16*>(final_norm);
  __nv_bfloat16* xo = lm_head ? nullptr : static_cast<__nv_bfloat16*>(out_x);
  __nv_bfloat16* ro = static_cast<__nv_bfloat16*>(out_res);
  if (cc)
    CF_CHECK(launch_kernel(resnorm_reduce_kernel, dim3(1), dim3(NORM_THREADS), 0, st,
        PDL_CHAIN, *cc, s.res_a, lm_head ? fnorm : nullptr, nullptr,
        lm_head ? s.xn : nullptr, xo, ro, hidden, eps));
  else
    CF_CHECK(launch_kernel(resnorm_kernel, dim3(1), dim3(NORM_THREADS), 0, st, PDL_CHAIN,
        s.hx, nullptr, s.res_a, nullptr, lm_head ? fnorm : nullptr, nullptr, nullptr,
        lm_head ? s.xn : nullptr, xo, ro, hidden, eps, nullptr, 0, nullptr, 0));
  ++n;
  const __nv_bfloat16* lm = static_cast<const __nv_bfloat16*>(lm_head);
  if (lm_head && gather) {   // kernel 14: this rank's shard pushed, then every rank's gathered
    CF_CHECK((push_gemv<false, G1_PUSH_GATHER>(lm_s ? WK_INT8 : WK_BF16, s.xn, 0, lm, &mlm, 0,
                                               static_cast<const float*>(lm_s), 0, hidden,
                                               vocab, threads, st, cc)));
    CF_CHECK(launch_kernel(gather_wait_kernel, dim3((vocab + COMM_TILE - 1) / COMM_TILE),
                           dim3(GATHER_THREADS), 0, st, PDL_CHAIN, *cc,
                           static_cast<float*>(logits), vocab));
    n += 2;
  } else if (lm_head) {      // int8 head: each logit scaled after its sum
    CF_CHECK(step_gemv<false>(lm_s ? WK_INT8 : WK_BF16, s.xn, 0, lm_head, &mlm, 0,
                              static_cast<const float*>(lm_s), 0, static_cast<float*>(logits),
                              hidden, vocab, 1, 0, 0, threads, st));
    ++n;
  }
  *n_launches = n;
  return 0;
}
