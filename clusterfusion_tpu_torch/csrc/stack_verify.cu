// Whole-stack verify of n rows for Hopper (sm_90a): every layer of one
// speculative-decoding verify, then the final RMSNorm and the LM head.
//
// Replaces the TPU kernel `fused_verify_stack`
// (clusterfusion_tpu/ops/stack_verify.py, `_verify_kernel`) for bf16, int8
// or int4 weights, a bf16, int8 (Int8KV) or fp8 e4m3 KV cache, a sliding
// window (Mistral's, below), no bias and no sandwich norms, with the
// layouts of stack_kernel.cu.  Row t of x is the token at position pos +
// t; it attends every cached row < pos and the fresh rows 0..t, and all n
// K/V rows are appended at pos..pos+n-1 of every layer.  Cache rows at and
// above pos are never read: they may hold rows of rejected drafts.
//
// Sliding window (`window` > 0; the TPU kernel's per-row bound): token t
// attends positions >= pos + t + 1 - window, cached and fresh.  The split
// pass runs the splits from the first that holds a row in token 0's window
// (the lowest bound) and masks each q row below its own token's bound; a
// split can hold no live row for a later token, and then its partial is
// (NEG_INF, 0, 0), which the merge folds as nothing.  The merge masks the
// fresh rows j < t + 1 - window of token t too.  A runtime argument, no
// template instance of its own.
//
// What bounds it: the products read every weight once for up to 16 rows
// (13.4 GB at Llama-2-7B) and do 2n operations per weight byte, far under
// the card's ~295 operations per byte, so bytes bound it, as they bound the
// one-row stack.  The GEMVs are common.cuh's rows GEMV: weights stream as
// TMA boxes through a shared-memory ring, mma.sync takes up to 16 rows of
// x at once, and the K chunks of a column tile meet inside a thread-block
// cluster in a fixed order, so one call on the same inputs gives the same
// bits every time and the products write their outputs whole.  The
// attention's split pass is the stack's own (common.cuh's
// attn_split_kernel, in its n-token instance): each split's K and V rows
// bulk-copied into shared memory once per kv head and tile of up to 16
// query rows.  Every kernel after the first is launched with programmatic
// dependent launch, as in the one-row stack: it starts while the one
// before it runs (a GEMV streams its first weight stages) and waits inside
// before it reads that one's output.
//
// The sequence per layer is stack_kernel.cu's at M = n rows, on one stream:
//   resnorm  grid n: r1 = hx + res; xn = bf16(rmsnorm(r1) * attn_norm)
//   gemv     qkv[t] = xn[t] @ wqkv_f[l]
//   split    attn_split_kernel<8 or 16, true>: per (kv head, split of cache
//            rows < pos, tile of query rows), q roped, scaled by
//            1/sqrt(hd)*log2(e) and rounded to bf16; bf16(p) . V against
//            the split's own max; one partial (m, l, acc) per query row
//   merge    verify_merge_kernel: per (kv head, q head row), merge the
//            partials, fold in the n x n causal block of fresh rows (scores
//            from the float32 q and k, then bf16(p) . bf16(v), as the TPU
//            kernel rounds them), append the n bf16 K/V rows,
//            o[t] = bf16(acc / l), token-major
//   gemv     aout[t] = o[t] @ wo_f[l]
//   resnorm  r2 = aout + r1; xn = bf16(rmsnorm(r2) * ffn_norm)
//   gemv     act[t] = bf16(silu(xn[t] @ w13[l][0]) * (xn[t] @ w13[l][1]))
//            (the rows GEMV's pair epilogue; at n = 1 the one-row GEMV
//            writes gate and up in f32 and the down product forms act)
//   gemv     hx[t] = act[t] @ w2[l]
// and once per call the final resnorm and the LM-head GEMV (or the bf16
// outputs without an LM head).  The hidden pair stays float32 across layers.
//
// Int8 and int4 weights run the GEMVs' int8 and int4 instances, as in
// stack_kernel.cu: from 2 rows the rows GEMV's (rows_gemv8_kernel,
// rows_gemv4_kernel; at n = 1 the one-row GEMV's).  In W4A8 each of the n
// rows is quantized on its own, per activation block: from 2 rows by
// common.cuh's quant_x8_kernel before each product (12 kernels a layer),
// at one row inside the one-row GEMV (8).
//
// 8-bit KV caches (common.cuh's note on the cache kinds): the split pass's
// n-token form converts each 8-bit tile to bf16 before its mma.sync (int8:
// the scores scaled by sk, p by sv before its bf16 rounding), and the merge
// stores each fresh row from float32, per (kv head, token): int8 codes and
// scales (the n positions may straddle a 128-column plane row: the planes
// are flat per kv head) or e4m3.  The causal block of fresh rows stays
// float32 K with bf16-rounded V, whatever the cache kind, as in the TPU
// kernel.
//
// Query row r of kv head h is (head row i, token t) with r = i*n + t, the
// TPU kernel's panel order.  The merge keeps the n fresh q, k and v rows of
// its head in shared memory, so n <= MAX_N.

#include "common.cuh"

namespace {

constexpr int MAX_N = 32;
constexpr int MERGE_SMEM_MAX = 96 * 1024;

// Merge of kv head h = blockIdx.x, q head row i = blockIdx.y and token t =
// blockIdx.z: the split partials plus the causal block of the fresh rows j
// <= t (under a window, j >= t + 1 - window), o[t*kv*group*hd +
// (h*group + i)*hd + d] = bf16(acc / l).  The
// blocks with i = 0 append fresh row t's K/V at pos + t (bf16, or as
// store_row8 stores it: int8 with its scales at ks/vs[h * srow + pos + t],
// or e4m3).  One block per query row, so that the partials of every row are
// read at once (a block per q head row walked its n rows' splits one after
// another); the splits' maximum is exact in any order and their sum runs in
// a fixed one.
template <int KV>
__global__ void __launch_bounds__(ATT_THREADS)
verify_merge_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ part_ml,
                    const float* __restrict__ part_acc,
                    const float* __restrict__ cos, const float* __restrict__ sin,
                    void* __restrict__ kc, void* __restrict__ vc,
                    __nv_bfloat16* __restrict__ o, int n, int group, int hd,
                    int cap, int pos, int ns, int neox, float* __restrict__ ks,
                    float* __restrict__ vs, int srow, int window) {
  hopper::grid_dep_launch_dependents();   // the O-projection may start
  hopper::grid_dep_wait();
  extern __shared__ float sm[];
  float* qr = sm;                        // [hd] roped, scaled f32 q of row (i, t)
  float* kr = qr + hd;                   // [t + 1][hd] roped f32 fresh k
  float* vb = kr + n * hd;               // [t + 1][hd] bf16-rounded fresh v
  float* scur = vb + n * hd;             // [t + 1] fresh scores
  float* es = scur + n;                  // [ns] exp2(split max - max)
  __shared__ float red[32];
  const int h = blockIdx.x, i = blockIdx.y, t = blockIdx.z, kv_heads = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int nw = blockDim.x / 32;
  const int rows = group * n;
  const size_t qrow = (size_t)h * ns * rows + (size_t)i * n + t;   // split 0's row
  const size_t qkv_n = (size_t)kv_heads * (group + 2) * hd;
  const float scale = LOG2E / sqrtf((float)hd);
  const int jlo = window > 0 ? max(0, t + 1 - window) : 0;   // fresh rows attended
  for (int e = tid; e < (t + 1) * hd; e += blockDim.x) {
    const int j = e / hd, d = e % hd;
    const float* head = qkv + j * qkv_n + (size_t)h * (group + 2) * hd;
    const float* ct = cos + (size_t)j * hd;
    const float* st = sin + (size_t)j * hd;
    const float kd = rope_at(head + group * hd, d, hd, ct, st, neox);
    const float vd = head[(group + 1) * hd + d];
    kr[e] = kd;
    vb[e] = bf16_round(vd);
    if (j == t) {
      qr[d] = rope_at(head + i * hd, d, hd, ct, st, neox) * scale;
      if constexpr (KV == KV_BF16) {
        if (i == 0) {
          const size_t row = ((size_t)h * cap + pos + t) * hd + d;
          static_cast<__nv_bfloat16*>(kc)[row] = __float2bfloat16(kd);
          static_cast<__nv_bfloat16*>(vc)[row] = __float2bfloat16(vd);
        }
      }
    }
  }
  float mx = NEG_INF;                    // the splits' maxima, threads over splits
  for (int s = tid; s < ns; s += blockDim.x)
    mx = fmaxf(mx, part_ml[(qrow + (size_t)s * rows) * 2]);
  __syncthreads();
  if constexpr (KV != KV_BF16) {
    if (i == 0) {                        // fresh row t's stored copy, from float32
      const size_t row = ((size_t)h * cap + pos + t) * hd;
      const float* vt = qkv + t * qkv_n + (size_t)h * (group + 2) * hd + (group + 1) * hd;
      const size_t at = (size_t)h * srow + pos + t;   // int8: the row's scale
      store_row8<KV>([&](int d) { return kr[t * hd + d]; }, hd,
                     static_cast<uint8_t*>(kc) + row, ks ? ks + at : nullptr, red);
      store_row8<KV>([&](int d) { return vt[d]; }, hd, static_cast<uint8_t*>(vc) + row,
                     vs ? vs + at : nullptr, red);
    }
  }
  for (int j = wid; j <= t; j += nw) {   // one warp per fresh row
    float part = 0.f;
    for (int d = lane; d < hd; d += 32) part = fmaf(qr[d], kr[j * hd + d], part);
    part = warp_sum(part);
    if (lane == 0) scur[j] = part;
  }
  mx = warp_max(mx);
  if (lane == 0) red[wid] = mx;
  __syncthreads();
  mx = NEG_INF;
  for (int w = 0; w < nw; ++w) mx = fmaxf(mx, red[w]);
  for (int j = jlo; j <= t; ++j) mx = fmaxf(mx, scur[j]);
  float lp = 0.f;
  for (int s = tid; s < ns; s += blockDim.x) {
    const size_t idx = qrow + (size_t)s * rows;
    const float e = exp2f(part_ml[idx * 2] - mx);
    es[s] = e;
    lp = fmaf(part_ml[idx * 2 + 1], e, lp);
  }
  const float l_split = block_sum(lp, red);   // its barriers publish es too
  for (int d = tid; d < hd; d += blockDim.x) {
    float acc = 0.f, l = l_split;
#pragma unroll 8
    for (int s = 0; s < ns; ++s)
      acc = fmaf(part_acc[(qrow + (size_t)s * rows) * hd + d], es[s], acc);
    for (int j = jlo; j <= t; ++j) {
      const float p = exp2f(scur[j] - mx);
      l += p;
      acc = fmaf(bf16_round(p), vb[j * hd + d], acc);
    }
    o[(size_t)t * kv_heads * group * hd + ((size_t)h * group + i) * hd + d] =
        __float2bfloat16(acc / l);
  }
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// The split pass's instance for `rows` query rows a kv head, of cache kind
// KV: tiles of up to 8 rows where they fit, else of up to ATT_MAX_ROWS.
struct SplitPlan {
  void (*kern)(const float*, const void*, const void*, const float*, const float*, float*,
               float*, int, int, int, int, int, int, int, const float*, const float*, int,
               int);
  int tile_rows, tiles;
};
template <int KV = KV_BF16>
SplitPlan split_plan(int rows) {
  if (rows <= ATT_MAX_GROUP)
    return {attn_split_kernel<ATT_MAX_GROUP, true, KV>, rows, 1};
  return {attn_split_kernel<ATT_MAX_ROWS, true, KV>, std::min(rows, ATT_MAX_ROWS),
          (rows + ATT_MAX_ROWS - 1) / ATT_MAX_ROWS};
}

// The split and merge passes' shared-memory allowances, set once for each
// cache kind.
template <int KV = KV_BF16>
int set_attrs() {
  static bool attrs_set = false;
  if (!attrs_set) {
    CF_CHECK((int)cudaFuncSetAttribute(attn_split_kernel<ATT_MAX_GROUP, true, KV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       G1_SMEM_MAX));
    CF_CHECK((int)cudaFuncSetAttribute(attn_split_kernel<ATT_MAX_ROWS, true, KV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       G1_SMEM_MAX));
    CF_CHECK((int)cudaFuncSetAttribute(verify_merge_kernel<KV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       MERGE_SMEM_MAX));
    attrs_set = true;
  }
  return 0;
}

// One layer's split pass (when a cached row is in token 0's window) and
// merge, of cache kind KV, on `st` under PDL; *k counts the launches.
// kc/vc are the layer's rows, ks/vs its int8 scale planes (row stride
// srow); window: 0 or the sliding window.
template <int KV>
int verify_attention(const float* qkv, const float* cosf, const float* sinf, float* part_ml,
                     float* part_acc, void* kc, void* vc, __nv_bfloat16* o, int n,
                     int kv_heads, int group, int hd, int cap, int pos, int kv_split, int neox,
                     float* ks, float* vs, int srow, int window, cudaStream_t st, int* k) {
  CF_CHECK(set_attrs<KV>());
  const SplitPlan sp = split_plan<KV>(group * n);
  const size_t split_smem = attn_split_smem(sp.tile_rows, hd, kv_split, true, KV);
  const int ns = attn_live_splits(pos, kv_split, window);
  const size_t merge_smem = sizeof(float) * ((size_t)(2 * n + 1) * hd + n + ns);
  if (ns > 0) {
    CF_CHECK(launch_kernel(sp.kern, dim3(kv_heads, ns, sp.tiles), dim3(ATT_THREADS), split_smem,
                           st, true, qkv, (const void*)kc, (const void*)vc, cosf, sinf,
                           part_ml, part_acc, group, hd, cap, pos, kv_split, neox, n,
                           (const float*)ks, (const float*)vs, srow, window));
    ++*k;
  }
  CF_CHECK(launch_kernel(verify_merge_kernel<KV>, dim3(kv_heads, group, n), dim3(ATT_THREADS),
                         merge_smem, st, true, qkv, part_ml, part_acc, cosf, sinf, kc, vc, o,
                         n, group, hd, cap, pos, ns, neox, ks, vs, srow, window));
  ++*k;
  return 0;
}

struct Scratch {
  float *hx, *res_a, *res_b, *aout, *qkv, *gu, *part_ml, *part_acc, *xs;
  __nv_bfloat16 *xn, *o, *x8;
  size_t floats;
};

Scratch layout(float* base, int n, int hidden, int kv_heads, int group, int hd,
               int cap, int f_pad, int kv_split) {
  const size_t ns_max = (size_t)(cap + kv_split - 1) / kv_split;
  const size_t rows = (size_t)kv_heads * group * n;   // query rows in all
  size_t off = 0;
  Scratch s;
  auto take = [&](size_t count) {
    float* p = base ? base + off : nullptr;
    off += align16(count);
    return p;
  };
  s.hx = take((size_t)n * hidden);
  s.res_a = take((size_t)n * hidden);
  s.res_b = take((size_t)n * hidden);
  s.aout = take((size_t)n * hidden);
  s.qkv = take((size_t)n * kv_heads * (group + 2) * hd);
  s.gu = take((size_t)n * 2 * f_pad);
  s.part_ml = take(rows * ns_max * 2);
  s.part_acc = take(rows * ns_max * hd);
  s.xn = reinterpret_cast<__nv_bfloat16*>(take(((size_t)n * hidden + 1) / 2));
  s.o = reinterpret_cast<__nv_bfloat16*>(take((rows * hd + 1) / 2));
  // W4A8: each product's x8 and its scales, one activation block of at
  // least GS4 columns a scale
  const size_t widest = std::max<size_t>({(size_t)hidden, rows * hd, (size_t)f_pad});
  s.x8 = reinterpret_cast<__nv_bfloat16*>(take((n * widest + 1) / 2));
  s.xs = take(n * (widest / GS4 + 1));
  s.floats = off;
  return s;
}

// One product of the verify, of weight kind wk (common.cuh's WK_*): bf16
// weights w, or the int8 matrices mat0.. of wmap scaled by sc with the
// scale group kg (common.cuh's launch_ring_gemv8), or the int4 ones with
// their group scales (launch_ring_gemv4; W4A8: kg the activation block).
int verify_gemv(int wk, const __nv_bfloat16* x, long long x_row, const void* w,
                const Int8Map* wmap, int mat0, const float* sc, int kg, float* y, int M, int K,
                int N, int nmat, long long ws, long long y_row, long long yz, int threads,
                cudaStream_t st, const Scratch& s) {
  if (wk == WK_INT8)
    return launch_ring_gemv8(x, x_row, wmap, mat0, sc, kg, y, M, K, N, nmat, y_row, yz,
                             threads, true, st);
  if (wk == WK_INT4 || wk == WK_INT4A8)
    return wk == WK_INT4A8 ? launch_ring_gemv4<true>(x, x_row, wmap, mat0, sc, kg, y, M, K, N,
                                                     nmat, y_row, yz, threads, true, st,
                                                     nullptr, s.x8, s.xs)
                           : launch_ring_gemv4<false>(x, x_row, wmap, mat0, sc, 0, y, M, K, N,
                                                      nmat, y_row, yz, threads, true, st);
  return launch_ring_gemv(x, x_row, static_cast<const __nv_bfloat16*>(w), y, M, K, N, nmat, ws,
                          y_row, yz, threads, true, st);
}

}  // namespace

// Floats of f32 scratch `cf_verify_stack` needs for this geometry.
extern "C" long long cf_verify_scratch_floats(int n, int hidden, int kv_heads,
                                              int group, int hd, int cap,
                                              int f_pad, int kv_split) {
  return (long long)layout(nullptr, n, hidden, kv_heads, group, hd, cap, f_pad,
                           kv_split).floats;
}

// The verify's split pass alone (one launch of attn_split_kernel in its
// n-token instance; the card tests hold it against the plain split): qkv
// f32 [n][kv*(group+2)*hd], cos/sin f32 [n, hd], caches bf16 [kv, cap, hd]
// of which rows < seq are read in splits of `split`; writes part_ml
// [kv, ns, group*n, 2] and part_acc [kv, ns, group*n, hd], ns the splits
// that hold a row in token 0's window (all of them without one: window 0).
// Returns a cudaError_t (0 on success; nothing is launched when ns is 0).
extern "C" int cf_verify_split(const void* qkv, const void* kc, const void* vc,
                               const void* cos, const void* sin, void* part_ml,
                               void* part_acc, int n, int kv_heads, int group, int hd,
                               int cap, int seq, int split, int neox, int window,
                               void* stream) {
  const SplitPlan sp = split_plan(group * n);
  const size_t smem = attn_split_smem(sp.tile_rows, hd, split, true);
  if (n < 1 || group < 1 || hd != 128 || split < 1 || split > ATT_MAX_SPLIT || seq < 1 ||
      seq > cap || window < 0 || smem > (size_t)G1_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  CF_CHECK(set_attrs());
  const int ns = attn_live_splits(seq, split, window);
  if (ns == 0) return 0;
  return launch_kernel(sp.kern, dim3(kv_heads, ns, sp.tiles),
                       dim3(ATT_THREADS), smem, static_cast<cudaStream_t>(stream), false,
                       static_cast<const float*>(qkv), kc, vc, static_cast<const float*>(cos),
                       static_cast<const float*>(sin), static_cast<float*>(part_ml),
                       static_cast<float*>(part_acc), group, hd, cap, seq, split, neox, n,
                       (const float*)nullptr, (const float*)nullptr, 0, window);
}

// The phase stamps of one of kernel 8's products inside a call (chip_smoke.py
// phase 9): the rows GEMV launched `at`-th (from 0) after this call records
// %globaltimer stamps into `stamps` (uint64 [blocks][8]); at < 0 turns the
// probe off.  Returns 0.
extern "C" int cf_verify_probe_gemv(void* stamps, int at) {
  rg_probe = RgProbe{static_cast<unsigned long long*>(stamps), at, 0};
  return 0;
}

// One n-row verify at positions pos..pos+n-1 through all L layers, on
// `stream`.  x is bf16 [n, hidden], cos/sin f32 [n, hd].  lm_head ==
// nullptr: writes out_x/out_res (bf16 [n, hidden]); otherwise writes logits
// (f32 [n, vocab]) and out_res.  K/V rows land in kc/vc at rows
// pos..pos+n-1.  *n_launches receives the number of kernels launched.
// wq_kind (common.cuh's WK_*) is the kind of wqkv/wo/w13/w2.  Int8
// weights (WK_INT8, the TPU kernel's wq_kind == "int8"): int8 codes and
// wqkv_s [L, G, C], wo_s [L, G, hidden], w13_s [L, 2, f_pad], w2_s [L,
// hidden] their float32 per-column scales (the O projection's per head
// group, applied to each group's partial before the groups are summed).
// Int4 (WK_INT4 exact, WK_INT4A8 W4A8; "int4"): codes packed two a byte
// along K and float32 group scales, as cf_decoder_stack takes them; W4A8
// quantizes each row's x per block as there (ffn_block: the down
// product's).  lm_s [vocab] given: lm_head holds int8 codes (a bf16 head
// beside quantized layers keeps its bf16 GEMV).  One tensor map per weight
// over all its layers' matrices, encoded per call.  kv_kind (common.cuh's
// KV_*): the cache kind, as cf_decoder_stack takes it (ks/vs: int8 scale
// planes [L, kv_heads, srow]).  window: 0 for full attention, else the
// sliding window.  Returns a cudaError_t (0 on success); every refusal
// comes before the first launch.
extern "C" int cf_verify_stack(
    const void* x, const void* attn_norm, const void* ffn_norm, const void* cos,
    const void* sin, const void* wqkv, const void* wo, const void* w13,
    const void* w2, void* kc, void* vc, const void* final_norm,
    const void* lm_head, void* out_x, void* out_res, void* logits,
    void* scratch, int n, int L, int hidden, int kv_heads, int hg, int group,
    int hd, int cap, int f_pad, int vocab, int pos, int neox, float eps,
    int kv_split, int threads, int* n_launches, void* stream, const void* wqkv_s,
    const void* wo_s, const void* w13_s, const void* w2_s, const void* lm_s, int wq_kind,
    int ffn_block, int kv_kind, void* ks, void* vs, int srow, int window) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w8 = wq_kind == WK_INT8, w4 = wq_kind == WK_INT4 || wq_kind == WK_INT4A8;
  const bool a8 = wq_kind == WK_INT4A8;
  *n_launches = 0;
  if (window < 0) return (int)cudaErrorInvalidValue;
  if (wq_kind < WK_BF16 || wq_kind > WK_INT4A8 || (wq_kind != WK_BF16) != (wqkv_s != nullptr))
    return (int)cudaErrorInvalidValue;
  if (w4 && (hidden % GS4 != 0 || f_pad % GS4 != 0 ||
             (a8 && (ffn_block < GS4 || ffn_block % GS4 != 0 || f_pad % ffn_block != 0))))
    return (int)cudaErrorInvalidValue;
  // hd 128 only: others (Gemma-2's 256) are not ported yet
  const SplitPlan sp = split_plan(group * n);
  const size_t split_smem = attn_split_smem(sp.tile_rows, hd, kv_split, true, kv_kind);
  const int ns = (pos + kv_split - 1) / kv_split;
  const size_t merge_smem = sizeof(float) * ((size_t)(2 * n + 1) * hd + n + ns);
  if (n < 1 || n > MAX_N || hd != 128 || group < 1 || threads % 32 != 0 || threads < 32 ||
      threads > G1_MAX_THREADS || kv_split < 1 || kv_split > ATT_MAX_SPLIT ||
      pos < 0 || pos + n > cap || kv_heads % hg != 0 ||
      split_smem > (size_t)G1_SMEM_MAX || merge_smem > (size_t)MERGE_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (kv_kind < KV_BF16 || kv_kind > KV_FP8 || (kv_kind == KV_INT8) != (ks != nullptr) ||
      (ks != nullptr) != (vs != nullptr) || (kv_kind == KV_INT8 && srow < cap))
    return (int)cudaErrorInvalidValue;
  if (((w8 || w4) && (!wo_s || !w13_s || !w2_s)) || (lm_s && (!lm_head || !(w8 || w4))))
    return (int)cudaErrorInvalidValue;
  Scratch s = layout(static_cast<float*>(scratch), n, hidden, kv_heads, group, hd,
                     cap, f_pad, kv_split);
  const int G = kv_heads / hg;
  const long long C = (long long)hg * (group + 2) * hd;   // qkv columns per group
  const long long Ko = (long long)hg * group * hd;       // wo rows per group
  const int qkv_n = kv_heads * (group + 2) * hd;
  const int o_n = kv_heads * group * hd;
  const size_t eb = 2;         // bytes per weight (the pointers below: bf16 only)
  const float* cosf = static_cast<const float*>(cos);
  const float* sinf = static_cast<const float*>(sin);
  // int8 and int4: one tensor map per weight over all its layers'
  // matrices, the one-row GEMV's at n == 1, the rows GEMV's from 2
  auto qmap = w4 ? make_int4_map : make_int8_map;
  Int8Map mq, mo, m13, m2, mlm;
  if ((w8 || w4) && (!qmap(&mq, wqkv, hidden, (int)C, (long long)L * G, n) ||
                     !qmap(&mo, wo, (int)(G * Ko), hidden, L, n) ||
                     !qmap(&m13, w13, hidden, f_pad, 2LL * L, n) ||
                     !qmap(&m2, w2, f_pad, hidden, L, n)))
    return (int)cudaErrorInvalidValue;
  const int gq = w4 ? hidden / GS4 : 1, go = w4 ? (int)(Ko / GS4) : 1;   // scale rows
  const int gf = w4 ? f_pad / GS4 : 1;
  // W4A8's activation blocks (int8: the O projection's scale group); from
  // 2 rows each W4A8 product is two launches, its x's quantization first
  const int kg_o = wq_kind == WK_INT4 ? 0 : (int)Ko, kg_d = a8 ? ffn_block : 0;
  const int qx = a8 && n >= 2 ? 1 : 0;
  if (lm_s && !make_int8_map(&mlm, lm_head, hidden, vocab, 1, n))
    return (int)cudaErrorInvalidValue;
  int k = 0;

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
    // the layer's rows (2 bytes a value, or 1 in an 8-bit cache) and scales
    const size_t eb_kv = kv_kind == KV_BF16 ? 2 : 1;
    char* kcl = static_cast<char*>(kc) + (size_t)l * kv_heads * cap * hd * eb_kv;
    char* vcl = static_cast<char*>(vc) + (size_t)l * kv_heads * cap * hd * eb_kv;
    float* ksl = ks ? static_cast<float*>(ks) + (size_t)l * kv_heads * srow : nullptr;
    float* vsl = vs ? static_cast<float*>(vs) + (size_t)l * kv_heads * srow : nullptr;

    // residual add + attention RMSNorm per row (the call's first kernel
    // waits for everything before it on the stream; the rest overlap)
    CF_CHECK(launch_kernel(resnorm_kernel, dim3(n), dim3(NORM_THREADS), 0, st, l > 0,
        l == 0 ? nullptr : s.hx,
        l == 0 ? static_cast<const __nv_bfloat16*>(x) : nullptr,
        l == 0 ? nullptr : s.res_a, nullptr, an, s.res_b, nullptr, s.xn, nullptr,
        nullptr, hidden, eps, nullptr, 0, nullptr, 0));
    ++k;
    // the G head groups' QKV products (int8: each scaled by its own s[G])
    CF_CHECK(verify_gemv(wq_kind, s.xn, hidden, wq, &mq, l * G, sq, 0, s.qkv, n, hidden,
                         (int)C, G, (long long)hidden * C, qkv_n, C, threads, st, s));
    k += 1 + qx;
    if (kv_kind == KV_INT8)
      CF_CHECK(verify_attention<KV_INT8>(s.qkv, cosf, sinf, s.part_ml, s.part_acc, kcl, vcl,
                                         s.o, n, kv_heads, group, hd, cap, pos, kv_split,
                                         neox, ksl, vsl, srow, window, st, &k));
    else if (kv_kind == KV_FP8)
      CF_CHECK(verify_attention<KV_FP8>(s.qkv, cosf, sinf, s.part_ml, s.part_acc, kcl, vcl,
                                        s.o, n, kv_heads, group, hd, cap, pos, kv_split, neox,
                                        nullptr, nullptr, 0, window, st, &k));
    else
      CF_CHECK(verify_attention<KV_BF16>(s.qkv, cosf, sinf, s.part_ml, s.part_acc, kcl, vcl,
                                         s.o, n, kv_heads, group, hd, cap, pos, kv_split,
                                         neox, nullptr, nullptr, 0, window, st, &k));
    // wo_f[l] is [G * Ko, hidden] row-major: one product sums the groups
    // (int8: each group's partial scaled by its s[G] first)
    CF_CHECK(verify_gemv(wq_kind, s.o, o_n, wol, &mo, l, so, kg_o, s.aout, n, (int)(G * Ko),
                         hidden, 1, 0, hidden, 0, threads, st, s));
    k += 1 + qx;
    // attention-out residual add + FFN RMSNorm
    CF_CHECK(launch_kernel(resnorm_kernel, dim3(n), dim3(NORM_THREADS), 0, st, true,
        s.aout, nullptr, s.res_b, nullptr, fn, s.res_a, nullptr, s.xn, nullptr,
        nullptr, hidden, eps, nullptr, 0, nullptr, 0));
    ++k;
    // gate and up (int8: each column scaled before the SwiGLU); down (int8:
    // scaled after the whole sum over f)
    if (n == 1) {   // one row: f32 gate/up, SwiGLU in the down product's x
      if (w4) {
        const CUtensorMap* m13r = m13.for_rows(1, true);
        const CUtensorMap* m2r = m2.for_rows(1, true);
        if (a8) {
          CF_CHECK((launch_gemv1<false, G1_Y, WK_INT4A8>(
              s.xn, 0, nullptr, s.gu, hidden, f_pad, 2, 0, f_pad, threads, true, st, nullptr,
              nullptr, 0.f, nullptr, m13r, 2 * l, s13, 0)));
          ++k;
          CF_CHECK((launch_gemv1<true, G1_Y, WK_INT4A8>(
              s.gu, f_pad, nullptr, s.hx, f_pad, hidden, 1, 0, 0, threads, true, st, nullptr,
              nullptr, 0.f, nullptr, m2r, l, s2, kg_d)));
        } else {
          CF_CHECK((launch_gemv1<false, G1_Y, WK_INT4>(
              s.xn, 0, nullptr, s.gu, hidden, f_pad, 2, 0, f_pad, threads, true, st, nullptr,
              nullptr, 0.f, nullptr, m13r, 2 * l, s13, 0)));
          ++k;
          CF_CHECK((launch_gemv1<true, G1_Y, WK_INT4>(
              s.gu, f_pad, nullptr, s.hx, f_pad, hidden, 1, 0, 0, threads, true, st, nullptr,
              nullptr, 0.f, nullptr, m2r, l, s2, 0)));
        }
      } else if (w8) {
        CF_CHECK((launch_gemv1<false, G1_Y, true>(s.xn, 0, nullptr, s.gu, hidden, f_pad, 2, 0,
                                                  f_pad, threads, true, st, nullptr, nullptr,
                                                  0.f, nullptr, m13.for_rows(1), 2 * l, s13,
                                                  0)));
        ++k;
        CF_CHECK((launch_gemv1<true, G1_Y, true>(s.gu, f_pad, nullptr, s.hx, f_pad, hidden, 1,
                                                 0, 0, threads, true, st, nullptr, nullptr,
                                                 0.f, nullptr, m2.for_rows(1), l, s2, 0)));
      } else {
        CF_CHECK(launch_gemv1<false>(s.xn, 0, w13l, s.gu, hidden, f_pad, 2,
                                     (long long)hidden * f_pad, f_pad, threads, true, st));
        ++k;
        CF_CHECK(launch_gemv1<true>(s.gu, f_pad, w2l, s.hx, f_pad, hidden, 1, 0, 0, threads,
                                    true, st));
      }
    } else {        // the gate/up product writes act = bf16(silu(gate) * up)
      __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(s.gu);
      if (a8) {
        CF_CHECK(launch_rows_gemv4<true, true>(s.xn, hidden, &m13, 2 * l, s13, 0, nullptr, n,
                                               hidden, f_pad, 2, f_pad, 0, true, st, act,
                                               s.x8, s.xs));
        k += 2;
        CF_CHECK(launch_rows_gemv4<false, true>(act, f_pad, &m2, l, s2, kg_d, s.hx, n, f_pad,
                                                hidden, 1, hidden, 0, true, st, nullptr, s.x8,
                                                s.xs));
        ++k;
      } else if (w4) {
        CF_CHECK(launch_rows_gemv4<true, false>(s.xn, hidden, &m13, 2 * l, s13, 0, nullptr, n,
                                                hidden, f_pad, 2, f_pad, 0, true, st, act));
        ++k;
        CF_CHECK(launch_rows_gemv4<false, false>(act, f_pad, &m2, l, s2, 0, s.hx, n, f_pad,
                                                 hidden, 1, hidden, 0, true, st));
      } else if (w8) {
        CF_CHECK(launch_rows_gemv8<true>(s.xn, hidden, &m13, 2 * l, s13, 0, nullptr, n, hidden,
                                         f_pad, 2, f_pad, 0, true, st, act));
        ++k;
        CF_CHECK(launch_rows_gemv8<false>(act, f_pad, &m2, l, s2, 0, s.hx, n, f_pad, hidden, 1,
                                          hidden, 0, true, st));
      } else {
        CF_CHECK(launch_rows_gemv<true>(s.xn, hidden,
                                        reinterpret_cast<const __nv_bfloat16*>(w13l), nullptr,
                                        n, hidden, f_pad, 2, (long long)hidden * f_pad, f_pad,
                                        0, true, st, act));
        ++k;
        CF_CHECK(launch_rows_gemv<false>(act, f_pad, reinterpret_cast<const __nv_bfloat16*>(w2l),
                                         s.hx, n, f_pad, hidden, 1, 0, hidden, 0, true, st));
      }
    }
    ++k;
  }

  if (lm_head) {
    CF_CHECK(launch_kernel(resnorm_kernel, dim3(n), dim3(NORM_THREADS), 0, st, L > 0,
        s.hx, nullptr, s.res_a, nullptr, static_cast<const __nv_bfloat16*>(final_norm),
        nullptr, nullptr, s.xn, nullptr, static_cast<__nv_bfloat16*>(out_res), hidden,
        eps, nullptr, 0, nullptr, 0));
    ++k;
    // an int8 head: each logit scaled after its sum
    CF_CHECK(verify_gemv(lm_s ? WK_INT8 : WK_BF16, s.xn, hidden, lm_head, &mlm, 0,
                         static_cast<const float*>(lm_s), 0, static_cast<float*>(logits), n,
                         hidden, vocab, 1, 0, vocab, 0, threads, st, s));
    ++k;
  } else {
    CF_CHECK(launch_kernel(resnorm_kernel, dim3(n), dim3(NORM_THREADS), 0, st, L > 0,
        s.hx, nullptr, s.res_a, nullptr, nullptr, nullptr, nullptr, nullptr,
        static_cast<__nv_bfloat16*>(out_x), static_cast<__nv_bfloat16*>(out_res),
        hidden, eps, nullptr, 0, nullptr, 0));
    ++k;
  }
  *n_launches = k;
  return 0;
}
