// Paged flash-decode attention with the in-place append of the current
// token, shared by `cf_paged_attention` (paged_attention.cu) and
// `cf_paged_decoder_layer` (paged_decoder_layer.cu).  Two kernels on one
// stream:
//
// Split pass: one block per (split s, kv head h, request b), grid
//   (ceil(max_pages * page / split), kv, B).  Split s holds the request's
//   cached rows [s*split, min((s+1)*split, lens[b])); a block whose split
//   starts at or past lens[b] exits at once, so a long request spreads
//   over as many blocks as it has splits and a short one costs one.  One
//   warp bulk-copies all the split's K and V rows into shared memory at
//   once (cp.async.bulk, one copy per run of rows that share a page and a
//   tile, so a (layer, page, head) slab of page*hd bf16 is one copy or
//   two), tile t of PA_TILE rows completing on barrier t: the whole split
//   is in flight from the block's first instructions, and the walk starts
//   on the first tile while the rest land.  Only rows < lens[b] are
//   copied; what the pool holds past them (stale rows, NaN, the row this
//   launch appends) never reaches shared memory, and every loop over rows
//   stops at the split's last real row.  Per tile: scores (four threads a
//   row, the 16-byte pieces taken in an order staggered by row, so a
//   warp's reads hit distinct banks; q read as bf16), an online softmax
//   whose running max restarts at each split (p = exp2(s - running max),
//   summed unrounded, rounded to bf16 for p.V), acc = acc * alpha +
//   bf16(p).V (a thread owns 8 columns over a slice of the rows; the
//   slices meet in shared memory in slice order at the end).  The block
//   writes (max, sum) and acc[g][hd] in float32.
// Merge: one block per (kv head, request), launched with programmatic
//   dependent launch.  It folds the current token's score (float32) and
//   the request's splits in split order 0..n-1, so the bits do not depend
//   on the order in which the split blocks ran; writes o = bf16(acc / l);
//   then appends the current K/V row at (layer, table[b, lens[b] / page],
//   h, lens[b] % page).  The append follows the split pass's grid
//   boundary (griddepcontrol.wait), so it never races a copy of that page.
//   Padding rows (lens 0, table row of zeros) all write the NULL page 0,
//   which no request reads.  Any page size >= 1 works (page 1 is the
//   sglang layout), since every run of rows computes its own address.
//
// Sliding window (Mistral's semantics, a.window > 0; a runtime argument of
//   every instance): the token at lens[b] attends cached rows >= wlo =
//   max(0, lens[b] + 1 - window) and itself.  The split boundaries stay at
//   multiples of `split` from row 0; a split that ends at or below wlo
//   exits at once, and in the first live split the rows below wlo are
//   never copied (its runs start at wlo) and are masked out of the
//   softmax, so what their table slots point at (the NULL page 0 under the
//   serving engine's rolling page buffer, which every padding row's append
//   writes) never reaches shared memory.  The merge folds the live splits
//   wlo / split .. n-1 in order, or none when no cached row is in the
//   window (window 1).  window >= lens[b] + 1 runs window 0's
//   instructions, so it gives window 0's bits.
//
// FROM_QKV = false (kernel 10): q [B, kv, g, hd] bf16, which both kernels
//   scale by qscale = log2(e)/sqrt(hd) and round to bf16 again (as the
//   TPU wrapper does before its kernel); k_new/v_new [B, kv, hd] bf16.
//   The walk and the fold both use these bf16 values.
// FROM_QKV = true (kernel 9): qkv [B, kv, g+2, hd] float32 raw projections,
//   written by the kernel before the split pass; every split block ropes q
//   at positions[b], scales it and rounds it to bf16 for its dots (g*hd
//   values, after griddepcontrol.wait), the merge ropes q and k again and
//   folds q, k and v in float32; the appended rows are bf16(k), bf16(v).
//
// The pool kind KV (common.cuh's KV_BF16 or KV_FP8) is a template parameter
// of both kernels; the pool pointers are pa_row_t<KV>, so the bf16
// instances keep their types.  KV_FP8 (the TPU kernels' e4m3 pools): the
// rows are bytes (an hd-64 row is 64 B, so every bulk copy stays a multiple
// of 16 bytes), each 8-byte piece decoded exactly with e4m3 denormals
// flushed to 0 (unpack8_e4m3, the TPU kernels' _kv_tile); scores and
// bf16(p).V as the bf16 instance computes them.  The current row and its
// append follow the TPU kernels' two rules:
//   kernel 10: the row is e4m3 of the bf16 k_new/v_new (saturating at
//     +-448), folded as stored (denormals kept) and appended as stored;
//   kernel 9: the fold stays float32; the append stores e4m3 of the
//     float32 row where the TPU kernel appends in-kernel (hd % 128 == 0
//     and page % 8 == 0), else e4m3 of its bf16 rounding (the TPU
//     wrapper's scatter of the bf16 k_new, a double rounding).
//
// A request whose lens or position is out of range gets NaN outputs and no
// append, which the serving engine's numeric watchdog reports.

#pragma once

#include "common.cuh"

namespace {

constexpr int PA_THREADS = 128;
constexpr int PA_TILE = 32;        // rows per barrier and per online-softmax step
constexpr int PA_MAX_GROUP = 16;
constexpr int PA_SMEM_MAX = 227 * 1024;

// A pool element of kind KV: bf16, or an e4m3 byte.
template <int KV>
using pa_row_t = std::conditional_t<KV == KV_FP8, uint8_t, __nv_bfloat16>;

template <int KV>
struct PagedArgsT {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  const float* qkv;
  const float* cos;                // [max_pos, hd] full-dim tables
  const float* sin;
  const int* positions;            // [B]
  pa_row_t<KV>* k_pool;            // [L, n_pages, kv, page, hd]
  pa_row_t<KV>* v_pool;
  const int* table;                // [B, max_pages]
  const int* lens;                 // [B] cached rows, current token excluded
  __nv_bfloat16* o;                // [B, kv * g * hd]
  float* part_ml;                  // [B, kv, ns, g, 2] (max, sum) per split
  float* part_acc;                 // [B, kv, ns, g, hd]
  int kv, group, page, n_pages, max_pages, layer, max_pos, neox, split, ns;
  int window;                      // sliding window (0: none)
  float qscale;                    // kernel 10: log2(e)/sqrt(hd), as float
};
using PagedArgs = PagedArgsT<KV_BF16>;

// Splits per request: enough for the longest request the table can hold.
inline int paged_splits(int max_pages, int page, int split) {
  return (int)(((long long)max_pages * page + split - 1) / split);
}

// f32 scratch of the split pass for B requests.
inline size_t paged_partial_floats(int B, int kv, int group, int hd, int ns) {
  return (size_t)B * kv * ns * group * (2 + (size_t)hd);
}

// Bytes of the split pass's row area: the split's K and V rows of `rb`
// bytes an element, and after the last tile the P.V slices' sums.
__host__ __device__ inline size_t paged_rows_bytes(int hd, int group, int split, int rb) {
  const size_t kv_rows = 2 * (size_t)split * hd * rb;
  const size_t sums = sizeof(float) * (PA_THREADS / (hd / 8)) * (size_t)group * hd;
  return kv_rows > sums ? kv_rows : sums;
}

// Shared memory of the split pass: a barrier per tile, the row area, q in
// bf16, a tile's scores and the running (max, sum, alpha) of each query row.
inline size_t paged_split_smem(int hd, int group, int split, int rb) {
  const size_t tiles = (size_t)(split + PA_TILE - 1) / PA_TILE;
  return (tiles * 8 + 15) / 16 * 16 + paged_rows_bytes(hd, group, split, rb) +
         (size_t)group * hd * 2 + sizeof(float) * ((size_t)group * PA_TILE + 4 * group);
}

template <int KV>
__device__ __forceinline__ bool paged_bad(const PagedArgsT<KV>& a, int n_past, int pos,
                                          bool from_qkv) {
  return n_past < 0 || n_past >= a.max_pages * a.page ||
         (from_qkv && (pos < 0 || pos >= a.max_pos));
}

// The first cached row of request b in the window: max(0, lens + 1 -
// window), or lens itself when no cached row is in it (window 1).
template <int KV>
__device__ __forceinline__ int paged_first_live(const PagedArgsT<KV>& a, int n_past) {
  return a.window > 0 ? min(n_past, max(0, n_past + 1 - a.window)) : 0;
}

// Eight pool elements at p (16 bytes of bf16, 8 of e4m3) -> eight floats.
template <int KV>
__device__ __forceinline__ void pa_unpack8(const pa_row_t<KV>* p, float* f) {
  if constexpr (KV == KV_FP8)
    unpack8_e4m3(*reinterpret_cast<const uint2*>(p), f);
  else
    unpack8(*reinterpret_cast<const uint4*>(p), f);
}

// One e4m3 code -> its float, exactly, denormals kept (a plain convert;
// 0x7f/0xff are e4m3fn's NaN).
__device__ __forceinline__ float e4m3_to_float(uint8_t c) {
  const uint32_t mag = c & 0x7fu;
  const float v = mag == 0x7fu ? __int_as_float(0x7fc00000)
                  : mag < 8   ? (float)mag * (1.0f / 512.0f)
                              : __uint_as_float((mag << 20) + 0x3C000000u);
  return (c & 0x80u) ? -v : v;
}

__device__ __forceinline__ uint8_t float_to_e4m3(float x) {
  return (uint8_t)__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

// GMAX: the group rounded up to a power of two (the unrolled row count).
template <int HD, int GMAX, bool FROM_QKV, int KV>
__global__ void __launch_bounds__(PA_THREADS) paged_split_kernel(PagedArgsT<KV> a) {
  using row_t = pa_row_t<KV>;
  constexpr int RB = (int)sizeof(row_t);       // bytes a pool element
  constexpr int CHUNKS = HD / 8;               // 16-byte pieces per row
  constexpr int NW = PA_THREADS / 32;
  constexpr int TPR = PA_THREADS / PA_TILE;    // threads per row in the scores
  constexpr int CPT = CHUNKS / TPR;            // pieces per thread
  constexpr int NCG = HD / 8;                  // P.V: 8-column groups
  constexpr int SL = PA_THREADS / NCG;         // P.V: row slices
  static_assert(PA_TILE == 32 && CHUNKS % TPR == 0, "tile layout");
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = a.group, kv = a.kv, S = a.split;
  const int tiles = (S + PA_TILE - 1) / PA_TILE;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);                    // [tiles]
  unsigned char* rows = smem + (tiles * 8 + 15) / 16 * 16;
  row_t* ks = reinterpret_cast<row_t*>(rows);                           // [S][HD]
  row_t* vs = ks + (size_t)S * HD;                                       // [S][HD]
  float* red = reinterpret_cast<float*>(rows);     // [SL][g][HD] once the rows are read
  __nv_bfloat16* qw =
      reinterpret_cast<__nv_bfloat16*>(rows + paged_rows_bytes(HD, g, S, RB));  // [g][HD]
  float* sc = reinterpret_cast<float*>(qw + g * HD);                     // [g][PA_TILE]
  float* st = sc + g * PA_TILE;                                          // [g][4]

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int n_past = a.lens[b];
  const int pos = FROM_QKV ? a.positions[b] : 0;
  const int j0 = s * S;
  if (paged_bad(a, n_past, pos, FROM_QKV)) return;
  // the split's first live row (j0 unless the window's bound lies in it)
  const int jl = max(j0, paged_first_live(a, n_past));
  if (jl >= n_past || jl >= j0 + S) return;     // past the end, or below the window
  const int n = min(S, n_past - j0);
  const int r0 = jl - j0;                        // rows [0, r0) of the split are masked
  const int t0 = r0 / PA_TILE, nt = (n + PA_TILE - 1) / PA_TILE;
  const int* trow = a.table + (size_t)b * a.max_pages;
  const size_t head0 = (size_t)a.layer * a.n_pages * kv + h;   // (layer, page 0, h)

  if (tid == 0) {
    for (int t = t0; t < nt; ++t) hopper::mbar_init(&bar[t], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // Warp 0: rows [jl, j0 + n) of K and of V, one copy per run of rows on
  // one page and in one tile; tile t's K and V bytes complete on bar[t].
  // The pool rows < lens[b] were written before this launch (earlier
  // steps, or a kernel the stream has finished).
  if (wid == 0) {
    for (int t = t0 + lane; t < nt; t += 32)
      hopper::mbar_arrive_expect_tx(
          &bar[t], (uint32_t)(min(n, (t + 1) * PA_TILE) - max(r0, t * PA_TILE)) * HD * 2 * RB);
    __syncwarp();
    for (int j = jl + lane; j < j0 + n; j += 32) {
      if (j != jl && j % a.page != 0 && (j - j0) % PA_TILE != 0) continue;  // not a run's first row
      const int end = min(min(j0 + n, (j / a.page + 1) * a.page),
                          j0 + ((j - j0) / PA_TILE + 1) * PA_TILE);
      const size_t off = ((head0 + (size_t)trow[j / a.page] * kv) * a.page + j % a.page) * HD;
      const uint32_t bytes = (uint32_t)(end - j) * HD * RB;
      uint64_t* tb = &bar[(j - j0) / PA_TILE];
      hopper::bulk_load_1d(ks + (size_t)(j - j0) * HD, a.k_pool + off, bytes, tb);
      hopper::bulk_load_1d(vs + (size_t)(j - j0) * HD, a.v_pool + off, bytes, tb);
    }
  }
  hopper::grid_dep_launch_dependents();

  if (FROM_QKV) {
    hopper::grid_dep_wait();                    // qkv comes from the kernel before
    const float* cr = a.cos + (size_t)pos * HD;
    const float* sr = a.sin + (size_t)pos * HD;
    const float* raw = a.qkv + ((size_t)b * kv + h) * (g + 2) * HD;
    const float scale = LOG2E / sqrtf((float)HD);
    for (int e = tid; e < g * HD; e += PA_THREADS)
      qw[e] = __float2bfloat16(rope_at(raw + (e / HD) * HD, e % HD, HD, cr, sr, a.neox) * scale);
  } else {
    const __nv_bfloat16* qs = a.q + ((size_t)b * kv + h) * g * HD;
    for (int e = tid; e < g * HD; e += PA_THREADS)
      qw[e] = __float2bfloat16(__bfloat162float(qs[e]) * a.qscale);
  }
  for (int i = tid; i < g; i += PA_THREADS) {
    st[4 * i] = NEG_INF;
    st[4 * i + 1] = 0.f;
  }
  __syncthreads();

  // thread (row r, part) of the scores; thread (column group cg, slice sl)
  // of P.V, which owns columns cg*8.. of every query row over the tile's
  // rows sl, sl + SL, ...
  const int r = tid / TPR, part = tid % TPR;
  const int cg = tid % NCG, sl = tid / NCG;
  float acc[GMAX][8];
#pragma unroll
  for (int i = 0; i < GMAX; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  for (int t = t0; t < nt; ++t) {
    const int rows_t = min(PA_TILE, n - t * PA_TILE);
    const int lo_t = t == t0 ? r0 - t * PA_TILE : 0;   // rows below it masked
    hopper::mbar_wait(&bar[t], 0);
    // 1. scores of the g query rows against the tile's rows: TPR threads a
    //    row, each over CPT pieces taken in an order staggered by row
    {
      const row_t* kr = ks + (size_t)(t * PA_TILE + r) * HD + part * CPT * 8;
      const __nv_bfloat16* qp = qw + part * CPT * 8;
      float sa[GMAX];
#pragma unroll
      for (int i = 0; i < GMAX; ++i) sa[i] = 0.f;
      if (r >= lo_t && r < rows_t) {
#pragma unroll
        for (int c0 = 0; c0 < CPT; ++c0) {
          const int c = (c0 + r) % CPT;
          float f[8];
          pa_unpack8<KV>(kr + c * 8, f);
#pragma unroll
          for (int i = 0; i < GMAX; ++i) {
            if (i < g) {
              float qf[8];
              unpack8(*reinterpret_cast<const uint4*>(qp + i * HD + c * 8), qf);
#pragma unroll
              for (int e = 0; e < 8; ++e) sa[i] = fmaf(qf[e], f[e], sa[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < GMAX; ++i) {
        if (i < g) {
#pragma unroll
          for (int off = 1; off < TPR; off <<= 1) sa[i] += __shfl_xor_sync(0xffffffffu, sa[i], off);
          if (part == 0) sc[i * PA_TILE + r] = sa[i];
        }
      }
    }
    __syncthreads();
    // 2. online softmax within the split: lane j takes the tile's row j; p
    //    against the running max, summed unrounded, kept as bf16(p) (0 past
    //    the end and below the window, by select)
    for (int i = wid; i < g; i += NW) {
      const bool live = lane >= lo_t && lane < rows_t;
      const float sj = live ? sc[i * PA_TILE + lane] : NEG_INF;
      const float m_old = st[4 * i];
      const float m_new = fmaxf(m_old, warp_max(sj));
      const float p = live ? exp2f(sj - m_new) : 0.f;
      const float sum = warp_sum(p);
      sc[i * PA_TILE + lane] = bf16_round(p);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        st[4 * i] = m_new;
        st[4 * i + 1] = st[4 * i + 1] * alpha + sum;
        st[4 * i + 2] = alpha;
      }
    }
    __syncthreads();
    // 3. acc = acc * alpha + bf16(p) . V over this thread's rows of the tile
#pragma unroll
    for (int i = 0; i < GMAX; ++i) {
      if (i < g) {
        const float al = st[4 * i + 2];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= al;
      }
    }
    // (the rows below the window were never copied: skipped, not weighted)
    for (int rr = sl + (lo_t > sl ? (lo_t - sl + SL - 1) / SL * SL : 0); rr < rows_t;
         rr += SL) {
      float v[8];
      pa_unpack8<KV>(vs + (size_t)(t * PA_TILE + rr) * HD + cg * 8, v);
#pragma unroll
      for (int i = 0; i < GMAX; ++i) {
        if (i < g) {
          const float p = sc[i * PA_TILE + rr];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(p, v[c], acc[i][c]);
        }
      }
    }
    __syncthreads();                   // sc is read before the next tile's scores
  }

  // the slices' sums meet in shared memory (the rows are all read), in
  // slice order
#pragma unroll
  for (int i = 0; i < GMAX; ++i) {
    if (i < g) {
#pragma unroll
      for (int c = 0; c < 8; ++c) red[((size_t)sl * g + i) * HD + cg * 8 + c] = acc[i][c];
    }
  }
  __syncthreads();
  const size_t part0 = (((size_t)b * kv + h) * a.ns + s) * g;     // this split's rows
  for (int e = tid; e < g * HD; e += PA_THREADS) {
    float v = 0.f;
    for (int q = 0; q < SL; ++q) v += red[(size_t)q * g * HD + e];
    a.part_acc[part0 * HD + e] = v;
  }
  for (int i = tid; i < g; i += PA_THREADS) {
    a.part_ml[(part0 + i) * 2] = st[4 * i];
    a.part_ml[(part0 + i) * 2 + 1] = st[4 * i + 1];
  }
}

// Merge of kv head h = blockIdx.x of request b = blockIdx.y: the current
// token first, then the live splits s_lo..nsb-1 in order, in float32; o,
// then the append.  Warp w takes query rows w, w + 4, ...: the splits'
// maxima and sums (lanes over splits, summed in a fixed butterfly), each
// split's weight into shared memory; then every (row, column) sums its
// splits.
template <int HD, bool FROM_QKV, int KV>
__global__ void __launch_bounds__(PA_THREADS) paged_merge_kernel(PagedArgsT<KV> a) {
  constexpr int NW = PA_THREADS / 32;
  hopper::grid_dep_launch_dependents();
  hopper::grid_dep_wait();                      // the split pass has completed
  extern __shared__ float msm[];
  const int g = a.group, kv = a.kv;
  float* qf = msm;                               // [g][HD] fold q
  float* kcur = qf + g * HD;                     // [HD]
  float* vcur = kcur + HD;                       // [HD]
  float* st = vcur + HD;                         // [g][4]: s_cur, max, sum, p_cur
  float* w = st + 4 * g;                         // [g][ns] split weights
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int n_past = a.lens[b];
  const int pos = FROM_QKV ? a.positions[b] : 0;
  __nv_bfloat16* ob = a.o + ((size_t)b * kv + h) * g * HD;
  if (paged_bad(a, n_past, pos, FROM_QKV)) {
    for (int e = tid; e < g * HD; e += PA_THREADS)
      ob[e] = __float2bfloat16(__int_as_float(0x7fc00000));
    return;
  }
  if (FROM_QKV) {
    const float* cr = a.cos + (size_t)pos * HD;
    const float* sr = a.sin + (size_t)pos * HD;
    const float* raw = a.qkv + ((size_t)b * kv + h) * (g + 2) * HD;
    const float scale = LOG2E / sqrtf((float)HD);
    for (int e = tid; e < g * HD; e += PA_THREADS)
      qf[e] = rope_at(raw + (e / HD) * HD, e % HD, HD, cr, sr, a.neox) * scale;
    for (int e = tid; e < HD; e += PA_THREADS) {
      kcur[e] = rope_at(raw + g * HD, e, HD, cr, sr, a.neox);
      vcur[e] = raw[(g + 1) * HD + e];
    }
  } else {
    const __nv_bfloat16* qs = a.q + ((size_t)b * kv + h) * g * HD;
    for (int e = tid; e < g * HD; e += PA_THREADS)
      qf[e] = bf16_round(__bfloat162float(qs[e]) * a.qscale);
    const size_t row = ((size_t)b * kv + h) * HD;
    for (int e = tid; e < HD; e += PA_THREADS) {
      if constexpr (KV == KV_FP8) {     // the row as stored: e4m3 of the bf16 row
        kcur[e] = e4m3_to_float(float_to_e4m3(__bfloat162float(a.k_new[row + e])));
        vcur[e] = e4m3_to_float(float_to_e4m3(__bfloat162float(a.v_new[row + e])));
      } else {
        kcur[e] = __bfloat162float(a.k_new[row + e]);
        vcur[e] = __bfloat162float(a.v_new[row + e]);
      }
    }
  }
  __syncthreads();
  const int nsb = (n_past + a.split - 1) / a.split;
  const int first = paged_first_live(a, n_past);
  const int s_lo = first < n_past ? first / a.split : nsb;   // the first live split
  const size_t part0 = ((size_t)b * kv + h) * a.ns * g;
  for (int i = wid; i < g; i += NW) {
    float dot = 0.f;
    for (int e = lane; e < HD; e += 32) dot = fmaf(qf[i * HD + e], kcur[e], dot);
    const float s_cur = warp_sum(dot);
    float mx = s_cur;
    for (int s = s_lo + lane; s < nsb; s += 32)
      mx = fmaxf(mx, a.part_ml[(part0 + (size_t)s * g + i) * 2]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = s_lo + lane; s < nsb; s += 32) {
      const size_t idx = part0 + (size_t)s * g + i;
      const float ws = exp2f(a.part_ml[idx * 2] - mx);
      w[i * a.ns + s] = ws;
      l = fmaf(a.part_ml[idx * 2 + 1], ws, l);
    }
    l = warp_sum(l);
    if (lane == 0) {
      const float pc = exp2f(s_cur - mx);
      st[4 * i + 2] = l + pc;
      st[4 * i + 3] = pc;
    }
  }
  __syncthreads();
  for (int e = tid; e < g * HD; e += PA_THREADS) {
    const int i = e / HD, d = e % HD;
    float acc = st[4 * i + 3] * vcur[d];
    const float* pa = a.part_acc + part0 * HD + (size_t)i * HD + d;
#pragma unroll 8
    for (int s = s_lo; s < nsb; ++s) acc = fmaf(pa[(size_t)s * g * HD], w[i * a.ns + s], acc);
    ob[e] = __float2bfloat16(acc / st[4 * i + 2]);
  }
  // append the current K/V row
  if (tid < HD) {
    const size_t head0 = (size_t)a.layer * a.n_pages * kv + h;
    const size_t pg = (size_t)a.table[(size_t)b * a.max_pages + n_past / a.page];
    const size_t off = ((head0 + pg * kv) * a.page + n_past % a.page) * HD + tid;
    if constexpr (KV == KV_FP8) {
      // kernel 10: kcur holds e4m3 values, stored back unchanged; kernel 9:
      // e4m3 of the float32 row, or of its bf16 rounding (the module's note)
      const bool f32_row = !FROM_QKV || (HD % 128 == 0 && a.page % 8 == 0);
      const float k = kcur[tid], v = vcur[tid];
      a.k_pool[off] = float_to_e4m3(f32_row ? k : bf16_round(k));
      a.v_pool[off] = float_to_e4m3(f32_row ? v : bf16_round(v));
    } else {
      a.k_pool[off] = __float2bfloat16(kcur[tid]);
      a.v_pool[off] = __float2bfloat16(vcur[tid]);
    }
  }
}

// Let `kernel` take up to PA_SMEM_MAX bytes of dynamic shared memory: a
// function attribute, set once per kernel (a per-launcher record would
// let one launcher lower what another set).  Returns a cudaError_t.
template <auto Kernel>
int paged_allow_smem() {
  static const int err = (int)cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PA_SMEM_MAX);
  return err;
}

template <int HD, int GMAX, bool FROM_QKV, int KV>
int launch_paged_attn_g(const PagedArgsT<KV>& a, int B, bool pdl, cudaStream_t st) {
  auto split = paged_split_kernel<HD, GMAX, FROM_QKV, KV>;
  auto merge = paged_merge_kernel<HD, FROM_QKV, KV>;
  const size_t smem = paged_split_smem(HD, a.group, a.split, (int)sizeof(pa_row_t<KV>));
  const size_t merge_smem =
      sizeof(float) * ((size_t)a.group * HD + 2 * HD + 4 * a.group + (size_t)a.group * a.ns);
  if (smem > (size_t)PA_SMEM_MAX || merge_smem > (size_t)PA_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  CF_CHECK((paged_allow_smem<paged_split_kernel<HD, GMAX, FROM_QKV, KV>>()));
  CF_CHECK((paged_allow_smem<paged_merge_kernel<HD, FROM_QKV, KV>>()));
  CF_CHECK(launch_kernel(split, dim3(a.ns, a.kv, B), dim3(PA_THREADS), smem, st, pdl, a));
  return launch_kernel(merge, dim3(a.kv, B), dim3(PA_THREADS), merge_smem, st, true, a);
}

template <int HD, bool FROM_QKV, int KV>
int launch_paged_attn_hd(const PagedArgsT<KV>& a, int B, bool pdl, cudaStream_t st) {
  if (a.group == 1) return launch_paged_attn_g<HD, 1, FROM_QKV>(a, B, pdl, st);
  if (a.group == 2) return launch_paged_attn_g<HD, 2, FROM_QKV>(a, B, pdl, st);
  if (a.group <= 4) return launch_paged_attn_g<HD, 4, FROM_QKV>(a, B, pdl, st);
  if (a.group <= 8) return launch_paged_attn_g<HD, 8, FROM_QKV>(a, B, pdl, st);
  return launch_paged_attn_g<HD, 16, FROM_QKV>(a, B, pdl, st);
}

// The split pass and the merge over all (request, kv head) pairs: two
// launches, the split pass with programmatic dependent launch when `pdl`
// (its q comes from the kernel before it), the merge always.  a.ns and
// the scratch must hold paged_splits(max_pages, page, split) splits.
// Returns a cudaError_t.
template <bool FROM_QKV, int KV>
int launch_paged_attn(const PagedArgsT<KV>& a, int B, int hd, bool pdl, cudaStream_t st) {
  if (B < 1 || a.kv < 1 || a.group < 1 || a.group > PA_MAX_GROUP || a.page < 1 ||
      a.max_pages < 1 || a.layer < 0 || a.split < 1 || a.window < 0 ||
      a.ns != paged_splits(a.max_pages, a.page, a.split))
    return (int)cudaErrorInvalidValue;
  if (hd == 128) return launch_paged_attn_hd<128, FROM_QKV>(a, B, pdl, st);
  if (hd == 64) return launch_paged_attn_hd<64, FROM_QKV>(a, B, pdl, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
