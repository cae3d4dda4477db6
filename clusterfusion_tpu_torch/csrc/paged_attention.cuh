// Paged flash-decode attention with the in-place append of the current
// token, shared by `cf_paged_attention` (paged_attention.cu) and
// `cf_paged_decoder_layer` (paged_decoder_layer.cu).
//
// One block per (request b, kv head h).  The block walks the request's
// cached rows 0..lens[b]-1 in tiles of PA_TILE rows: it looks up each row's
// page in its own row of the block table (no scalar prefetch on Hopper),
// copies the tile's K and V rows into shared memory with 16-byte loads
// (rows past the end are zero-filled), takes the scores of the g query
// rows of its kv head, updates the online softmax in the exp2 domain, rounds
// p to bf16 against the running max and adds p.V.  After the walk it folds
// in the current token in float32, writes o = bf16(acc / l) and appends the
// current K/V row at (layer, table[b, lens[b] / page], h, lens[b] % page).
// The append comes after every read of the block, and no other block reads
// that row: requests own disjoint pages, each block owns its head, and
// padding rows (lens 0, table row of zeros) all write the NULL page 0,
// which no request reads.  Any page size >= 1 works (page 1 is the sglang
// layout), since every row computes its own address.
//
// FROM_QKV = false (kernel 10): q [B, kv, g, hd] bf16 already scaled by
//   log2(e)/sqrt(hd), k_new/v_new [B, kv, hd] bf16.  The walk and the fold
//   both use these bf16 values.
// FROM_QKV = true (kernel 9): qkv [B, kv, g+2, hd] float32 raw projections;
//   the block ropes q and k at positions[b], scales q, rounds q to bf16 for
//   the walk's dots and keeps q, k and v float32 for the fold; the appended
//   rows are bf16(k), bf16(v).
//
// A request whose lens or position is out of range gets NaN outputs and no
// append, which the serving engine's numeric watchdog reports.

#pragma once

#include "common.cuh"

namespace {

constexpr int PA_THREADS = 128;
constexpr int PA_TILE = 64;        // cache rows per walk step (2 per lane)
constexpr int PA_MAX_GROUP = 16;
constexpr int PA_PAD = 8;          // bf16 pad per shared K/V row: no bank conflicts

struct PagedArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  const float* qkv;
  const float* cos;                // [max_pos, hd] full-dim tables
  const float* sin;
  const int* positions;            // [B]
  __nv_bfloat16* k_pool;           // [L, n_pages, kv, page, hd]
  __nv_bfloat16* v_pool;
  const int* table;                // [B, max_pages]
  const int* lens;                 // [B] cached rows, current token excluded
  __nv_bfloat16* o;                // [B, kv * g * hd]
  int kv, group, page, n_pages, max_pages, layer, max_pos, neox;
};

size_t paged_smem_bytes(int hd, int group) {
  return sizeof(__nv_bfloat16) * 2 * PA_TILE * (hd + PA_PAD) +
         sizeof(float) * ((size_t)2 * group * hd + 2 * hd +
                          (size_t)group * PA_TILE + 4 * (size_t)group);
}

// GMAX: the group rounded up to a power of two (the unrolled row count).
template <int HD, int GMAX, bool FROM_QKV>
__global__ void __launch_bounds__(PA_THREADS) paged_attn_kernel(PagedArgs a) {
  constexpr int LDK = HD + PA_PAD;
  constexpr int CHUNKS = HD / 8;               // 16-byte chunks per row
  constexpr int NW = PA_THREADS / 32;
  constexpr int SETS = PA_THREADS / HD;        // threads per column d
  constexpr int PER = (GMAX + SETS - 1) / SETS;  // query rows per thread, at most
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + PA_TILE * LDK;
  const int g = a.group, kv = a.kv;
  float* qw = reinterpret_cast<float*>(vs + PA_TILE * LDK);  // [g][HD] walk q
  float* qf = qw + g * HD;                                   // [g][HD] fold q
  float* kcur = qf + g * HD;                                 // [HD]
  float* vcur = kcur + HD;                                   // [HD]
  float* sc = vcur + HD;                                     // [g][PA_TILE]
  float* st = sc + g * PA_TILE;                              // [g]: m, l, alpha, s_cur

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int d = tid % HD, set = tid / HD;
  const int n_past = a.lens[b];
  const int pos = FROM_QKV ? a.positions[b] : 0;
  __nv_bfloat16* ob = a.o + ((size_t)b * kv + h) * g * HD;
  if (n_past < 0 || n_past >= a.max_pages * a.page ||
      (FROM_QKV && (pos < 0 || pos >= a.max_pos))) {
    for (int e = tid; e < g * HD; e += PA_THREADS)
      ob[e] = __float2bfloat16(__int_as_float(0x7fc00000));
    return;
  }

  if (FROM_QKV) {
    const float* cr = a.cos + (size_t)pos * HD;
    const float* sr = a.sin + (size_t)pos * HD;
    const float* raw = a.qkv + ((size_t)b * kv + h) * (g + 2) * HD;
    const float scale = LOG2E / sqrtf((float)HD);
    for (int e = tid; e < g * HD; e += PA_THREADS) {
      const float v = rope_at(raw + (e / HD) * HD, e % HD, HD, cr, sr, a.neox) * scale;
      qf[e] = v;
      qw[e] = bf16_round(v);
    }
    for (int e = tid; e < HD; e += PA_THREADS) {
      kcur[e] = rope_at(raw + g * HD, e, HD, cr, sr, a.neox);
      vcur[e] = raw[(g + 1) * HD + e];
    }
  } else {
    const __nv_bfloat16* qs = a.q + ((size_t)b * kv + h) * g * HD;
    for (int e = tid; e < g * HD; e += PA_THREADS) qw[e] = qf[e] = __bfloat162float(qs[e]);
    const size_t row = ((size_t)b * kv + h) * HD;
    for (int e = tid; e < HD; e += PA_THREADS) {
      kcur[e] = __bfloat162float(a.k_new[row + e]);
      vcur[e] = __bfloat162float(a.v_new[row + e]);
    }
  }
  for (int i = tid; i < g; i += PA_THREADS) {
    st[4 * i] = NEG_INF;
    st[4 * i + 1] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = 0.f;
  const int* trow = a.table + (size_t)b * a.max_pages;
  const size_t head0 = (size_t)a.layer * a.n_pages * kv + h;   // (layer, page 0, h)
  // Each thread copies LOADS 16-byte chunks of K and of V per tile.  The
  // loads of tile t+1 are issued into registers before tile t's arithmetic
  // and stored to shared memory after it, so their latency hides behind
  // it.  Rows past the end load a real row (clamped, so every load is
  // unconditional and the compiler keeps them all in flight) and store
  // zeros.
  constexpr int LOADS = PA_TILE * CHUNKS / PA_THREADS;
  uint4 kreg[LOADS], vreg[LOADS];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int e = tid + it * PA_THREADS;
      const int p = min(t0 + e / CHUNKS, n_past - 1);
      const size_t pg = (size_t)trow[p / a.page];
      const size_t off =
          ((head0 + pg * kv) * a.page + p % a.page) * HD + (e % CHUNKS) * 8;
      kreg[it] = __ldg(reinterpret_cast<const uint4*>(a.k_pool + off));
      vreg[it] = __ldg(reinterpret_cast<const uint4*>(a.v_pool + off));
    }
  };
  if (n_past > 0) load_tile(0);
  __syncthreads();

  for (int t0 = 0; t0 < n_past; t0 += PA_TILE) {
    const int n = min(PA_TILE, n_past - t0);
    // 1. the tile's K/V rows -> shared memory, zeros past the end; then the
    //    next tile's loads
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int e = tid + it * PA_THREADS;
      const int r = e / CHUNKS, c = e % CHUNKS;
      *reinterpret_cast<uint4*>(ks + r * LDK + c * 8) = r < n ? kreg[it] : zero;
      *reinterpret_cast<uint4*>(vs + r * LDK + c * 8) = r < n ? vreg[it] : zero;
    }
    __syncthreads();
    if (t0 + PA_TILE < n_past) load_tile(t0 + PA_TILE);
    // 2. scores of the g query rows against the tile's rows
    for (int e = tid; e < g * PA_TILE; e += PA_THREADS) {
      const int i = e / PA_TILE, r = e % PA_TILE;
      float s = NEG_INF;
      if (r < n) {
        const __nv_bfloat16* kr = ks + r * LDK;
        const float* qi = qw + i * HD;
        float s2[2] = {0.f, 0.f};              // two chains: half the latency
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(kr + c * 8), f);
#pragma unroll
          for (int j = 0; j < 8; ++j) s2[c & 1] = fmaf(qi[c * 8 + j], f[j], s2[c & 1]);
        }
        s = s2[0] + s2[1];
      }
      sc[e] = s;
    }
    __syncthreads();
    // 3. online softmax: warp w takes query rows w, w + NW, ...; p is summed
    //    unrounded and kept as bf16(p) for the p.V product (0 past the end)
    for (int i = wid; i < g; i += NW) {
      float* si = sc + i * PA_TILE;
      const float s0 = si[lane], s1 = si[lane + 32];
      const float m_old = st[4 * i];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < n ? exp2f(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? exp2f(s1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      si[lane] = bf16_round(p0);
      si[lane + 32] = bf16_round(p1);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        st[4 * i] = m_new;
        st[4 * i + 1] = st[4 * i + 1] * alpha + sum;
        st[4 * i + 2] = alpha;
      }
    }
    __syncthreads();
    // 4. acc = acc * alpha + bf16(p) . V, thread (d, set) owns rows set + k*SETS;
    //    rows past the end hold p = 0 and V = 0
    float pv[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) pv[k] = 0.f;
#pragma unroll 16
    for (int r = 0; r < PA_TILE; ++r) {
      const float vv = __bfloat162float(vs[r * LDK + d]);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = set + k * SETS;
        if (i < g) pv[k] = fmaf(sc[i * PA_TILE + r], vv, pv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = set + k * SETS;
      if (i < g) acc[k] = acc[k] * st[4 * i + 2] + pv[k];
    }
    __syncthreads();
  }

  // fold the current token: s_cur = q . k_cur, float32
  for (int i = wid; i < g; i += NW) {
    float part = 0.f;
    for (int e = lane; e < HD; e += 32) part = fmaf(qf[i * HD + e], kcur[e], part);
    part = warp_sum(part);
    if (lane == 0) st[4 * i + 3] = part;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = set + k * SETS;
    if (i < g) {
      const float m_old = st[4 * i], l_old = st[4 * i + 1], s = st[4 * i + 3];
      const float m_f = fmaxf(m_old, s);
      const float alpha = exp2f(m_old - m_f), pc = exp2f(s - m_f);
      ob[i * HD + d] = __float2bfloat16((acc[k] * alpha + pc * vcur[d]) /
                                        (l_old * alpha + pc));
    }
  }
  // append the current K/V row
  if (tid < HD) {
    const size_t pg = (size_t)trow[n_past / a.page];
    const size_t off = ((head0 + pg * kv) * a.page + n_past % a.page) * HD + tid;
    a.k_pool[off] = __float2bfloat16(kcur[tid]);
    a.v_pool[off] = __float2bfloat16(vcur[tid]);
  }
}

template <int HD, int GMAX, bool FROM_QKV>
int launch_paged_attn_g(const PagedArgs& a, int B, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    CF_CHECK((int)cudaFuncSetAttribute(paged_attn_kernel<HD, GMAX, FROM_QKV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)paged_smem_bytes(HD, GMAX)));
    attr_set = true;
  }
  paged_attn_kernel<HD, GMAX, FROM_QKV>
      <<<dim3(B, a.kv), PA_THREADS, paged_smem_bytes(HD, a.group), st>>>(a);
  return (int)cudaGetLastError();
}

template <int HD, bool FROM_QKV>
int launch_paged_attn_hd(const PagedArgs& a, int B, cudaStream_t st) {
  if (a.group == 1) return launch_paged_attn_g<HD, 1, FROM_QKV>(a, B, st);
  if (a.group == 2) return launch_paged_attn_g<HD, 2, FROM_QKV>(a, B, st);
  if (a.group <= 4) return launch_paged_attn_g<HD, 4, FROM_QKV>(a, B, st);
  if (a.group <= 8) return launch_paged_attn_g<HD, 8, FROM_QKV>(a, B, st);
  return launch_paged_attn_g<HD, 16, FROM_QKV>(a, B, st);
}

// One launch over all (request, kv head) pairs.  Returns a cudaError_t.
template <bool FROM_QKV>
int launch_paged_attn(const PagedArgs& a, int B, int hd, cudaStream_t st) {
  if (B < 1 || a.kv < 1 || a.group < 1 || a.group > PA_MAX_GROUP || a.page < 1 ||
      a.max_pages < 1 || a.layer < 0)
    return (int)cudaErrorInvalidValue;
  if (hd == 128) return launch_paged_attn_hd<128, FROM_QKV>(a, B, st);
  if (hd == 64) return launch_paged_attn_hd<64, FROM_QKV>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
