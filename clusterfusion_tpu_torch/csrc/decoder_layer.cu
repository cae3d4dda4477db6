// The attention half of one bs=1 Llama decoder layer for Hopper (sm_90a),
// one launch: residual add, RMSNorm, the QKV projection, RoPE, flash-decode
// over the cached rows with the current token folded in, and the
// O-projection.
//
// Replaces the TPU kernel `_fused_decoder_layer`
// (clusterfusion_tpu/ops/decoder_layer.py, `_decoder_layer_kernel`) for
// bf16 weights, a bf16 KV cache, no window, no bias and no softcap, with
// one layer's slices of its layouts:
//   wqkv [G, hidden, hg*(g+2)*hd]   columns per kv head [q_0..q_{g-1}|k|v]
//   wo   [G, hg*g*hd, hidden]       caches [kv_heads, cap, hd]
// (the wrapper passes pointers into the [L, ...] stacks; nothing is
// copied).  Its modes, as the TPU kernel's:
//   residual    h = x + residual, res_out = bf16(h); or (nullptr) h = x
//   append      write the bf16 k/v rows at row `seq` of the cache
//   fold        fold the current token into the softmax state or not
//   partials    (acc_out given) no O-projection: write the unnormalised
//               acc [kv*g, hd] and ml [2, kv*g] (log2-domain max and sum,
//               the empty state m = -1e30, l = 0, acc = 0) for a merge
//               across sequence shards
//
// What bounds it: one token reads the layer's wqkv and wo once (134 MB at
// Llama-2-7B) plus the K/V rows < seq and does two operations per weight
// byte, far under the card's ~295 operations per byte, so bytes bound it.
// The TPU kernel walks a sequential (head group, 1 + KV chunk) grid and
// carries the (m, l, acc) state in VMEM.  Here, as in ClusterFusion's own
// layer, one thread-block cluster of C blocks (ranks) owns one kv head,
// and the whole layer is one launch.  C is the largest, up to SMs / kv
// heads and 16, for which the card holds every cluster at once: at 7B's 32
// kv heads an H100 holds 30 clusters of 4 one-block-per-SM blocks (its
// GPCs), so C = 3, 96 blocks (PERF.md).  Each block streams its share of
// the head's bytes through one ring of shared-memory stages (common.cuh,
// "one-launch layer halves"), in this order, the copies running ahead of
// the arithmetic across every phase:
//   1. norm       every block: h = x (+ residual) in f32, the mean of h^2
//                 over the row, xn = bf16(h * rsqrt(. + eps) * w); block 0
//                 writes res_out = bf16(h)
//   2. QKV        rank r: its slice [r*cw, (r+1)*cw) of the head's (g+2)*hd
//                 columns over every wqkv row (one TMA box a stage), so the
//                 ranks of a cluster, and the heads of a group, read each
//                 weight row at about the same time; every rank gathers the
//                 others' f32 slices over distributed shared memory (no sum
//                 crosses ranks), so all hold the same bits of q, k and v
//   3. rope       q roped, pre-scaled by 1/sqrt(hd)*log2(e), bf16 for the
//                 dots; rank 0 writes k_new/v_new and (append) row `seq`
//   4. split-KV   split s (kv_split rows < seq) is rank s % C's; a rank
//                 walks its splits in chunks (up to 32 KB of scores): the
//                 chunk's K rows (one bulk copy per tile; only rows < seq
//                 are copied, so row `seq` and whatever lies above it are
//                 never read), each split's max m_s and sum l_s of
//                 exp2(s - m_s) (the splits on the warps side by side), p
//                 rounded to bf16 against its own split's max, then the V
//                 rows weighted by bf16(p) * exp2(m_s - m) for the rank's
//                 running max m; the ranks' states and the current token
//                 merge in rank order (every rank computes the same merge)
//   5. partials   rank 0 writes acc, m, l; the launch ends
//   6. O-proj     o = bf16(acc / l); rank r: wo's g*hd rows of this head for
//                 its columns [r*oc, (r+1)*oc) (one TMA box a stage), a
//                 float32 row of a [kv_heads, hidden] scratch
//   7. fold       per rank's columns, the kv heads' rows are summed in
//                 head order, in two levels of tickets, and out = bf16(sum)
//                 is written (common.cuh's ordered_fold: tickets, never a
//                 sum by atomics)
// A producer warp issues the copies; the other eight warps compute.
// Every sum runs in a fixed order, so a call repeats its bits exactly.

#include <string.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

// Ring stages: 4 measured faster than 5 and 6 at the 7B cell on the H100
// (fewer copies in flight, less wait on the latency-bound phases; PERF.md).
constexpr int DL_STAGES = 4;
// Rows (kv heads) per first-level group of the fold: 4 measured faster than
// 8, 16 and 32 (one level) at 7B's 32 heads (PERF.md).
constexpr int DL_FOLD_GROUP = 4;

// Geometry of one call, the same on the host and in every block.
struct DlGeom {
  int hidden, kv, hg, g, hd, cap, seq, split, fold, neox, append, partials;
  int C;     // blocks per cluster (ranks)
  int ns;    // splits of the rows < seq
  int cw;    // qkv columns per rank (a multiple of 8)
  int pw;    // columns of a QKV box's inner dimension (divides cw and (g+2)*hd)
  int rq;    // wqkv rows per tile
  int oc;    // wo columns per rank (a multiple of 8)
  int ro;    // wo rows per tile
  int bw;    // columns of a wo box's inner dimension (divides oc and hidden)
  int tr;    // cache rows per K or V tile
  int kch;   // splits per chunk of the split-KV walk
  int nst;   // ring stages
  float eps;
};

// Shared-memory offsets (bytes) of one block.
struct DlSmem {
  int xs, qkvp, qkv, qs, qb, kr, cs, small, A, o, sc, pst, red, ring, total;
};

__host__ __device__ inline DlSmem dl_smem(const DlGeom& G) {
  const int ghd = G.g * G.hd, cq = ghd + 2 * G.hd;
  const int red = OL_WARPS * ghd > OL_RED_FLOATS ? OL_WARPS * ghd : OL_RED_FLOATS;
  DlSmem s;
  int off = OL_HEAD;
  s.xs = ol_take(off, 4 * G.hidden);          // xn, f32
  s.qkvp = ol_take(off, 4 * G.cw);            // this rank's QKV columns
  s.qkv = ol_take(off, 4 * cq);               // the ranks' columns gathered
  s.qs = ol_take(off, 4 * ghd);               // q roped and scaled, f32
  s.qb = ol_take(off, 2 * ghd);               // the same in bf16
  s.kr = ol_take(off, 4 * G.hd);              // k roped
  s.cs = ol_take(off, 4 * 2 * G.hd);          // the token's cos | sin
  s.small = ol_take(off, 4 * 4 * ATT_MAX_GROUP);  // s_cur, M, L, the rescale
  s.A = ol_take(off, 4 * ghd);                // this rank's state acc
  s.o = ol_take(off, 4 * ghd);                // bf16(acc / l) as f32
  s.sc = ol_take(off, 4 * G.g * G.kch * G.split);   // a chunk's scores, then p
  s.pst = ol_take(off, 4 * 2 * G.g * G.kch);  // per (split, row): max, sum
  s.red = ol_take(off, 4 * red);
  s.ring = (off + 1023) / 1024 * 1024;
  s.total = s.ring + G.nst * OL_STAGE;
  return s;
}

// GT: the group's bound (1, 2, 4 or 8; g <= GT), so that the loops over a
// group's query rows hold no more code than the call runs; HDT: the head
// dim when it is 128 (0: G.hd).  With both known (7B's g 1, hd 128) the
// index arithmetic folds into shifts and the launch's code, fetched cold on
// every call of a decode step, is the shorter.
template <int GT, int HDT>
__global__ void __launch_bounds__(OL_BLOCK, 1)
decoder_layer_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap omap, DlGeom G,
                     const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ res,
                     const __nv_bfloat16* __restrict__ rms_w, const float* __restrict__ cos,
                     const float* __restrict__ sin, __nv_bfloat16* kc,
                     __nv_bfloat16* vc, __nv_bfloat16* __restrict__ out,
                     __nv_bfloat16* __restrict__ res_out, __nv_bfloat16* __restrict__ k_new,
                     __nv_bfloat16* __restrict__ v_new, float* __restrict__ acc_out,
                     float* __restrict__ ml_out, float* part, unsigned* ctr,
                     unsigned long long* stamps) {
  extern __shared__ __align__(1024) unsigned char dl_sm[];
  const DlSmem S = dl_smem(G);
  uint64_t* full = reinterpret_cast<uint64_t*>(dl_sm);   // [nst] bytes landed
  uint64_t* empty = full + OL_MAX_STAGES;                // [nst] consumers done
  int* flag = reinterpret_cast<int*>(dl_sm + 16 * OL_MAX_STAGES);
  unsigned char* ring = dl_sm + S.ring;
  float* xs = reinterpret_cast<float*>(dl_sm + S.xs);
  float* qkvp = reinterpret_cast<float*>(dl_sm + S.qkvp);
  float* qkv = reinterpret_cast<float*>(dl_sm + S.qkv);
  float* qs = reinterpret_cast<float*>(dl_sm + S.qs);
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(dl_sm + S.qb);
  float* kr = reinterpret_cast<float*>(dl_sm + S.kr);
  float* cs = reinterpret_cast<float*>(dl_sm + S.cs);     // cos [hd], sin [hd]
  float* scur = reinterpret_cast<float*>(dl_sm + S.small);
  float* M = scur + ATT_MAX_GROUP;
  float* Lsum = M + ATT_MAX_GROUP;
  float* ab = Lsum + ATT_MAX_GROUP;              // [g] the state's rescale
  float* A = reinterpret_cast<float*>(dl_sm + S.A);
  float* o = reinterpret_cast<float*>(dl_sm + S.o);
  float* sc = reinterpret_cast<float*>(dl_sm + S.sc);
  float* pm = reinterpret_cast<float*>(dl_sm + S.pst);   // [kch][g] split maxima
  float* pl = pm + G.kch * G.g;                          // split sums
  float* red = reinterpret_cast<float*>(dl_sm + S.red);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = G.C;
  const int h = blockIdx.y / C;                   // this cluster's kv head
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int g = GT == 1 ? 1 : G.g, hd = HDT ? HDT : G.hd, ghd = g * hd, cq = ghd + 2 * hd;
  const int q0 = rank * G.cw, cql = max(0, min(G.cw, cq - q0));
  const int c0 = rank * G.oc, ocl = max(0, min(G.oc, G.hidden - c0));

  // the tile sequence: QKV rows, then per chunk of this rank's splits
  // (rank, rank + C, ...; only the globally last split can be short) the K
  // tiles, then the V tiles; then wo rows
  const int nq = cql > 0 ? (G.hidden + G.rq - 1) / G.rq : 0;
  const int nmine = G.ns > rank ? (G.ns - 1 - rank) / C + 1 : 0;
  const int ntf = (G.split + G.tr - 1) / G.tr;   // K (or V) tiles of a full split
  int nkv = 0;
  if (nmine > 0) {
    const int nl = min(G.split, G.seq - (rank + (nmine - 1) * C) * G.split);
    nkv = 2 * (ntf * (nmine - 1) + (nl + G.tr - 1) / G.tr);
  }
  const int no = (G.partials || ocl == 0) ? 0 : (ghd + G.ro - 1) / G.ro;
  const int total = nq + nkv + no;
  const int grp = h / G.hg, hin = h % G.hg;
  const __nv_bfloat16* kh = kc + (size_t)h * G.cap * hd;
  const __nv_bfloat16* vh = vc + (size_t)h * G.cap * hd;

  // the producer (lane 0): tile u into stage u % nst.  A QKV box is [rq rows]
  // [cw/pw][pw] of the map over the layer's wqkv as [G*hidden][hg*(g+2)*hd
  // /pw][pw]; a wo box [ro rows][oc/bw][bw] of the map over wo as
  // [kv*g*hd][hidden/bw][bw]; what lies past the tensor arrives as zeros
  auto issue = [&](int u) {
    const int s = u % G.nst;
    unsigned char* dst = ring + s * OL_STAGE;
    if (lane != 0) return;
    if (u < nq) {
      hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)G.rq * G.cw * 2);
      hopper::tma_load_3d(dst, &qmap, &full[s], 0, (hin * cq + q0) / G.pw,
                          grp * G.hidden + u * G.rq);
    } else if (u < nq + nkv) {
      int v = u - nq;
      const int c = v / (2 * G.kch * ntf), j0 = c * G.kch;
      v -= c * 2 * G.kch * ntf;
      const int nsc = min(G.kch, nmine - j0);
      const int nl = min(G.split, G.seq - (rank + (j0 + nsc - 1) * C) * G.split);
      const int ntk = ntf * (nsc - 1) + (nl + G.tr - 1) / G.tr;   // K tiles of the chunk
      const bool is_v = v >= ntk;
      if (is_v) v -= ntk;
      const int r0 = (rank + (j0 + v / ntf) * C) * G.split, t = v % ntf;
      const int n = min(G.split, G.seq - r0);
      const uint32_t bytes = (uint32_t)min(G.tr, n - t * G.tr) * hd * 2;
      hopper::mbar_arrive_expect_tx(&full[s], bytes);
      hopper::bulk_load_1d(dst, (is_v ? vh : kh) + (size_t)(r0 + t * G.tr) * hd, bytes,
                           &full[s]);
    } else {
      const int t = u - nq - nkv;
      hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)G.ro * G.oc * 2);
      hopper::tma_load_3d(dst, &omap, &full[s], 0, c0 / G.bw,
                          (grp * G.hg + hin) * ghd + t * G.ro);
    }
  };
  int u = 0;                                      // the next tile to read
  auto wait = [&]() {
    hopper::mbar_wait(&full[u % G.nst], (u / G.nst) & 1);
    return (const unsigned char*)(ring + (u % G.nst) * OL_STAGE);
  };
  auto release = [&]() {                          // this warp has read tile u
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[u % G.nst]);
    ++u;
  };

  ol_stamp(stamps, 0);
  OlRow row;                                      // the norm's (and rope's) loads first
  if (wid < OL_WARPS) ol_norm_load(row, x, res, rms_w, G.hidden);
  const float cs_v = tid < 2 * hd ? (tid < hd ? cos[tid] : sin[tid - hd]) : 0.f;
  if (tid == 0) {
    for (int s = 0; s < G.nst; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], OL_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (wid == OL_WARPS) {                          // the producer: QKV tiles before the
    ol_produce(total, G.nst, empty, 3,            // first cluster barrier, K/V tiles
               [&](int v) { return v < nq ? 0 : (v < nq + nkv ? 1 : 2); },   // before the
               issue);                            // second, wo tiles after it
    return;
  }

  if (tid < 2 * hd) cs[tid] = cs_v;
  // 1. norm: the whole row's mean of squares in every block, in a fixed order
  const float inv = rsqrtf(ol_norm_sum(row, red) / G.hidden + G.eps);
#pragma unroll
  for (int q = 0; q < OL_MAX_NP; ++q) {
    const int i = 8 * (tid + q * OL_THREADS);
    if (i >= G.hidden) break;
    float hv[8], wv[8];
    ol_norm_h(row, q, hv);
    unpack8(row.w[q], wv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (res_out && blockIdx.y == 0) res_out[i + e] = __float2bfloat16(hv[e]);
      xs[i + e] = bf16_round(hv[e] * inv * wv[e]);
    }
  }
  if (tid < ATT_MAX_GROUP) {
    M[tid] = NEG_INF;
    Lsum[tid] = 0.f;
  }
  for (int e = tid; e < ghd; e += OL_THREADS) A[e] = 0.f;
  ol_cbar();
  ol_stamp(stamps, 1);

  // 2. QKV: this rank's columns, then every rank's gathered
  if (cql > 0) {
    float acc[1][8] = {};
    for (int t = 0; t < nq; ++t) {
      const unsigned char* st = wait();
      tile_gemv<1>(st, G.cw * 2, cql / 8, 0, min(G.rq, G.hidden - t * G.rq), xs + t * G.rq,
                   cql / 8, acc);
      release();
    }
    tile_gemv_reduce<1>(acc, cql / 8, red, qkvp);
  }
  ol_stamp(stamps, 2);
  ol_cluster_sync();                                 // every rank's columns are written
  for (int e = tid; e < cq; e += OL_THREADS) {
    const int r = e / G.cw;
    qkv[e] = cluster.map_shared_rank(qkvp, r)[e - r * G.cw];
  }
  ol_cbar();

  // 3. rope; rank 0 writes the new rows
  const float scale = LOG2E / sqrtf((float)hd);
  for (int e = tid; e < ghd; e += OL_THREADS) {
    const int i = e / hd, d = e - i * hd;
    const float q = rope_at(qkv + i * hd, d, hd, cs, cs + hd, G.neox) * scale;
    qs[e] = q;
    qb[e] = __float2bfloat16(q);
  }
  const float* vcur = qkv + ghd + hd;
  for (int d = tid; d < hd; d += OL_THREADS) {
    const float kd = rope_at(qkv + ghd, d, hd, cs, cs + hd, G.neox);
    kr[d] = kd;
    if (rank == 0) {
      k_new[(size_t)h * hd + d] = __float2bfloat16(kd);
      v_new[(size_t)h * hd + d] = __float2bfloat16(vcur[d]);
      if (G.append) {
        const size_t row = ((size_t)h * G.cap + G.seq) * hd + d;
        kc[row] = __float2bfloat16(kd);
        vc[row] = __float2bfloat16(vcur[d]);
      }
    }
  }
  ol_cbar();
  if (wid < g) {                                  // the current token's score, f32 q
    float p = 0.f;
    for (int d = lane; d < hd; d += 32) p = fmaf(qs[wid * hd + d], kr[d], p);
    p = warp_sum(p);
    if (lane == 0) scur[wid] = p;
  }
  ol_stamp(stamps, 3);

  // 4. split-KV over this rank's splits
  const int npq = hd / 32;                        // 16-byte pieces per thread of a K row
  const int ncg = hd / 8;
  const int ncgp = ncg <= 4 ? 4 : (ncg <= 8 ? 8 : 16);   // lanes per P.V row
  const int slices = OL_THREADS / ncgp, sl = tid / ncgp, cgi = tid % ncgp;
  const int CH = G.kch * G.split;                 // score columns per query row
  // Q.K: four threads a row (kr_row), each over hd/4 of it in 16-byte
  // pieces q4, q4 + 4, ... in an order staggered by row (so the rows a warp
  // reads at once fall in distinct banks); the thread's pieces of q are
  // kept in registers (bf16) for groups of up to 2 query rows
  const int kr_row = tid >> 2, kr_q4 = tid & 3;
  int kpc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int x = c + kr_row % npq;
    if (x >= npq) x -= npq;
    kpc[c] = kr_q4 + 4 * x;
  }
  constexpr int QV = GT <= 2 ? GT : 1;
  uint4 qv[QV][4];
#pragma unroll
  for (int i = 0; i < QV; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      qv[i][c] = GT <= 2 && i < g && c < npq
                     ? *reinterpret_cast<const uint4*>(qb + i * hd + kpc[c] * 8)
                     : make_uint4(0u, 0u, 0u, 0u);
  auto split_rows = [&](int j) { return min(G.split, G.seq - (rank + j * C) * G.split); };
  for (int j0 = 0; j0 < nmine; j0 += G.kch) {
    const int nsc = min(G.kch, nmine - j0);
    for (int jj = 0; jj < nsc; ++jj) {
      const int n = split_rows(j0 + jj), nt = (n + G.tr - 1) / G.tr;
      for (int t = 0; t < nt; ++t) {
        const unsigned char* st = wait();
        const int rows = min(G.tr, n - t * G.tr);
        float a[GT], a2[GT];                      // two FMA chains per query row
#pragma unroll
        for (int i = 0; i < GT; ++i) a[i] = a2[i] = 0.f;
        if (kr_row < rows) {
          const unsigned char* krow = st + kr_row * hd * 2;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c < npq) {
              float kf[8];
              unpack8(*reinterpret_cast<const uint4*>(krow + kpc[c] * 16), kf);
#pragma unroll
              for (int i = 0; i < GT; ++i) {
                if (i < g) {
                  float qf[8];
                  unpack8(GT <= 2 ? qv[i < QV ? i : 0][c]
                                  : *reinterpret_cast<const uint4*>(qb + i * hd + kpc[c] * 8),
                          qf);
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    a[i] = fmaf(qf[e], kf[e], a[i]);
                    a2[i] = fmaf(qf[e + 4], kf[e + 4], a2[i]);
                  }
                }
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < GT; ++i) a[i] += a2[i];
        const int r = kr_row, q4 = kr_q4;
#pragma unroll
        for (int i = 0; i < GT; ++i) {
          if (i < g) {
            a[i] += __shfl_xor_sync(0xffffffffu, a[i], 1);
            a[i] += __shfl_xor_sync(0xffffffffu, a[i], 2);
            if (q4 == 0 && r < rows) sc[i * CH + jj * G.split + t * G.tr + r] = a[i];
          }
        }
        release();
      }
    }
    ol_cbar();                                    // the chunk's scores are written
    // each (split, query row)'s max and sum, the pairs on the warps side by
    // side; p rounded to bf16 (the p.V products take bf16 p)
    for (int pr = wid; pr < nsc * g; pr += OL_WARPS) {
      const int jj = pr / g, i = pr - jj * g, n = split_rows(j0 + jj);
      float* si = sc + i * CH + jj * G.split;
      float mx = NEG_INF;
      for (int q = lane; q < n; q += 32) mx = fmaxf(mx, si[q]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int q = lane; q < n; q += 32) {
        const float p = exp2f(si[q] - mx);
        sum += p;
        si[q] = bf16_round(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        pm[pr] = mx;
        pl[pr] = sum;
      }
    }
    ol_cbar();
    // the rank's new max per query row and each split's scale to it, which
    // every thread computes for itself (no barrier); the state's (M, L) are
    // updated after the P.V products
    float mn[GT];
#pragma unroll
    for (int i = 0; i < GT; ++i) {
      mn[i] = i < g ? M[i] : 0.f;
      if (i < g)
        for (int jj = 0; jj < nsc; ++jj) mn[i] = fmaxf(mn[i], pm[jj * g + i]);
    }
    // P.V: thread (slice sl, 8 columns cgi) over rows sl, sl + slices, ...
    float pv[GT][8];
#pragma unroll
    for (int i = 0; i < GT; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) pv[i][c] = 0.f;
    for (int jj = 0; jj < nsc; ++jj) {
      const int n = split_rows(j0 + jj), nt = (n + G.tr - 1) / G.tr;
      float ej[GT];                               // this split's scale per query row
#pragma unroll
      for (int i = 0; i < GT; ++i) ej[i] = i < g ? exp2f(pm[jj * g + i] - mn[i]) : 0.f;
      for (int t = 0; t < nt; ++t) {
        const unsigned char* st = wait();
        const int rows = min(G.tr, n - t * G.tr);
        if (cgi < ncg) {
          const float* pt = sc + jj * G.split + t * G.tr;
#pragma unroll 4
          for (int rr = sl; rr < rows; rr += slices) {
            float vf[8];
            unpack8(*reinterpret_cast<const uint4*>(st + rr * hd * 2 + cgi * 16), vf);
#pragma unroll
            for (int i = 0; i < GT; ++i) {
              if (i < g) {
                const float p = pt[i * CH + rr] * ej[i];
#pragma unroll
                for (int c = 0; c < 8; ++c) pv[i][c] = fmaf(p, vf[c], pv[i][c]);
              }
            }
          }
        }
        release();
      }
    }
    // the slices' sums: lanes of a column group in a warp, then warps in order
#pragma unroll
    for (int i = 0; i < GT; ++i) {
      if (i < g) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          for (int off = ncgp; off < 32; off <<= 1)
            pv[i][c] += __shfl_xor_sync(0xffffffffu, pv[i][c], off);
        if (lane < ncgp && cgi < ncg)
#pragma unroll
          for (int c = 0; c < 8; ++c) red[(wid * g + i) * hd + cgi * 8 + c] = pv[i][c];
      }
    }
    if (tid < g) {                                // the state's max and sum
      const float ea = exp2f(M[tid] - mn[tid]);
      float l = Lsum[tid] * ea;
      for (int jj = 0; jj < nsc; ++jj)
        l = fmaf(pl[jj * g + tid], exp2f(pm[jj * g + tid] - mn[tid]), l);
      M[tid] = mn[tid];
      Lsum[tid] = l;
      ab[tid] = ea;
    }
    ol_cbar();
    for (int e = tid; e < ghd; e += OL_THREADS) {
      float s = red[e];
      for (int w = 1; w < OL_WARPS; ++w) s += red[w * ghd + e];
      A[e] = fmaf(A[e], ab[e / hd], s);
    }
    ol_cbar();
  }

  // the ranks' states and the current token, merged in rank order (each
  // element's C maxima, sums and accumulators read over distributed shared
  // memory at once)
  ol_stamp(stamps, 4);
  ol_cluster_sync();                                 // every rank's state is final
  for (int e = tid; e < ghd; e += OL_THREADS) {
    const int i = e / hd, d = e - i * hd;
    // the current token's (m, l, acc), then each rank's folded in rank
    // order against the running max, four ranks' reads in flight a trip
    float mf = G.fold ? scur[i] : NEG_INF;
    float l = G.fold ? 1.f : 0.f, acc = G.fold ? vcur[d] : 0.f;
    for (int r0 = 0; r0 < C; r0 += 4) {
      float mv[4], lv[4], av[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = r0 + q < C;
        mv[q] = in ? cluster.map_shared_rank(M, r0 + q)[i] : NEG_INF;
        lv[q] = in ? cluster.map_shared_rank(Lsum, r0 + q)[i] : 0.f;
        av[q] = in ? cluster.map_shared_rank(A, r0 + q)[e] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float mn = fmaxf(mf, mv[q]);
        const float ea = exp2f(mf - mn), eb = exp2f(mv[q] - mn);
        l = fmaf(lv[q], eb, l * ea);
        acc = fmaf(av[q], eb, acc * ea);
        mf = mn;
      }
    }
    if (G.partials) {
      if (rank == 0) {
        const int row = h * g + i;
        acc_out[(size_t)row * hd + d] = acc;
        if (d == 0) {
          ml_out[row] = mf;
          ml_out[G.kv * g + row] = l;
        }
      }
    } else {
      o[e] = bf16_round(acc / l);
    }
  }
  ol_cbar();
  ol_stamp(stamps, 5);

  // 6. O-projection of this rank's columns, then 7. the ordered fold
  if (!G.partials && ocl > 0) {
    float acc[OL_MAX_NP][8] = {};
    for (int t = 0; t < no; ++t) {
      const unsigned char* st = wait();
      tile_gemv<OL_MAX_NP>(st, G.oc * 2, ocl / 8, 0, min(G.ro, ghd - t * G.ro), o + t * G.ro,
                           ocl / 8, acc);
      release();
    }
    tile_gemv_reduce<OL_MAX_NP>(acc, ocl / 8, red, part + (size_t)h * G.hidden + c0);
    ol_stamp(stamps, 6);
    ordered_fold(part, G.hidden, G.kv, h, c0, ocl, ctr + rank * OL_FOLD_STRIDE, out, flag,
                 DL_FOLD_GROUP);
  }
  ol_stamp(stamps, 7);
  ol_cluster_sync();                                 // peers have read this block's state
}

// The geometry at cluster size c, or nst == 0 if it does not fit.
DlGeom dl_geom(DlGeom G, int c) {
  G.C = c;
  const int cq = (G.g + 2) * G.hd;
  G.cw = ((cq + c - 1) / c + 7) / 8 * 8;
  // wo columns per rank rounded to 64, so that a box's lines are >= 128 bytes
  G.oc = ((G.hidden + c - 1) / c + 63) / 64 * 64;
  G.rq = std::min(256, OL_STAGE / (2 * G.cw));
  G.ro = std::min(256, OL_STAGE / (2 * G.oc));
  G.tr = std::min(G.split, 64);
  // splits per chunk: as many as this call gives a rank, up to 32 KB of scores
  const int mine = G.ns > 0 ? (G.ns + c - 1) / c : 1;
  G.kch = std::max(1, std::min({64, mine, 8192 / (G.g * G.split)}));
  G.pw = ol_box_width(G.cw, cq);
  G.bw = ol_box_width(G.oc, G.hidden);
  G.nst = 0;
  if (G.ro < 1 || G.oc / G.bw > 256 || G.cw / G.pw > 256 || G.hidden > OL_MAX_HIDDEN)
    return G;
  G.nst = ol_stages(dl_smem(G).ring, DL_STAGES);
  if (G.nst < 2) G.nst = 0;
  return G;
}

using DlKernel = decltype(&decoder_layer_kernel<1, 0>);

template <int HDT>
DlKernel dl_kernel_hd(int g) {
  return g <= 1 ? decoder_layer_kernel<1, HDT>
                : g <= 2 ? decoder_layer_kernel<2, HDT>
                         : g <= 4 ? decoder_layer_kernel<4, HDT> : decoder_layer_kernel<8, HDT>;
}

// The instantiation for a group of g query rows of head dim hd.
DlKernel dl_kernel(int g, int hd) {
  return hd == 128 ? dl_kernel_hd<128>(g) : dl_kernel_hd<0>(g);
}

// The cluster size for this geometry on the current device (cached): the
// largest, up to SMs / kv heads, whose kv_heads clusters the card holds all
// at once; else the largest that fits at all.  *act (if given) receives
// the clusters of that size the card holds.  Returns a cudaError_t.
int dl_pick(int hidden, int kv_heads, int group, int hd, int kv_split, int* c_out,
            int* act_out) {
  int num_sms = 0, max_cluster = 0;
  const DlKernel kern = dl_kernel(group, hd);
  CF_CHECK(ol_device(kern, &num_sms, &max_cluster));
  static struct { int dev, hidden, kv, g, hd, split, c, act; } picks[32];
  static int n_picks = 0;
  int dev = 0;
  CF_CHECK((int)cudaGetDevice(&dev));
  for (int i = 0; i < n_picks; ++i)
    if (picks[i].dev == dev && picks[i].hidden == hidden && picks[i].kv == kv_heads &&
        picks[i].g == group && picks[i].hd == hd && picks[i].split == kv_split) {
      *c_out = picks[i].c;
      if (act_out) *act_out = picks[i].act;
      return 0;
    }
  DlGeom G{hidden, kv_heads, 1, group, hd, 0, 0, kv_split};
  G.ns = 1 << 20;                                 // the largest chunk: the most shared memory
  const int cmax = std::min({max_cluster, std::max(1, num_sms / kv_heads),
                             (group + 2) * hd / 8});
  int c = 0, act = 0;
  for (int t = cmax; t >= 1; --t) {
    const DlGeom Gt = dl_geom(G, t);
    if (Gt.nst == 0) continue;
    const int a = ol_active_clusters(kern, t, dl_smem(Gt).total, t * kv_heads);
    if (a >= 1 && c == 0) {
      c = t;
      act = a;
    }
    if (a >= kv_heads) {
      c = t;
      act = a;
      break;
    }
  }
  if (c == 0) return (int)cudaErrorInvalidValue;
  if (n_picks < 32) picks[n_picks++] = {dev, hidden, kv_heads, group, hd, kv_split, c, act};
  *c_out = c;
  if (act_out) *act_out = act;
  return 0;
}

}  // namespace

// The launch plan of cf_decoder_layer for this geometry on the current
// device, into info[0..20]: blocks per cluster, blocks, ring stages, shared
// bytes per block, clusters the card holds at that size, then for cluster
// sizes 1..16 the clusters the card holds (0 where none fits).  Returns a
// cudaError_t.
extern "C" int cf_decoder_layer_plan(int hidden, int kv_heads, int group, int hd,
                                     int kv_split, int* info) {
  int c = 0, act = 0;
  CF_CHECK(dl_pick(hidden, kv_heads, group, hd, kv_split, &c, &act));
  DlGeom G{hidden, kv_heads, 1, group, hd, 0, 0, kv_split};
  G.ns = 1 << 20;
  G = dl_geom(G, c);
  info[0] = c;
  info[1] = c * kv_heads;
  info[2] = G.nst;
  info[3] = dl_smem(G).total;
  info[4] = act;
  for (int t = 1; t <= OL_MAX_CLUSTER; ++t) {
    const DlGeom Gt = dl_geom(G, t);
    info[4 + t] = Gt.nst ? ol_active_clusters(dl_kernel(group, hd), t, dl_smem(Gt).total,
                                              t * kv_heads)
                         : 0;
  }
  return 0;
}

// Floats of scratch `cf_decoder_layer` needs (the fold's [kv_heads, hidden]
// rows, its group rows and ticket counters); zero it once, when it is
// allocated: every call leaves the counters at 0.
extern "C" long long cf_decoder_layer_scratch_floats(int hidden, int kv_heads) {
  return ol_fold_floats(kv_heads, hidden, DL_FOLD_GROUP);
}

// The attention half of one layer at `seq` cached rows, on `stream`, one
// launch.  x, residual (nullptr: no residual add), rms_w, out, res_out
// (nullptr: not written) are bf16 [hidden]; cos/sin f32 [hd]; k_new/v_new
// bf16 [kv, hd]; kc/vc the layer's bf16 [kv, cap, hd] cache, row `seq`
// written when `append`.  acc_out (f32 [kv*g, hd]) and ml_out (f32
// [2, kv*g]) given: partials mode, wo and out unused.  scratch: see
// cf_decoder_layer_scratch_floats (one per stream: calls on one stream
// take turns with it).  stamps: nullptr, or zeroed uint64 [16 * kv_heads]
// [OL_STAMPS] (rows past the launch's blocks stay 0) for the phases'
// times: start, norm, QKV, rope, split-KV, merge, O-projection, fold.
// *n_launches receives the number of kernels launched.  Returns a
// cudaError_t (0 on success).
extern "C" int cf_decoder_layer(
    const void* x, const void* residual, const void* rms_w, const void* cos,
    const void* sin, const void* wqkv, const void* wo, void* kc, void* vc,
    void* out, void* res_out, void* k_new, void* v_new, void* acc_out,
    void* ml_out, void* scratch, int hidden, int kv_heads, int hg, int group,
    int hd, int cap, int seq, int fold, int append, int neox, float eps,
    int kv_split, void* stamps, int* n_launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *n_launches = 0;
  const bool partials = acc_out != nullptr;
  if (kv_heads < 1 || kv_heads > OL_FOLD_MAX_ROWS || hg < 1 || kv_heads % hg != 0 || seq < 0 || seq > cap ||
      (append && (partials || seq >= cap)) || hidden < 8 || hidden % 8 != 0 ||
      group < 1 || group > ATT_MAX_GROUP || hd < 32 || hd % 32 != 0 || hd > 128 ||
      kv_split < 1 || kv_split > ATT_MAX_SPLIT || k_new == nullptr || v_new == nullptr ||
      (partials && ml_out == nullptr) || (!partials && (wo == nullptr || out == nullptr)))
    return (int)cudaErrorInvalidValue;
  DlGeom G{hidden, kv_heads, hg, group, hd, cap, seq, kv_split, fold ? 1 : 0,
           neox ? 1 : 0, append ? 1 : 0, partials ? 1 : 0};
  G.ns = (seq + kv_split - 1) / kv_split;
  G.eps = eps;
  int c = 0;
  CF_CHECK(dl_pick(hidden, kv_heads, group, hd, kv_split, &c, nullptr));
  G = dl_geom(G, c);
  const int ng = kv_heads / hg, cq = (group + 2) * hd;
  CUtensorMap qm, om;
  memset(&om, 0, sizeof(om));
  if (!hopper::make_tensor_map_bf16_3d(&qm, wqkv, G.pw, (uint64_t)hg * cq / G.pw,
                                       (uint64_t)ng * hidden, (uint64_t)G.pw * 2,
                                       (uint64_t)hg * cq * 2, G.pw, G.cw / G.pw, G.rq,
                                       CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (!partials &&
       !hopper::make_tensor_map_bf16_3d(&om, wo, G.bw, hidden / G.bw,
                                        (uint64_t)kv_heads * group * hd, (uint64_t)G.bw * 2,
                                        (uint64_t)hidden * 2, G.bw, G.oc / G.bw, G.ro,
                                        CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  unsigned* ctr = reinterpret_cast<unsigned*>(
      part + (size_t)(kv_heads + ol_fold_groups(kv_heads, DL_FOLD_GROUP)) * hidden);
  CF_CHECK(launch_kernel_cluster(
      dl_kernel(group, hd), dim3(1, c * kv_heads), dim3(OL_BLOCK), dl_smem(G).total, st,
      false, c, qm, om, G, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(residual), static_cast<const __nv_bfloat16*>(rms_w),
      static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<__nv_bfloat16*>(kc), static_cast<__nv_bfloat16*>(vc),
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(res_out),
      static_cast<__nv_bfloat16*>(k_new), static_cast<__nv_bfloat16*>(v_new),
      static_cast<float*>(acc_out), static_cast<float*>(ml_out), part, ctr,
      static_cast<unsigned long long*>(stamps)));
  *n_launches = 1;
  return 0;
}
