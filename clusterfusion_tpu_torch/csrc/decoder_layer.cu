// The attention half of one bs=1 Llama decoder layer for Hopper (sm_90a),
// one launch: residual add, RMSNorm, the QKV projection, RoPE, flash-decode
// over the cached rows with the current token folded in, and the
// O-projection.
//
// Replaces the TPU kernel `_fused_decoder_layer`
// (clusterfusion_tpu/ops/decoder_layer.py, `_decoder_layer_kernel`) for
// bf16, int8 or int4 weights, a bf16 or fp8 e4m3 KV cache, a sliding
// window (Mistral's, with the sp step's shard bound; below), no bias and
// no softcap, with one layer's slices of its layouts:
//   wqkv [G, hidden, hg*(g+2)*hd]   columns per kv head [q_0..q_{g-1}|k|v]
//   wo   [G, hg*g*hd, hidden]       caches [kv_heads, cap, hd]
// (the wrapper passes pointers into the [L, ...] stacks; nothing is
// copied).  Its modes, as the TPU kernel's:
//   residual    h = x + residual, res_out = bf16(h); or (nullptr) h = x
//   append      write the k/v rows at row `seq` of the cache (bf16, or
//               e4m3 of the float32 rows)
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
//   4. split-KV   live split s (kv_split rows < seq; see the window) is
//                 rank s % C's; a rank walks its splits in chunks (up to
//                 32 KB of scores): the
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
//
// Int8 weights (W8; the TPU kernel's wq_kind == "int8", ops/quant.py's
// per-output-column QuantizedTensor): wqkv and wo hold int8 codes, sq
// [G, hg*(g+2)*hd] and so [G, hidden] their float32 scales.  The codes
// stream as they are, never a bf16 copy: 67 MB of a 7B layer instead of
// 134.  A stage keeps its 16 KB and so holds twice the rows (the bytes in
// flight per SM do not change); the boxes' inner widths are whole 16-byte
// units of int8 columns (ol_box_width with unit 16: 7B's QKV slice of 128
// columns a rank is one 128-byte box row).  A lane reads its 8 columns of
// a row as one 8-byte shared load and makes exact floats of them
// (tile_gemv<NP, true>), so the FMA chain and the fixed-order sums are the
// bf16 path's.  The scales go where the TPU kernel applies them: each QKV
// column of a rank's slice after the sum over hidden (before the DSM
// gather), and each kv head's O-projection row by its head group's scale
// so[h / hg] before the ordered fold sums the heads in order (the TPU
// kernel sums a group's heads in one dot and then scales; the rounding
// differs, not the function).  Partials mode streams the int8 QKV only.
//
// Int4 weights (WK_INT4 exact, WK_INT4A8 W4A8; the TPU kernel's wq_kind ==
// "int4", ops/quant.py's group-wise QuantizedTensor, groups of GS4 = 128
// k rows, codes packed two a byte along K): wqkv [G, hidden/2, C] and wo
// [G, hg*g*hd/2, hidden] hold the code pairs, sq [G, hidden/128, C] and so
// [G, hg*g*hd/128, hidden] the float32 group scales.  The code pairs
// stream as they are through the same 16 KB stages (a stage row is a
// packed row: two k rows), never a bf16 copy; each thread finds the scale
// group of its rows itself (gemv4_piece, common.cuh) and rounds the scale
// to bf16 as the TPU kernel streams it.  Exact: the weights are bf16(code
// * s), the int8 path's FMA chain.  W4A8 (KernelConfig.int4_w4a8): every
// block quantizes the normed row to int8 against its absmax, sums each
// group's dp4a products in int32 and scales them by the group's scale at
// the group's end, and x's scale after the sum.  The O projection in W4A8
// cannot stay inside the clusters: the TPU kernel quantizes a whole head
// group's o (hg heads, hg clusters) against one absmax.  So the layer
// writes o and one launch of the ring GEMV's W4A8 instance projects it
// (kernel 7's W4A8 O projection: chunks inside one head group, a fixed
// summation order), two launches a call.  The exact O stays in the
// layer's own tile loop and ordered fold.  Partials mode streams the int4
// QKV only.
//
// An fp8 e4m3 KV cache (KV == KV_FP8; the TPU kernel's kv_kind == "fp8",
// beside any weight kind, in every mode): a row is hd bytes, so each K or V
// tile of G.tr rows is one bulk copy of half the bf16 tile's bytes into the
// same 16 KB stages.  Q.K and P.V keep the bf16 path's pieces of 8 elements
// (a piece is 8 bytes, one 8-byte shared load) and decode each byte exactly
// to float with e4m3 denormals (|v| <= 0.0137) flushed to 0, as the TPU
// kernel's fp8_decode_scaled (common.cuh's unpack8_e4m3, kernel 7's
// decode); the score is bf16(q) . k in float32 and p stays bf16-rounded.
// The append stores e4m3 straight from the float32 roped k and the float32
// v (saturating at +-448), no bf16 step between; k_new/v_new stay bf16 and
// the current token's fold stays float32.  An Int8KV cache is not taken:
// the TPU kernel reads none either.
//
// Sliding window (the TPU kernel's `window` and prefetched `window_lo`,
// Mistral's pattern): the token attends the cached rows >= lo and itself,
// lo the window's bound in this cache's own rows (seq + 1 - window on one
// card; the sp step's shard translates the global bound into its rows,
// pos + 1 - window - start, which may lie below 0 or at or above seq), the
// entry clamping it to [0, seq].  The splits keep their boundaries
// (multiples of kv_split from row 0, so a bound at or below row 0 runs the
// arithmetic of no window bit for bit).  Splits wholly below lo are not
// walked at all (the TPU kernel aliases their chunks and skips them); the
// live ones are f = lo / kv_split onwards, and live split 0 starts at row
// lo: its bulk copies start at the bound's row (rows of 64 to 256 bytes,
// so every copy stays 16-byte aligned) and no byte below it is fetched, so
// whatever lies there (NaN too) reaches no output.  The round-robin of
// splits over a cluster's ranks starts at the first live split, so a
// window of a few splits still spreads over the ranks.  A rank with no
// live split, and a whole cluster with none (a shard below the window),
// keeps the empty state (m = -1e30, l = 0, acc = 0) through the merge, so
// partials mode without the fold writes exactly that.  The append writes
// row seq, which always lies in the window.  The bound is a runtime
// argument of the same instances (no template instance of its own).

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
  int lo;    // the first cached row read: the window's bound in [0, seq] (0: none)
  int f;     // the first live split (the one holding row lo): splits f .. f+ns-1
};

// Shared-memory offsets (bytes) of one block.
struct DlSmem {
  int xs, qkvp, qkv, qs, qb, kr, cs, small, A, o, sc, pst, red, ring, total, x8;
};

// x8: W4A8's int8 x of the row (hidden bytes) too.
__host__ __device__ inline DlSmem dl_smem(const DlGeom& G, bool x8 = false) {
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
  s.x8 = x8 ? ol_take(off, G.hidden) : 0;
  s.ring = (off + 1023) / 1024 * 1024;
  s.total = s.ring + G.nst * OL_STAGE;
  return s;
}

// GT: the group's bound (1, 2, 4 or 8; g <= GT), so that the loops over a
// group's query rows hold no more code than the call runs; HDT: the head
// dim when it is 128 (0: G.hd).  With both known (7B's g 1, hd 128) the
// index arithmetic folds into shifts and the launch's code, fetched cold on
// every call of a decode step, is the shorter.  WK (common.cuh's WK_*): the
// weight kind; int8 and int4 weights come with the scales sq and so
// (unused, and null, in the bf16 instances).  WK_INT4A8 writes o (bf16
// [kv*g*hd]) to `out` and projects nothing (the ring GEMV's W4A8 instance
// runs the O projection after it).  KV: the cache kind (KV_BF16 or
// KV_FP8, whose rows are bytes).
template <int KV>
using dl_row_t = std::conditional_t<KV == KV_FP8, uint8_t, __nv_bfloat16>;

template <int GT, int HDT, int WK, int KV = KV_BF16>
__global__ void __launch_bounds__(OL_BLOCK, 1)
decoder_layer_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap omap, DlGeom G,
                     const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ res,
                     const __nv_bfloat16* __restrict__ rms_w, const float* __restrict__ cos,
                     const float* __restrict__ sin, dl_row_t<KV>* kc,
                     dl_row_t<KV>* vc, __nv_bfloat16* __restrict__ out,
                     __nv_bfloat16* __restrict__ res_out, __nv_bfloat16* __restrict__ k_new,
                     __nv_bfloat16* __restrict__ v_new, float* __restrict__ acc_out,
                     float* __restrict__ ml_out, float* part, unsigned* ctr,
                     unsigned long long* stamps, const float* __restrict__ sq,
                     const float* __restrict__ so) {
  constexpr bool W8 = WK == WK_INT8, W4 = WK >= WK_INT4, A8 = WK == WK_INT4A8;
  constexpr int EB = W8 || W4 ? 1 : 2;            // bytes per weight (int4: a code pair)
  constexpr int KR = W4 ? 2 : 1;                  // k rows per weight row
  constexpr bool F8 = KV == KV_FP8;
  constexpr int KB = F8 ? 1 : 2;                  // bytes per cache element
  extern __shared__ __align__(1024) unsigned char dl_sm[];
  const DlSmem S = dl_smem(G, A8);
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

  // the tile sequence: QKV rows, then per chunk of this rank's splits the
  // K tiles, then the V tiles; then wo rows.  This rank's j-th split is
  // live split rank + j*C (the round-robin starts at the first live split,
  // so a short window keeps the ranks busy alike), rows [split_r0(j),
  // split_r0(j) + split_rows(j)): live split 0 starts at the window's
  // bound G.lo, and only it and the last live split can be short
  const int hrows = G.hidden / KR;                // wqkv rows (int4: packed)
  const int nq = cql > 0 ? (hrows + G.rq - 1) / G.rq : 0;
  const int nmine = G.ns > rank ? (G.ns - 1 - rank) / C + 1 : 0;
  const int ntf = (G.split + G.tr - 1) / G.tr;   // K (or V) tiles of a full split
  auto split_r0 = [&](int j) {
    const int s = rank + j * C;
    return s == 0 ? G.lo : (G.f + s) * G.split;
  };
  auto split_rows = [&](int j) {
    return min((G.f + rank + j * C + 1) * G.split, G.seq) - split_r0(j);
  };
  auto split_tiles = [&](int j) { return (split_rows(j) + G.tr - 1) / G.tr; };
  int nkv = 2 * ntf * nmine;                      // less the short splits' missing tiles
  if (nmine > 0) {
    if (rank == 0) nkv += 2 * (split_tiles(0) - ntf);
    if (rank != 0 || nmine > 1) nkv += 2 * (split_tiles(nmine - 1) - ntf);
  }
  const int no = (A8 || G.partials || ocl == 0) ? 0 : (ghd / KR + G.ro - 1) / G.ro;
  const int total = nq + nkv + no;
  const int grp = h / G.hg, hin = h % G.hg;
  const dl_row_t<KV>* kh = kc + (size_t)h * G.cap * hd;
  const dl_row_t<KV>* vh = vc + (size_t)h * G.cap * hd;

  // the producer (lane 0): tile u into stage u % nst.  A QKV box is [rq rows]
  // [cw/pw][pw] of the map over the layer's wqkv as [G*hidden][hg*(g+2)*hd
  // /pw][pw]; a wo box [ro rows][oc/bw][bw] of the map over wo as
  // [kv*g*hd][hidden/bw][bw]; what lies past the tensor arrives as zeros.
  // K/V tiles follow a cursor (tiles are issued in order): split pj, its
  // tile pt, of the chunk starting at split pc, its V tiles when pv
  int pj = 0, pt = 0, pc = 0;
  bool pv = false;
  auto issue = [&](int u) {
    const int s = u % G.nst;
    unsigned char* dst = ring + s * OL_STAGE;
    if (lane != 0) return;
    if (u < nq) {
      hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)G.rq * G.cw * EB);
      hopper::tma_load_3d(dst, &qmap, &full[s], 0, (hin * cq + q0) / G.pw,
                          grp * hrows + u * G.rq);
    } else if (u < nq + nkv) {
      const uint32_t bytes = (uint32_t)min(G.tr, split_rows(pj) - pt * G.tr) * hd * KB;
      hopper::mbar_arrive_expect_tx(&full[s], bytes);
      hopper::bulk_load_1d(dst, (pv ? vh : kh) + (size_t)(split_r0(pj) + pt * G.tr) * hd,
                           bytes, &full[s]);
      if (++pt == split_tiles(pj)) {              // the chunk's next split, its V
        pt = 0;                                   // tiles after its K tiles, then
        if (++pj == min(pc + G.kch, nmine)) {     // the next chunk
          if (pv) pc += G.kch;
          pj = pc;
          pv = !pv;
        }
      }
    } else {
      const int t = u - nq - nkv;
      hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)G.ro * G.oc * EB);
      hopper::tma_load_3d(dst, &omap, &full[s], 0, c0 / G.bw,
                          (grp * G.hg + hin) * ghd / KR + t * G.ro);
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
  // W4A8: xn quantized to int8 against the row's absmax (JAX's
  // w4a8_int4_dot on the normed row), four k rows a word; every block
  // computes the same bits
  float xsc = 1.f;
  int* x8 = reinterpret_cast<int*>(dl_sm + S.x8);
  if constexpr (A8) {
    float am = 0.f;
    for (int i = tid; i < G.hidden; i += OL_THREADS) am = fmaxf(am, fabsf(xs[i]));
    am = warp_max(am);
    if (lane == 0) red[wid] = am;
    ol_cbar();
#pragma unroll
    for (int w = 0; w < OL_WARPS; ++w) am = fmaxf(am, red[w]);
    xsc = fmaxf(am, 1e-8f) * (1.f / 127.f);
    for (int i = tid; i < G.hidden / 4; i += OL_THREADS) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        w |= ((uint32_t)(int)quant_x8(xs[4 * i + b], xsc) & 0xffu) << (8 * b);
      x8[i] = (int)w;
    }
    ol_cbar();
  }
  ol_stamp(stamps, 1);

  // 2. QKV: this rank's columns (int8: each scaled after its sum; int4:
  // the group scales inside it, W4A8's x scale after it), then every
  // rank's gathered
  if (cql > 0) {
    float acc[1][8] = {};
    for (int t = 0; t < nq; ++t) {
      const unsigned char* st = wait();
      if constexpr (W4)
        tile_gemv4<1, A8>(st, G.cw, min(G.rq, hrows - t * G.rq), 2 * t * G.rq,
                          xs + 2 * t * G.rq, x8 + t * G.rq / 2, cql / 8,
                          sq + ((size_t)grp * (G.hidden / GS4)) * G.hg * cq + hin * cq + q0,
                          (size_t)G.hg * cq, acc);
      else
        tile_gemv<1, W8>(st, G.cw * EB, cql / 8, 0, min(G.rq, G.hidden - t * G.rq),
                         xs + t * G.rq, cql / 8, acc);
      release();
    }
    if constexpr (A8) {
      tile_gemv_reduce<1>(acc, cql / 8, red, qkvp);
      for (int e = tid; e < cql; e += OL_THREADS) qkvp[e] *= xsc;
    } else if constexpr (W8)
      tile_gemv_reduce_scaled<1>(acc, cql / 8, red, qkvp,
                                 sq + (size_t)grp * G.hg * cq + hin * cq + q0);
    else
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
        if constexpr (F8) {     // e4m3 of the float32 rows
          kc[row] = __nv_cvt_float_to_fp8(kd, __NV_SATFINITE, __NV_E4M3);
          vc[row] = __nv_cvt_float_to_fp8(vcur[d], __NV_SATFINITE, __NV_E4M3);
        } else {
          kc[row] = __float2bfloat16(kd);
          vc[row] = __float2bfloat16(vcur[d]);
        }
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
          const unsigned char* krow = st + kr_row * hd * KB;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c < npq) {
              float kf[8];
              if constexpr (F8)   // a piece of 8 e4m3 bytes
                unpack8_e4m3(*reinterpret_cast<const uint2*>(krow + kpc[c] * 8), kf);
              else
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
            if constexpr (F8)
              unpack8_e4m3(*reinterpret_cast<const uint2*>(st + rr * hd + cgi * 8), vf);
            else
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
    } else if constexpr (A8) {    // o_flat for the ring GEMV's O projection
      if (rank == 0) out[(size_t)h * ghd + e] = __float2bfloat16(acc / l);
    } else {
      o[e] = bf16_round(acc / l);
    }
  }
  ol_cbar();
  ol_stamp(stamps, 5);

  // 6. O-projection of this rank's columns (int8: the head's row scaled by
  // its group's scale; exact int4: the group scales inside the sum), then
  // 7. the ordered fold
  if (!A8 && !G.partials && ocl > 0) {
    float acc[OL_MAX_NP][8] = {};
    for (int t = 0; t < no; ++t) {
      const unsigned char* st = wait();
      if constexpr (W4)
        tile_gemv4<OL_MAX_NP, false>(
            st, G.oc, min(G.ro, ghd / 2 - t * G.ro), hin * ghd + 2 * t * G.ro,
            o + 2 * t * G.ro, nullptr, ocl / 8,
            so + (size_t)grp * (G.hg * ghd / GS4) * G.hidden + c0, (size_t)G.hidden, acc);
      else
        tile_gemv<OL_MAX_NP, W8>(st, G.oc * EB, ocl / 8, 0, min(G.ro, ghd - t * G.ro),
                                 o + t * G.ro, ocl / 8, acc);
      release();
    }
    if constexpr (W8)
      tile_gemv_reduce_scaled<OL_MAX_NP>(acc, ocl / 8, red, part + (size_t)h * G.hidden + c0,
                                         so + (size_t)grp * G.hidden + c0);
    else
      tile_gemv_reduce<OL_MAX_NP>(acc, ocl / 8, red, part + (size_t)h * G.hidden + c0);
    ol_stamp(stamps, 6);
    ordered_fold(part, G.hidden, G.kv, h, c0, ocl, ctr + rank * OL_FOLD_STRIDE, out, flag,
                 DL_FOLD_GROUP);
  }
  ol_stamp(stamps, 7);
  // every store is done: a kernel launched after this one with programmatic
  // dependent launch (kernel 2 on the tp step) may start, and waits for
  // this grid's completion before it reads
  hopper::grid_dep_launch_dependents();
  ol_cluster_sync();                                 // peers have read this block's state
}

// The geometry at cluster size c for weight kind wk (int8 and int4: stages
// of 16 KB hold rows of int8 codes or of int4 code pairs, two k rows a
// byte, and the boxes' inner widths are multiples of 16 columns), or nst
// == 0 if it does not fit.
DlGeom dl_geom(DlGeom G, int c, int wk) {
  G.C = c;
  const bool q8 = wk != WK_BF16;
  const int cq = (G.g + 2) * G.hd;
  const int unit = q8 ? 16 : 8, eb = q8 ? 1 : 2;
  G.cw = ((cq + c - 1) / c + unit - 1) / unit * unit;
  // wo columns per rank rounded to 64, so that a box's lines are >= 128 bytes
  // (bf16; int8 lines are >= 64)
  G.oc = ((G.hidden + c - 1) / c + 63) / 64 * 64;
  G.rq = std::min(256, OL_STAGE / (eb * G.cw));
  G.ro = std::min(256, OL_STAGE / (eb * G.oc));
  if (wk >= WK_INT4) G.rq &= ~1;         // W4A8 reads packed rows in pairs
  G.tr = std::min(G.split, 64);
  // splits per chunk: as many as this call gives a rank, up to 32 KB of scores
  const int mine = G.ns > 0 ? (G.ns + c - 1) / c : 1;
  G.kch = std::max(1, std::min({64, mine, 8192 / (G.g * G.split)}));
  G.pw = ol_box_width(G.cw, cq, unit);
  G.bw = ol_box_width(G.oc, G.hidden, unit);
  G.nst = 0;
  if (G.rq < 1 || G.ro < 1 || G.oc / G.bw > 256 || G.cw / G.pw > 256 ||
      G.hidden > OL_MAX_HIDDEN)
    return G;
  G.nst = ol_stages(dl_smem(G, wk == WK_INT4A8).ring, DL_STAGES);
  if (G.nst < 2) G.nst = 0;
  return G;
}

template <int KV>
using DlKernel = decltype(&decoder_layer_kernel<1, 0, WK_BF16, KV>);

template <int HDT, int WK, int KV>
DlKernel<KV> dl_kernel_hd(int g) {
  return g <= 1   ? decoder_layer_kernel<1, HDT, WK, KV>
         : g <= 2 ? decoder_layer_kernel<2, HDT, WK, KV>
         : g <= 4 ? decoder_layer_kernel<4, HDT, WK, KV>
                  : decoder_layer_kernel<8, HDT, WK, KV>;
}

template <int WK, int KV>
DlKernel<KV> dl_kernel_wk(int g, int hd) {
  return hd == 128 ? dl_kernel_hd<128, WK, KV>(g) : dl_kernel_hd<0, WK, KV>(g);
}

// The instantiation for a group of g query rows of head dim hd, weight
// kind wk and cache kind KV (KV_BF16 or KV_FP8).
template <int KV>
DlKernel<KV> dl_kernel(int g, int hd, int wk) {
  return wk == WK_INT8     ? dl_kernel_wk<WK_INT8, KV>(g, hd)
         : wk == WK_INT4   ? dl_kernel_wk<WK_INT4, KV>(g, hd)
         : wk == WK_INT4A8 ? dl_kernel_wk<WK_INT4A8, KV>(g, hd)
                           : dl_kernel_wk<WK_BF16, KV>(g, hd);
}

// ol_device and ol_active_clusters of the instance for (g, hd, wk, kv).
int dl_device(int g, int hd, int wk, int kv, int* num_sms, int* max_cluster) {
  return kv == KV_FP8 ? ol_device(dl_kernel<KV_FP8>(g, hd, wk), num_sms, max_cluster)
                      : ol_device(dl_kernel<KV_BF16>(g, hd, wk), num_sms, max_cluster);
}

int dl_active(int g, int hd, int wk, int kv, int c, size_t smem, int blocks) {
  return kv == KV_FP8 ? ol_active_clusters(dl_kernel<KV_FP8>(g, hd, wk), c, smem, blocks)
                      : ol_active_clusters(dl_kernel<KV_BF16>(g, hd, wk), c, smem, blocks);
}

// The two weights' tensor maps of one call and the weight kind they were
// encoded for; the launch takes its kernel instance from that kind, so a
// map is never read by the instance of another kind.
struct DlMaps {
  CUtensorMap q, o;
  int wk;
};

// Encode the maps for this geometry: wqkv as [G*hidden][hg*cq/pw][pw] in
// boxes [rq][cw/pw][pw], wo (not in partials mode, nor in W4A8, whose O
// projection is the ring GEMV's) as [kv*g*hd][hidden/bw][bw] in boxes
// [ro][oc/bw][bw]; bf16 or int8 elements (int4: int8 code pairs, the rows
// halved).
bool dl_maps(DlMaps* m, const DlGeom& G, const void* wqkv, const void* wo, int wk) {
  const bool q8 = wk != WK_BF16;
  const CUtensorMapDataType type =
      q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t eb = q8 ? 1 : 2, kr = wk >= WK_INT4 ? 2 : 1;
  const int ng = G.kv / G.hg, cq = (G.g + 2) * G.hd;
  m->wk = wk;
  memset(&m->o, 0, sizeof(m->o));
  return hopper::make_tensor_map_3d(&m->q, type, wqkv, G.pw, (uint64_t)G.hg * cq / G.pw,
                                    (uint64_t)ng * G.hidden / kr, (uint64_t)G.pw * eb,
                                    (uint64_t)G.hg * cq * eb, G.pw, G.cw / G.pw, G.rq,
                                    CU_TENSOR_MAP_SWIZZLE_NONE) &&
         (G.partials || wk == WK_INT4A8 ||
          hopper::make_tensor_map_3d(&m->o, type, wo, G.bw, G.hidden / G.bw,
                                     (uint64_t)G.kv * G.g * G.hd / kr, (uint64_t)G.bw * eb,
                                     (uint64_t)G.hidden * eb, G.bw, G.oc / G.bw, G.ro,
                                     CU_TENSOR_MAP_SWIZZLE_NONE));
}

// The cluster size for this geometry, weight kind and cache kind on the
// current device (cached): the largest, up to SMs / kv heads, whose kv_heads
// clusters the card holds all at once; else the largest that fits at all.
// *act (if given) receives the clusters of that size the card holds.
// Returns a cudaError_t.
int dl_pick(int hidden, int kv_heads, int group, int hd, int kv_split, int wk, int kv,
            int* c_out, int* act_out) {
  int num_sms = 0, max_cluster = 0;
  CF_CHECK(dl_device(group, hd, wk, kv, &num_sms, &max_cluster));
  static struct { int dev, hidden, kv, g, hd, split, wk, kvk, c, act; } picks[32];
  static int n_picks = 0;
  int dev = 0;
  CF_CHECK((int)cudaGetDevice(&dev));
  for (int i = 0; i < n_picks; ++i)
    if (picks[i].dev == dev && picks[i].hidden == hidden && picks[i].kv == kv_heads &&
        picks[i].g == group && picks[i].hd == hd && picks[i].split == kv_split &&
        picks[i].wk == wk && picks[i].kvk == kv) {
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
    const DlGeom Gt = dl_geom(G, t, wk);
    if (Gt.nst == 0) continue;
    const int a =
        dl_active(group, hd, wk, kv, t, dl_smem(Gt, wk == WK_INT4A8).total, t * kv_heads);
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
  if (n_picks < 32)
    picks[n_picks++] = {dev, hidden, kv_heads, group, hd, kv_split, wk, kv, c, act};
  *c_out = c;
  if (act_out) *act_out = act;
  return 0;
}

// One launch of the layer kernel of cache kind KV (the arguments after the
// cache rows as decoder_layer_kernel takes them).
template <int KV, typename... Args>
int dl_launch(const DlGeom& G, const DlMaps& m, int c, cudaStream_t st, const void* x,
              const void* res, const void* rms_w, const float* cos, const float* sin, void* kc,
              void* vc, Args... rest) {
  return launch_kernel_cluster(dl_kernel<KV>(G.g, G.hd, m.wk), dim3(1, c * G.kv),
                               dim3(OL_BLOCK), dl_smem(G, m.wk == WK_INT4A8).total, st, false,
                               c, m.q, m.o, G, static_cast<const __nv_bfloat16*>(x),
                               static_cast<const __nv_bfloat16*>(res),
                               static_cast<const __nv_bfloat16*>(rms_w), cos, sin,
                               static_cast<dl_row_t<KV>*>(kc), static_cast<dl_row_t<KV>*>(vc),
                               rest...);
}

}  // namespace

// The launch plan of cf_decoder_layer for this geometry on the current
// device (wk: the weight kind, common.cuh's WK_*; kv: the cache kind,
// KV_BF16 or KV_FP8), into info[0..20]: blocks per cluster, blocks, ring
// stages, shared bytes per block, clusters the card holds at that size,
// then for cluster sizes 1..16 the clusters the card holds (0 where none
// fits).  Returns a cudaError_t.
extern "C" int cf_decoder_layer_plan(int hidden, int kv_heads, int group, int hd,
                                     int kv_split, int wk, int kv, int* info) {
  if (wk < WK_BF16 || wk > WK_INT4A8 || (kv != KV_BF16 && kv != KV_FP8))
    return (int)cudaErrorInvalidValue;
  int c = 0, act = 0;
  CF_CHECK(dl_pick(hidden, kv_heads, group, hd, kv_split, wk, kv, &c, &act));
  DlGeom G{hidden, kv_heads, 1, group, hd, 0, 0, kv_split};
  G.ns = 1 << 20;
  const bool x8 = wk == WK_INT4A8;
  const DlGeom Gc = dl_geom(G, c, wk);
  info[0] = c;
  info[1] = c * kv_heads;
  info[2] = Gc.nst;
  info[3] = dl_smem(Gc, x8).total;
  info[4] = act;
  for (int t = 1; t <= OL_MAX_CLUSTER; ++t) {
    const DlGeom Gt = dl_geom(G, t, wk);
    info[4 + t] = Gt.nst ? dl_active(group, hd, wk, kv, t, dl_smem(Gt, x8).total, t * kv_heads)
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

// The attention half of one layer at `seq` cached rows, on `stream`.
// x, residual (nullptr: no residual add), rms_w, out, res_out
// (nullptr: not written) are bf16 [hidden]; cos/sin f32 [hd]; k_new/v_new
// bf16 [kv, hd]; kc/vc the layer's [kv, cap, hd] cache of kind kv_kind
// (KV_BF16: bf16 rows; KV_FP8: e4m3 rows, the appended row e4m3 of the
// float32 row), row `seq` written when `append`.  acc_out (f32 [kv*g, hd]) and ml_out (f32
// [2, kv*g]) given: partials mode, wo and out unused.  scratch: see
// cf_decoder_layer_scratch_floats (one per stream: calls on one stream
// take turns with it).  stamps: nullptr, or zeroed uint64 [16 * kv_heads]
// [OL_STAMPS] (rows past the launch's blocks stay 0) for the phases'
// times: start, norm, QKV, rope, split-KV, merge, O-projection, fold.
// *n_launches receives the number of kernels launched.  wk (common.cuh's
// WK_*): the weight kind.  WK_INT8: wqkv and wo hold int8 codes and wqkv_s
// (float32 [G, hg*(g+2)*hd]) and wo_s (float32 [G, hidden]; unused in
// partials mode) their per-column scales; hidden a multiple of 16.
// WK_INT4 (exact) and WK_INT4A8 (W4A8): wqkv [G, hidden/2, C] and wo [G,
// hg*g*hd/2, hidden] hold int4 codes packed two a byte along K, wqkv_s
// [G, hidden/GS4, C] and wo_s [G, hg*g*hd/GS4, hidden] their float32 group
// scales; hidden and hg*g*hd multiples of GS4.  W4A8 (not in partials
// mode) is two launches: the layer writes o (bf16 [kv*g*hd]) into o_buf,
// and the ring GEMV's W4A8 instance (o_threads consumer threads) projects
// the head groups' o as one [kv*g*hd, hidden] product whose activation
// blocks are the head groups (the TPU kernel quantizes each head group's
// o_flat against its own absmax, and no cluster holds a whole group), out
// = bf16 of its sums.  window_lo: the sliding window's bound in this
// cache's rows, the first row read (0: no window; at or above seq, clamped
// to seq: no cached row is read).  Returns a cudaError_t (0 on success).
extern "C" int cf_decoder_layer(
    const void* x, const void* residual, const void* rms_w, const void* cos,
    const void* sin, const void* wqkv, const void* wo, void* kc, void* vc,
    void* out, void* res_out, void* k_new, void* v_new, void* acc_out,
    void* ml_out, void* scratch, int hidden, int kv_heads, int hg, int group,
    int hd, int cap, int seq, int fold, int append, int neox, float eps,
    int kv_split, void* stamps, int* n_launches, void* stream, const void* wqkv_s,
    const void* wo_s, int wk, void* o_buf, int o_threads, int kv_kind, int window_lo) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *n_launches = 0;
  const bool partials = acc_out != nullptr;
  const bool w4 = wk == WK_INT4 || wk == WK_INT4A8, a8 = wk == WK_INT4A8 && !partials;
  if (wk < WK_BF16 || wk > WK_INT4A8 || (kv_kind != KV_BF16 && kv_kind != KV_FP8))
    return (int)cudaErrorInvalidValue;
  if (wk != WK_BF16 &&
      (wqkv_s == nullptr || (!partials && wo_s == nullptr) || hidden % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (w4 && (hidden % GS4 != 0 || (hg * group * hd) % GS4 != 0))
    return (int)cudaErrorInvalidValue;
  if (a8 && (o_buf == nullptr || o_threads < 32 || o_threads % 32 != 0 ||
             o_threads > G1_MAX_THREADS))
    return (int)cudaErrorInvalidValue;
  if (kv_heads < 1 || kv_heads > OL_FOLD_MAX_ROWS || hg < 1 || kv_heads % hg != 0 || seq < 0 || seq > cap ||
      (append && (partials || seq >= cap)) || hidden < 8 || hidden % 8 != 0 ||
      group < 1 || group > ATT_MAX_GROUP || hd < 32 || hd % 32 != 0 || hd > 128 ||
      kv_split < 1 || kv_split > ATT_MAX_SPLIT || k_new == nullptr || v_new == nullptr ||
      (partials && ml_out == nullptr) || (!partials && (wo == nullptr || out == nullptr)))
    return (int)cudaErrorInvalidValue;
  DlGeom G{hidden, kv_heads, hg, group, hd, cap, seq, kv_split, fold ? 1 : 0,
           neox ? 1 : 0, append ? 1 : 0, partials ? 1 : 0};
  // the window's bound: rows below lo are neither read nor weighed; the
  // splits keep their boundaries, and the live ones are f .. f + ns - 1
  G.lo = std::min(std::max(window_lo, 0), seq);
  G.f = G.lo < seq ? G.lo / kv_split : (seq + kv_split - 1) / kv_split;
  G.ns = (seq + kv_split - 1) / kv_split - G.f;
  G.eps = eps;
  int c = 0;
  CF_CHECK(dl_pick(hidden, kv_heads, group, hd, kv_split, wk, kv_kind, &c, nullptr));
  G = dl_geom(G, c, wk);
  DlMaps m;
  if (!dl_maps(&m, G, wqkv, wo, wk)) return (int)cudaErrorInvalidValue;
  CUtensorMap om;                 // W4A8's O projection: wo as one packed matrix
  const int ko = kv_heads * group * hd;
  if (a8 && !make_int8_weight_map(&om, wo, ko / 2, hidden, 1))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  unsigned* ctr = reinterpret_cast<unsigned*>(
      part + (size_t)(kv_heads + ol_fold_groups(kv_heads, DL_FOLD_GROUP)) * hidden);
  auto launch = [&](auto kind) {
    return dl_launch<decltype(kind)::value>(
        G, m, c, st, x, residual, rms_w, static_cast<const float*>(cos),
        static_cast<const float*>(sin), kc, vc, static_cast<__nv_bfloat16*>(a8 ? o_buf : out),
        static_cast<__nv_bfloat16*>(res_out), static_cast<__nv_bfloat16*>(k_new),
        static_cast<__nv_bfloat16*>(v_new), static_cast<float*>(acc_out),
        static_cast<float*>(ml_out), part, ctr, static_cast<unsigned long long*>(stamps),
        static_cast<const float*>(wqkv_s), static_cast<const float*>(wo_s));
  };
  if (kv_kind == KV_FP8)
    CF_CHECK(launch(std::integral_constant<int, KV_FP8>()));
  else
    CF_CHECK(launch(std::integral_constant<int, KV_BF16>()));
  *n_launches = 1;
  if (a8) {
    CF_CHECK((launch_gemv1<false, G1_Y, WK_INT4A8>(
        o_buf, 0, nullptr, nullptr, ko, hidden, 1, 0, 0, o_threads, true, st,
        static_cast<__nv_bfloat16*>(out), nullptr, 0.f, nullptr, &om, 0,
        static_cast<const float*>(wo_s), hg * group * hd)));
    *n_launches = 2;
  }
  return 0;
}
