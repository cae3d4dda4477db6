// Fused SwiGLU FFN of one bs=1 token for Hopper (sm_90a), one launch:
// residual add, RMSNorm, the gate/up product, SiLU(gate) * up and the down
// product.
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
// down product accumulating in VMEM scratch.  Here the walk is spatial and
// the FFN is one launch: block b owns the f_pad columns [b*fw, (b+1)*fw)
// (fw a multiple of 8 that makes the grid one wave, 88 at 11264: 128
// blocks) and streams them through one ring of shared-memory stages
// (common.cuh, "one-launch layer halves"), the copies running ahead of
// the arithmetic:
//   norm      every block: h = x (+ residual) in f32, the mean of h^2 over
//             the row, xn = bf16(h * rsqrt(. + eps) * norm_w); block 0
//             writes res_out = bf16(h)
//   gate/up   its columns of w13[l]'s gate and up, one TMA box [2][rk][fw]
//             a stage (a tensor map over the layer's [2, hidden, f_pad]),
//             f32 sums; act = bf16(silu(gate) * up)
//   down      its rows of w2[l] (contiguous, a bulk copy a stage) into an
//             f32 partial [hidden]
//   fold      the C blocks of a cluster (2 on an H100: it holds 64 clusters
//             of 2, not 16 of 8) sum their partials over distributed shared
//             memory in rank order (rank r the columns of its share), then
//             per share the clusters' rows are summed in cluster order, in
//             two levels of tickets, and out = bf16(sum) is written
//             (common.cuh's ordered_fold: tickets, never a sum by atomics)
// Every sum runs in a fixed order, so a call repeats its bits exactly;
// gu never goes through device memory.

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

// Ring stages: 3 measured faster than 4, 5, 6 and 8 at 2048 x 11264 on
// the H100 (PERF.md).
constexpr int FFN_STAGES = 3;
// Rows (clusters) per first-level group of the fold: 8 measured faster than
// 4, 16 and 32 at 64 clusters (PERF.md).
constexpr int FFN_FOLD_GROUP = 8;

struct FfnGeom {
  int hidden, f_pad;
  int fw;    // f_pad columns per block (a multiple of 8, <= 256)
  int C;     // blocks per cluster
  int ncl;   // clusters
  int rk;    // hidden rows per gate/up tile
  int rd;    // w2 rows per down tile
  int nst;   // ring stages
  float eps;
};

struct FfnSmem {
  int xs, red, gu, psm, ring, total;
};

__host__ __device__ inline FfnSmem ffn_smem(const FfnGeom& G) {
  FfnSmem s;
  int off = OL_HEAD;
  s.xs = ol_take(off, 4 * G.hidden);         // xn, f32
  s.red = ol_take(off, 4 * OL_RED_FLOATS);
  s.gu = ol_take(off, 4 * 2 * G.fw);         // gate | up, then act in gate's place
  s.psm = ol_take(off, 4 * G.hidden);        // this block's down partial
  s.ring = (off + 1023) / 1024 * 1024;
  s.total = s.ring + G.nst * OL_STAGE;
  return s;
}

__global__ void __launch_bounds__(OL_BLOCK, 1)
fused_ffn_kernel(const __grid_constant__ CUtensorMap w13map, FfnGeom G,
                 const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res,
                 const __nv_bfloat16* __restrict__ nw, const __nv_bfloat16* __restrict__ w2,
                 __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ res_out,
                 float* part, unsigned* ctr, unsigned long long* stamps) {
  extern __shared__ __align__(1024) unsigned char ffn_sm[];
  const FfnSmem S = ffn_smem(G);
  uint64_t* full = reinterpret_cast<uint64_t*>(ffn_sm);  // [nst] bytes landed
  uint64_t* empty = full + OL_MAX_STAGES;                // [nst] consumers done
  int* flag = reinterpret_cast<int*>(ffn_sm + 16 * OL_MAX_STAGES);
  unsigned char* ring = ffn_sm + S.ring;
  float* xs = reinterpret_cast<float*>(ffn_sm + S.xs);
  float* red = reinterpret_cast<float*>(ffn_sm + S.red);
  float* gu = reinterpret_cast<float*>(ffn_sm + S.gu);
  float* psm = reinterpret_cast<float*>(ffn_sm + S.psm);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = G.C, cid = blockIdx.y / C;
  const int tid = threadIdx.x, wid = tid / 32, lane = tid % 32;
  const int hidden = G.hidden, fw = G.fw;
  const int f0 = blockIdx.y * fw, fwl = max(0, min(fw, G.f_pad - f0));
  const int nk = fwl > 0 ? (hidden + G.rk - 1) / G.rk : 0;
  const int nd = (fwl + G.rd - 1) / G.rd;
  const int total = nk + nd;

  // the producer (lane 0): tile u into stage u % nst
  auto issue = [&](int u) {
    const int s = u % G.nst;
    unsigned char* dst = ring + s * OL_STAGE;
    if (lane != 0) return;
    if (u < nk) {
      hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)4 * G.rk * fw);
      hopper::tma_load_3d(dst, &w13map, &full[s], f0, u * G.rk, 0);
    } else {
      const int t = u - nk;
      const uint32_t bytes = (uint32_t)min(G.rd, fwl - t * G.rd) * hidden * 2;
      hopper::mbar_arrive_expect_tx(&full[s], bytes);
      hopper::bulk_load_1d(dst, w2 + (size_t)(f0 + t * G.rd) * hidden, bytes, &full[s]);
    }
  };
  int u = 0;
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
  OlRow row;                                      // the norm's loads first
  if (fwl > 0 && wid < OL_WARPS) ol_norm_load(row, x, res, nw, hidden);
  if (tid == 0) {
    for (int s = 0; s < G.nst; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], OL_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (wid == OL_WARPS) {                          // the producer: every tile before
    ol_produce(total, G.nst, empty, 2, [](int) { return 0; }, issue);   // the first
    return;                                       // cluster barrier
  }

  if (fwl > 0) {
    // norm: the whole row in every block, in a fixed order
    const float inv = rsqrtf(ol_norm_sum(row, red) / hidden + G.eps);
#pragma unroll
    for (int q = 0; q < OL_MAX_NP; ++q) {
      const int i = 8 * (tid + q * OL_THREADS);
      if (i >= hidden) break;
      float hv[8], wv[8];
      ol_norm_h(row, q, hv);
      unpack8(row.w[q], wv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (blockIdx.y == 0) res_out[i + e] = __float2bfloat16(hv[e]);
        xs[i + e] = bf16_round(hv[e] * inv * wv[e]);
      }
    }
    ol_cbar();
    ol_stamp(stamps, 1);

    // gate/up: pieces 0..fw/8-1 are gate's columns, the rest up's
    float acc[1][8] = {};
    for (int t = 0; t < nk; ++t) {
      const unsigned char* st = wait();
      tile_gemv<1>(st, fw * 2, fw / 8, G.rk * fw * 2, min(G.rk, hidden - t * G.rk),
                   xs + t * G.rk, fw / 4, acc);
      release();
    }
    tile_gemv_reduce<1>(acc, fw / 4, red, gu);
    ol_stamp(stamps, 2);
    for (int c = tid; c < fwl; c += OL_THREADS) {
      const float gt = gu[c], up = gu[fw + c];
      gu[c] = bf16_round(gt / (1.f + expf(-gt)) * up);
    }
    ol_cbar();
    ol_stamp(stamps, 3);
  }

  // down: this block's w2 rows against act
  {
    float acc[OL_MAX_NP][8] = {};
    for (int t = 0; t < nd; ++t) {
      const unsigned char* st = wait();
      tile_gemv<OL_MAX_NP>(st, hidden * 2, hidden / 8, 0, min(G.rd, fwl - t * G.rd),
                           gu + t * G.rd, hidden / 8, acc);
      release();
    }
    tile_gemv_reduce<OL_MAX_NP>(acc, hidden / 8, red, psm);
  }
  ol_stamp(stamps, 4);

  // the cluster's sum of its blocks' partials, rank r summing its share of
  // the columns in rank order; then the ordered fold over the clusters
  ol_cluster_sync();
  const int cw = ((hidden + C - 1) / C + 7) / 8 * 8;
  const int q0 = rank * cw, qn = max(0, min(cw, hidden - q0));
  for (int c = tid; c < qn; c += OL_THREADS) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += cluster.map_shared_rank(psm, r)[q0 + c];
    part[(size_t)cid * hidden + q0 + c] = s;
  }
  ol_stamp(stamps, 5);
  if (qn > 0)
    ordered_fold(part, hidden, G.ncl, cid, q0, qn, ctr + rank * OL_FOLD_STRIDE, out, flag,
                 FFN_FOLD_GROUP);
  ol_stamp(stamps, 6);
  ol_cluster_sync();                                 // peers have read this block's partial
  ol_stamp(stamps, 7);
}

// The launch geometry for (hidden, f_pad) on the current device (cached),
// nst == 0 if the shapes do not fit.
int ffn_geom(int hidden, int f_pad, FfnGeom* out) {
  int num_sms = 0, max_cluster = 0;
  CF_CHECK(ol_device(fused_ffn_kernel, &num_sms, &max_cluster));
  int dev = 0;
  CF_CHECK((int)cudaGetDevice(&dev));
  static struct { int dev; FfnGeom G; } picks[32];
  static int n_picks = 0;
  for (int i = 0; i < n_picks; ++i)
    if (picks[i].dev == dev && picks[i].G.hidden == hidden && picks[i].G.f_pad == f_pad) {
      *out = picks[i].G;
      return 0;
    }
  FfnGeom G{hidden, f_pad};
  // one column slice per SM, 8-column aligned; at most 256 (a TMA box)
  G.fw = std::min(256, ((f_pad + num_sms - 1) / num_sms + 7) / 8 * 8);
  G.rk = std::min(256, OL_STAGE / (4 * G.fw));
  G.rd = OL_STAGE / (2 * hidden);
  G.nst = 0;
  if (G.rd >= 1 && hidden <= OL_MAX_HIDDEN) {
    G.C = 1;
    G.nst = ol_stages(ffn_smem(G).ring, FFN_STAGES);
    if (G.nst < 2) G.nst = 0;
  }
  const int slices = (f_pad + G.fw - 1) / G.fw;
  G.ncl = slices;
  if (G.nst > 0) {
    // the largest cluster (portable sizes) whose clusters are all resident
    const size_t smem = ffn_smem(G).total;
    for (int c = std::min(8, max_cluster); c >= 2; c /= 2) {
      const int ncl = (slices + c - 1) / c;
      if (ol_active_clusters(fused_ffn_kernel, c, smem, ncl * c) >= ncl) {
        G.C = c;
        G.ncl = ncl;
        break;
      }
    }
  }
  if (G.ncl > OL_FOLD_MAX_ROWS) G.nst = 0;      // more rows than the fold takes
  if (n_picks < 32) picks[n_picks++] = {dev, G};
  *out = G;
  return 0;
}

}  // namespace

// The launch plan of cf_fused_ffn for (hidden, f_pad) on the current
// device, into info[0..5]: blocks per cluster, blocks, ring stages, shared
// bytes per block, clusters the card holds at that size, and the f_pad
// columns per block.  Returns a cudaError_t.
extern "C" int cf_fused_ffn_plan(int hidden, int f_pad, int* info) {
  FfnGeom G;
  if (hidden < 8 || f_pad < 8) return (int)cudaErrorInvalidValue;
  CF_CHECK(ffn_geom(hidden, f_pad, &G));
  info[0] = G.C;
  info[1] = G.C * G.ncl;
  info[2] = G.nst;
  info[3] = ffn_smem(G).total;
  info[4] = G.nst ? ol_active_clusters(fused_ffn_kernel, G.C, ffn_smem(G).total,
                                       G.C * G.ncl)
                  : 0;
  info[5] = G.fw;
  return 0;
}

// Floats of scratch `cf_fused_ffn` needs for (hidden, f_pad) on the current
// device (the fold's [ncl, hidden] rows of the clusters, its group rows and
// ticket counters); zero it once, when it is allocated: every call leaves
// the counters at 0.  -1 on an error.
extern "C" long long cf_fused_ffn_scratch_floats(int hidden, int f_pad) {
  FfnGeom G;
  if (hidden < 8 || f_pad < 8 || ffn_geom(hidden, f_pad, &G) != 0) return -1;
  return ol_fold_floats(G.ncl, hidden, FFN_FOLD_GROUP);
}

// One fused FFN on `stream`, one launch.  x, residual (nullptr: no
// residual add), out and res_out are bf16 [hidden]; norm_w, w13 and w2 the
// [L, ...] stacks (or one layer), layer `layer` read.  scratch: see
// cf_fused_ffn_scratch_floats (one per stream: calls on one stream take
// turns with it).  stamps: nullptr, or zeroed uint64 [f_pad / 8 + 8]
// [OL_STAMPS] (rows past the launch's blocks stay 0) for the phases'
// times: start, norm, gate/up, act, down, cluster sum, fold, end.
// *n_launches receives the number of kernels launched.  Returns a
// cudaError_t (0 on success).
extern "C" int cf_fused_ffn(const void* x, const void* residual, const void* norm_w,
                            const void* w13, const void* w2, void* out, void* res_out,
                            void* scratch, int hidden, int f_pad, int layer, float eps,
                            void* stamps, int* n_launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *n_launches = 0;
  if (hidden < 8 || hidden % 8 != 0 || f_pad < 8 || f_pad % 8 != 0 || layer < 0 ||
      res_out == nullptr)
    return (int)cudaErrorInvalidValue;
  FfnGeom G;
  CF_CHECK(ffn_geom(hidden, f_pad, &G));
  if (G.nst == 0) return (int)cudaErrorInvalidValue;
  G.eps = eps;
  const __nv_bfloat16* nw = static_cast<const __nv_bfloat16*>(norm_w) + (size_t)layer * hidden;
  const __nv_bfloat16* w13l =
      static_cast<const __nv_bfloat16*>(w13) + (size_t)layer * 2 * hidden * f_pad;
  const __nv_bfloat16* w2l = static_cast<const __nv_bfloat16*>(w2) + (size_t)layer * f_pad * hidden;
  CUtensorMap map;
  if (!hopper::make_tensor_map_bf16_3d(&map, w13l, f_pad, hidden, 2, (uint64_t)f_pad * 2,
                                       (uint64_t)hidden * f_pad * 2, G.fw, G.rk, 2,
                                       CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  unsigned* ctr =
      reinterpret_cast<unsigned*>(
          part + (size_t)(G.ncl + ol_fold_groups(G.ncl, FFN_FOLD_GROUP)) * hidden);
  CF_CHECK(launch_kernel_cluster(fused_ffn_kernel, dim3(1, G.ncl * G.C), dim3(OL_BLOCK),
                                 ffn_smem(G).total, st, false, G.C, map, G,
                                 static_cast<const __nv_bfloat16*>(x),
                                 static_cast<const __nv_bfloat16*>(residual), nw, w2l,
                                 static_cast<__nv_bfloat16*>(out),
                                 static_cast<__nv_bfloat16*>(res_out), part, ctr,
                                 static_cast<unsigned long long*>(stamps)));
  *n_launches = 1;
  return 0;
}
