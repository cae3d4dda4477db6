// DeepSeek-V2 MLA decode layer of one bs=1 token for Hopper (sm_90a):
// RMSNorm, the fused q_nope | q_pe | ckv | k_pe projection, the q @ W_UK
// absorption, attention over the compressed cache, the @ W_UV expansion and
// the O-projection.
//
// Replaces both TPU kernels built on `_mla_kernel`
// (clusterfusion_tpu/ops/deepseek_layer.py): `deepseek_decoder_layer_fused`
// (one layer, every cache row < seq read, the current row returned) and
// `deepseek_decoder_stack_layer` (the [L, ...] weight stacks, the layer
// picked by `layer`, the current row appended in place at row seq of the
// [L, cap, stride] cache), for bf16 weights and a bf16 cache.  Layouts:
//   wproj [L, hidden, n_proj]  n_proj = heads*(nope+rope) + lora + rope
//   wuk [L, heads, nope, lora]   wuv [L, heads, lora, nope]
//   wo_t [L, heads*nope, hidden]   cache [L, cap, stride], stride >= mla
// with mla = lora + rope (576 at V2-Lite; the model's cache pads rows to
// 640 columns, which are never read and are written as zeros).
//
// What bounds it: at DeepSeek-V2-Lite a layer reads 27.5 MB of weights
// plus 1152 bytes per cached row, and does about two operations per byte,
// so bytes bound it.  The TPU kernel walks a sequential grid of cache
// chunks with a running (m, l) in VMEM; Hopper blocks run in parallel and
// in no order, so here the layer is a fixed sequence of five kernels on one
// stream (four at seq 0), each launched with programmatic dependent launch
// (PDL): a kernel starts while the one before it runs, copies what depends
// on nothing earlier in the step (its weights; the cache rows < seq, which
// earlier steps wrote) into shared memory, and only then waits for the
// kernels before it (griddepcontrol.wait):
//   gemv      proj = bf16(rmsnorm(x) * rms_in) @ wproj[l]   (f32; the ring
//             GEMV, common.cuh, each block normalising x as it stages it;
//             K chunks summed in rank order inside a cluster, y written)
//   absorb    per (head, 64 columns): q = [bf16(q_nope[h]) @ wuk[h] |
//             rope(q_pe[h])] * scale * log2(e), kept in f32 (qs) and
//             rounded to bf16 (qb); the weight slice bulk-copied first
//   split     per block of `split` rows < seq, all heads at once: the rows
//             bulk-copied first; scores [heads x rows] over the mla columns
//             and p.V [heads x lora] on mma.sync m16n8k16 with the heads
//             as M; p = exp2(s - m_split) rounded to bf16 against the first
//             lora columns (the compressed row doubles as V); one partial
//             (m, l, acc[lora]) per (split, head)
//   merge     per (head, 128-row chunk of lora), the chunks of a head one
//             cluster: the W_UV chunk bulk-copied first; cur = [rmsnorm(ckv)
//             | rope(k_pe)] in f32, the current token and the splits folded
//             in f32 in split order (the splits' weights computed once, a
//             slice of the splits per thread, the slices added in order),
//             o = bf16(acc / l) on the chunk, its
//             share of o @ wuv[h], the chunks' shares summed in rank order
//             through distributed shared memory, o_nope[h] = bf16(sum);
//             block (0, 0) writes bf16(cur) to the cache row (append) or to
//             ckv_new
//   gemv      out = bf16(o_nope @ wo_t[l])   (the ring GEMV, bf16 epilogue)
// Every sum has a fixed order, so a call's bits repeat.  Cache rows at and
// above seq are never read.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int MLA_THREADS = 256;
constexpr int MAX_HEADS = 32;
constexpr int ABSORB_COLS = 64;    // q columns per absorb block
constexpr int MERGE_KC = 128;      // lora rows of W_UV per merge block
constexpr int MERGE_MAX_CLUSTER = 8;
constexpr int GEMV_RED = MLA_THREADS * 8;   // floats of smem_gemv's sums

// NEOX rope of element d of a rope-wide row x.  cos/sin hold rope / 2
// values, or rope values whose second half repeats the first (the full-dim
// tables); only the first half is read.
__device__ __forceinline__ float mla_rope_at(const float* x, int d, int rope,
                                             const float* cos, const float* sin) {
  const int half = rope / 2, j = d % half;
  const float rot = d < half ? -x[d + half] : x[d - half];
  return x[d] * cos[j] + rot * sin[j];
}

// y[n] = scale * sum_k xs[k] * w[k * N + n] for n < N, in one block: xs (K
// floats) and w (bf16 [K][N]) in shared memory.  Threads take 8 adjacent
// columns each (one 16-byte load per weight row) and split K into
// blockDim / (N/8) phases, which meet in `red` (GEMV_RED floats) in phase
// order.  Writes y to out_f (f32) and bf16(y) to out_b, where given.
// Needs N % 8 == 0 and N <= 8 * blockDim.
__device__ void smem_gemv(const float* xs, const __nv_bfloat16* w, int K, int N, float scale,
                          float* red, float* out_f, __nv_bfloat16* out_b) {
  const int tid = threadIdx.x;
  const int ngrp = N / 8, P = blockDim.x / ngrp;
  const int cg = tid % ngrp, ph = tid / ngrp;
  if (ph < P) {
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    const __nv_bfloat16* wc = w + cg * 8;
#pragma unroll 4
    for (int k = ph; k < K; k += P) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(wc + (size_t)k * N), f);
      const float xk = xs[k];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(xk, f[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) red[ph * N + cg * 8 + c] = acc[c];
  }
  __syncthreads();
  for (int n = tid; n < N; n += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < P; ++q) s += red[q * N + n];
    s *= scale;
    if (out_f) out_f[n] = s;
    if (out_b) out_b[n] = __float2bfloat16(s);
  }
}

// The scaled q of head h = blockIdx.x, row h of qs (f32) and qb (bf16)
// [heads, lora + rope]: columns c0 = blockIdx.y * ABSORB_COLS .. of
// bf16(q_nope[h]) @ wuk[h] (q_nope[h] is proj[h*nope ..]), and, in the
// blocks with blockIdx.y = 0, rope(q_pe[h]) in the last rope columns.
// cos/sin as mla_rope_at takes them.
__global__ void __launch_bounds__(MLA_THREADS)
mla_absorb_kernel(const float* __restrict__ proj, const __nv_bfloat16* __restrict__ wuk,
                  const float* __restrict__ cos, const float* __restrict__ sin,
                  float* __restrict__ qs, __nv_bfloat16* __restrict__ qb, int heads,
                  int nope, int rope, int lora, float scale) {
  extern __shared__ __align__(128) unsigned char ab_sm[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(ab_sm);
  __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(ab_sm + 16);     // [nope][ABSORB_COLS]
  float* xs = reinterpret_cast<float*>(w + nope * ABSORB_COLS);          // [nope]
  float* red = xs + nope;                                                // [GEMV_RED]
  const int h = blockIdx.x, c0 = blockIdx.y * ABSORB_COLS, mla = lora + rope;
  const int tid = threadIdx.x, lane = tid % 32;
  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid < 32) {                      // the weight slice: nope rows of 128 bytes
    if (lane == 0) hopper::mbar_arrive_expect_tx(bar, (uint32_t)nope * ABSORB_COLS * 2);
    __syncwarp();
    for (int k = lane; k < nope; k += 32)
      hopper::bulk_load_1d(w + k * ABSORB_COLS, wuk + ((size_t)h * nope + k) * lora + c0,
                           ABSORB_COLS * 2, bar);
  }
  hopper::grid_dep_launch_dependents();
  hopper::grid_dep_wait();             // proj comes from the projection
  for (int k = tid; k < nope; k += blockDim.x) xs[k] = bf16_round(proj[(size_t)h * nope + k]);
  if (blockIdx.y == 0) {
    const float* qpe = proj + (size_t)heads * nope + (size_t)h * rope;
    for (int d = tid; d < rope; d += blockDim.x) {
      const float v = mla_rope_at(qpe, d, rope, cos, sin) * scale;
      qs[(size_t)h * mla + lora + d] = v;
      qb[(size_t)h * mla + lora + d] = __float2bfloat16(v);
    }
  }
  __syncthreads();
  hopper::mbar_wait(bar, 0);
  smem_gemv(xs, w, nope, ABSORB_COLS, scale, red, qs + (size_t)h * mla + c0,
            qb + (size_t)h * mla + c0);
}

// bf16 row pitch (elements) of the split pass's row and q tiles: mla plus
// a pad that makes the pitch an odd number of 16-byte units, so the eight
// rows an ldmatrix reads fall in distinct banks.
__host__ __device__ inline int mla_pitch(int mla) {
  const int u = mla / 8;
  return (u % 2 ? u + 2 : u + 1) * 8;
}

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

inline size_t mla_split_smem(int heads, int mla, int split) {
  const int hp = round16(heads), pitch = mla_pitch(mla), kp = 8 / (split / 8);
  return 16 + 2 * (size_t)(split + hp) * pitch + 4 * (size_t)kp * hp * split +
         2 * (size_t)hp * (split + 8);
}

// Split pass over compressed rows [s*split, min((s+1)*split, seq)) for all
// heads, s = blockIdx.x, with qb the bf16 scaled q [heads, mla].  Writes
// part_ml [ns, heads, 2] (max, sum) and part_acc [ns, heads, lora].
// split is 16, 32 or 64 (split / 8 n-tiles of the scores, 8 / (split / 8)
// parts of the mla columns, one per warp).
__global__ void __launch_bounds__(MLA_THREADS)
mla_split_kernel(const __nv_bfloat16* __restrict__ qb_g,
                 const __nv_bfloat16* __restrict__ cache, int stride,
                 float* __restrict__ part_ml, float* __restrict__ part_acc, int heads,
                 int rope, int lora, int seq, int split) {
  extern __shared__ __align__(128) unsigned char sp_sm[];
  const int mla = lora + rope, pitch = mla_pitch(mla), hp = round16(heads);
  const int nt_n = split / 8, kparts = 8 / nt_n, pp = split + 8;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sp_sm);
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(sp_sm + 16);   // [split][pitch]
  __nv_bfloat16* qt = rows + (size_t)split * pitch;                      // [hp][pitch]
  float* sc = reinterpret_cast<float*>(qt + (size_t)hp * pitch);        // [kparts][hp][split]
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(sc + kparts * hp * split);  // [hp][pp]
  const int s = blockIdx.x, j0 = s * split, n = min(split, seq - j0);
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int g = lane / 4, t = lane % 4;
  if (tid == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (wid == 0) {                      // the split's rows, one copy each
    if (lane == 0) hopper::mbar_arrive_expect_tx(&bar[0], (uint32_t)n * mla * 2);
    __syncwarp();
    for (int j = lane; j < n; j += 32)
      hopper::bulk_load_1d(rows + (size_t)j * pitch, cache + (size_t)(j0 + j) * stride,
                           (uint32_t)mla * 2, &bar[0]);
  }
  // rows past the split's end read as 0 in p.V (no copy lands there), and
  // so do the q rows of heads past `heads`
  const int kend = round16(n);
  for (int e = tid; e < (kend - n) * (lora / 8); e += blockDim.x)
    *reinterpret_cast<uint4*>(rows + (size_t)(n + e / (lora / 8)) * pitch + (e % (lora / 8)) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < (hp - heads) * (mla / 8); e += blockDim.x)
    *reinterpret_cast<uint4*>(qt + (size_t)(heads + e / (mla / 8)) * pitch + (e % (mla / 8)) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  hopper::grid_dep_launch_dependents();
  hopper::grid_dep_wait();             // qb comes from the absorb kernel
  if (wid == 0) {                      // q, one copy per head
    if (lane == 0) hopper::mbar_arrive_expect_tx(&bar[1], (uint32_t)heads * mla * 2);
    __syncwarp();
    for (int hh = lane; hh < heads; hh += 32)
      hopper::bulk_load_1d(qt + (size_t)hh * pitch, qb_g + (size_t)hh * mla,
                           (uint32_t)mla * 2, &bar[1]);
  }
  __syncthreads();
  hopper::mbar_wait(&bar[0], 0);
  hopper::mbar_wait(&bar[1], 0);

  // scores: warp w takes n-tile w % nt_n (8 rows) over part w / nt_n of the
  // mla columns; each k step's products sum in the mma from 0 and the steps
  // add in float32
  {
    const int nt = wid % nt_n, kp = wid / nt_n, ks_all = mla / 16;
    const int k0 = kp * ks_all / kparts, k1 = (kp + 1) * ks_all / kparts;
    for (int mt = 0; mt < hp / 16; ++mt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = k0; ks < k1; ++ks) {
        uint32_t a[4], b[2];
        hopper::ldmatrix_x4(a, qt + (size_t)(mt * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * pitch +
                                   ks * 16 + 8 * (lane / 16));
        hopper::ldmatrix_x2(b, rows + (size_t)(nt * 8 + lane % 8) * pitch + ks * 16 +
                                   8 * ((lane / 8) % 2));
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        hopper::mma_m16n8k16_bf16(p, a, b[0], b[1]);
#pragma unroll
        for (int c = 0; c < 4; ++c) d[c] += p[c];
      }
      float* out = sc + ((size_t)kp * hp + mt * 16) * split + nt * 8 + 2 * t;
      out[g * split] = d[0];
      out[g * split + 1] = d[1];
      out[(g + 8) * split] = d[2];
      out[(g + 8) * split + 1] = d[3];
    }
  }
  __syncthreads();

  // softmax statistics: warp w takes heads w, w+8, ...; the parts of a
  // score add in part order; rows past the end and heads past `heads` get
  // p = 0 (by select)
  for (int h = wid; h < hp; h += 8) {
    if (h >= heads) {
      for (int j = lane; j < split; j += 32) pt[h * pp + j] = __float2bfloat16(0.f);
      continue;
    }
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32) {
      float v = 0.f;
      for (int kp = 0; kp < kparts; ++kp) v += sc[((size_t)kp * hp + h) * split + j];
      sc[(size_t)h * split + j] = v;         // part 0 holds the sum from here on
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < split; j += 32) {
      const float p = j < n ? exp2f(sc[(size_t)h * split + j] - mx) : 0.f;
      sum += p;
      pt[h * pp + j] = __float2bfloat16(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_ml[((size_t)s * heads + h) * 2] = mx;
      part_ml[((size_t)s * heads + h) * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // p.V over the first lora columns: warp w takes column pairs of n-tiles
  // (16 columns) w, w+8, ...; the rows to round16(n), past n zero
  for (int mt = 0; mt < hp / 16; ++mt) {
    for (int np = wid; np < lora / 16; np += 8) {
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kb = 0; kb < kend; kb += 16) {
        uint32_t a[4], bf[4];
        hopper::ldmatrix_x4(a, pt + (size_t)(mt * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * pp +
                                   kb + 8 * (lane / 16));
        const int j = lane / 8;
        hopper::ldmatrix_x4_trans(bf, rows + (size_t)(kb + (j & 1) * 8 + lane % 8) * pitch +
                                          np * 16 + (j >> 1) * 8);
        float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
        hopper::mma_m16n8k16_bf16(p0, a, bf[0], bf[1]);
        hopper::mma_m16n8k16_bf16(p1, a, bf[2], bf[3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          d0[c] += p0[c];
          d1[c] += p1[c];
        }
      }
      const int col = np * 16 + 2 * t;
      for (int half = 0; half < 2; ++half) {
        const int h = mt * 16 + g + 8 * half;
        if (h < heads) {
          float* out = part_acc + ((size_t)s * heads + h) * lora + col;
          *reinterpret_cast<float2*>(out) = make_float2(d0[2 * half], d0[2 * half + 1]);
          *reinterpret_cast<float2*>(out + 8) = make_float2(d1[2 * half], d1[2 * half + 1]);
        }
      }
    }
  }
}

// Merge of head h = blockIdx.x on lora rows c0 = blockIdx.y * kc .. (the
// cluster rank; the gridDim.y blocks of a head form one cluster): the
// current token (f32 qs[h] . f32 cur) and the ns split partials folded in
// split order, o = bf16(acc / l) on the block's rows, its share of
// o @ wuv[h] (kc rows of W_UV, bulk-copied before the wait), the ranks'
// shares summed in rank order, o_nope[h] = bf16(sum).  Block (0, 0) writes
// bf16(cur) to `row` (row_cols columns, zero past mla) and to ckv_new (mla
// columns) where they are given.
__global__ void __launch_bounds__(MLA_THREADS)
mla_merge_kernel(const float* __restrict__ proj, const float* __restrict__ qs,
                 const __nv_bfloat16* __restrict__ rms_ckv, const float* __restrict__ cos,
                 const float* __restrict__ sin, const float* __restrict__ part_ml,
                 const float* __restrict__ part_acc, const __nv_bfloat16* __restrict__ wuv,
                 __nv_bfloat16* __restrict__ o_nope, __nv_bfloat16* __restrict__ row,
                 int row_cols, __nv_bfloat16* __restrict__ ckv_new, int heads, int nope,
                 int rope, int lora, int ns, int kc, float eps) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char mg_sm[];
  __shared__ float red32[32];
  __shared__ float stat[2];
  const int mla = lora + rope;
  uint64_t* bar = reinterpret_cast<uint64_t*>(mg_sm);                // [2]: W_UV, inputs
  __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(mg_sm + 16);   // [kc][nope]
  float* cur = reinterpret_cast<float*>(w + (size_t)kc * nope);       // [mla] current row
  float* o = cur + mla;                                               // [kc]
  float* part = o + kc;                                               // [nope]
  float* red = part + nope;                                           // [GEMV_RED]
  float* wsp = red + GEMV_RED;                                        // [ns] split weights
  float* ckv = wsp + (ns + 3) / 4 * 4;                                // [mla] raw ckv | k_pe
  float* q = ckv + mla;                                               // [mla] q of head h
  float* pml = q + mla;                                               // [ns][heads][2]
  const int h = blockIdx.x, rank = blockIdx.y, ranks = gridDim.y, c0 = rank * kc;
  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {                      // W_UV rows c0 .. c0 + kc of head h: contiguous
    const uint32_t bytes = (uint32_t)kc * nope * 2;
    hopper::mbar_arrive_expect_tx(bar, bytes);
    hopper::bulk_load_1d(w, wuv + ((size_t)h * lora + c0) * nope, bytes, bar);
  }
  hopper::grid_dep_launch_dependents();
  hopper::grid_dep_wait();             // proj, qs and the partials
  // the current row's raw ckv | k_pe, q of this head and the splits'
  // (max, sum): one round trip, one copy each
  if (tid == 0) {
    const uint32_t row_b = (uint32_t)mla * 4;
    const uint32_t ml_b = ((uint32_t)ns * heads * 2 * 4 + 15) / 16 * 16;   // scratch follows
    hopper::mbar_arrive_expect_tx(&bar[1], 2 * row_b + ml_b);
    hopper::bulk_load_1d(ckv, proj + (size_t)heads * (nope + rope), row_b, &bar[1]);
    hopper::bulk_load_1d(q, qs + (size_t)h * mla, row_b, &bar[1]);
    if (ns > 0) hopper::bulk_load_1d(pml, part_ml, ml_b, &bar[1]);
  }
  hopper::mbar_wait(&bar[1], 0);
  const float* kpe = ckv + lora;
  float ss = 0.f;
  for (int c = tid; c < lora; c += blockDim.x) ss += ckv[c] * ckv[c];
  const float inv = rsqrtf(block_sum(ss, red32) / lora + eps);
  for (int c = tid; c < mla; c += blockDim.x)
    cur[c] = c < lora ? ckv[c] * inv * __bfloat162float(rms_ckv[c])
                      : mla_rope_at(kpe, c - lora, rope, cos, sin);
  __syncthreads();
  float dot = 0.f;
  for (int c = tid; c < mla; c += blockDim.x) dot += q[c] * cur[c];
  const float s_cur = block_sum(dot, red32);
  if (tid < 32) {                      // the splits' weights: lanes over splits
    float mx = s_cur;
    for (int s = tid; s < ns; s += 32) mx = fmaxf(mx, pml[((size_t)s * heads + h) * 2]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = tid; s < ns; s += 32) {
      const float* ml = pml + ((size_t)s * heads + h) * 2;
      const float ws = exp2f(ml[0] - mx);
      wsp[s] = ws;
      l = fmaf(ml[1], ws, l);
    }
    l = warp_sum(l);
    if (tid == 0) {
      stat[0] = mx;
      stat[1] = l + exp2f(s_cur - mx);
    }
  }
  __syncthreads();
  const float mx = stat[0], l = stat[1], pc = exp2f(s_cur - mx);
  // the splits' sums of the block's kc columns: thread (4-column group,
  // slice of the splits), the slices then added in slice order
  {
    const int ngrp = kc / 4, slices = blockDim.x / ngrp;
    const int cq = tid % ngrp, sl = tid / ngrp;
    if (sl < slices) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int s = sl; s < ns; s += slices) {
        const float4 v = *reinterpret_cast<const float4*>(
            part_acc + ((size_t)s * heads + h) * lora + c0 + cq * 4);
        const float ws = wsp[s];
        acc.x = fmaf(v.x, ws, acc.x);
        acc.y = fmaf(v.y, ws, acc.y);
        acc.z = fmaf(v.z, ws, acc.z);
        acc.w = fmaf(v.w, ws, acc.w);
      }
      *reinterpret_cast<float4*>(red + sl * kc + cq * 4) = acc;
    }
    __syncthreads();
    for (int k = tid; k < kc; k += blockDim.x) {
      float acc = pc * cur[c0 + k];
      for (int q2 = 0; q2 < slices; ++q2) acc += red[q2 * kc + k];
      o[k] = bf16_round(acc / l);
    }
  }
  if (h == 0 && rank == 0) {
    for (int c = tid; c < row_cols; c += blockDim.x) {
      const __nv_bfloat16 v = __float2bfloat16(c < mla ? cur[c] : 0.f);
      if (row) row[c] = v;
      if (ckv_new && c < mla) ckv_new[c] = v;
    }
  }
  __syncthreads();
  hopper::mbar_wait(bar, 0);
  smem_gemv(o, w, kc, nope, 1.f, red, part, nullptr);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                      // every rank's share is in its shared memory
  const int per = nope / ranks;
  for (int c = tid; c < per; c += blockDim.x) {
    const int col = rank * per + c;
    float v = 0.f;
    for (int q2 = 0; q2 < ranks; ++q2) v += cluster.map_shared_rank(part, q2)[col];
    o_nope[(size_t)h * nope + col] = __float2bfloat16(v);
  }
  cluster.sync();                      // peers have read this block's share
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// lora rows of W_UV per merge block: MERGE_KC when it divides lora into at
// most MERGE_MAX_CLUSTER chunks, else all of lora in one block.
int mla_merge_kc(int lora) {
  return lora % MERGE_KC == 0 && lora / MERGE_KC <= MERGE_MAX_CLUSTER ? MERGE_KC : lora;
}

struct MlaScratch {
  float *proj, *qs, *part_ml, *part_acc;
  __nv_bfloat16 *qb, *o_nope;
  size_t floats;
};

MlaScratch mla_layout(float* base, int hidden, int heads, int nope, int rope, int lora,
                      int seq, int split) {
  const size_t n_proj = (size_t)heads * (nope + rope) + lora + rope;
  const size_t ns = seq > 0 ? (size_t)(seq + split - 1) / split : 0;
  size_t off = 0;
  MlaScratch s;
  auto take = [&](size_t n) {
    float* p = base ? base + off : nullptr;
    off += align16(n);
    return p;
  };
  s.proj = take(n_proj);
  s.qs = take((size_t)heads * (lora + rope));
  s.part_ml = take(ns * heads * 2);
  s.part_acc = take(ns * heads * lora);
  s.qb = reinterpret_cast<__nv_bfloat16*>(take(((size_t)heads * (lora + rope) + 1) / 2));
  s.o_nope = reinterpret_cast<__nv_bfloat16*>(take(((size_t)heads * nope + 1) / 2));
  s.floats = off;
  return s;
}

}  // namespace

// Floats of f32 scratch `cf_mla_decode` needs for `seq` cached rows.
extern "C" long long cf_mla_scratch_floats(int hidden, int heads, int nope, int rope,
                                           int lora, int seq, int split) {
  return (long long)mla_layout(nullptr, hidden, heads, nope, rope, lora, seq, split).floats;
}

// One MLA decode layer on `stream`, reading cache rows < seq of layer
// `layer` (5 launches, 4 at seq 0).  append != 0: bf16(cur) is written to
// row seq of that layer (stride columns, zero past mla; seq < cap);
// ckv_new (bf16 [mla], or nullptr) receives the same row.  out is bf16
// [hidden].  *n_launches receives the number of kernels launched.  Returns
// a cudaError_t (0 on success).
extern "C" int cf_mla_decode(const void* x, const void* rms_in, const void* rms_ckv,
                             const void* cos, const void* sin, const void* wproj,
                             const void* wuk, const void* wuv, const void* wo, void* cache,
                             void* out, void* ckv_new, void* scratch, int hidden, int heads,
                             int nope, int rope, int lora, int cap, int stride, int seq,
                             int layer, int append, float eps, float softmax_scale,
                             int split, int threads, int* n_launches, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *n_launches = 0;
  const int mla = lora + rope;
  const int n_proj = heads * (nope + rope) + mla;
  const int kc = mla_merge_kc(lora), ranks = lora / kc;
  if (heads < 1 || heads > MAX_HEADS || nope % 8 != 0 || lora % ABSORB_COLS != 0 ||
      rope % 8 != 0 || mla % 16 != 0 || nope > 8 * MLA_THREADS || nope % ranks != 0 ||
      hidden % 8 != 0 || stride < mla || stride % 8 != 0 ||
      (split != 16 && split != 32 && split != 64) || seq < 0 || seq > cap ||
      (append && seq >= cap) || layer < 0 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  MlaScratch s = mla_layout(static_cast<float*>(scratch), hidden, heads, nope, rope, lora,
                            seq, split);
  const __nv_bfloat16* rin = static_cast<const __nv_bfloat16*>(rms_in) + (size_t)layer * hidden;
  const __nv_bfloat16* rckv = static_cast<const __nv_bfloat16*>(rms_ckv) + (size_t)layer * lora;
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(wproj) + (size_t)layer * hidden * n_proj;
  const __nv_bfloat16* wk = static_cast<const __nv_bfloat16*>(wuk) + (size_t)layer * heads * nope * lora;
  const __nv_bfloat16* wv = static_cast<const __nv_bfloat16*>(wuv) + (size_t)layer * heads * lora * nope;
  const __nv_bfloat16* wol = static_cast<const __nv_bfloat16*>(wo) + (size_t)layer * heads * nope * hidden;
  __nv_bfloat16* cl = static_cast<__nv_bfloat16*>(cache) + (size_t)layer * cap * stride;
  const float* cosf = static_cast<const float*>(cos);
  const float* sinf = static_cast<const float*>(sin);
  const float scale = softmax_scale * LOG2E;
  const int ns = (seq + split - 1) / split;
  const size_t absorb_smem = 16 + 2 * (size_t)nope * ABSORB_COLS + 4 * ((size_t)nope + GEMV_RED);
  const size_t split_smem = mla_split_smem(heads, mla, split);
  const size_t merge_smem =
      16 + 2 * (size_t)kc * nope +
      4 * ((size_t)mla + kc + nope + GEMV_RED + (ns + 3) / 4 * 4 + 2 * mla +
           (size_t)ns * heads * 2 + 4);
  static size_t set[3] = {0, 0, 0};     // the dynamic sizes set so far
  const void* kerns[3] = {(const void*)mla_absorb_kernel, (const void*)mla_split_kernel,
                          (const void*)mla_merge_kernel};
  const size_t smems[3] = {absorb_smem, split_smem, merge_smem};
  for (int i = 0; i < 3; ++i) {
    if (smems[i] > (size_t)227 * 1024) return (int)cudaErrorInvalidValue;
    if (smems[i] > set[i]) {
      CF_CHECK((int)cudaFuncSetAttribute(kerns[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smems[i]));
      set[i] = smems[i];
    }
  }

  CF_CHECK(launch_gemv1<false>(x, 0, wp, s.proj, hidden, n_proj, 1, 0, 0, threads, true, st,
                               nullptr, rin, eps));
  ++*n_launches;
  CF_CHECK(launch_kernel(mla_absorb_kernel, dim3(heads, lora / ABSORB_COLS), dim3(MLA_THREADS),
                         absorb_smem, st, true, s.proj, wk, cosf, sinf, s.qs, s.qb, heads, nope,
                         rope, lora, scale));
  ++*n_launches;
  if (ns > 0) {
    CF_CHECK(launch_kernel(mla_split_kernel, dim3(ns), dim3(MLA_THREADS), split_smem, st, true,
                           s.qb, cl, stride, s.part_ml, s.part_acc, heads, rope, lora, seq,
                           split));
    ++*n_launches;
  }
  CF_CHECK(launch_kernel_cluster(
      mla_merge_kernel, dim3(heads, ranks), dim3(MLA_THREADS), merge_smem, st, true, ranks,
      s.proj, s.qs, rckv, cosf, sinf, s.part_ml, s.part_acc, wv, s.o_nope,
      append ? cl + (size_t)seq * stride : nullptr, append ? stride : mla,
      static_cast<__nv_bfloat16*>(ckv_new), heads, nope, rope, lora, ns, kc, eps));
  ++*n_launches;
  CF_CHECK(launch_gemv1<false>(s.o_nope, 0, wol, nullptr, heads * nope, hidden, 1, 0, 0,
                               threads, true, st, static_cast<__nv_bfloat16*>(out)));
  ++*n_launches;
  return 0;
}
