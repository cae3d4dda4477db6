// How fast blocks stream device memory into shared memory on a Hopper card,
// by copy pattern: one 16 KB contiguous bulk copy a stage, a 2-D TMA box a
// stage (lines of 128-512 bytes, four blocks reading the column slices of
// the same rows), or one bulk copy per row issued by a warp's lanes; 96,
// 128 and 132 blocks of one block per SM, each streaming 1 MiB through an
// 8-stage ring of 16 KB stages with nothing computed.  It measured the
// per-block cap that sizes kernels 5 and 6 (PERF.md).  Build and run on the
// card from the repository root:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -I clusterfusion_tpu_torch/csrc scripts/tma_stream_bench.cu -o /tmp/tma_stream_bench
//   /tmp/tma_stream_bench
#include <cstdio>
#include <cstring>
#include <cstdint>
#include <vector>
#include "hopper.cuh"
constexpr int STAGE = 16384, NS = 8, T = 256;
struct P { int mode, W, rows_per_box, slices; long long pitch, region; int per_block_tiles; };
__global__ void __launch_bounds__(T, 1) k(const __grid_constant__ CUtensorMap map, P p, const unsigned char* base, float* sink) {
  extern __shared__ __align__(1024) unsigned char sm[];
  uint64_t* full = (uint64_t*)sm; unsigned char* ring = sm + 1024;
  int b = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) { for (int s = 0; s < NS; ++s) hopper::mbar_init(&full[s], 1); hopper::fence_barrier_init(); }
  __syncthreads();
  const int slice = b % p.slices, reg = b / p.slices;
  auto issue = [&](int u) {
    int s = u % NS; unsigned char* dst = ring + s * STAGE;
    if (p.mode == 0) {            // 1-D contiguous 16 KB
      if (tid == 0) { hopper::mbar_arrive_expect_tx(&full[s], STAGE);
        hopper::bulk_load_1d(dst, base + (long long)b * p.region + (long long)u * STAGE, STAGE, &full[s]); }
    } else if (p.mode == 1) {     // 2-D box W x rows
      if (tid == 0) { hopper::mbar_arrive_expect_tx(&full[s], p.W * 2 * p.rows_per_box);
        hopper::tma_load_3d(dst, &map, &full[s], slice * p.W, reg * p.rows_per_box * p.per_block_tiles + u * p.rows_per_box, 0); }
    } else {                      // 1-D bulk per row, lanes of warp 0
      if (tid < 32) {
        if (tid == 0) hopper::mbar_arrive_expect_tx(&full[s], p.W * 2 * p.rows_per_box);
        __syncwarp();
        for (int r = tid; r < p.rows_per_box; r += 32)
          hopper::bulk_load_1d(dst + r * p.W * 2, base + (long long)(reg * p.rows_per_box * p.per_block_tiles + u * p.rows_per_box + r) * p.pitch + slice * p.W * 2, p.W * 2, &full[s]);
      }
    }
  };
  if (tid < 32) for (int s = 0; s < NS && s < p.per_block_tiles; ++s) issue(s);
  float acc = 0.f;
  for (int u = 0; u < p.per_block_tiles; ++u) {
    hopper::mbar_wait(&full[u % NS], (u / NS) & 1);
    acc += ((float*)(ring + (u % NS) * STAGE))[tid];
    __syncthreads();
    if (tid < 32 && u + NS < p.per_block_tiles) issue(u + NS);
  }
  if (acc == 12345.f) sink[b] = acc;
}
int main() {
  const long long TOTAL = 1ll << 30;   // 1 GiB buffer
  unsigned char* buf; cudaMalloc(&buf, TOTAL); cudaMemset(buf, 1, TOTAL);
  float* sink; cudaMalloc(&sink, 4096);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 1024 + NS * STAGE);
  const long long per_block = 1ll << 20;   // 1 MiB per block
  for (int nb : {96, 128, 132}) {
    for (int cfg = 0; cfg < 8; ++cfg) {
      P p{}; CUtensorMap map; memset(&map, 0, sizeof(map));
      const char* name = "";
      p.per_block_tiles = per_block / STAGE;
      if (cfg == 0) { p.mode = 0; p.region = per_block; name = "bulk1d 16KB contiguous"; p.slices = 1; }
      else {
        int W = cfg == 1 ? 64 : cfg == 2 ? 96 : cfg == 3 ? 128 : cfg == 4 ? 256 : cfg == 5 ? 128 : cfg == 6 ? 384 : 256;
        p.mode = cfg <= 4 ? 1 : 2;
        p.W = W; p.slices = 4; p.pitch = (long long)W * 2 * 4; p.rows_per_box = STAGE / (W * 2);
        if (p.mode == 2 && p.rows_per_box > 32) p.rows_per_box = 32;
        p.per_block_tiles = per_block / (p.rows_per_box * W * 2);
        long long rows_total = (long long)((nb + 3) / 4) * p.rows_per_box * p.per_block_tiles;
        if (p.mode == 1)
          hopper::make_tensor_map_bf16_3d(&map, buf, W * 4, rows_total, 1, p.pitch, p.pitch * rows_total, W, p.rows_per_box, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
        static char nm[64]; snprintf(nm, 64, "%s W=%d (%d B lines), 4 blocks/row", p.mode == 1 ? "tma2d" : "bulk-per-row", W, W * 2); name = nm;
      }
      cudaEvent_t a, bb; cudaEventCreate(&a); cudaEventCreate(&bb);
      for (int w = 0; w < 2; ++w) k<<<nb, T, 1024 + NS * STAGE>>>(map, p, buf, sink);
      cudaEventRecord(a);
      for (int r = 0; r < 10; ++r) k<<<nb, T, 1024 + NS * STAGE>>>(map, p, buf, sink);
      cudaEventRecord(bb); cudaEventSynchronize(bb);
      float ms; cudaEventElapsedTime(&ms, a, bb);
      double bytes = (double)nb * p.per_block_tiles * (p.mode == 0 ? STAGE : p.rows_per_box * p.W * 2) * 10;
      printf("nb=%3d %-48s %.3f TB/s (%.1f GB/s per block) err=%s\n", nb, name, bytes / ms / 1e9, bytes / ms / 1e6 / nb, cudaGetErrorString(cudaGetLastError()));
    }
  }
  return 0;
}
