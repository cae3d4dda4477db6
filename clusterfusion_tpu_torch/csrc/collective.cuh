// The all-reduce protocol of kernel 13 (see the note at the top of
// collective.cu): the communicator a kernel is given, and the device
// functions of one reduce -- the push, the publish, the bounded wait and
// the rank-order sum.  The standalone kernels of collective.cu run them, and
// so do the ring GEMV and the residual norm of common.cuh, which carry the
// stack kernel's reduces (stack_kernel.cu, mode 5) inside its own launches.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

constexpr int CF_MAX_RANKS = 8;

// One rank's view of the symmetric buffers of one mesh axis (made by
// cf_comm_new; kernels take it by value): bufs[p] is rank p's buffer as
// this process maps it, bufs[rank] its own; err is the device address of a
// host-mapped error word.
struct CfComm {
  int rank, size;
  long long slot_bytes;
  char* bufs[CF_MAX_RANKS];
  int* err;
};

namespace {

constexpr int COMM_MAX_BLOCKS = 32;                  // flag columns per source
constexpr int COMM_TILE = 256;       // columns per flag column of the stack's reduces
constexpr long long COMM_FLAGS_OFF = 128;
constexpr long long COMM_DATA_OFF = 2048;
constexpr unsigned long long COMM_TIMEOUT_NS = 2000000000ull;

// bufs[p] by selects over constant indices: an array of a kernel's
// parameter indexed at run time would be copied to local memory first.
__device__ __forceinline__ char* comm_buf(const CfComm& c, int p) {
  char* b = c.bufs[0];
#pragma unroll
  for (int q = 1; q < CF_MAX_RANKS; ++q)
    if (p == q) b = c.bufs[q];
  return b;
}

__device__ __forceinline__ unsigned* comm_flag(char* buf, int src, int col) {
  return reinterpret_cast<unsigned*>(buf + COMM_FLAGS_OFF) + src * COMM_MAX_BLOCKS + col;
}

// Slot `src` of `bank` in `buf`, as 16-byte units.
__device__ __forceinline__ uint4* comm_slot(char* buf, int bank, int src, int size,
                                            long long slot_bytes) {
  return reinterpret_cast<uint4*>(buf + COMM_DATA_OFF +
                                  ((long long)bank * size + src) * slot_bytes);
}

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_sys(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The epoch of rank `rank`'s next reduce: one past the last one its
// buffer records (the control word, ctl[0]).
__device__ __forceinline__ unsigned comm_next_epoch(const CfComm& c, int rank) {
  return *reinterpret_cast<volatile unsigned*>(comm_buf(c, rank)) + 1u;
}

__device__ __forceinline__ void comm_set_epoch(const CfComm& c, int rank, unsigned e) {
  atomicExch(reinterpret_cast<unsigned*>(comm_buf(c, rank)), e);
}

// Push: unit i (16 bytes) of rank `src`'s data into slot `src` of bank
// e % 2 of rank p's buffer.
__device__ __forceinline__ void comm_push(const CfComm& c, int src, int p, unsigned e,
                                          long long i, uint4 v) {
  comm_slot(comm_buf(c, p), e & 1, src, c.size, c.slot_bytes)[i] = v;
}

// Publish (one thread per peer p, after every push of the column is
// ordered before it): flag [src][col] of rank p's buffer := e, as
// fence.acq_rel.sys then a relaxed store, one release pattern.  (A release
// store after the fence would fence again: a second MEMBAR.SYS, which cost
// each producing GEMV ~1.6 µs on the H100.)
__device__ __forceinline__ void comm_publish(const CfComm& c, int src, int p, int col,
                                             unsigned e) {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
  st_relaxed_sys(comm_flag(comm_buf(c, p), src, col), e);
}

// Bounded wait (rank `rank` for flag [p][col] of its own buffer to reach
// e): false, with 0x10000 | rank << 8 | p in the error word, when 2 s of
// %globaltimer pass, or at once when the word already holds an earlier
// failure (so a step whose peer died fails once, not once per reduce).
__device__ __forceinline__ bool comm_wait(const CfComm& c, int rank, int p, int col,
                                          unsigned e) {
  const unsigned* f = comm_flag(comm_buf(c, rank), p, col);
  unsigned long long t0 = 0;
  for (unsigned spins = 1; (int)(ld_acquire_sys(f) - e) < 0; ++spins) {
    if ((spins & 255u) == 0) {
      const unsigned long long t = hopper::global_ns();
      if (t0 == 0) {
        t0 = t;
        if (*reinterpret_cast<volatile int*>(c.err) != 0) return false;
      } else if (t - t0 > COMM_TIMEOUT_NS) {
        atomicCAS_system(c.err, 0, 0x10000 | (rank << 8) | p);
        return false;
      }
    }
  }
  return true;
}

__device__ __forceinline__ float comm_add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 comm_add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Rank-order sum: element i (a float or a float4) of slots 0, 1, ...,
// size-1 of bank e % 2 of rank `rank`'s buffer, added in that order in
// float32, so that every rank gets the same bits.  Read through L2: the
// peers wrote these bytes.
template <typename V>
__device__ __forceinline__ V comm_sum(const CfComm& c, int rank, unsigned e, long long i) {
  char* own = comm_buf(c, rank);
  V v[CF_MAX_RANKS];                  // every slot's load in flight before the adds
#pragma unroll
  for (int s = 0; s < CF_MAX_RANKS; ++s)
    if (s < c.size)
      v[s] = __ldcg(reinterpret_cast<const V*>(comm_slot(own, e & 1, s, c.size,
                                                         c.slot_bytes)) + i);
  V acc = v[0];
#pragma unroll
  for (int s = 1; s < CF_MAX_RANKS; ++s)
    if (s < c.size) acc = comm_add(acc, v[s]);
  return acc;
}

}  // namespace
