// Kernels 13 and 14 for Hopper (sm_90a): the all-reduce (f32 sum, ReLU
// after the sum at Stage.FFN) and the all-gather (shards concatenated in
// rank order) over the ranks of one mesh axis, one process per card.
//
// Replaces the TPU kernels `_pallas_all_reduce` and `_pallas_all_gather`
// (clusterfusion_tpu/parallel/collective.py, bodies
// `_ring_all_reduce_kernel` and `_ring_all_gather_kernel`), and
// `ring_reduce_scratch` inside the stack kernel (stack_kernel.cu, mode 5),
// where the same protocol runs inside the stack's own launches.
//
// The TPU kernels are one-way rings of N-1 remote copies, because ICI is a
// torus.  An HGX H100 host joins every pair of cards through NVSwitch, so
// here every rank stores its data straight into every peer's memory: one
// hop, the reference's own DSM pattern in which each CTA pushes its
// partials to every peer (dsm.cuh:89-169).
//
// Memory.  Each rank owns one symmetric buffer (cudaMalloc'ed by
// cf_comm_alloc, mapped by the peers through CUDA IPC):
//   [0, 128)      ctl: the epoch (the last reduce done), the count of done blocks
//   [128, 1152)   flags [CF_MAX_RANKS sources][COMM_MAX_BLOCKS columns], u32
//   [2048, ...)   data [2 banks][size slots][slot_bytes]
// Reduce (or gather) e (e = 1, 2, ...) uses bank e % 2.  The device
// functions of one reduce are in collective.cuh.
//
// The standalone kernels, one call, block b of rank r (block b owns one
// range of the data, flag column b):
//   1. push: stores its range of x with 16-byte stores into slot r of bank
//      e%2 of every rank's buffer, its own included;
//   2. publish: __syncthreads(); thread p < size: fence.acq_rel.sys, then
//      a relaxed sys-scope store of e into flag [r][b] of rank p (one
//      release pattern);
//   3. wait: thread p < size waits with ld.acquire.sys until flag [p][b] of
//      its own buffer reaches e; __syncthreads();
//   4. all-reduce: sums the size slots of its range in rank order
//      0, 1, ..., size-1 in f32 (ReLU after the sum when asked) into out;
//      all-gather: copies slot s of its range into part s of out;
//   5. the last block of the rank to finish stores e as the rank's epoch.
// Every rank adds the same values in the same order, so every rank gets
// the same bits.  (The TPU ring adds from the rank itself backwards, so
// its sums differ by rounding from rank to rank.)
//
// Inside the stack kernel (mode 5) the reduce has no launch of its own.
// Its producer is the product that makes the partial (the O-projection or
// the down projection, common.cuh's ring GEMV in its PUSH instance): after
// its griddepcontrol.wait it reads e from its ctl; in its epilogue each
// block pushes its share of the 256-column tile's fixed-order cluster sum
// (steps 1), and after the cluster barrier the tile's rank-0 block
// publishes flag [r][tile] to every rank (step 2; COMM_MAX_BLOCKS columns
// hold hidden 8192).  Its consumer is the residual norm after it
// (resnorm_reduce_kernel): after its griddepcontrol.wait it waits for every
// peer's flag of every tile (step 3), sums the slots in rank order as in
// step 4 (the same values in the same order as the standalone kernel's, so
// the same bits), adds the residual, and stores e as the rank's epoch.
//
// Why there is no ack semaphore.  The TPU kernels wait for an ack before
// each send, so that a fast sender cannot overwrite a slot that is still
// being read.  Here the two banks do that job.  A sender s stores into
// bank e%2 of rank r for reduce e and next for reduce e+2; those stores
// must come after r's reads of reduce e.
// - Standalone: s starts call e+2 only after its call e+1 finished, and
//   that took r's call-(e+1) flags.  r sets those in its call-(e+1)
//   kernel, which starts only after its call-e kernel, the last reader of
//   bank e%2, has finished (stream order).
// - In the stack: s's producer of e+2 stores only after its
//   griddepcontrol.wait, which returns once the kernels before it on s's
//   stream have completed, s's consumer of e+1 among them.  That consumer
//   finished only after it saw r's flags of e+1.  r's producer of e+1 sets
//   them after its own griddepcontrol.wait, that is, after r's consumer of
//   e, the reader of bank e%2, has completed.
// - Mixed (the stack's reduces and standalone calls on one communicator)
//   chain the same way: each link is "starts, or passes its wait, after
//   the kernels before it on its stream have completed".
// The chain holds only if every kernel between a consumer and the next
// producer on a stream completes after the kernels before it: each calls
// griddepcontrol.wait before it finishes (the ring GEMV, the split and
// merge passes and the residual norm all do, in every block), or is
// launched without programmatic dependent launch.  So no store of reduce
// e+2 lands before the reads of reduce e are done.  The flags are never
// reset: they only grow, a sender is at most one reduce ahead (flag e+1
// where e is awaited), and the wait is for flag >= e.
//
// The epoch lives in the buffer and the kernels advance it, so the host
// passes no call number: a later change can capture the launches in a
// CUDA graph.
//
// Bounded wait.  A wait that has not seen its flag after 2 s of
// %globaltimer writes an error code (0x10000 | rank << 8 | peer) into a
// host-mapped error word and gives up; a wait that finds the word already
// set gives up at once.  The caller raises on a non-zero word, so a dead
// peer or a protocol fault becomes an error, not a hang.
//
// Loopback.  cf_allreduce_loopback / cf_allgather_loopback run `size`
// virtual ranks in one launch on one card (blockIdx.y = rank) over `size`
// buffers of that card, with the same device code.  Blocks of one virtual
// rank wait for blocks of the others, so every block must be resident at
// once: the grid is held to one wave, and a larger one is refused.
//
// Lazy loading.  CUDA loads a kernel at its first launch, and a load may
// wait for the card to go idle.  A rank's kernel that spins for a peer
// whose launch comes later from the same host thread (virtual ranks on
// streams of one card) would then wait out its 2 s; cf_comm_preload loads
// this file's kernels when a communicator is made, and the stack loads its
// mode-5 kernels before its first launch.
//
// What bounds it: a call moves little (the tp step's reduce is [1, 4096]
// float32 per rank), so its time is set by the flag round trip across the
// cards, not by bytes.  A simple kernel first: no TMA, no multimem (NVLS).

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "collective.cuh"
#include "common.cuh"

namespace {

constexpr int COMM_THREADS = 256;

__device__ __forceinline__ float relu_f(float v) { return v < 0.f ? 0.f : v; }

// One call of rank `rank` over n16 16-byte units of x (see the note at the
// top): the all-gather when GATHER, else the all-reduce of float4s.
template <bool GATHER>
__device__ void comm_call(const CfComm& c, int rank, const uint4* x, uint4* out,
                          long long n16, int relu) {
  __shared__ unsigned s_epoch;
  __shared__ int s_failed;
  if (threadIdx.x == 0) {
    s_epoch = comm_next_epoch(c, rank);
    s_failed = 0;
  }
  __syncthreads();
  const unsigned e = s_epoch;
  const long long per = (n16 + gridDim.x - 1) / gridDim.x;
  const long long lo = min(n16, (long long)blockIdx.x * per);
  const long long hi = min(n16, lo + per);

  // 1. push this block's range into slot `rank` of every rank
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const uint4 v = x[i];
    for (int p = 0; p < c.size; ++p) comm_push(c, rank, p, e, i, v);
  }
  __syncthreads();

  // 2.-3. publish, then wait for every source's flag of this block
  if (threadIdx.x < c.size) {
    const int p = threadIdx.x;
    comm_publish(c, rank, p, blockIdx.x, e);
    if (!comm_wait(c, rank, p, blockIdx.x, e)) s_failed = 1;
  }
  __syncthreads();

  // 4. sum or copy the slots of this range, in rank order
  if (!s_failed) {
    if (GATHER) {
      for (int s = 0; s < c.size; ++s) {
        const uint4* src = comm_slot(comm_buf(c, rank), e & 1, s, c.size, c.slot_bytes);
        for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
          out[(long long)s * n16 + i] = __ldcg(src + i);
      }
    } else {
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        float4 acc = comm_sum<float4>(c, rank, e, i);
        if (relu) {
          acc.x = relu_f(acc.x);
          acc.y = relu_f(acc.y);
          acc.z = relu_f(acc.z);
          acc.w = relu_f(acc.w);
        }
        reinterpret_cast<float4*>(out)[i] = acc;
      }
    }
  }

  // 5. the rank's last block to finish advances its epoch
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ctl = reinterpret_cast<unsigned*>(comm_buf(c, rank));
    __threadfence();
    if (atomicAdd(ctl + 1, 1u) == gridDim.x - 1) {
      atomicExch(ctl + 1, 0u);
      comm_set_epoch(c, rank, e);
    }
  }
}

template <bool GATHER>
__global__ void __launch_bounds__(COMM_THREADS)
comm_kernel(CfComm c, const void* x, void* out, long long n16, int relu) {
  comm_call<GATHER>(c, c.rank, static_cast<const uint4*>(x), static_cast<uint4*>(out), n16,
                    relu);
}

struct Ptrs {
  void* p[CF_MAX_RANKS];
};

template <bool GATHER>
__global__ void __launch_bounds__(COMM_THREADS)
comm_loopback_kernel(CfComm c, Ptrs xs, Ptrs outs, long long n16, int relu) {
  const int r = blockIdx.y;
  comm_call<GATHER>(c, r, static_cast<const uint4*>(xs.p[r]), static_cast<uint4*>(outs.p[r]),
                    n16, relu);
}

// Blocks of one call: one 16-byte unit per thread, at most COMM_MAX_BLOCKS
// (the flag columns); the same on every rank for the same n16.
int comm_blocks(long long n16) {
  long long b = (n16 + COMM_THREADS - 1) / COMM_THREADS;
  return (int)(b < 1 ? 1 : (b > COMM_MAX_BLOCKS ? COMM_MAX_BLOCKS : b));
}

int check_call(const CfComm* c, long long n16) {
  if (!c || c->size < 1 || c->size > CF_MAX_RANKS || c->rank < 0 || c->rank >= c->size ||
      n16 < 1 || n16 * 16 > c->slot_bytes)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool GATHER>
int launch(const CfComm* c, const void* x, void* out, long long n16, int relu, cudaStream_t st) {
  CF_CHECK(check_call(c, n16));
  comm_kernel<GATHER><<<comm_blocks(n16), COMM_THREADS, 0, st>>>(*c, x, out, n16, relu);
  return (int)cudaGetLastError();
}

template <bool GATHER>
int launch_loopback(const CfComm* c, void** xs, void** outs, long long n16, int relu,
                    cudaStream_t st) {
  CF_CHECK(check_call(c, n16));
  const int blocks = comm_blocks(n16);
  int dev = 0, sms = 0, occ = 0;
  CF_CHECK((int)cudaGetDevice(&dev));
  CF_CHECK((int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  CF_CHECK((int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, comm_loopback_kernel<GATHER>, COMM_THREADS, 0));
  if ((long long)blocks * c->size > (long long)occ * sms)
    return (int)cudaErrorInvalidConfiguration;      // not one wave: could deadlock
  Ptrs X{}, O{};
  for (int r = 0; r < c->size; ++r) {
    X.p[r] = xs[r];
    O.p[r] = outs[r];
  }
  comm_loopback_kernel<GATHER><<<dim3(blocks, c->size), COMM_THREADS, 0, st>>>(*c, X, O, n16,
                                                                               relu);
  return (int)cudaGetLastError();
}

}  // namespace

// Load this file's kernels now (see "Lazy loading" above).
extern "C" int cf_comm_preload() {
  cudaFuncAttributes a;
  CF_CHECK((int)cudaFuncGetAttributes(&a, comm_kernel<false>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, comm_kernel<true>));
  CF_CHECK((int)cudaFuncGetAttributes(&a, comm_loopback_kernel<false>));
  return (int)cudaFuncGetAttributes(&a, comm_loopback_kernel<true>);
}

// Bytes of one rank's symmetric buffer.
extern "C" long long cf_comm_buffer_bytes(int size, long long slot_bytes) {
  return COMM_DATA_OFF + 2LL * size * slot_bytes;
}

// A zeroed symmetric buffer on `device`, the base of its own allocation
// (what cudaIpcGetMemHandle needs).
extern "C" int cf_comm_alloc(int device, long long bytes, void** out) {
  *out = nullptr;
  CF_CHECK((int)cudaSetDevice(device));
  void* p = nullptr;
  CF_CHECK((int)cudaMalloc(&p, (size_t)bytes));
  int e = (int)cudaMemset(p, 0, (size_t)bytes);
  if (!e) e = (int)cudaDeviceSynchronize();
  if (e) {
    cudaFree(p);
    return e;
  }
  *out = p;
  return 0;
}

extern "C" int cf_comm_free(void* p) { return (int)cudaFree(p); }

extern "C" int cf_comm_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

extern "C" int cf_comm_ipc_handle(void* p, void* handle) {
  cudaIpcMemHandle_t h;
  CF_CHECK((int)cudaIpcGetMemHandle(&h, p));
  memcpy(handle, &h, sizeof h);
  return 0;
}

extern "C" int cf_comm_ipc_open(int device, const void* handle, void** out) {
  *out = nullptr;
  CF_CHECK((int)cudaSetDevice(device));
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int cf_comm_ipc_close(void* p) { return (int)cudaIpcCloseMemHandle(p); }

extern "C" int cf_device_bus_id(int device, char* out, int len) {
  return (int)cudaDeviceGetPCIBusId(out, len, device);
}

extern "C" int cf_device_by_bus_id(const char* bus, int* device) {
  return (int)cudaDeviceGetByPCIBusId(device, bus);
}

extern "C" int cf_can_access_peer(int device, int peer, int* out) {
  return (int)cudaDeviceCanAccessPeer(out, device, peer);
}

// A zeroed error word in host memory that kernels can write (mapped).
extern "C" int cf_comm_err_alloc(void** host, void** dev) {
  *host = *dev = nullptr;
  int* h = nullptr;
  CF_CHECK((int)cudaHostAlloc(reinterpret_cast<void**>(&h), sizeof(int),
                              cudaHostAllocMapped | cudaHostAllocPortable));
  *h = 0;
  const int e = (int)cudaHostGetDevicePointer(dev, h, 0);
  if (e) {
    cudaFreeHost(h);
    return e;
  }
  *host = h;
  return 0;
}

extern "C" int cf_comm_err_free(void* host) { return (int)cudaFreeHost(host); }

// rank's view of `size` buffers (bufs[p] as this process maps rank p's);
// nullptr on bad arguments.  Free with cf_comm_delete.
extern "C" void* cf_comm_new(int rank, int size, long long slot_bytes, void** bufs, void* err) {
  if (size < 1 || size > CF_MAX_RANKS || rank < 0 || rank >= size || slot_bytes < 16 ||
      slot_bytes % 16)
    return nullptr;
  CfComm* c = static_cast<CfComm*>(calloc(1, sizeof(CfComm)));
  if (!c) return nullptr;
  c->rank = rank;
  c->size = size;
  c->slot_bytes = slot_bytes;
  for (int p = 0; p < size; ++p) c->bufs[p] = static_cast<char*>(bufs[p]);
  c->err = static_cast<int*>(err);
  return c;
}

extern "C" void cf_comm_delete(void* c) { free(c); }

// Kernel 13: out[n] f32 = sum over ranks of x[n] (n % 4 == 0).
extern "C" int cf_allreduce(const void* comm, const void* x, void* out, long long n, int relu,
                            void* stream) {
  if (n % 4) return (int)cudaErrorInvalidValue;
  return launch<false>(static_cast<const CfComm*>(comm), x, out, n / 4, relu,
                       static_cast<cudaStream_t>(stream));
}

// Kernel 14: out[size * n16] 16-byte units = the ranks' x[n16], in rank order.
extern "C" int cf_allgather(const void* comm, const void* x, void* out, long long n16,
                            void* stream) {
  return launch<true>(static_cast<const CfComm*>(comm), x, out, n16, 0,
                      static_cast<cudaStream_t>(stream));
}

// Kernel 13 for `size` virtual ranks on one card in one launch: xs[r],
// outs[r] are rank r's input and output; comm is any rank's view.
extern "C" int cf_allreduce_loopback(const void* comm, void** xs, void** outs, long long n,
                                     int relu, void* stream) {
  if (n % 4) return (int)cudaErrorInvalidValue;
  return launch_loopback<false>(static_cast<const CfComm*>(comm), xs, outs, n / 4, relu,
                                static_cast<cudaStream_t>(stream));
}

// Kernel 14 for `size` virtual ranks on one card in one launch.
extern "C" int cf_allgather_loopback(const void* comm, void** xs, void** outs, long long n16,
                                     void* stream) {
  return launch_loopback<true>(static_cast<const CfComm*>(comm), xs, outs, n16, 0,
                               static_cast<cudaStream_t>(stream));
}
