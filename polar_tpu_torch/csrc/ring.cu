// The ring shift of the element-sharded decoder: y[d] = x[(d + offset) % n]
// over the n shards of a mesh, each shard's block copied whole.
//
// Replaces polar_tpu/parallel/rdma.py:ring_shift (:61), body _shift_kernel
// (:42-58). There every device signals its send target and its receive
// source on a barrier semaphore, waits for both, and issues one remote DMA
// of its block over the interconnect; a token threaded through the decoder
// keeps any two such exchanges from running at once
// (polar_tpu/parallel/seqpar_decode.py:86-93). The port drives the mesh
// from one process, and one stream per device already orders every launch:
// the exchange is an ordinary kernel on the destination's stream, with no
// semaphore. The wrapper (ops/cuda/ring_kernel.py) makes one launch per
// destination device, carrying every shard whose output lies on it: when
// all shards share a card, one launch moves all n blocks. A source on
// another card is read through peer access, after the destination's stream
// has waited on the source's (polar_enable_peer below, events in the
// wrapper).
//
// What bounds it on the card: device memory, one read and one write of
// every byte. Each thread moves 16-byte words (int4) where every source and
// destination pointer is 16-byte aligned, a grid-stride loop over the
// block, blockIdx.y the shard; the tail below 16 bytes, and any payload
// with an unaligned pointer, goes a byte at a time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShards = 64;  // pointers a launch carries (kernel params)

struct Table {
  const char* src[kMaxShards];
  char* dst[kMaxShards];
};

__global__ void ring_kernel(Table t, long long bytes, int vec) {
  const char* __restrict__ src = t.src[blockIdx.y];
  char* __restrict__ dst = t.dst[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long words = bytes / 16;
    const int4* __restrict__ s = reinterpret_cast<const int4*>(src);
    int4* __restrict__ d = reinterpret_cast<int4*>(dst);
    for (long long i = first; i < words; i += stride) d[i] = s[i];
    done = words * 16;
  }
  for (long long i = done + first; i < bytes; i += stride) dst[i] = src[i];
}

}  // namespace

// Copy `count` blocks of `bytes` bytes each, srcs[i] to dsts[i] (host arrays
// of device pointers, count <= 64), in one launch of `threads` threads a
// block on `stream`, on the current device. Returns cudaGetLastError().
extern "C" int polar_ring_shift(const void* srcs, const void* dsts, int count,
                                long long bytes, int threads, void* stream) {
  if (count < 1 || count > kMaxShards || bytes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Table t;
  int vec = 1;
  for (int i = 0; i < count; ++i) {
    t.src[i] = static_cast<const char* const*>(srcs)[i];
    t.dst[i] = static_cast<char* const*>(dsts)[i];
    vec &= ((uintptr_t)t.src[i] % 16 == 0) & ((uintptr_t)t.dst[i] % 16 == 0);
  }
  if (bytes == 0) return 0;
  // enough blocks to fill the card over all shards (132 SMs, 2048 threads
  // each), no more than the work needs
  const long long units = vec ? (bytes + 15) / 16 : bytes;
  long long blocks = (units + threads - 1) / threads;
  const long long cap = (132LL * 2048 / threads * 2 + count - 1) / count;
  if (blocks > cap) blocks = cap;
  ring_kernel<<<dim3((unsigned)blocks, (unsigned)count), threads, 0,
                (cudaStream_t)stream>>>(t, bytes, vec);
  return (int)cudaGetLastError();
}

// Let the current device's kernels read `peer`'s memory. Returns
// cudaErrorPeerAccessUnsupported where the cards cannot reach each other;
// access enabled before is not an error.
extern "C" int polar_enable_peer(int device, int peer) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int can = 0;
  err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // so that the next launch check does not see it
    return 0;
  }
  return (int)err;
}
