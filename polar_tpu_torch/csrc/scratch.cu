// Scratch-style Fast-SSC decoder: the soft pyramid and the hard stack of a
// block's frames in shared memory, one thread per frame.
//
// Replaces polar_tpu/ops/pallas/decoder_kernel.py's scratch style:
// _decoder_kernel (:541, make_pallas_decoder(style="scratch"), u output)
// and _subtree_kernel (:550, make_subtree_decoder(style="scratch"): u and
// the node's hard block), both over _KernelBuilder (:112-272). The TPU
// kernel keeps a (2N, tile) soft pyramid and an (N, tile) hard stack in
// VMEM; here a block of T frames keeps N soft rows (the root's LLRs are
// read where they lie in device memory) and N hard rows per frame in
// dynamic shared memory, element-major with stride T (a Col over shared
// memory), and walks the byte program with the same fastssc_decode as the
// SSA-style kernels (decoder.cu, subtree.cu), so the outputs agree bit for
// bit. The message goes straight to device memory; the subtree entry copies
// the node's hard block out at the end.
//
// What bounds it on the card: shared memory. A block takes 2 N T bytes of
// the SM's 228 KB, so an SM holds about 114 KB / N frames: 1782 at N = 64,
// 111 at N = 1024, 55 at N = 2048. At N >= 1024 too few warps are resident
// to hide the walk's dependent accesses, which the SSA kernel pays in L1/L2
// latency instead. T is a multiple of 32 frames; 2 N T above the 227 KB a
// block may take (N > 2048 at T = 32) is refused by the wrapper, as the TPU
// scratch style fails on VMEM. The last block is masked.

#include <cuda_runtime.h>

#include "fastssc.cuh"

namespace {

__global__ void scratch_decoder_kernel(const uint8_t* __restrict__ prog,
                                       int n, int batch, const int8_t* llr,
                                       int8_t* mesg, int8_t* hard_out) {
  extern __shared__ int8_t smem[];
  const int t = threadIdx.x;
  const int f = blockIdx.x * blockDim.x + t;
  if (f >= batch) return;  // no barrier below: the tail threads may leave
  const long long b = batch, frames = blockDim.x;
  const polar::Col soft{smem + t, frames};
  const polar::Col hard{smem + (long long)n * frames + t, frames};
  polar::fastssc_decode(prog, n, polar::Col{const_cast<int8_t*>(llr) + f, b},
                        soft, hard, polar::Col{mesg + f, b});
  if (hard_out != nullptr) {
    const polar::Col out{hard_out + f, b};
    for (int r = 0; r < n; ++r) out[r] = hard[r];
  }
}

int launch(const void* prog, int n, int batch, const void* llr, void* mesg,
           void* hard, int threads, void* stream) {
  const int bytes = 2 * n * threads;
  // above 48 KB a block's dynamic shared memory must be granted first
  cudaError_t err = cudaFuncSetAttribute(
      scratch_decoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + threads - 1) / threads;
  scratch_decoder_kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)prog, n, batch, (const int8_t*)llr, (int8_t*)mesg,
      (int8_t*)hard);
  return (int)cudaGetLastError();
}

}  // namespace

// The whole-code decoder on `stream`, u output: llr (n, batch) in, mesg
// (k, batch) out, int8 element-major; `threads` frames a block (a multiple
// of 32, 2 n threads bytes of shared memory). Returns the CUDA error of the
// attribute call or of the launch (a block refused for its shared memory
// never runs, and only this reports it).
extern "C" int polar_scratch_decode(const void* prog, int n, int batch,
                                    const void* llr, void* mesg, int threads,
                                    void* stream) {
  return launch(prog, n, batch, llr, mesg, nullptr, threads, stream);
}

// One hybrid node on `stream`: in (n, batch), out mesg (k, batch) and the
// node's hard block (n, batch), as polar_scratch_decode.
extern "C" int polar_scratch_subtree(const void* prog, int n, int batch,
                                     const void* in, void* mesg, void* hard,
                                     int threads, void* stream) {
  return launch(prog, n, batch, in, mesg, hard, threads, stream);
}
