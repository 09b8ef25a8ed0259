// Whole-code Fast-SSC decoder kernel, with an optional codeword-estimate
// track.
//
// Replaces polar_tpu/ops/pallas/decoder_kernel.py:_ssa_decoder_kernel (u
// output, make_pallas_decoder(style="ssa", output="u")) and
// _ssa_decoder_kernel_cw (output in {systematic, codeword, both}).
//
// One thread decodes one frame (the reference's one frame per SIMD lane);
// frames stay element-major (N, B) int8, so each row access of a warp is one
// coalesced 32-byte sector. What bounds it on the card: the latency of the
// per-row byte loads and stores to the soft pyramid and hard stack in device
// memory, and at B = 32768 one thread per frame fills only a fraction of the
// card's thread slots. The design keeps the kernel one fixed source that
// walks the code's byte program, so it builds once, in seconds, for every
// code. With cw != nullptr the same thread then re-encodes its message into
// the (N, B) codeword estimate; the systematic output is cw at the info rows.
// The last block is masked, so any B works without padding.

#include <cuda_runtime.h>

#include "fastssc.cuh"

namespace {

__global__ void fastssc_decoder_kernel(const uint8_t* __restrict__ prog,
                                       const uint8_t* __restrict__ frozen,
                                       const int8_t* llr, int8_t* soft,
                                       int8_t* hard, int8_t* mesg, int8_t* cw,
                                       int n, int batch) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= batch) return;
  const long long b = batch;
  // the root input is only read; Col carries a mutable pointer for the
  // scratch arrays it also describes
  const polar::Col in{const_cast<int8_t*>(llr) + f, b};
  const polar::Col m{mesg + f, b};
  polar::fastssc_decode(prog, n, in, polar::Col{soft + f, b},
                        polar::Col{hard + f, b}, m);
  if (cw != nullptr) polar::reencode(frozen, n, m, polar::Col{cw + f, b});
}

}  // namespace

// Launch on `stream`. llr (n, batch), soft and hard (n, batch) scratch, mesg
// (k, batch) and, when not null, cw (n, batch): all int8, element-major.
// Returns cudaGetLastError() after the launch.
extern "C" int polar_decode(const void* prog, const void* frozen,
                            const void* llr, void* soft, void* hard,
                            void* mesg, void* cw, int n, int batch,
                            int threads, void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  fastssc_decoder_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)prog, (const uint8_t*)frozen, (const int8_t*)llr,
      (int8_t*)soft, (int8_t*)hard, (int8_t*)mesg, (int8_t*)cw, n, batch);
  return (int)cudaGetLastError();
}
