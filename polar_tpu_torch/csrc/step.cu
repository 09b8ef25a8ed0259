// Monte-Carlo BER step kernels, one thread per frame, over the two halves
// in mc.cuh:
//
//   mc_step_kernel — the fused step: message -> encode -> AWGN -> quantize
//     -> Fast-SSC decode -> the five testbench counters. Replaces
//     polar_tpu/ops/pallas/step_kernel.py:make_pallas_step
//     (_step_kernel_native / _step_kernel_inject, _chain, _front,
//     _count_and_store).
//   front_whole_kernel — the front half alone, systematic: (llr, cw) out.
//     Replaces step_kernel.py:make_pallas_front (:632),
//     _front_kernel_native (:611) / _front_kernel_inject (:623) over _front
//     (:225).
//   decode_count_kernel — the back half alone, systematic: decode the LLRs
//     on the codeword-estimate track and count against cw. Replaces
//     step_kernel.py:make_pallas_decode_count (:475), _decode_count_kernel
//     (:453).
//
// Math as in testbench.cc:125-192:
//   1. u0 = frozen ? +1 : message symbol;
//   2. cw = T(u0); systematic mode refreezes and transforms again;
//   3. llr = clamp(rint(scale * (cw + sigma * n)), -128, 127), each product
//      and sum rounded on its own (this file is built with -fmad=false);
//   4. decode; the systematic mode re-encodes the message into the
//      codeword estimate and compares it with cw at the info rows, the
//      plain mode compares the message with u0 at the info rows;
//   5. counters, in the bool domain: uncorrected bit errors, frame errors,
//      ambiguity erasures (decoded 0), AWGN sign flips (llr != 0 with a sign
//      other than cw's) and quantization erasures (llr == 0).
// Message symbols and normals come from the inputs (inject mode) or from
// Philox words (native mode, philox.cuh); Box-Muller pairs row i (radius)
// with row N/2 + i (angle) as _bits_to_normals does. The normal and the
// quantizer are channel.cuh's, shared with the large-N front (front.cu).
// The front kernel draws the fused step's words, so the front plus
// decode+count counts what the fused step counts on the same seeds.
//
// What bounds them on the card: like the decoder, the latency of per-row
// byte accesses to the frame's columns in device memory; the front half adds
// two Philox blocks and one Box-Muller per row pair, the split adds one
// write and one read of llr and cw, (N, B) bytes each. The design keeps
// every stage in the one thread that owns the frame, so nothing crosses
// threads until the counters. Counters are reduced per block (warp
// shuffles, then shared memory) into a (grid, 5) int32 array that the
// wrapper sums: no atomics, so the counts are deterministic.

#include <cuda_runtime.h>

#include "mc.cuh"

namespace {

__global__ void mc_step_kernel(const uint8_t* __restrict__ prog,
                               const uint8_t* __restrict__ frozen, int n,
                               int batch, int systematic, float sigma,
                               float scale, const int8_t* __restrict__ msg_in,
                               const float* __restrict__ normals_in,
                               uint32_t seed0, uint32_t seed1, uint32_t call,
                               int8_t* u_s, int8_t* c_s, int8_t* llr_s,
                               int8_t* soft, int8_t* hard, int8_t* mesg,
                               int* out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  int cnt[polar::kCounters] = {0, 0, 0, 0, 0};
  if (f < batch) {
    const long long b = batch;
    const polar::Col u{u_s + f, b}, c{c_s + f, b}, llr{llr_s + f, b};
    const polar::Col m{mesg + f, b};
    polar::mc_front(frozen, n, f, b, systematic, sigma, scale, msg_in,
                    normals_in, make_uint2(seed0, seed1), call, true, u, c,
                    llr, cnt);
    polar::fastssc_decode(prog, n, llr, polar::Col{soft + f, b},
                          polar::Col{hard + f, b}, m);
    if (systematic) {
      // codeword estimate into u's column (u0 is no longer needed)
      polar::cw_counts(frozen, n, m, u, c, cnt);
    } else {
      // u-domain estimate against the drawn u-domain message
      int frame_err = 0;
      for (int i = 0, k = 0; i < n; ++i) {
        if (__ldg(frozen + i)) continue;
        const int hat = m[k++];
        const int e = hat != u[i];
        cnt[0] += e;
        cnt[2] += hat == 0;
        frame_err |= e;
      }
      cnt[1] = frame_err;
    }
  }
  polar::store_block_counts(cnt, out);
}

__global__ void front_whole_kernel(const uint8_t* __restrict__ frozen, int n,
                                   int batch, float sigma, float scale,
                                   const int8_t* __restrict__ msg_in,
                                   const float* __restrict__ normals_in,
                                   uint32_t seed0, uint32_t seed1,
                                   uint32_t call, int8_t* llr_s,
                                   int8_t* cw_s) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= batch) return;
  const long long b = batch;
  const polar::Col c{cw_s + f, b};
  int cnt[polar::kCounters] = {0, 0, 0, 0, 0};  // unused here
  polar::mc_front(frozen, n, f, b, 1, sigma, scale, msg_in, normals_in,
                  make_uint2(seed0, seed1), call, false, c, c,
                  polar::Col{llr_s + f, b}, cnt);
}

__global__ void decode_count_kernel(const uint8_t* __restrict__ prog,
                                    const uint8_t* __restrict__ frozen, int n,
                                    int batch, const int8_t* llr_s,
                                    const int8_t* cw_s, int8_t* soft,
                                    int8_t* hard, int8_t* mesg, int* out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  int cnt[polar::kCounters] = {0, 0, 0, 0, 0};
  if (f < batch) {
    const long long b = batch;
    // the inputs are only read; Col carries a mutable pointer
    const polar::Col llr{const_cast<int8_t*>(llr_s) + f, b};
    const polar::Col c{const_cast<int8_t*>(cw_s) + f, b};
    for (int i = 0; i < n; ++i) {
      const int l = llr[i], cwv = c[i];
      cnt[3] += (l != 0) & ((l < 0) != (cwv < 0));
      cnt[4] += l == 0;
    }
    const polar::Col s{soft + f, b}, m{mesg + f, b};
    polar::fastssc_decode(prog, n, llr, s, polar::Col{hard + f, b}, m);
    // the codeword estimate into the soft column, free after the decode
    polar::cw_counts(frozen, n, m, s, c, cnt);
  }
  polar::store_block_counts(cnt, out);
}

}  // namespace

// Launch on `stream`. Inject mode: msg (n, batch) int8 ±1 and normals
// (n, batch) float32; native mode: msg and normals null, words from Philox
// keyed by (seed0, seed1) with counter word 2 = call. Scratch u, c, llr,
// soft, hard (n, batch) and mesg (k, batch) int8; out (blocks, 5) int32.
// threads must be a multiple of 32, at most 1024. Returns cudaGetLastError().
extern "C" int polar_step(const void* prog, const void* frozen, int n,
                          int batch, int systematic, float sigma, float scale,
                          const void* msg, const void* normals,
                          unsigned int seed0, unsigned int seed1,
                          unsigned int call, void* u, void* c, void* llr,
                          void* soft, void* hard, void* mesg, void* out,
                          int threads, void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  mc_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)prog, (const uint8_t*)frozen, n, batch, systematic,
      sigma, scale, (const int8_t*)msg, (const float*)normals, seed0, seed1,
      call, (int8_t*)u, (int8_t*)c, (int8_t*)llr, (int8_t*)soft,
      (int8_t*)hard, (int8_t*)mesg, (int*)out);
  return (int)cudaGetLastError();
}

// The systematic front on `stream`: llr and cw (n, batch) int8 out. Inject
// and native modes as polar_step's. Returns cudaGetLastError().
extern "C" int polar_front_whole(const void* frozen, int n, int batch,
                                 float sigma, float scale, const void* msg,
                                 const void* normals, unsigned int seed0,
                                 unsigned int seed1, unsigned int call,
                                 void* llr, void* cw, int threads,
                                 void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  front_whole_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frozen, n, batch, sigma, scale, (const int8_t*)msg,
      (const float*)normals, seed0, seed1, call, (int8_t*)llr, (int8_t*)cw);
  return (int)cudaGetLastError();
}

// Decode+count on `stream`: llr and cw (n, batch) int8 in; scratch soft,
// hard (n, batch) and mesg (k, batch) int8; out (blocks, 5) int32 in
// polar_step's order. threads as polar_step's. Returns cudaGetLastError().
extern "C" int polar_decode_count(const void* prog, const void* frozen, int n,
                                  int batch, const void* llr, const void* cw,
                                  void* soft, void* hard, void* mesg,
                                  void* out, int threads, void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  decode_count_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)prog, (const uint8_t*)frozen, n, batch,
      (const int8_t*)llr, (const int8_t*)cw, (int8_t*)soft, (int8_t*)hard,
      (int8_t*)mesg, (int*)out);
  return (int)cudaGetLastError();
}
