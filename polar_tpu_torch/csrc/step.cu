// Fused Monte-Carlo BER step: message -> encode -> AWGN -> quantize ->
// Fast-SSC decode -> the five testbench counters, one thread per frame.
//
// Replaces polar_tpu/ops/pallas/step_kernel.py:make_pallas_step
// (_step_kernel_native / _step_kernel_inject, _chain, _front,
// _count_and_store). Math as there (testbench.cc:125-192):
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
//
// What bounds it on the card: like the decoder, the latency of per-row byte
// accesses to the frame's columns in device memory. The design keeps every
// stage in the one thread that owns the frame, so nothing crosses threads
// until the counters. Counters are reduced per block (warp shuffles, then
// shared memory) into a (grid, 5) int32 array that the wrapper sums: no
// atomics, so the counts are deterministic.

#include <cuda_runtime.h>

#include "channel.cuh"
#include "fastssc.cuh"

namespace {

constexpr int kCounters = 5;
constexpr int kMaxWarps = 32;

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
  int cnt[kCounters] = {0, 0, 0, 0, 0};
  if (f < batch) {
    const long long b = batch;
    const polar::Col u{u_s + f, b}, c{c_s + f, b}, llr{llr_s + f, b};
    const polar::Col m{mesg + f, b};
    const bool inject = msg_in != nullptr;
    const uint2 key = make_uint2(seed0, seed1);
    polar::PhiloxStream msg_words(key, (uint32_t)f, call);

    // message in the u domain, frozen rows pinned to +1; encode
    for (int i = 0; i < n; ++i) {
      int8_t sym = 1;
      if (!__ldg(frozen + i))
        sym = inject ? msg_in[(long long)i * b + f]
                     : (int8_t)(1 - 2 * (int)(msg_words.word(n + i) & 1u));
      u[i] = sym;
      c[i] = sym;
    }
    polar::transform(c, n);
    if (systematic) {
      for (int i = 0; i < n; ++i)
        if (__ldg(frozen + i)) c[i] = 1;
      polar::transform(c, n);
    }

    // AWGN and quantize; the channel counters need only llr and cw
    const int h = n >> 1;
    polar::PhiloxStream radius_words(key, (uint32_t)f, call);
    polar::PhiloxStream angle_words(key, (uint32_t)f, call);
    for (int i = 0; i < h; ++i) {
      float n0, n1;
      if (inject) {
        n0 = normals_in[(long long)i * b + f];
        n1 = normals_in[(long long)(h + i) * b + f];
      } else {
        polar::box_muller(radius_words.word(i), angle_words.word(h + i), &n0,
                          &n1);
      }
      const int rows[2] = {i, h + i};
      const float nz[2] = {n0, n1};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cwv = c[rows[j]];
        const int8_t l = polar::quantize((float)cwv, nz[j], sigma, scale);
        llr[rows[j]] = l;
        cnt[3] += (l != 0) & ((l < 0) != (cwv < 0));
        cnt[4] += l == 0;
      }
    }

    polar::fastssc_decode(prog, n, llr, polar::Col{soft + f, b},
                          polar::Col{hard + f, b}, m);

    int frame_err = 0;
    if (systematic) {
      // codeword estimate into u's column (u0 is no longer needed); the
      // transmitted truth at the info rows is cw
      polar::reencode(frozen, n, m, u);
      for (int i = 0; i < n; ++i) {
        if (__ldg(frozen + i)) continue;
        const int hat = u[i];
        const int e = hat != c[i];
        cnt[0] += e;
        cnt[2] += hat == 0;
        frame_err |= e;
      }
    } else {
      // u-domain estimate against the drawn u-domain message
      for (int i = 0, k = 0; i < n; ++i) {
        if (__ldg(frozen + i)) continue;
        const int hat = m[k++];
        const int e = hat != u[i];
        cnt[0] += e;
        cnt[2] += hat == 0;
        frame_err |= e;
      }
    }
    cnt[1] = frame_err;
  }

  __shared__ int red[kCounters][kMaxWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kCounters; ++j) {
    int v = cnt[j];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[j][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kCounters) {
    int s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[threadIdx.x][w];
    out[blockIdx.x * kCounters + threadIdx.x] = s;
  }
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
