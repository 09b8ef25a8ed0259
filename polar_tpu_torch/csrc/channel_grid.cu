// Elementwise channel kernels over a frame-major (rows, cols) grid: the +-1
// message symbols and the AWGN + quantization pass of the Monte-Carlo step
// around a caller's decoder (ops/cuda/channel_kernel.py).
//
// Replaces polar_tpu/ops/pallas/channel_kernel.py:
//   symbols_kernel: make_pallas_symbols (:120), _sym_kernel_native /
//     _sym_kernel_bits (:77-86): symbol = 1 - 2 (word & 1);
//   awgn_kernel: make_pallas_awgn (:146), _awgn_body and _normals (:47-65):
//     llr = quant(2/sigma^2 (cw + sigma n)), n by the cosine-only
//     Box-Muller on two independent words per element.
//
// Row f of a grid is frame f. Native mode reads word c of frame f's Philox
// stream (philox.cuh, counter (f, c / 4, call, 0)): symbol c from word c of
// the message stream; the normal of element c from words c (radius) and
// cols + c (angle) of the noise stream, which has seeds of its own. Bits
// mode reads the same words from int64 tensors in [0, 2^32), so the kernels
// can be held against their plain versions on any words.
//
// One thread per four neighbouring elements of a row: one Philox block
// feeds them all (the angle words may straddle two blocks when cols is not
// a multiple of 4), and when cols is a multiple of 4 the int8 loads and
// stores are one aligned 32-bit word each. What bounds it on the card:
// symbols is a byte-store stream plus one Philox block per 4 bytes; AWGN is
// compute-bound on two Philox blocks, a logf, a sqrtf and the cosine
// polynomial per 4 elements. The channel math is channel.cuh's, built with
// -fmad=false, so it rounds as the plain version does.

#include <cuda_runtime.h>

#include "channel.cuh"

namespace {

struct Quad {
  int f, c0;  // frame and first column
  long long base;
};

__device__ __forceinline__ bool quad_of(int rows, int cols, Quad* q) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = (cols + 3) >> 2;
  if (t >= (long long)rows * per_row) return false;
  q->f = (int)(t / per_row);
  q->c0 = (int)(t - (long long)q->f * per_row) * 4;
  q->base = (long long)q->f * cols + q->c0;
  return true;
}

__device__ __forceinline__ uint32_t lane_of(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void symbols_kernel(int rows, int cols,
                               const long long* __restrict__ words,
                               uint32_t seed0, uint32_t seed1, uint32_t call,
                               int8_t* __restrict__ out) {
  Quad q;
  if (!quad_of(rows, cols, &q)) return;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (words == nullptr)
    v = polar::philox4x32_10(
        make_uint4((uint32_t)q.f, (uint32_t)(q.c0 >> 2), call, 0u),
        make_uint2(seed0, seed1));
  const int m = min(4, cols - q.c0);
  uint32_t packed = 0u;
  int8_t sym[4];
  for (int i = 0; i < m; ++i) {
    const uint32_t w = words != nullptr ? (uint32_t)words[q.base + i]
                                        : lane_of(v, i);
    sym[i] = (int8_t)(1 - 2 * (int)(w & 1u));
    packed |= (uint32_t)(uint8_t)sym[i] << (8 * i);
  }
  if ((cols & 3) == 0) {
    *reinterpret_cast<uint32_t*>(out + q.base) = packed;
  } else {
    for (int i = 0; i < m; ++i) out[q.base + i] = sym[i];
  }
}

__global__ void awgn_kernel(int rows, int cols, float sigma, float scale,
                            const int8_t* __restrict__ cw,
                            const long long* __restrict__ w1,
                            const long long* __restrict__ w2, uint32_t seed0,
                            uint32_t seed1, uint32_t call,
                            int8_t* __restrict__ llr) {
  Quad q;
  if (!quad_of(rows, cols, &q)) return;
  const bool vec = (cols & 3) == 0;
  const int m = min(4, cols - q.c0);
  int8_t x[4];
  if (vec) {
    const uint32_t packed = *reinterpret_cast<const uint32_t*>(cw + q.base);
    for (int i = 0; i < 4; ++i) x[i] = (int8_t)(packed >> (8 * i));
  } else {
    for (int i = 0; i < m; ++i) x[i] = cw[q.base + i];
  }
  const uint2 key = make_uint2(seed0, seed1);
  polar::PhiloxStream radius(key, (uint32_t)q.f, call);
  polar::PhiloxStream angle(key, (uint32_t)q.f, call);
  uint32_t out = 0u;
  for (int i = 0; i < m; ++i) {
    const int c = q.c0 + i;
    const uint32_t a = w1 != nullptr ? (uint32_t)w1[q.base + i]
                                     : radius.word(c);
    const uint32_t b = w2 != nullptr ? (uint32_t)w2[q.base + i]
                                     : angle.word(cols + c);
    const int8_t v =
        polar::quantize((float)x[i], polar::normal_cos(a, b), sigma, scale);
    if (vec)
      out |= (uint32_t)(uint8_t)v << (8 * i);
    else
      llr[q.base + i] = v;
  }
  if (vec) *reinterpret_cast<uint32_t*>(llr + q.base) = out;
}

unsigned int grid_of(int rows, int cols, int threads) {
  const long long quads = (long long)rows * ((cols + 3) / 4);
  return (unsigned int)((quads + threads - 1) / threads);
}

}  // namespace

// Symbols on `stream`: out (rows, cols) int8 +-1. Bits mode: words (rows,
// cols) int64; native mode: words null, Philox keyed by (seed0, seed1) with
// counter word 2 = call. Returns cudaGetLastError().
extern "C" int polar_symbols(int rows, int cols, const void* words,
                             unsigned int seed0, unsigned int seed1,
                             unsigned int call, void* out, int threads,
                             void* stream) {
  symbols_kernel<<<grid_of(rows, cols, threads), threads, 0,
                   (cudaStream_t)stream>>>(rows, cols,
                                           (const long long*)words, seed0,
                                           seed1, call, (int8_t*)out);
  return (int)cudaGetLastError();
}

// AWGN and quantization on `stream`: cw and llr (rows, cols) int8. Bits
// mode: w1 (radius) and w2 (angle) (rows, cols) int64; native mode: both
// null. Returns cudaGetLastError().
extern "C" int polar_awgn(int rows, int cols, float sigma, float scale,
                          const void* cw, const void* w1, const void* w2,
                          unsigned int seed0, unsigned int seed1,
                          unsigned int call, void* llr, int threads,
                          void* stream) {
  awgn_kernel<<<grid_of(rows, cols, threads), threads, 0,
                (cudaStream_t)stream>>>(
      rows, cols, sigma, scale, (const int8_t*)cw, (const long long*)w1,
      (const long long*)w2, seed0, seed1, call, (int8_t*)llr);
  return (int)cudaGetLastError();
}
