// Block-structured Monte-Carlo front for large N: the message draw and the
// channel of the step, as two row-block kernels around a plain torch middle
// (ops/cuda/front_kernel.py).
//
// Replaces polar_tpu/ops/pallas/step_kernel.py:make_pallas_front_blocks
// (:831):
//   kernel A (front_msg_kernel): _msg_block_kernel_native / _inject
//     (:713-734): +-1 message symbols, frozen rows pinned to +1, then the
//     block's bottom butterfly stages (systematic); _msg_u0_kernel_native /
//     _inject (:737-759): the same draw and pin without the butterfly (the
//     non-systematic u0);
//   kernel B (front_chan_kernel): _chan_block_kernel_native / _inject and
//     _chan_block_body (:762-778): the block's bottom butterfly stages,
//     AWGN and quantization.
// The middle (top stages and refreeze, :957-970) stays torch, as it is XLA
// in the JAX package.
//
// Native mode draws the words of the fused step kernel (step.cu): row r's
// message symbol from word N + r of the frame's Philox stream, row r's
// normal from radius word r mod N/2 and angle word N/2 + r mod N/2 (the cos
// output for r < N/2, the sin output above), through channel.cuh. A kernel-B
// thread therefore computes its rows' normals from both words, whichever
// block holds the partner row, and the large-N step reproduces the fused
// step's LLRs and counters on the same seeds.
//
// Grid: x over frames (one thread per frame, masked tail), y over row
// blocks; every array is element-major (N, B) int8 (normals float32), so a
// warp's row accesses are neighbouring bytes. What bounds it on the card:
// kernel A is a byte-store stream plus one Philox block per four rows;
// kernel B is compute-bound on two Philox blocks, a logf, a sqrtf and the
// sin/cos polynomial per four rows, over a butterfly whose in-place passes
// stay in L1/L2 for the block sizes used (2^8 .. 2^12 rows).

#include <cuda_runtime.h>

#include "channel.cuh"
#include "fastssc.cuh"

namespace {

__global__ void front_msg_kernel(const uint8_t* __restrict__ frozen, int n,
                                 int batch, int blk, int butterfly,
                                 const int8_t* __restrict__ msg_in,
                                 uint32_t seed0, uint32_t seed1,
                                 uint32_t call, int8_t* out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= batch) return;
  const long long b = batch;
  const int r0 = blockIdx.y * blk;
  const polar::Col o{out + (long long)r0 * b + f, b};
  polar::PhiloxStream words(make_uint2(seed0, seed1), (uint32_t)f, call);
  for (int i = 0; i < blk; ++i) {
    const int r = r0 + i;
    int8_t sym = 1;
    if (!__ldg(frozen + r))
      sym = msg_in != nullptr
                ? msg_in[(long long)r * b + f]
                : (int8_t)(1 - 2 * (int)(words.word(n + r) & 1u));
    o[i] = sym;
  }
  if (butterfly) polar::transform(o, blk);
}

__global__ void front_chan_kernel(int n, int batch, int blk, float sigma,
                                  float scale, const int8_t* __restrict__ y,
                                  const float* __restrict__ normals_in,
                                  uint32_t seed0, uint32_t seed1,
                                  uint32_t call, int8_t* llr, int8_t* cw) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= batch) return;
  const long long b = batch;
  const int r0 = blockIdx.y * blk;
  const long long base = (long long)r0 * b + f;
  const polar::Col c{cw + base, b};
  for (int i = 0; i < blk; ++i) c[i] = y[base + (long long)i * b];
  polar::transform(c, blk);
  const uint2 key = make_uint2(seed0, seed1);
  polar::PhiloxStream radius_words(key, (uint32_t)f, call);
  polar::PhiloxStream angle_words(key, (uint32_t)f, call);
  const int h = n >> 1;
  for (int i = 0; i < blk; ++i) {
    const int r = r0 + i;
    float nz;
    if (normals_in != nullptr) {
      nz = normals_in[base + (long long)i * b];
    } else {
      const int j = r < h ? r : r - h;
      float n0, n1;
      polar::box_muller(radius_words.word(j), angle_words.word(h + j), &n0,
                        &n1);
      nz = r < h ? n0 : n1;
    }
    llr[base + (long long)i * b] =
        polar::quantize((float)c[i], nz, sigma, scale);
  }
}

}  // namespace

// Kernel A on `stream`: out (n, batch) int8. Inject mode: msg (n, batch)
// int8 +-1; native mode: msg null, words from Philox keyed by (seed0, seed1)
// with counter word 2 = call. blk (a power of two dividing n) rows per
// block; butterfly != 0 applies the block's bottom stages. Returns
// cudaGetLastError().
extern "C" int polar_front_msg(const void* frozen, int n, int batch, int blk,
                               int butterfly, const void* msg,
                               unsigned int seed0, unsigned int seed1,
                               unsigned int call, void* out, int threads,
                               void* stream) {
  const dim3 grid((batch + threads - 1) / threads, n / blk);
  front_msg_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frozen, n, batch, blk, butterfly, (const int8_t*)msg,
      seed0, seed1, call, (int8_t*)out);
  return (int)cudaGetLastError();
}

// Kernel B on `stream`: y (n, batch) int8 in, llr and cw (n, batch) int8
// out. Inject mode: normals (n, batch) float32; native mode: normals null.
// Returns cudaGetLastError().
extern "C" int polar_front_chan(int n, int batch, int blk, float sigma,
                                float scale, const void* y,
                                const void* normals, unsigned int seed0,
                                unsigned int seed1, unsigned int call,
                                void* llr, void* cw, int threads,
                                void* stream) {
  const dim3 grid((batch + threads - 1) / threads, n / blk);
  front_chan_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      n, batch, blk, sigma, scale, (const int8_t*)y, (const float*)normals,
      seed0, seed1, call, (int8_t*)llr, (int8_t*)cw);
  return (int)cudaGetLastError();
}
