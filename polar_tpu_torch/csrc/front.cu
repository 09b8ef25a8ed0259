// Block-structured Monte-Carlo front for large N: the message draw and the
// channel of the step, as two row-block kernels around the middle's top
// butterfly stages (ops/cuda/front_kernel.py).
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
//     AWGN and quantization;
//   the middle (front_middle_kernel): _stages_kernel (:800) over
//     _stages_rows (:781), with the systematic refreeze that the JAX
//     package runs as an XLA where between two such passes (:1000-1007).
//
// Native mode draws the words of the fused step kernel (step.cu): row r's
// message symbol from word N + r of the frame's Philox stream, row r's
// normal from radius word r mod N/2 and angle word N/2 + r mod N/2 (the cos
// output for r < N/2, the sin output above), through channel.cuh. A kernel-B
// thread therefore computes its rows' normals from both words, whichever
// block holds the partner row, and the large-N step reproduces the fused
// step's LLRs and counters on the same seeds.
//
// Grid of A and B: x over frames (one thread per frame, masked tail), y over
// row blocks; every array is element-major (N, B) int8 (normals float32), so
// a warp's row accesses are neighbouring bytes. What bounds them on the
// card: kernel A is a byte-store stream plus one Philox block per four rows;
// kernel B is compute-bound on two Philox blocks, a logf, a sqrtf and the
// sin/cos polynomial per four rows, over a butterfly whose in-place passes
// stay in L1/L2 for the block sizes used (2^8 .. 2^12 rows).
//
// The middle is bound by device memory: it has to read and write the (N, B)
// +-1 array once, 2^30 bytes at m = 17, B = 4096 (0.32 ms at 3.35 TB/s).
// Every stage h >= h_lo pairs rows in the same residue class mod h_lo, so a
// thread that owns residue r and four neighbouring frames loads the G rows
// r + j h_lo once (one 32-bit word per row: a warp reads 128 contiguous
// bytes), holds each frame's G values as bits (+1 -> 0, -1 -> 1, the
// product becomes XOR), runs the first transform's stages, the refreeze (a
// per-residue frozen bit mask) and the second transform's stages, and stores
// the rows once. Stage s of the window pairs bit j with bit j + 2^s: a
// masked shift inside a 32-bit word for s < 5, an XOR of two words above.
// Where G is more than a thread holds (2^8 bits a frame), the wrapper splits
// the stages into passes over windows of consecutive stages; at m = 17 with
// row blocks of 2^10 the whole systematic middle is one pass.

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


// Window bits of frame q held as W 32-bit words: stages [lo, hi) of the
// window (stage s pairs bit j, bit s clear, with bit j + 2^s; j ^= j + 2^s).
template <int W>
__device__ __forceinline__ void window_stages(uint32_t (&x)[4][W], int lo,
                                              int hi) {
  for (int s = lo; s < min(hi, 5); ++s) {
    const int sh = 1 << s;
    const uint32_t low = 0xFFFFFFFFu / ((1u << sh) + 1u);  // bit s clear
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < W; ++w) x[q][w] ^= (x[q][w] >> sh) & low;
  }
#pragma unroll
  for (int e = 0; (1 << e) < W; ++e) {
    if (5 + e < lo || 5 + e >= hi) continue;
    const int d = 1 << e;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w & d) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q][w] ^= x[q][w | d];
    }
  }
}

// One pass of the middle over windows of G = 2^glog rows r + j h_lo
// (j < G) at offset g * h_lo * G: thread = (window, four frames). Applies
// the window's stages [s1_lo, s1_hi), the refreeze (frz: W words of frozen
// bits per residue r, read when refreeze != 0; only a pass whose window
// spans all N rows refreezes), then stages [s2_lo, s2_hi). in and out may
// be the same array: every element is read and written by one thread.
template <int W>
__global__ void front_middle_kernel(const int8_t* in, int8_t* out,
                                    const uint32_t* __restrict__ frz,
                                    int batch, int words, int quads,
                                    int qblocks, int h_lo, int glog,
                                    int s1_lo, int s1_hi, int refreeze,
                                    int s2_lo, int s2_hi) {
  const int q = (blockIdx.x % qblocks) * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  const long long win = blockIdx.x / qblocks;
  const int r = (int)(win % h_lo);
  const int g_rows = 1 << glog;
  const long long b = batch;
  const long long base = ((win / h_lo) * h_lo * g_rows + r) * b + 4LL * q;
  const long long step = (long long)h_lo * b;
  const int nf = min(4, batch - 4 * q);
  uint32_t x[4][W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t a[4] = {0u, 0u, 0u, 0u};
    const int lim = min(32, g_rows - 32 * w);
    for (int jj = 0; jj < lim; ++jj) {
      const int8_t* p = in + base + (32LL * w + jj) * step;
      uint32_t v = 0x01010101u;
      if (words) {
        v = *reinterpret_cast<const uint32_t*>(p);
      } else {
        for (int k = 0; k < nf; ++k)
          v = (v & ~(0xFFu << (8 * k))) | ((uint32_t)(uint8_t)p[k] << (8 * k));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] |= ((v >> (8 * k + 1)) & 1u) << jj;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k][w] = a[k];
  }
  window_stages<W>(x, s1_lo, s1_hi);
  if (refreeze) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t keep = ~__ldg(frz + (long long)r * W + w);
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k][w] &= keep;
    }
  }
  window_stages<W>(x, s2_lo, s2_hi);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int lim = min(32, g_rows - 32 * w);
    for (int jj = 0; jj < lim; ++jj) {
      uint32_t bits = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) bits |= ((x[k][w] >> jj) & 1u) << (8 * k);
      const uint32_t v = 0x01010101u | (bits * 0xFEu);  // 0 -> +1, 1 -> -1
      int8_t* p = out + base + (32LL * w + jj) * step;
      if (words) {
        *reinterpret_cast<uint32_t*>(p) = v;
      } else {
        for (int k = 0; k < nf; ++k) p[k] = (int8_t)(v >> (8 * k));
      }
    }
  }
}

template <int W>
int launch_middle(const void* in, void* out, const void* frz, int n,
                  int batch, int words, int h_lo, int glog, int s1_lo,
                  int s1_hi, int refreeze, int s2_lo, int s2_hi, int threads,
                  cudaStream_t stream) {
  const int quads = (batch + 3) / 4;
  const int qblocks = (quads + threads - 1) / threads;
  const long long windows = (long long)n >> glog;  // h_lo residues x groups
  front_middle_kernel<W><<<(unsigned)(windows * qblocks), threads, 0,
                           stream>>>(
      (const int8_t*)in, (int8_t*)out, (const uint32_t*)frz, batch, words,
      quads, qblocks, h_lo, glog, s1_lo, s1_hi, refreeze, s2_lo, s2_hi);
  return (int)cudaGetLastError();
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

// One middle pass on `stream` (front_middle_kernel): in, out (n, batch) int8
// +-1, element-major, possibly the same array; windows of 2^glog rows at
// stride h_lo; frz (h_lo, W) uint32 frozen bits, W = max(1, 2^glog / 32),
// read when refreeze != 0. glog at most 8. words != 0: batch is a multiple
// of 4 and in, out are 4-byte aligned, so each thread moves one 32-bit word
// per row; else bytes. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a glog out of range.
extern "C" int polar_front_middle(const void* in, void* out, const void* frz,
                                  int n, int batch, int words, int h_lo,
                                  int glog, int s1_lo, int s1_hi,
                                  int refreeze, int s2_lo, int s2_hi,
                                  int threads, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (glog <= 5 ? 1 : 1 << (glog - 5)) {
    case 1:
      return launch_middle<1>(in, out, frz, n, batch, words, h_lo, glog,
                              s1_lo, s1_hi, refreeze, s2_lo, s2_hi, threads,
                              st);
    case 2:
      return launch_middle<2>(in, out, frz, n, batch, words, h_lo, glog,
                              s1_lo, s1_hi, refreeze, s2_lo, s2_hi, threads,
                              st);
    case 4:
      return launch_middle<4>(in, out, frz, n, batch, words, h_lo, glog,
                              s1_lo, s1_hi, refreeze, s2_lo, s2_hi, threads,
                              st);
    case 8:
      return launch_middle<8>(in, out, frz, n, batch, words, h_lo, glog,
                              s1_lo, s1_hi, refreeze, s2_lo, s2_hi, threads,
                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
