// Block polar encoder: the bottom butterfly stages of a frame-major (B, N)
// codeword, one row block of one frame per thread block, in shared memory
// (ops/cuda/encode_kernel.py).
//
// Replaces polar_tpu/ops/pallas/encode_kernel.py:make_pallas_encoder (:63),
// _block_kernel (:52): per 2^l-row block, B(x) or, when systematic,
// B(mask . B(x)), where B is the transform's stages h < 2^l and mask pins
// the frozen rows to +1 (polar_encoder.hh:30-59). The stages commute, so
// with the top stages P outside, T(mask . T(u)) = P B mask B P u
// (encode_kernel.py:1-33). For 2^l = N the kernel also scatters the message
// into the info rows and the whole encode is this one launch; for 2^l < N
// the wrapper scatters and runs P in torch, as the JAX package runs them in
// XLA.
//
// In the frame-major layout one frame's block is 2^l contiguous bytes, so a
// block of up to 2^17 bytes (the largest power of two within the 227 KB of
// shared memory a block may take) sits in shared memory for all its
// stages. Values are +-1 int8 (the message contract), held as b ^ 1 (+1 ->
// 0x00, -1 -> 0xFE) so that the butterfly's product becomes XOR and four
// rows go in one 32-bit word: stages h = 1, 2 are shifts inside a word, the
// others XOR word pairs h / 4 apart, all threads in step between stages.
// The refreeze ANDs each word with its frozen mask (an all-info block keeps
// every byte). What bounds it: shared-memory word traffic and one barrier
// per stage (2 l stages when systematic); device memory sees the message
// once and the codeword once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kOnes = 0x01010101u;

// bytes [0, len) of p as a little-endian word, zero above len (< 4)
__device__ __forceinline__ uint32_t short_word(const uint8_t* p, int len) {
  uint32_t w = 0u;
  for (int i = 0; i < len; ++i) w |= (uint32_t)p[i] << (8 * i);
  return w;
}

// The stages h < blk of the words s[0, words), in the XOR domain.
__device__ void butterfly(uint32_t* s, int blk, int words) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int i = t; i < words; i += nt) {
    uint32_t w = s[i];
    if (blk > 1) w ^= (w >> 8) & 0x00FF00FFu;   // h = 1: bytes 0, 2 ^= 1, 3
    if (blk > 2) w ^= (w >> 16) & 0x0000FFFFu;  // h = 2: bytes 0, 1 ^= 2, 3
    s[i] = w;
  }
  __syncthreads();
  for (int hw = 1; hw < words; hw <<= 1) {  // h = 4 hw rows
    for (int p = t; p < words / 2; p += nt) {
      const int i = ((p & ~(hw - 1)) << 1) | (p & (hw - 1));
      s[i] ^= s[i + hw];
    }
    __syncthreads();
  }
}

__global__ void encode_kernel(const int8_t* __restrict__ msg, int k,
                              const int* __restrict__ info,
                              const int* __restrict__ kstart, int scatter,
                              const int8_t* __restrict__ x,
                              const uint8_t* __restrict__ frozen, int n,
                              int blk, int systematic,
                              int8_t* __restrict__ out) {
  extern __shared__ uint32_t s[];
  const int f = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, nt = blockDim.x;
  const int r0 = b * blk;
  const int words = (blk + 3) >> 2;
  const long long row = (long long)f * n + r0;
  if (scatter) {
    for (int i = t; i < words; i += nt) s[i] = 0u;  // every row +1
    __syncthreads();
    uint8_t* sb = reinterpret_cast<uint8_t*>(s);
    const long long mrow = (long long)f * k;
    for (int j = kstart[b] + t; j < kstart[b + 1]; j += nt)
      sb[info[j] - r0] = (uint8_t)msg[mrow + j] ^ 1u;
  } else if (blk >= 4) {
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(x + row);
    for (int i = t; i < words; i += nt) s[i] = xw[i] ^ kOnes;
  } else if (t == 0) {
    s[0] = short_word(reinterpret_cast<const uint8_t*>(x + row), blk) ^ kOnes;
  }
  __syncthreads();
  butterfly(s, blk, words);
  if (systematic) {
    for (int i = t; i < words; i += nt) {
      const uint32_t fw =
          blk >= 4 ? reinterpret_cast<const uint32_t*>(frozen + r0)[i]
                   : short_word(frozen + r0, blk);
      s[i] &= ~(fw * 0xFFu);  // frozen bytes (0x01) -> 0x00, i.e. +1
    }
    __syncthreads();
    butterfly(s, blk, words);
  }
  if (blk >= 4) {
    uint32_t* ow = reinterpret_cast<uint32_t*>(out + row);
    for (int i = t; i < words; i += nt) ow[i] = s[i] ^ kOnes;
  } else if (t == 0) {
    const uint32_t w = s[0] ^ kOnes;
    for (int i = 0; i < blk; ++i) out[row + i] = (int8_t)(w >> (8 * i));
  }
}

}  // namespace

// One launch on `stream` over a (batch, n / blk) grid of blocks: out
// (batch, n) int8. scatter != 0: the input is msg (batch, k) int8 +-1,
// placed at the ascending info rows `info` (k int32), kstart (n / blk + 1
// int32) being each row block's first info index; else the input is x
// (batch, n) int8 +-1. frozen (n uint8) is read when systematic != 0.
// blk is a power of two dividing n, at most 2^17; n is 2 or a multiple of
// 4. Returns cudaGetLastError().
extern "C" int polar_encode(const void* msg, int k, const void* info,
                            const void* kstart, int scatter, const void* x,
                            const void* frozen, int n, int batch, int blk,
                            int systematic, void* out, int threads,
                            void* stream) {
  const int bytes = blk < 4 ? 4 : blk;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(batch, n / blk);
  encode_kernel<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      (const int8_t*)msg, k, (const int*)info, (const int*)kstart, scatter,
      (const int8_t*)x, (const uint8_t*)frozen, n, blk, systematic,
      (int8_t*)out);
  return (int)cudaGetLastError();
}
