// Elementwise channel kernels over a frame-major (rows, cols) grid: the +-1
// message symbols and the AWGN + quantization pass of the Monte-Carlo step
// around a caller's decoder (ops/cuda/channel_kernel.py).
//
// Replaces polar_tpu/ops/pallas/channel_kernel.py:
//   symbols_lines_kernel: make_pallas_symbols (:120), _sym_kernel_native /
//     _sym_kernel_bits (:77-86): symbol = 1 - 2 (word & 1);
//   awgn_lines_kernel: make_pallas_awgn (:146), _awgn_body and _normals
//     (:47-65): llr = quant(2/sigma^2 (cw + sigma n)), n by the cosine-only
//     Box-Muller on two independent words per element.
//
// Row f of a grid is frame f. Native mode reads word c of frame f's Philox
// stream (philox.cuh, counter (f, c / 4, call, 0)): symbol c from word c of
// the message stream; the normal of element c from words c (radius) and
// cols + c (angle) of the noise stream, which has seeds of its own. Bits
// mode reads the same words from int64 tensors in [0, 2^32), so the kernels
// can be held against their plain versions on any words.
//
// What bounds AWGN on this card: instruction throughput. Each element
// needs two Philox words (half a block each), two unit maps, a logf, a
// sqrtf, the cosine polynomial and the quantize, about 100 instructions,
// against 2 bytes of device memory; and -fmad=false (the plain version's
// rounding) keeps every product and sum a single-rate instruction, so the
// rate is 132 SMs x 128 lanes x 1.98 GHz = 33.5 T/s, half the FMA-counted
// 67 T/s of the bound. So awgn_lines_kernel spends no instruction it need
// not (a thread-a-quad grid with a 64-bit division per thread, a runtime
// element loop and both sincos polynomials were slower; PERF.md section 6,
// rows 10 and 11):
//   - a 2-D grid, column groups on x and frames on y (a frame loop past
//     65535 rows), so no thread divides;
//   - 16 elements a thread in straight-line code when cols % 16 == 0 and
//     the tensors are 16-byte aligned: four radius and four angle Philox
//     blocks (PhiloxFrame: round keys and the first round once per thread
//     and frame, one wide multiply per product), one 16-byte load of cw
//     and one 16-byte store of llr, all lane indices compile-time;
//   - one polynomial per normal (philox.cuh:cos_2pi), which rounds as
//     sincos_2pi's cosine does.
// Ragged rows (cols % 16 != 0, or unaligned tensors) take the same kernel
// with a bound check per element and byte accesses. logf, sqrtf, rintf and
// -fmad=false stay: they are what the plain version computes on the card.
//
// What bounds symbols on this card: instruction throughput. A symbol needs
// a quarter of a Philox block (nine rounds of two wide multiplies and two
// three-input XORs, once the frame's first round is shared) against one
// byte of device memory. symbols_lines_kernel takes awgn_lines' shape: the
// same 2-D grid and frame loop, 16 symbols a thread in straight-line code
// when cols % 16 == 0 and the output (and the words in bits mode) is
// 16-byte aligned: four PhiloxFrame blocks, the +-1 bytes packed four to a
// word (0x01 | (w & 1) * 0xFE) and one 16-byte store.
// Bits mode (int64 words in) takes the same kernel with 16-byte word loads,
// a warp's together where its 512 columns lie in one row; it is bound by
// its 9 bytes a symbol.

#include <cuda_runtime.h>

#include "channel.cuh"

namespace {

__device__ __forceinline__ uint32_t lane_of(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The AWGN pass in straight-line code: a thread takes 16 neighbouring
// elements of a row (column group blockIdx.x * blockDim.x + threadIdx.x)
// in every frame blockIdx.y * blockDim.y + threadIdx.y + k gridDim.y
// blockDim.y. STRAIGHT: cols % 16 == 0 and every tensor 16-byte aligned,
// so the radius words c0 .. c0 + 15 are four whole Philox blocks, the
// angle words cols + c0 .. cols + c0 + 15 four more, and the accesses are
// 16 bytes wide; else a bound check per element and byte accesses.
template <bool BITS, bool STRAIGHT>
__global__ void __launch_bounds__(256) awgn_lines_kernel(
    int rows, int cols, float sigma, float scale,
    const int8_t* __restrict__ cw, const long long* __restrict__ w1,
    const long long* __restrict__ w2, uint32_t seed0, uint32_t seed1,
    uint32_t call, int8_t* __restrict__ llr) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * 16;
  if (c0 >= cols) return;
  polar::PhiloxFrame ph(make_uint2(seed0, seed1));
  for (int f = blockIdx.y * blockDim.y + threadIdx.y; f < rows;
       f += gridDim.y * blockDim.y) {
    const long long base = (long long)f * cols + c0;
    uint32_t a[16], b[16];
    int8_t x[16];
    if (STRAIGHT) {
      const uint4 v = *reinterpret_cast<const uint4*>(cw + base);
      const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = (int8_t)(vw[i >> 2] >> (8 * (i & 3)));
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = c0 + i < cols ? cw[base + i] : 0;
    }
    if (BITS) {
      if (STRAIGHT) {
        const longlong2* p1 = reinterpret_cast<const longlong2*>(w1 + base);
        const longlong2* p2 = reinterpret_cast<const longlong2*>(w2 + base);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const longlong2 u = p1[i], v = p2[i];
          a[2 * i] = (uint32_t)u.x;
          a[2 * i + 1] = (uint32_t)u.y;
          b[2 * i] = (uint32_t)v.x;
          b[2 * i + 1] = (uint32_t)v.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const bool in = c0 + i < cols;
          a[i] = in ? (uint32_t)w1[base + i] : 0u;
          b[i] = in ? (uint32_t)w2[base + i] : 0u;
        }
      }
    } else {
      ph.start((uint32_t)f, call);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (STRAIGHT || c0 + 4 * q < cols)
          v = ph.block((uint32_t)((c0 >> 2) + q));
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
      if (STRAIGHT) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 v = ph.block((uint32_t)(((cols + c0) >> 2) + q));
          b[4 * q] = v.x;
          b[4 * q + 1] = v.y;
          b[4 * q + 2] = v.z;
          b[4 * q + 3] = v.w;
        }
      } else {  // angle words may straddle five blocks
        int blk = -1;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int w = cols + c0 + i;
          if (c0 + i < cols && (w >> 2) != blk) {
            blk = w >> 2;
            v = ph.block((uint32_t)blk);
          }
          b[i] = lane_of(v, w & 3);
        }
      }
    }
    uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float r = sqrtf(-2.0f * logf(polar::bits_to_unit(a[i])));
      const float n = r * polar::cos_2pi(polar::bits_to_unit(b[i]));
      const int8_t q = polar::quantize((float)x[i], n, sigma, scale);
      if (STRAIGHT)
        out[i >> 2] |= (uint32_t)(uint8_t)q << (8 * (i & 3));
      else if (c0 + i < cols)
        llr[base + i] = q;
    }
    if (STRAIGHT)
      *reinterpret_cast<uint4*>(llr + base) =
          make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// The symbols in straight-line code: a thread takes the 16 neighbouring
// symbols c0 .. c0 + 15 of a row (column group blockIdx.x * blockDim.x +
// threadIdx.x) in every frame blockIdx.y * blockDim.y + threadIdx.y +
// k gridDim.y blockDim.y. Native mode: symbol c0 + 4 q + i from lane i of
// Philox block c0 / 4 + q of the frame's stream. STRAIGHT: cols % 16 == 0
// and out (and words) 16-byte aligned; else a bound check per element.
// WARP (bits mode, STRAIGHT and cols % 512 == 0, so a warp holds 512
// neighbouring columns of one row): the warp reads its 4 KiB of words
// coalesced, 32 lanes x 16 bytes an instruction, and hands each lane its
// words' low bits by ballot, where a lane's own eight 16-byte loads would
// each touch 32 lines.
template <bool BITS, bool STRAIGHT, bool WARP = false>
__global__ void __launch_bounds__(256) symbols_lines_kernel(
    int rows, int cols, const long long* __restrict__ words, uint32_t seed0,
    uint32_t seed1, uint32_t call, int8_t* __restrict__ out) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * 16;
  if (c0 >= cols) return;
  polar::PhiloxFrame ph(make_uint2(seed0, seed1));
  for (int f = blockIdx.y * blockDim.y + threadIdx.y; f < rows;
       f += gridDim.y * blockDim.y) {
    const long long base = (long long)f * cols + c0;
    uint32_t w[16];
    if (BITS && WARP) {
      const int lane = threadIdx.x & 31;
      const longlong2* p =
          reinterpret_cast<const longlong2*>(words + base - 16 * lane);
      uint32_t even = 0u, odd = 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const longlong2 v = p[32 * k + lane];
        const uint32_t e = __ballot_sync(0xFFFFFFFFu, (int)(v.x & 1));
        const uint32_t o = __ballot_sync(0xFFFFFFFFu, (int)(v.y & 1));
        if (k == lane >> 2) {
          even = e;
          odd = o;
        }
      }
      // the lane's words 16 lane + 2 j and + 1 (j < 8) are pair 8 lane + j:
      // bit 8 (lane & 3) + j of ballot lane >> 2
      even >>= 8 * (lane & 3);
      odd >>= 8 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w[2 * j] = (even >> j) & 1u;
        w[2 * j + 1] = (odd >> j) & 1u;
      }
    } else if (BITS) {
      if (STRAIGHT) {
        const longlong2* p = reinterpret_cast<const longlong2*>(words + base);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const longlong2 v = p[i];
          w[2 * i] = (uint32_t)v.x;
          w[2 * i + 1] = (uint32_t)v.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w[i] = c0 + i < cols ? (uint32_t)words[base + i] : 0u;
      }
    } else {
      ph.start((uint32_t)f, call);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (STRAIGHT || c0 + 4 * q < cols)
          v = ph.block((uint32_t)((c0 >> 2) + q));
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
    }
    if (STRAIGHT) {
      uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        packed[i >> 2] |= (0x01u | (w[i] & 1u) * 0xFEu) << (8 * (i & 3));
      *reinterpret_cast<uint4*>(out + base) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (c0 + i < cols) out[base + i] = (int8_t)(1 - 2 * (int)(w[i] & 1u));
    }
  }
}

// The lines kernels' grid: column groups of 16 on x, frames on y, 256
// threads a block, at most 65535 blocks on y (the frame loop takes the rest).
void lines_grid(int rows, int cols, dim3* grid, dim3* block) {
  const int groups = (cols + 15) / 16;
  const int gx = groups < 256 ? groups : 256;
  const int gy = 256 / gx;
  const long long fy = ((long long)rows + gy - 1) / gy;
  *grid = dim3((groups + gx - 1) / gx,
               (unsigned int)(fy < 65535 ? fy : 65535));
  *block = dim3(gx, gy);
}

}  // namespace

// Symbols (symbols_lines_kernel) on `stream`: out (rows, cols) int8 +-1.
// Bits mode: words (rows, cols) int64; native mode: words null, Philox
// keyed by (seed0, seed1) with counter word 2 = call. straight != 0 only
// when cols % 16 == 0 and out (and words in bits mode) are 16-byte
// aligned, 2 when besides cols % 512 == 0 (bits mode reads a warp's words
// together). Returns cudaGetLastError().
extern "C" int polar_symbols_lines(int rows, int cols, const void* words,
                                   unsigned int seed0, unsigned int seed1,
                                   unsigned int call, void* out, int straight,
                                   void* stream) {
  dim3 grid, block;
  lines_grid(rows, cols, &grid, &block);
  const cudaStream_t s = (cudaStream_t)stream;
  const long long* w = (const long long*)words;
  int8_t* o = (int8_t*)out;
  if (words != nullptr) {
    if (straight == 2 && cols % 512 == 0)
      symbols_lines_kernel<true, true, true><<<grid, block, 0, s>>>(
          rows, cols, w, seed0, seed1, call, o);
    else if (straight)
      symbols_lines_kernel<true, true><<<grid, block, 0, s>>>(
          rows, cols, w, seed0, seed1, call, o);
    else
      symbols_lines_kernel<true, false><<<grid, block, 0, s>>>(
          rows, cols, w, seed0, seed1, call, o);
  } else {
    if (straight)
      symbols_lines_kernel<false, true><<<grid, block, 0, s>>>(
          rows, cols, w, seed0, seed1, call, o);
    else
      symbols_lines_kernel<false, false><<<grid, block, 0, s>>>(
          rows, cols, w, seed0, seed1, call, o);
  }
  return (int)cudaGetLastError();
}

// AWGN and quantization (awgn_lines_kernel) on `stream`: cw and llr (rows,
// cols) int8. Bits mode: w1 (radius) and w2 (angle) (rows, cols) int64;
// native mode: both null. straight != 0 only when cols % 16 == 0 and cw,
// llr (and w1, w2 in bits mode) are 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int polar_awgn_lines(int rows, int cols, float sigma, float scale,
                                const void* cw, const void* w1,
                                const void* w2, unsigned int seed0,
                                unsigned int seed1, unsigned int call,
                                void* llr, int straight, void* stream) {
  dim3 grid, block;
  lines_grid(rows, cols, &grid, &block);
  const cudaStream_t s = (cudaStream_t)stream;
  const int8_t* c = (const int8_t*)cw;
  const long long* a = (const long long*)w1;
  const long long* b = (const long long*)w2;
  int8_t* out = (int8_t*)llr;
  if (w1 != nullptr) {
    if (straight)
      awgn_lines_kernel<true, true><<<grid, block, 0, s>>>(
          rows, cols, sigma, scale, c, a, b, seed0, seed1, call, out);
    else
      awgn_lines_kernel<true, false><<<grid, block, 0, s>>>(
          rows, cols, sigma, scale, c, a, b, seed0, seed1, call, out);
  } else {
    if (straight)
      awgn_lines_kernel<false, true><<<grid, block, 0, s>>>(
          rows, cols, sigma, scale, c, a, b, seed0, seed1, call, out);
    else
      awgn_lines_kernel<false, false><<<grid, block, 0, s>>>(
          rows, cols, sigma, scale, c, a, b, seed0, seed1, call, out);
  }
  return (int)cudaGetLastError();
}
