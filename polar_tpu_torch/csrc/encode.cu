// Block polar encoder: the bottom butterfly stages of a frame-major (B, N)
// codeword, one row block of one frame at a time (ops/cuda/encode_kernel.py).
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
// What bounds it on this card: device memory. It must read the message
// (or the block input) once and write the codeword once, 805 MB at
// Polar(131072, 65536), B = 4096 (0.24 ms at 3.35 TB/s); the butterfly's
// word operations are far below that.
//
// encode_bits_kernel: one bit a row. +1 -> 0, -1 -> 1, so
// the butterfly's product is XOR and 32 rows share a word (a frame of
// Polar(131072, 65536) is 16 KB). A frame's block is W words spread over
// T threads (T = min(W, 256), a power of two), R = W / T words a thread in
// registers, word i T + t in thread t's register i; a thread block of 256
// threads holds 256 / T frame blocks. The stages of a butterfly run where
// their pairs lie: rows within a word by masked shift-XORs; words across
// the lanes of a warp by __shfl_xor_sync; words across a thread's
// registers in registers; only words across warps (T > 32) through shared
// memory (R words a thread, 16 KB a thread block). The systematic
// refreeze ANDs each word with its info mask. Rows are packed on load and
// unpacked on store; where a warp holds 32 neighbouring words of a frame
// (T >= 32), its lanes move 512 contiguous bytes an instruction and trade
// 16-row halves by shuffles. With the scatter, the frame's message row is
// read 16 bytes a thread into shared memory as a bit stream; each word's
// run of it starts at the word's first message symbol (a host table, with
// each word's info mask) and is deposited at the mask's set bits (an
// all-info word takes the run as it is). A byte a row in shared memory,
// every stage a pass and a barrier, was 1.9-5.2x slower (PERF.md section
// 6, row 12).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBitThreads = 256;

// four +-1 bytes -> four bits (-1 -> 1), byte j to bit j: bit 1 of each
// byte, gathered by one product (no two partial bits meet)
__device__ __forceinline__ uint32_t nibble_of(uint32_t x) {
  return ((((x >> 1) & 0x01010101u) * 0x00204081u) >> 21) & 0xFu;
}

// four bits -> four +-1 bytes (1 -> 0xFF, 0 -> 0x01), bit j to byte j
__device__ __forceinline__ uint32_t bytes_of(uint32_t n) {
  return 0x01010101u | (((n * 0x00204081u) & 0x01010101u) * 0xFEu);
}

// u rows (u = 32, or the block when it is smaller) of +-1 bytes at p as bits
__device__ __forceinline__ uint32_t pack_rows(const int8_t* p, int u,
                                              bool vec) {
  if (u == 32 && vec) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint4 b = reinterpret_cast<const uint4*>(p)[1];
    return nibble_of(a.x) | nibble_of(a.y) << 4 | nibble_of(a.z) << 8 |
           nibble_of(a.w) << 12 | nibble_of(b.x) << 16 |
           nibble_of(b.y) << 20 | nibble_of(b.z) << 24 | nibble_of(b.w) << 28;
  }
  uint32_t w = 0u;
  for (int j = 0; j < u; ++j) w |= (uint32_t)((uint8_t)p[j] >> 7) << j;
  return w;
}

__device__ __forceinline__ void unpack_rows(int8_t* p, uint32_t w, int u,
                                            bool vec) {
  if (u == 32 && vec) {
    reinterpret_cast<uint4*>(p)[0] =
        make_uint4(bytes_of(w & 0xFu), bytes_of((w >> 4) & 0xFu),
                   bytes_of((w >> 8) & 0xFu), bytes_of((w >> 12) & 0xFu));
    reinterpret_cast<uint4*>(p)[1] =
        make_uint4(bytes_of((w >> 16) & 0xFu), bytes_of((w >> 20) & 0xFu),
                   bytes_of((w >> 24) & 0xFu), bytes_of(w >> 28));
    return;
  }
  for (int j = 0; j < u; ++j) p[j] = (int8_t)(1 - 2 * (int)((w >> j) & 1u));
}

// 16 +-1 bytes -> 16 bits
__device__ __forceinline__ uint32_t half_of(uint4 a) {
  return nibble_of(a.x) | nibble_of(a.y) << 4 | nibble_of(a.z) << 8 |
         nibble_of(a.w) << 12;
}

__device__ __forceinline__ uint4 bytes_of_half(uint32_t h) {
  return make_uint4(bytes_of(h & 0xFu), bytes_of((h >> 4) & 0xFu),
                    bytes_of((h >> 8) & 0xFu), bytes_of((h >> 12) & 0xFu));
}

// The 32 words of a warp's lanes, lane l's word the 32 rows at p + 32 l,
// loaded so that the warp reads 512 contiguous bytes an instruction: lane l
// packs the 16-byte pieces l and 32 + l, and its word's two halves come
// from lanes 2l and 2l + 1 (mod 32) by two shuffles.
__device__ __forceinline__ uint32_t pack_warp_rows(const int8_t* p, int lane) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint32_t c = half_of(q[lane]) | half_of(q[32 + lane]) << 16;
  const uint32_t a = __shfl_sync(0xFFFFFFFFu, c, (2 * lane) & 31);
  const uint32_t b = __shfl_sync(0xFFFFFFFFu, c, (2 * lane + 1) & 31);
  return lane < 16 ? (a & 0xFFFFu) | b << 16 : (a >> 16) | (b & 0xFFFF0000u);
}

// the inverse: lane l stores the pieces l and 32 + l, halves of the words
// of lanes l / 2 and 16 + l / 2
__device__ __forceinline__ void unpack_warp_rows(int8_t* p, uint32_t w,
                                                 int lane) {
  uint4* q = reinterpret_cast<uint4*>(p);
  const int sh = (lane & 1) * 16;
  const uint32_t a = __shfl_sync(0xFFFFFFFFu, w, lane >> 1);
  const uint32_t b = __shfl_sync(0xFFFFFFFFu, w, 16 + (lane >> 1));
  q[lane] = bytes_of_half((a >> sh) & 0xFFFFu);
  q[32 + lane] = bytes_of_half((b >> sh) & 0xFFFFu);
}

// the low bits of `x` placed at the set bits of `m`, in order: the
// parallel-suffix expand of Hacker's Delight (Warren, 2nd ed., 7-5), the
// same instructions whatever the mask, so the lanes of a warp do not
// diverge over masks of different weight
__device__ __forceinline__ uint32_t deposit(uint32_t x, uint32_t m) {
  if (m == 0xFFFFFFFFu) return x;
  const uint32_t m0 = m;
  uint32_t mk = ~m << 1, mv[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    uint32_t mp = mk ^ (mk << 1);
    mp ^= mp << 2;
    mp ^= mp << 4;
    mp ^= mp << 8;
    mp ^= mp << 16;
    mv[i] = mp & m;
    m = (m ^ mv[i]) | (mv[i] >> (1 << i));
    mk &= ~mp;
  }
#pragma unroll
  for (int i = 4; i >= 0; --i) x = (x & ~mv[i]) | ((x << (1 << i)) & mv[i]);
  return x & m0;
}

// The stages h < blk of one frame block whose W = R T words are held as
// v[i] = word i T + t by its T threads (u rows a word; sw: the frame
// block's W words of shared memory, used when T > 32).
template <int R>
__device__ __forceinline__ void bit_butterfly(uint32_t (&v)[R], int u, int T,
                                              int t, uint32_t* sw) {
#pragma unroll
  for (int i = 0; i < R; ++i) {  // rows h < u inside a word
    uint32_t x = v[i];
    if (u > 1) x ^= (x >> 1) & 0x55555555u;
    if (u > 2) x ^= (x >> 2) & 0x33333333u;
    if (u > 4) x ^= (x >> 4) & 0x0F0F0F0Fu;
    if (u > 8) x ^= (x >> 8) & 0x00FF00FFu;
    if (u > 16) x ^= (x >> 16) & 0x0000FFFFu;
    v[i] = x;
  }
  const int lanes = T < 32 ? T : 32;
  for (int d = 1; d < lanes; d <<= 1) {  // words across lanes
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, v[i], d);
      if (!(t & d)) v[i] ^= y;
    }
  }
#pragma unroll
  for (int d = 1; d < R; d <<= 1) {  // words across registers
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (!(i & d)) v[i] ^= v[i + d];
  }
  if (T > 32) {  // words across warps, through shared memory
#pragma unroll
    for (int i = 0; i < R; ++i) sw[i * T + t] = v[i];
    __syncthreads();
    for (int d = 32; d < T; d <<= 1) {
      if (!(t & d)) {
#pragma unroll
        for (int i = 0; i < R; ++i) sw[i * T + t] ^= sw[i * T + t + d];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = sw[i * T + t];
    __syncthreads();
  }
}

// One launch: frame block q = blockIdx.x (256 / T) + threadIdx.x / T of
// batch * nb (frame q >> log_nb, row block q & (nb - 1)).
template <int R>
__global__ void __launch_bounds__(kBitThreads) encode_bits_kernel(
    const int8_t* __restrict__ msg, int k, const uint32_t* __restrict__ imask,
    const int* __restrict__ kfirst, int scatter,
    const int8_t* __restrict__ x, int n, long long frame_blocks, int log_nb,
    int blk, int u, int T, int log_t, int systematic, int vec,
    int8_t* __restrict__ out) {
  extern __shared__ uint32_t s[];
  const int local = threadIdx.x >> log_t, t = threadIdx.x & (T - 1);
  const long long q = (long long)blockIdx.x * (kBitThreads >> log_t) + local;
  const bool valid = q < frame_blocks;
  const long long f = q >> log_nb;
  const int b = (int)(q & ((1 << log_nb) - 1));
  const int words = R * T;
  const long long row = f * n + (long long)b * blk;
  // the frame block's shared memory: words + 2 words (the message as bits,
  // then the butterfly's stages across warps)
  uint32_t* sw = s + local * (words + 2);
  // a warp holds 32 neighbouring words of one frame block: its rows move
  // 512 contiguous bytes an instruction
  const bool warp_rows = vec && T >= 32;
  const int lane = threadIdx.x & 31;
  uint32_t v[R];
  if (scatter) {
    // the frame's K message bytes, read 16 bytes a thread from the aligned
    // piece around the row's start, as a bit stream in shared memory: bit
    // off + j is message symbol j
    const uintptr_t base = reinterpret_cast<uintptr_t>(msg + f * k);
    const int off = (int)(base & 15u);
    if (valid) {
      const uint4* src = reinterpret_cast<const uint4*>(base - off);
      uint16_t* bits = reinterpret_cast<uint16_t*>(sw);
      const int pieces = (off + k + 15) >> 4;
      for (int c = t; c < pieces; c += T)
        bits[c] = (uint16_t)half_of(__ldg(src + c));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int w = i * T + t;
      const uint32_t mk = valid ? imask[w] : 0u;
      v[i] = 0u;
      if (mk != 0u) {  // the word's run of message bits, deposited
        const int s0 = kfirst[w] + off;
        uint32_t run =
            __funnelshift_r(sw[s0 >> 5], sw[(s0 >> 5) + 1], s0 & 31);
        const int cnt = __popc(mk);
        if (cnt < 32) run &= (1u << cnt) - 1u;
        v[i] = deposit(run, mk);
      }
    }
    __syncthreads();  // before the stages across warps reuse sw
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long at = row + (long long)(i * T + t) * u;
      if (warp_rows)
        v[i] = valid ? pack_warp_rows(x + at - 32 * lane, lane) : 0u;
      else
        v[i] = valid ? pack_rows(x + at, u, vec) : 0u;
    }
  }
  bit_butterfly<R>(v, u, T, t, sw);
  if (systematic) {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] &= imask[b * words + i * T + t];
    bit_butterfly<R>(v, u, T, t, sw);
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int8_t* at = out + row + (long long)(i * T + t) * u;
      if (warp_rows)
        unpack_warp_rows(at - 32 * lane, v[i], lane);
      else
        unpack_rows(at, v[i], u, vec);
    }
  }
}

}  // namespace

// The bit-packed encoder (encode_bits_kernel) on `stream`: out (batch, n)
// int8. scatter != 0 (blk == n): the input is msg (batch, k) int8 +-1; else
// x (batch, n) int8 +-1. imask (n / u uint32) holds each u-row word's info
// rows as bits, kfirst (n / u int32) the index of its first message symbol
// (u = min(32, blk)). blk is a power of two dividing n, from 2 to 2^17;
// T = min(blk / u, 256) threads a frame block. vec != 0 only when x and
// out are 16-byte aligned (and n % 32 == 0, which u = 32 implies). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a block it does not take.
extern "C" int polar_encode_bits(const void* msg, int k, const void* imask,
                                 const void* kfirst, int scatter,
                                 const void* x, int n, int batch, int blk,
                                 int systematic, int vec, void* out,
                                 void* stream) {
  const int u = blk < 32 ? blk : 32;
  const int words = blk / u;
  const int T = words < kBitThreads ? words : kBitThreads;
  const int R = words / T;
  int log_t = 0, log_nb = 0;
  while ((1 << log_t) < T) ++log_t;
  while ((1 << log_nb) < n / blk) ++log_nb;
  const long long frame_blocks = (long long)batch * (n / blk);
  const int per_block = kBitThreads / T;
  const long long grid = (frame_blocks + per_block - 1) / per_block;
  const size_t smem =
      T > 32 || scatter ? (size_t)per_block * (words + 2) * 4 : 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define POLAR_ENCODE_BITS(RR)                                                 \
  encode_bits_kernel<RR><<<(unsigned int)grid, kBitThreads, smem, st>>>(     \
      (const int8_t*)msg, k, (const uint32_t*)imask, (const int*)kfirst,     \
      scatter, (const int8_t*)x, n, frame_blocks, log_nb, blk, u, T, log_t,  \
      systematic, vec, (int8_t*)out)
  switch (R) {
    case 1: POLAR_ENCODE_BITS(1); break;
    case 2: POLAR_ENCODE_BITS(2); break;
    case 4: POLAR_ENCODE_BITS(4); break;
    case 8: POLAR_ENCODE_BITS(8); break;
    case 16: POLAR_ENCODE_BITS(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef POLAR_ENCODE_BITS
  return (int)cudaGetLastError();
}
