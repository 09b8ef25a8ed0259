// Block-structured Monte-Carlo front for large N: the message draw and the
// channel of the step, as two row-block kernels around the middle's top
// butterfly stages (ops/cuda/front_kernel.py); and the whole front of a
// code in one kernel on the same row words (ops/cuda/step_kernel.py:front).
//
// Replaces polar_tpu/ops/pallas/step_kernel.py:make_pallas_front_blocks
// (:831):
//   kernel A (front_msg_rows_kernel): _msg_block_kernel_native / _inject
//     (:713-734): +-1 message symbols, frozen rows pinned to +1, then the
//     block's bottom butterfly stages (systematic); _msg_u0_kernel_native /
//     _inject (:737-759): the same draw and pin without the butterfly (the
//     non-systematic u0);
//   kernel B (front_chan_rows_kernel): _chan_block_kernel_native / _inject
//     and _chan_block_body (:762-778): the block's bottom butterfly stages,
//     AWGN and quantization;
//   the middle (front_middle_kernel): _stages_kernel (:800) over
//     _stages_rows (:781), with the systematic refreeze that the JAX
//     package runs as an XLA where between two such passes (:1000-1007).
//
// Native mode draws the words of the fused step kernel (step.cu): row r's
// message symbol from word N + r of the frame's Philox stream, row r's
// normal from radius word r mod N/2 and angle word N/2 + r mod N/2 (the cos
// output for r < N/2, the sin output above), through channel.cuh's
// box_muller and quantize, so the large-N step reproduces the fused step's
// LLRs and counters on the same seeds.
//
// Kernels A and B: 32 frames a row word. A CTA owns the 32 frames of one
// warp's width (lane l is frame 32 blockIdx.x + l) and S rows: kernel A one
// row block (S = blk), kernel B row block R below N/2 and its partner
// R + N/(2 blk) above it (S = 2 blk; where blk = N one block holds both
// halves, S = N). A row's +-1 values for the 32 frames are one 32-bit word
// made by __ballot_sync (bit l set for -1: kernel A from the Philox word's
// low bit, or the injected symbol's sign; kernel B from y < 0), and the S
// words sit in shared memory. With +1 as bit 0 and -1 as bit 1 the
// butterfly's product is an XOR: stage h is word[j] ^= word[j + h], spread
// over the CTA's threads with a barrier between stages, and no stage
// touches device memory. Frozen rows are words of 0; frozen is per row, so
// the test is uniform across a warp. Rows leave as +-1 bytes (0x01 / 0xFF):
// where batch % 4 == 0 and the row arrays are 4-byte aligned a lane moves
// four frames as one 32-bit word (a warp four rows an instruction), else
// its frame's byte. At the ragged edge the tail lanes vote 0 and store
// nothing. Each lane keeps its frame's Philox round keys and first round
// (PhiloxFrame) for the whole CTA. One thread a frame walking its rows,
// the butterfly in device memory, was 4-14x slower (PERF.md section 6,
// rows 9 A and 9 B).
//
// What bounds them on this card (the H100's 33.5 T lane instructions/s and
// 3.35 TB/s; PERF.md section 6 has the times): kernel A moves one byte an
// element (0.16 ms at m = 17, B = 4096) and issues a Philox block of nine
// rounds per four rows with an info row; a warp takes its chunks 32 at a
// time, lane l reading chunk k + l's frozen nibble, zeroes the all-frozen
// ones without drawing and draws the live ones two at a time, so two
// independent Philox chains are in flight. Kernel B moves three bytes an
// element (y in, cw and the LLR out, 0.48 ms) and is bound by issued
// instructions and the conversion pipe: a lane takes the radius block of
// words j..j+3 and the angle block of words N/2 + j .. N/2 + j + 3,
// computes four Box-Muller pairs once each and writes n0 into rows j..j+3
// and n1 into rows N/2 + j ..: per element a quarter Philox block, half a
// logf and a sqrtf, one of the two polynomials and one quantize. Its row
// loads (a lane keeps kLoads in flight) and the draw do not overlap within
// a CTA. channel.cuh's instruction sequence is kept as it is (-fmad=false),
// so the LLRs equal the fused step's.
//
// The whole front (front_rows_kernel) replaces
// polar_tpu/ops/pallas/step_kernel.py:make_pallas_front (:632),
// _front_kernel_native (:611) / _front_kernel_inject (:623) over _front
// (:225): the systematic front of the fused step for a whole code, (llr, cw)
// out, on kernel A's and kernel B's machinery with the middle on chip. A
// CTA owns one 32-frame column and all N rows of it as N row words in
// shared memory (4N bytes), its G warps (the wrapper's choice, 1 to 8)
// splitting every phase's rows: kernel A's chunked draw with its all-frozen
// skip (or the injected symbols' signs, frozen words then 0), the first
// transform's log2 N XOR stages, the refreeze, the second transform, the cw
// rows out, then kernel B's channel over pair rows j < N/2 (row j n0, row
// N/2 + j n1, each Box-Muller pair once) with the same channel.cuh
// instructions, so the LLRs equal the fused step's. Where words move, a
// chunk's eight LLR rows go through 256 bytes of staging a warp so that a
// lane stores four frames as one 32-bit word. It reaches N = 2^15 (the
// wrapper's FRONT_ROWS_MAX_LEVEL); bound like kernel B by issued
// instructions (the draws, Box-Muller, quantize), with one byte of cw and
// one of LLR out an element and nothing read back.
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

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// Word k (0..3) of a Philox block.
__device__ __forceinline__ uint32_t pick(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Bit t of an 8-bit x to bit 4 t.
__device__ __forceinline__ uint32_t spread8(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// The CTA's rows of one 32-frame column: local row l < S at global row
// row(l). Kernel A: a row block from r0. Kernel B: pair rows [r0, r0 + S/2)
// below N/2 and the same rows + N/2 above (with S = N, the code in order).
struct Rows {
  int r0, half, h;  // half: S/2 for kernel B, 0 for kernel A
  __device__ __forceinline__ long long row(int l) const {
    return half == 0 ? r0 + l : l < half ? r0 + l : (long long)h + r0 + l - half;
  }
};

// Load S rows of x (n, batch) int8 into sm as row words (bit l: x < 0 for
// frame 32 g + l). words: four frames a lane, a warp four rows a step, a
// lane's kLoads loads issued before their ballots (the loads' latency, not
// the bytes, bounds this phase); else a frame a lane, a row a step.
constexpr int kLoads = 8;

__device__ __forceinline__ void load_rows(const int8_t* __restrict__ x,
                                          const Rows& rows, int S, int batch,
                                          int words, uint32_t* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long b = batch;
  const int f0 = blockIdx.x * 32;
  if (words) {
    const int i = lane >> 3, c = lane & 7;
    const bool live = f0 + 4 * c < batch;
    const int step = 4 * nwarps;
    for (int l0 = 4 * warp + i; l0 - i < S; l0 += kLoads * step) {
      uint32_t v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int l = l0 + u * step;
        v[u] = live && l < S ? __ldg(reinterpret_cast<const uint32_t*>(
                                   x + rows.row(l) * b + f0 + 4 * c))
                             : 0u;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int l = l0 + u * step;
        if (l - i >= S) break;  // uniform across the warp
        uint32_t w = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t bal =
              __ballot_sync(kFull, (v[u] >> (8 * k + 7)) & 1u);
          w |= spread8((bal >> (8 * i)) & 0xFFu) << k;
        }
        if (c == 0 && l < S) sm[l] = w;
      }
    }
  } else {
    const bool live = f0 + lane < batch;
    for (int l = warp; l < S; l += nwarps) {
      const int8_t v = live ? x[rows.row(l) * b + f0 + lane] : (int8_t)0;
      const uint32_t w = __ballot_sync(kFull, v < 0);
      if (lane == 0) sm[l] = w;
    }
  }
}

// Store the S row words of sm as +-1 bytes (0x01 for bit 0, 0xFF for 1).
__device__ __forceinline__ void store_rows(int8_t* out, const Rows& rows,
                                           int S, int batch, int words,
                                           const uint32_t* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long b = batch;
  const int f0 = blockIdx.x * 32;
  if (words) {
    const int i = lane >> 3, c = lane & 7;
    if (f0 + 4 * c >= batch) return;
    for (int l = 4 * warp + i; l < S; l += 4 * nwarps) {
      const uint32_t q = (sm[l] >> (4 * c)) & 0xFu;
      const uint32_t bits = (q | (q << 7) | (q << 14) | (q << 21)) & 0x01010101u;
      *reinterpret_cast<uint32_t*>(out + rows.row(l) * b + f0 + 4 * c) =
          0x01010101u | (bits * 0xFEu);
    }
  } else {
    if (f0 + lane >= batch) return;
    for (int l = warp; l < S; l += nwarps)
      out[rows.row(l) * b + f0 + lane] =
          (sm[l] >> lane) & 1u ? (int8_t)-1 : (int8_t)1;
  }
}

// The bottom butterfly stages h < blk of every blk-row block of sm's S
// words (blk <= S): word[j] ^= word[j + h]. Ends with a barrier.
__device__ __forceinline__ void xor_stages(uint32_t* sm, int S, int blk) {
  for (int h = 1; h < blk; h <<= 1) {
    __syncthreads();
    for (int q = threadIdx.x; q < S / 2; q += blockDim.x) {
      const int j = ((q & ~(h - 1)) << 1) | (q & (h - 1));
      sm[j] ^= sm[j + h];
    }
  }
  __syncthreads();
}

// Frozen bits of rows r .. r + 3 (nonzero bytes) as a nibble; r a
// multiple of 4.
__device__ __forceinline__ uint32_t frozen_nibble(const uint8_t* frozen,
                                                  int r) {
  const uint32_t m =
      __vcmpne4(__ldg(reinterpret_cast<const uint32_t*>(frozen + r)), 0u) &
      0x01010101u;
  return (m | (m >> 7) | (m >> 14) | (m >> 21)) & 0xFu;
}

// Native mode's message row words of rows [r0, r0 + blk) into sm[0, blk):
// rows in chunks of c = min(4, blk), a warp a chunk, one Philox block each
// (words N + r .. N + r + c - 1 lie in one block) unless all c rows are
// frozen; lane l votes for frame f0 + l (0 unless `live`). WIDE (blk >= 4):
// c = 4, a chunk's words are one whole block; the warp's chunks k = 0, 1,
// ... start at rows 4 warp + 4 nwarps k, taken 32 at a time: lane l reads
// chunk k + l's frozen nibble and zeroes its rows if all four are frozen;
// the live ones go two at a time, their two Philox blocks independent.
template <bool WIDE>
__device__ __forceinline__ void draw_msg_rows(const polar::PhiloxFrame& ph,
                                              const uint8_t* __restrict__ frozen,
                                              int n, int r0, int blk,
                                              bool live, uint32_t* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (WIDE) {
    const int stride = 4 * nwarps;
    for (int ib = 4 * warp; ib < blk; ib += 32 * stride) {
      const int ii = ib + stride * lane;
      const uint32_t nib = ii < blk ? frozen_nibble(frozen, r0 + ii) : 0xFu;
      if (ii < blk && nib == 0xFu)
        *reinterpret_cast<uint4*>(sm + ii) = make_uint4(0u, 0u, 0u, 0u);
      uint32_t todo = __ballot_sync(kFull, nib != 0xFu);
      while (todo) {
        const int k0 = __ffs(todo) - 1;
        todo &= todo - 1;
        const int k1 = todo ? __ffs(todo) - 1 : k0;
        todo &= todo - 1;
        const int i0 = ib + stride * k0, i1 = ib + stride * k1;
        const uint32_t fz0 = __shfl_sync(kFull, nib, k0);
        const uint32_t fz1 = __shfl_sync(kFull, nib, k1);
        const uint4 v0 = ph.block((uint32_t)((n + r0 + i0) >> 2));
        const uint4 v1 = ph.block((uint32_t)((n + r0 + i1) >> 2));
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t b0 = __ballot_sync(
              kFull, live && !((fz0 >> t) & 1u) && (pick(v0, t) & 1u));
          const uint32_t b1 = __ballot_sync(
              kFull, live && !((fz1 >> t) & 1u) && (pick(v1, t) & 1u));
          if (lane == t) {
            sm[i0 + t] = b0;
            sm[i1 + t] = b1;
          }
        }
      }
    }
  } else {
    const int c = min(4, blk);
    for (int i0 = c * warp; i0 < blk; i0 += c * nwarps) {
      uint32_t fz = 0u;  // bit t: row r0 + i0 + t frozen
      for (int t = 0; t < c; ++t)
        fz |= (uint32_t)(__ldg(frozen + r0 + i0 + t) != 0) << t;
      if (fz == (1u << c) - 1u) {  // no info row: no Philox block
        if (lane < c) sm[i0 + lane] = 0u;
        continue;
      }
      const int w = n + r0 + i0;
      const uint4 v = ph.block((uint32_t)(w >> 2));
      for (int t = 0; t < c; ++t) {
        const uint32_t bal = __ballot_sync(
            kFull, live && !((fz >> t) & 1u) && (pick(v, (w & 3) + t) & 1u));
        if (lane == t) sm[i0 + t] = bal;
      }
    }
  }
}

// One frame's LLRs at pair rows j + t (q0[t], the n0 of pair j + t) and
// N/2 + j + t (q1[t], its n1), t < c <= 4: the radius block (words j ..)
// and the angle block (words N/2 + j ..), one block where both lie in it
// (N <= 4), then c Box-Muller pairs, each computed once; or, where nz (the
// frame's column of the injected normals) is set, its rows j + t and
// N/2 + j + t. lo, hi: the row words of rows j and N/2 + j on, bit `lane`
// the frame's codeword sign. WIDE (c = 4, N/2 >= 4): the chunk's radius
// and angle words are whole blocks.
template <bool WIDE>
__device__ __forceinline__ void pair_llrs(const polar::PhiloxFrame& ph,
                                          int h, int j, int c,
                                          const float* nz, long long b,
                                          const uint32_t* lo,
                                          const uint32_t* hi, int lane,
                                          float sigma, float scale,
                                          int8_t (&q0)[4], int8_t (&q1)[4]) {
  uint4 vr = make_uint4(0u, 0u, 0u, 0u), va = vr;
  if (nz == nullptr) {
    vr = ph.block((uint32_t)(j >> 2));
    va = !WIDE && (h + j) >> 2 == j >> 2 ? vr
                                         : ph.block((uint32_t)((h + j) >> 2));
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= c) break;
    float n0, n1;
    if (nz != nullptr) {
      n0 = nz[(long long)(j + t) * b];
      n1 = nz[(long long)(h + j + t) * b];
    } else {
      polar::box_muller(pick(vr, WIDE ? t : (j + t) & 3),
                        pick(va, WIDE ? t : (h + j + t) & 3), &n0, &n1);
    }
    const float c0 = (lo[t] >> lane) & 1u ? -1.0f : 1.0f;
    const float c1 = (hi[t] >> lane) & 1u ? -1.0f : 1.0f;
    q0[t] = polar::quantize(c0, n0, sigma, scale);
    q1[t] = polar::quantize(c1, n1, sigma, scale);
  }
}

// Kernel A: grid (ceil(batch / 32), n / blk), S = blk words of shared
// memory; the draw is draw_msg_rows's. WIDE: blk >= 4.
template <bool WIDE>
__global__ void __launch_bounds__(256) front_msg_rows_kernel(
    const uint8_t* __restrict__ frozen, int n, int batch, int blk,
    int butterfly, const int8_t* __restrict__ msg_in, uint32_t seed0,
    uint32_t seed1, uint32_t call, int8_t* out, int words) {
  extern __shared__ uint32_t sm[];
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * blk;
  const Rows rows{r0, 0, 0};
  if (msg_in != nullptr) {
    load_rows(msg_in, rows, blk, batch, words, sm);
    __syncthreads();
    for (int l = threadIdx.x; l < blk; l += blockDim.x)
      if (__ldg(frozen + r0 + l)) sm[l] = 0u;
  } else {
    const int f = blockIdx.x * 32 + lane;
    polar::PhiloxFrame ph(make_uint2(seed0, seed1));
    ph.start((uint32_t)f, call);
    draw_msg_rows<WIDE>(ph, frozen, n, r0, blk, f < batch, sm);
  }
  if (butterfly) {
    xor_stages(sm, blk, blk);
  } else {
    __syncthreads();
  }
  store_rows(out, rows, blk, batch, words, sm);
}

// Kernel B: grid (ceil(batch / 32), N / S) with P = min(blk, N/2) pair rows
// a CTA and S = 2 P words of shared memory: pair rows [p P, p P + P) and
// the same rows + N/2. Pair rows in chunks of c = min(4, P), a warp a
// chunk, each chunk's LLRs pair_llrs's. WIDE: P >= 4.
template <bool WIDE>
__global__ void __launch_bounds__(256) front_chan_rows_kernel(
    int n, int batch, int blk, float sigma, float scale,
    const int8_t* __restrict__ y, const float* __restrict__ normals_in,
    uint32_t seed0, uint32_t seed1, uint32_t call, int8_t* llr, int8_t* cw,
    int words) {
  extern __shared__ uint32_t sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int h = n >> 1;
  const int P = min(blk, h), S = 2 * P;
  const int j0 = blockIdx.y * P;
  const Rows rows{j0, P, h};
  load_rows(y, rows, S, batch, words, sm);
  xor_stages(sm, S, blk);
  store_rows(cw, rows, S, batch, words, sm);
  const int f = blockIdx.x * 32 + lane;
  if (f >= batch) return;  // no barrier or ballot below
  const long long b = batch;
  polar::PhiloxFrame ph(make_uint2(seed0, seed1));
  ph.start((uint32_t)f, call);
  const float* nz = normals_in == nullptr ? nullptr : normals_in + f;
  const int c = WIDE ? 4 : min(4, P);
  for (int i0 = c * warp; i0 < P; i0 += c * nwarps) {
    const int j = j0 + i0;
    int8_t q0[4], q1[4];
    pair_llrs<WIDE>(ph, h, j, c, nz, b, sm + i0, sm + P + i0, lane, sigma,
                    scale, q0, q1);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t >= c) break;
      llr[(long long)(j + t) * b + f] = q0[t];
      llr[(long long)(h + j + t) * b + f] = q1[t];
    }
  }
}

// The whole systematic front (front_rows_kernel): grid ceil(batch / 32),
// a CTA of G warps owns one 32-frame column and all N rows of it, N row
// words in shared memory, then kStage words of LLR staging a warp.
constexpr int kStage = 64;  // 8 rows of 32 LLR bytes

template <bool WIDE>
__global__ void __launch_bounds__(256) front_rows_kernel(
    const uint8_t* __restrict__ frozen, int n, int batch, float sigma,
    float scale, const int8_t* __restrict__ msg_in,
    const float* __restrict__ normals_in, uint32_t seed0, uint32_t seed1,
    uint32_t call, int8_t* llr, int8_t* cw, int words) {
  extern __shared__ uint32_t sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const Rows rows{0, 0, 0};
  const int f0 = blockIdx.x * 32, f = f0 + lane;
  const bool live = f < batch;
  polar::PhiloxFrame ph(make_uint2(seed0, seed1));
  ph.start((uint32_t)f, call);
  // 1. u0's row words: the message (a Philox word's low bit or the
  // injected symbol's sign) on the info rows, 0 (+1) on the frozen ones
  if (msg_in != nullptr) {
    load_rows(msg_in, rows, n, batch, words, sm);
    __syncthreads();
    for (int l = threadIdx.x; l < n; l += blockDim.x)
      if (__ldg(frozen + l)) sm[l] = 0u;
  } else {
    draw_msg_rows<WIDE>(ph, frozen, n, 0, n, live, sm);
  }
  // 2. cw = T(refreeze(T(u0))), every stage an XOR of row words on chip
  xor_stages(sm, n, n);
  for (int l = threadIdx.x; l < n; l += blockDim.x)
    if (__ldg(frozen + l)) sm[l] = 0u;
  xor_stages(sm, n, n);
  store_rows(cw, rows, n, batch, words, sm);
  // 3. the LLRs: pair j's Box-Muller gives rows j and N/2 + j. With word
  // stores a chunk's 2c rows go through the warp's staging rows (t and
  // 4 + t), then a lane moves four frames of a row as one 32-bit word
  const long long b = batch;
  const int h = n >> 1;
  const int c = WIDE ? 4 : min(4, h);
  const float* nz = normals_in == nullptr || !live ? nullptr : normals_in + f;
  int8_t* stage = reinterpret_cast<int8_t*>(sm + n + kStage * warp);
  const int i = lane >> 3, q = lane & 7;
  const bool quad = f0 + 4 * q < batch;
  for (int j = c * warp; j < h; j += c * nwarps) {
    int8_t q0[4], q1[4];
    pair_llrs<WIDE>(ph, h, j, c, nz, b, sm + j, sm + h + j, lane, sigma,
                    scale, q0, q1);
    if (words) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t >= c) break;
        stage[32 * t + lane] = q0[t];
        stage[32 * (4 + t) + lane] = q1[t];
      }
      __syncwarp();
      if (i < c && quad) {
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(stage);
        *reinterpret_cast<uint32_t*>(llr + (j + i) * b + f0 + 4 * q) =
            sw[8 * i + q];
        *reinterpret_cast<uint32_t*>(llr + (h + j + i) * b + f0 + 4 * q) =
            sw[8 * (4 + i) + q];
      }
      __syncwarp();
    } else if (live) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t >= c) break;
        llr[(j + t) * b + f] = q0[t];
        llr[(h + j + t) * b + f] = q1[t];
      }
    }
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

// Shared memory of the row-word kernels: S row words a CTA, S at most
// 2^15 (128 KB), and `extra` words more (the whole front's LLR staging);
// above 48 KB by the opt-in attribute.
template <typename K>
int rows_smem(K kernel, int S, int extra = 0) {
  const int bytes = 4 * (S + extra);
  if (S > (1 << 15)) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Threads of a row-word CTA of S rows: a warp per chunk of four rows, at
// most 256.
int rows_threads(int S) { return S >= 32 ? 256 : S <= 4 ? 32 : 8 * S; }

}  // namespace

// Kernel A (front_msg_rows_kernel) on `stream`: out (n, batch) int8.
// Inject mode: msg (n, batch) int8 +-1; native mode: msg null, words from
// Philox keyed by (seed0, seed1) with counter word 2 = call. blk (a power
// of two dividing n, at most 2^15) rows per block; butterfly != 0 applies
// the block's bottom stages. words != 0: batch % 4 == 0 and out, msg are
// 4-byte aligned. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a block above 2^15 rows.
extern "C" int polar_front_msg_rows(const void* frozen, int n, int batch,
                                    int blk, int butterfly, const void* msg,
                                    unsigned int seed0, unsigned int seed1,
                                    unsigned int call, void* out, int words,
                                    void* stream) {
  const auto kernel = blk >= 4 ? front_msg_rows_kernel<true>
                               : front_msg_rows_kernel<false>;
  const int err = rows_smem(kernel, blk);
  if (err) return err;
  const dim3 grid((batch + 31) / 32, n / blk);
  kernel<<<grid, rows_threads(blk), 4 * blk, (cudaStream_t)stream>>>(
      (const uint8_t*)frozen, n, batch, blk, butterfly, (const int8_t*)msg,
      seed0, seed1, call, (int8_t*)out, words);
  return (int)cudaGetLastError();
}

// Kernel B (front_chan_rows_kernel) on `stream`: y (n, batch) int8 +-1 in,
// llr and cw (n, batch) int8 out. Inject mode: normals (n, batch) float32;
// native mode: normals null. 2 min(blk, n / 2) at most 2^15. words != 0:
// batch % 4 == 0 and y, cw are 4-byte aligned (the LLRs go out a byte a
// lane). Returns cudaGetLastError(), or cudaErrorInvalidValue for too many
// rows a CTA.
extern "C" int polar_front_chan_rows(int n, int batch, int blk, float sigma,
                                     float scale, const void* y,
                                     const void* normals, unsigned int seed0,
                                     unsigned int seed1, unsigned int call,
                                     void* llr, void* cw, int words,
                                     void* stream) {
  const int S = 2 * (blk < n / 2 ? blk : n / 2);
  const auto kernel = S >= 8 ? front_chan_rows_kernel<true>
                             : front_chan_rows_kernel<false>;
  const int err = rows_smem(kernel, S);
  if (err) return err;
  const dim3 grid((batch + 31) / 32, n / S);
  kernel<<<grid, rows_threads(S), 4 * S, (cudaStream_t)stream>>>(
      n, batch, blk, sigma, scale, (const int8_t*)y, (const float*)normals,
      seed0, seed1, call, (int8_t*)llr, (int8_t*)cw, words);
  return (int)cudaGetLastError();
}

// The whole systematic front (front_rows_kernel) on `stream`: llr and cw
// (n, batch) int8 out, n >= 2. Inject mode: msg (n, batch) int8 +-1 and
// normals (n, batch) float32; native mode: both null, words from Philox
// keyed by (seed0, seed1) with counter word 2 = call. warps (1..8) share a
// CTA's 32 frames; 4 (n + 64 warps) bytes of shared memory. words != 0:
// batch % 4 == 0 and msg, llr, cw are 4-byte aligned. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for n above 2^15 or warps
// out of range.
extern "C" int polar_front_rows(const void* frozen, int n, int batch,
                                float sigma, float scale, const void* msg,
                                const void* normals, unsigned int seed0,
                                unsigned int seed1, unsigned int call,
                                void* llr, void* cw, int warps, int words,
                                void* stream) {
  if (warps < 1 || warps > 8) return (int)cudaErrorInvalidValue;
  const auto kernel = n >= 8 ? front_rows_kernel<true>
                             : front_rows_kernel<false>;
  const int err = rows_smem(kernel, n, kStage * warps);
  if (err) return err;
  kernel<<<(batch + 31) / 32, 32 * warps, 4 * (n + kStage * warps),
           (cudaStream_t)stream>>>(
      (const uint8_t*)frozen, n, batch, sigma, scale, (const int8_t*)msg,
      (const float*)normals, seed0, seed1, call, (int8_t*)llr, (int8_t*)cw,
      words);
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
