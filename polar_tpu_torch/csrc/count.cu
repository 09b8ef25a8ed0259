// The Monte-Carlo counter epilogue alone: the five testbench counters
// (testbench.cc:185-192) over (llr_t, cw_t, hat_t) and the frozen mask.
//
// Replaces polar_tpu/ops/pallas/step_kernel.py:make_pallas_count (:544),
// body _count_kernel (:537) over _count_and_store (:182-222), in its
// cw-domain form: at the info rows, hat != cw is an uncorrected error and
// hat == 0 an ambiguity erasure; a frame with any error is a frame error;
// over all rows, llr != 0 with a sign other than cw's is an AWGN error and
// llr == 0 a quantization erasure.
//
// What bounds it on this card: device memory. It must read llr and cw at
// every row and hat at the info rows, (2 N + K) B bytes (0.40 ms at
// Polar(131072, 65536), B = 4096, at 3.35 TB/s); the compares are a few
// word operations per four bytes.
//
// count_rows_kernel: 16 frames a lane over row chunks (a thread a frame
// with a byte load a row was 5x slower; PERF.md section 6, row 7).
//   - A warp owns a frame group of 512 frames: lane l reads frames
//     512 g + 16 l .. + 15 of a row as one aligned 16-byte word from each
//     array, so a warp's load is 512 contiguous bytes. A CTA's 8 warps
//     split the rows of one row chunk, each loading kUnroll rows of llr and
//     cw (and hat at the info rows: frozen is per row, so the skip is
//     uniform across the warp) before its first compare.
//   - The grid is frame groups x row chunks, sized by the wrapper
//     (count_kernel.count_plan) to fill the card with several CTAs an SM.
//   - The compares run on four bytes at a time: zero80 marks the zero
//     bytes exactly, a sign test is (l ^ c) & 0x80808080 masked by
//     l != 0, and __popc counts the marks. A lane keeps its 16 frames'
//     error bytes in an OR accumulator.
//   - A frame spans the CTAs of its row chunks, so its any-error flag is an
//     OR across chunks: each CTA writes its group's frame-error bits for its
//     chunk as 32-bit words (bit j of word w is frame 32 w + j) into a
//     (chunks, ceil(B / 32)) scratch array, and its four partial sums
//     beside them. Every word is written, so the scratch needs no zeroing.
//   - The fold is the last CTA to finish (a __threadfence, then an atomic
//     ticket that it resets to 0 for the next launch on the stream): it ORs
//     the words over chunks, __popc's them and sums the partials in 64
//     bits (at m = 17, B = 16384 the totals can pass 2^31), and writes the
//     (5,) int64 counters. Integer sums do not depend on order, so the
//     counts are deterministic. One launch, no reduction after it.
//   - STRAIGHT: batch % 16 == 0 and the three arrays 16-byte aligned; else
//     the same kernel with byte loads and a bound check per frame. Frames
//     past the batch read as bytes 0x01 in all three arrays, which count
//     nothing: ragged lanes vote "no error".
//
// count_frames_kernel: the five counters of the draws path's step in the
// u domain (ber.frame_counters, polar_tpu/ber.py:394-411, jnp there: no
// Pallas kernel) over frame-major message and decoded (B, K) and codeword
// and llrs (B, N), all int8: errs = decoded == 0 or a sign other than the
// message's; a frame with any errs is a frame error; decoded == 0 an
// ambiguity erasure; llrs != 0 with a sign other than the codeword's an
// AWGN error; llrs == 0 a quantization erasure. Bound: the four arrays
// once, 2 (N + K) B bytes.
//   - Frames go to lanes: a frame's row is read by a span of 2^s lanes
//     (the least power of two that covers its 16-byte words, at most a
//     warp), 32 / 2^s frames a warp, and the span's lanes stride over the
//     frame's message / decoded words and then its codeword / llrs words,
//     kFrameUnroll words of each array loaded before the first compare.
//     Warps take frame units (32 / 2^s frames) grid-stride.
//   - The compares are count_rows_kernel's byte-SIMD ones: zero80 and the
//     sign bit of an XOR, __popc of the marks. A lane ORs its frame's error
//     marks; one __ballot_sync a unit gives each span's frame its
//     any-error bit, counted by the span's first lane.
//   - Each CTA folds its lanes by warp shuffles and shared memory into
//     five int64 partials; the last CTA to finish (a __threadfence, the
//     ticket) sums them (integer sums: the counts do not depend on the
//     order) and writes the (5,) int64 counters, then resets the ticket.
//     One launch, no reduction after it.
//   - STRAIGHT: K and N multiples of 16 and the four arrays 16-byte
//     aligned (every row is then); else byte loads with a bound check per
//     byte, the bytes past a row read as 0x01, which count nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCounters = 5;                    // the (5,) counters
constexpr int kLaneFrames = 16;                 // one 16-byte word a row
constexpr int kGroupFrames = 32 * kLaneFrames;  // a warp's frames: 512
constexpr int kGroupWords = kGroupFrames / 32;  // its frame-error words
constexpr int kWarps = 8;                       // a CTA's warps
constexpr int kUnroll = 4;                      // rows loaded per compare
constexpr int kSums = 4;                        // err, amb, awgn, qz
constexpr uint32_t kPad = 0x01010101u;          // frames past the batch

// 0x80 in every zero byte of x, 0 elsewhere. Exact: (x & 0x7F) + 0x7F
// sets bit 7 of a byte unless its low seven bits are 0, and never carries
// into the next byte.
__device__ __forceinline__ uint32_t zero80(uint32_t x) {
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x | 0x7F7F7F7Fu);
}

// A lane's 16 frames of one row: one 16-byte load, or (ragged) byte loads
// with a bound check per frame; frames past the batch read as kPad.
template <bool STRAIGHT>
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ row,
                                        int f0, int batch) {
  if (STRAIGHT)
    return f0 < batch ? __ldg(reinterpret_cast<const uint4*>(row + f0))
                      : make_uint4(kPad, kPad, kPad, kPad);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = f0 + 4 * i + k;
      const uint32_t b = f < batch ? (uint8_t)__ldg(row + f) : 1u;
      w[i] |= b << (8 * k);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// bit k = byte k's top bit, for a word whose bytes are 0x00 or 0x80: the
// flags moved to bits 0, 8, 16, 24 land by one product on bits 28..31.
__device__ __forceinline__ uint32_t top_bits(uint32_t x) {
  return (((x >> 7) & 0x01010101u) * 0x10204080u) >> 28;
}

template <bool STRAIGHT>
__global__ void __launch_bounds__(kWarps * 32) count_rows_kernel(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ cw,
    const int8_t* __restrict__ hat, const uint8_t* __restrict__ frozen,
    int n, int batch, int rows_per_chunk, int words,
    uint32_t* scratch, unsigned int* ticket,
    long long* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = blockIdx.x, chunk = blockIdx.y, chunks = gridDim.y;
  const int f0 = group * kGroupFrames + lane * kLaneFrames;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  const long long b = batch;
  int err = 0, amb = 0, awgn = 0, qz = 0;
  uint32_t fe[4] = {0u, 0u, 0u, 0u};
  for (int r = r0 + warp; r < r1; r += kWarps * kUnroll) {
    uint4 l[kUnroll], c[kUnroll], h[kUnroll];
    bool info[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r + u * kWarps;
      const bool in = ru < r1;
      info[u] = in && !__ldg(frozen + ru);
      const long long at = (long long)ru * b;
      const uint4 pad = make_uint4(kPad, kPad, kPad, kPad);
      l[u] = in ? load16<STRAIGHT>(llr + at, f0, batch) : pad;
      c[u] = in ? load16<STRAIGHT>(cw + at, f0, batch) : pad;
      h[u] = info[u] ? load16<STRAIGHT>(hat + at, f0, batch) : pad;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t lw = word_of(l[u], i), cwd = word_of(c[u], i);
        const uint32_t lz = zero80(lw);
        qz += __popc(lz);
        awgn += __popc((lw ^ cwd) & ~lz & 0x80808080u);
        if (info[u]) {
          const uint32_t hw = word_of(h[u], i);
          const uint32_t ne = ~zero80(hw ^ cwd) & 0x80808080u;
          err += __popc(ne);
          amb += __popc(zero80(hw));
          fe[i] |= ne;
        }
      }
    }
  }

  // the CTA's sums and its group's frame-error words for this chunk
  __shared__ int s_sum[kWarps][kSums];
  __shared__ uint32_t s_bits[kWarps][32];
  __shared__ long long s_tot[kWarps][kCounters];
  __shared__ bool s_last;
  s_bits[warp][lane] = top_bits(fe[0]) | top_bits(fe[1]) << 4 |
                       top_bits(fe[2]) << 8 | top_bits(fe[3]) << 12;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    err += __shfl_xor_sync(0xFFFFFFFFu, err, off);
    amb += __shfl_xor_sync(0xFFFFFFFFu, amb, off);
    awgn += __shfl_xor_sync(0xFFFFFFFFu, awgn, off);
    qz += __shfl_xor_sync(0xFFFFFFFFu, qz, off);
  }
  if (lane == 0) {
    s_sum[warp][0] = err;
    s_sum[warp][1] = amb;
    s_sum[warp][2] = awgn;
    s_sum[warp][3] = qz;
  }
  __syncthreads();
  int* partials = reinterpret_cast<int*>(scratch + (long long)chunks * words);
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  if (warp == 0) {
    uint32_t bits = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) bits |= s_bits[w][lane];
    // lanes 2j and 2j + 1 hold frames 32 j .. 32 j + 31 of the group
    const uint32_t high = __shfl_down_sync(0xFFFFFFFFu, bits, 1);
    const int word = group * kGroupWords + (lane >> 1);
    if (!(lane & 1) && word < words)
      scratch[(long long)chunk * words + word] = bits | high << 16;
    if (lane < kSums) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_sum[w][lane];
      partials[cta * kSums + lane] = s;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;

  // the fold, in the last CTA: every other CTA's words and sums are out
  __threadfence();
  long long tot[kCounters] = {0, 0, 0, 0, 0};
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    uint32_t any = 0u;
#pragma unroll 8
    for (int k = 0; k < chunks; ++k)
      any |= __ldcg(scratch + (long long)k * words + w);
    tot[1] += __popc(any);
  }
  const int ctas = gridDim.x * gridDim.y;
  for (int i = threadIdx.x; i < ctas; i += blockDim.x) {
    tot[0] += __ldcg(partials + i * kSums + 0);
    tot[2] += __ldcg(partials + i * kSums + 1);
    tot[3] += __ldcg(partials + i * kSums + 2);
    tot[4] += __ldcg(partials + i * kSums + 3);
  }
#pragma unroll
  for (int k = 0; k < kCounters; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tot[k] += __shfl_xor_sync(0xFFFFFFFFu, tot[k], off);
    if (lane == 0) s_tot[warp][k] = tot[k];
  }
  __syncthreads();
  if (threadIdx.x < kCounters) {
    // out: uncorrected, frame errors, ambiguity, awgn, quantization
    long long s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_tot[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

constexpr int kFrameWarps = 8;   // count_frames_kernel: a CTA's warps
constexpr int kFrameUnroll = 4;  // words of each array loaded per compare

// 16-byte word w of a row of len bytes: one load, or (ragged) byte loads
// with a bound check per byte, the bytes past the row read as kPad.
template <bool STRAIGHT>
__device__ __forceinline__ uint4 row_word(const int8_t* __restrict__ row,
                                          int w, int len) {
  if (STRAIGHT) return __ldg(reinterpret_cast<const uint4*>(row) + w);
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int at = 16 * w + 4 * i + k;
      const uint32_t b = at < len ? (uint8_t)__ldg(row + at) : 1u;
      v[i] |= b << (8 * k);
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool STRAIGHT>
__global__ void __launch_bounds__(kFrameWarps * 32) count_frames_kernel(
    const int8_t* __restrict__ msg, const int8_t* __restrict__ dec,
    const int8_t* __restrict__ cw, const int8_t* __restrict__ llr,
    int batch, int k, int n, int span_log2, long long* scratch,
    unsigned int* ticket, long long* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = 1 << span_log2;
  const int sub = lane & (span - 1);
  const uint32_t seg = span == 32 ? 0xFFFFFFFFu : (1u << span) - 1u;
  const int wk = (k + 15) >> 4, wn = (n + 15) >> 4;
  const long long units = (batch + (32 >> span_log2) - 1) >> (5 - span_log2);
  const long long stride = (long long)gridDim.x * kFrameWarps;
  const uint4 pad = make_uint4(kPad, kPad, kPad, kPad);
  int err = 0, amb = 0, awgn = 0, qz = 0, fe = 0;
  for (long long u = (long long)blockIdx.x * kFrameWarps + warp; u < units;
       u += stride) {
    const long long f = (u << (5 - span_log2)) + (lane >> span_log2);
    uint32_t any = 0u;
    if (f < batch) {
      const int8_t* m_row = msg + f * k;
      const int8_t* d_row = dec + f * k;
      for (int w = sub; w < wk; w += span * kFrameUnroll) {
        uint4 m[kFrameUnroll], d[kFrameUnroll];
#pragma unroll
        for (int j = 0; j < kFrameUnroll; ++j) {
          const int wj = w + j * span;
          m[j] = wj < wk ? row_word<STRAIGHT>(m_row, wj, k) : pad;
          d[j] = wj < wk ? row_word<STRAIGHT>(d_row, wj, k) : pad;
        }
#pragma unroll
        for (int j = 0; j < kFrameUnroll; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t dw = word_of(d[j], i);
            const uint32_t dz = zero80(dw);
            const uint32_t e = dz | ((dw ^ word_of(m[j], i)) & 0x80808080u);
            err += __popc(e);
            amb += __popc(dz);
            any |= e;
          }
        }
      }
      const int8_t* c_row = cw + f * n;
      const int8_t* l_row = llr + f * n;
      for (int w = sub; w < wn; w += span * kFrameUnroll) {
        uint4 c[kFrameUnroll], l[kFrameUnroll];
#pragma unroll
        for (int j = 0; j < kFrameUnroll; ++j) {
          const int wj = w + j * span;
          c[j] = wj < wn ? row_word<STRAIGHT>(c_row, wj, n) : pad;
          l[j] = wj < wn ? row_word<STRAIGHT>(l_row, wj, n) : pad;
        }
#pragma unroll
        for (int j = 0; j < kFrameUnroll; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t lw = word_of(l[j], i);
            const uint32_t lz = zero80(lw);
            qz += __popc(lz);
            awgn += __popc((lw ^ word_of(c[j], i)) & ~lz & 0x80808080u);
          }
        }
      }
    }
    // bit l of hit: lane l saw an error; a span's first lane counts its
    // frame
    const uint32_t hit = __ballot_sync(0xFFFFFFFFu, any != 0u);
    fe += sub == 0 && ((hit >> lane) & seg) != 0u;
  }

  // the CTA's five partials, then the fold in the last CTA to finish
  __shared__ long long s_part[kFrameWarps][kCounters];
  __shared__ bool s_last;
  long long part[kCounters] = {err, fe, amb, awgn, qz};
#pragma unroll
  for (int c = 0; c < kCounters; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part[c] += __shfl_xor_sync(0xFFFFFFFFu, part[c], off);
    if (lane == 0) s_part[warp][c] = part[c];
  }
  __syncthreads();
  if (threadIdx.x < kCounters) {
    long long s = 0;
#pragma unroll
    for (int w = 0; w < kFrameWarps; ++w) s += s_part[w][threadIdx.x];
    scratch[(long long)blockIdx.x * kCounters + threadIdx.x] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  long long tot[kCounters] = {0, 0, 0, 0, 0};
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
#pragma unroll
    for (int c = 0; c < kCounters; ++c)
      tot[c] += __ldcg(scratch + (long long)b * kCounters + c);
  }
#pragma unroll
  for (int c = 0; c < kCounters; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tot[c] += __shfl_xor_sync(0xFFFFFFFFu, tot[c], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kCounters; ++c) s_part[warp][c] = tot[c];
  }
  __syncthreads();
  if (threadIdx.x < kCounters) {
    // out: uncorrected, frame errors, ambiguity, awgn, quantization
    long long s = 0;
#pragma unroll
    for (int w = 0; w < kFrameWarps; ++w) s += s_part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace

// count_rows_kernel on `stream`: llr, cw, hat (n, batch) int8
// element-major, frozen (n,) uint8; chunks row chunks of rows_per_chunk
// rows (chunks * rows_per_chunk >= n, chunks <= 65535); scratch
// chunks * ceil(batch / 32) + 4 * ceil(batch / 512) * chunks 32-bit words;
// ticket one 32-bit word, 0 before the launch and after it; out (5,)
// int64. straight != 0 only when batch % 16 == 0 and the three arrays are
// 16-byte aligned. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a plan that does not cover the rows.
extern "C" int polar_count_rows(const void* llr, const void* cw,
                                const void* hat, const void* frozen, int n,
                                int batch, int chunks, int rows_per_chunk,
                                int straight, void* scratch, void* ticket,
                                void* out, void* stream) {
  if (chunks < 1 || chunks > 65535 || batch < 1 ||
      (long long)chunks * rows_per_chunk < n)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((batch + kGroupFrames - 1) / kGroupFrames, chunks);
  const int words = (batch + 31) / 32;
  const cudaStream_t s = (cudaStream_t)stream;
  if (straight)
    count_rows_kernel<true><<<grid, kWarps * 32, 0, s>>>(
        (const int8_t*)llr, (const int8_t*)cw, (const int8_t*)hat,
        (const uint8_t*)frozen, n, batch, rows_per_chunk, words,
        (uint32_t*)scratch, (unsigned int*)ticket, (long long*)out);
  else
    count_rows_kernel<false><<<grid, kWarps * 32, 0, s>>>(
        (const int8_t*)llr, (const int8_t*)cw, (const int8_t*)hat,
        (const uint8_t*)frozen, n, batch, rows_per_chunk, words,
        (uint32_t*)scratch, (unsigned int*)ticket, (long long*)out);
  return (int)cudaGetLastError();
}

// count_frames_kernel on `stream`: msg, dec (batch, k) and cw, llr
// (batch, n) int8 frame-major, each contiguous; a frame spans
// 2^span_log2 lanes (0..5); blocks CTAs; scratch blocks * 5 int64; ticket
// one 32-bit word, 0 before the launch and after it; out (5,) int64.
// straight != 0 only when k % 16 == 0, n % 16 == 0 and the four arrays
// are 16-byte aligned. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int polar_count_frames(const void* msg, const void* dec,
                                  const void* cw, const void* llr, int batch,
                                  int k, int n, int span_log2, int blocks,
                                  int straight, void* scratch, void* ticket,
                                  void* out, void* stream) {
  if (batch < 1 || k < 0 || n < 1 || span_log2 < 0 || span_log2 > 5 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (straight)
    count_frames_kernel<true><<<blocks, kFrameWarps * 32, 0, s>>>(
        (const int8_t*)msg, (const int8_t*)dec, (const int8_t*)cw,
        (const int8_t*)llr, batch, k, n, span_log2, (long long*)scratch,
        (unsigned int*)ticket, (long long*)out);
  else
    count_frames_kernel<false><<<blocks, kFrameWarps * 32, 0, s>>>(
        (const int8_t*)msg, (const int8_t*)dec, (const int8_t*)cw,
        (const int8_t*)llr, batch, k, n, span_log2, (long long*)scratch,
        (unsigned int*)ticket, (long long*)out);
  return (int)cudaGetLastError();
}

// CTAs of count_frames_kernel (the 16-byte instance where straight != 0,
// else the byte one) that one SM holds at once, into *per_sm: the grid's
// cap of one resident wave. Returns the CUDA error of the occupancy call.
extern "C" int polar_count_frames_occupancy(int straight, int* per_sm) {
  if (straight)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, count_frames_kernel<true>, kFrameWarps * 32, 0);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, count_frames_kernel<false>, kFrameWarps * 32, 0);
}
