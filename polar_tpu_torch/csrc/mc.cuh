// The two halves of the Monte-Carlo step, shared by the fused step kernel
// (mc_step_kernel), the whole-block front (front_whole_kernel) and the
// decode+count kernel (decode_count_kernel), all in step.cu. One source for
// the three, so the front plus decode+count reproduces the fused step's
// counters on the same Philox words, and the fused step compiles to what it
// was.
//
// Layout: every array is element-major (rows, B), one thread per frame
// (fastssc.cuh's Col). Counter order: uncorrected bit errors, frame errors,
// ambiguity erasures, AWGN sign flips, quantization erasures
// (testbench.cc:185-192).
#pragma once

#include <cstdint>

#include "channel.cuh"
#include "fastssc.cuh"

namespace polar {

constexpr int kCounters = 5;
constexpr int kMaxWarps = 32;

// Front half for frame f (polar_tpu/ops/pallas/step_kernel.py:_front):
//   1. u0 = frozen ? +1 : message symbol (msg_in row i in inject mode, else
//      bit 0 of word N + i), into u when keep_u and into c;
//   2. c = T(u0); systematic: refreeze, c = T(c);
//   3. llr = quantize(c + sigma * normal), normals from normals_in (inject)
//      or Box-Muller over words i (radius) and N/2 + i (angle), giving rows
//      i and N/2 + i;
//   4. cnt[3] += AWGN sign flips, cnt[4] += zero LLRs.
// The words: row r of words_in (2N, B) u32 in bits mode, else word r of the
// frame's Philox stream.
__device__ inline void mc_front(const uint8_t* __restrict__ frozen, int n,
                                int f, long long b, int systematic,
                                float sigma, float scale,
                                const int8_t* __restrict__ msg_in,
                                const float* __restrict__ normals_in,
                                const uint32_t* __restrict__ words_in,
                                uint2 key, uint32_t call, bool keep_u, Col u,
                                Col c, Col llr, int* cnt) {
  const bool inject = msg_in != nullptr, bits = words_in != nullptr;
  PhiloxStream msg_words(key, (uint32_t)f, call);
  for (int i = 0; i < n; ++i) {
    int8_t sym = 1;
    if (!__ldg(frozen + i)) {
      const uint32_t w = bits ? words_in[(long long)(n + i) * b + f] : 0u;
      sym = inject ? msg_in[(long long)i * b + f]
            : (int8_t)(1 - 2 * (int)((bits ? w : msg_words.word(n + i)) & 1u));
    }
    if (keep_u) u[i] = sym;
    c[i] = sym;
  }
  transform(c, n);
  if (systematic) {
    for (int i = 0; i < n; ++i)
      if (__ldg(frozen + i)) c[i] = 1;
    transform(c, n);
  }
  const int h = n >> 1;
  PhiloxStream radius_words(key, (uint32_t)f, call);
  PhiloxStream angle_words(key, (uint32_t)f, call);
  for (int i = 0; i < h; ++i) {
    float n0, n1;
    if (inject) {
      n0 = normals_in[(long long)i * b + f];
      n1 = normals_in[(long long)(h + i) * b + f];
    } else if (bits) {
      box_muller(words_in[(long long)i * b + f],
                 words_in[(long long)(h + i) * b + f], &n0, &n1);
    } else {
      box_muller(radius_words.word(i), angle_words.word(h + i), &n0, &n1);
    }
    const int rows[2] = {i, h + i};
    const float nz[2] = {n0, n1};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cwv = c[rows[j]];
      const int8_t l = quantize((float)cwv, nz[j], sigma, scale);
      llr[rows[j]] = l;
      cnt[3] += (l != 0) & ((l < 0) != (cwv < 0));
      cnt[4] += l == 0;
    }
  }
}

// Back half of a systematic frame, after the decode: re-encode the message
// m into the codeword estimate hat, compare it with the transmitted c at the
// info rows (the message IS those rows): cnt[0] errors, cnt[2] decoded
// zeros, cnt[1] = any error.
__device__ inline void cw_counts(const uint8_t* __restrict__ frozen, int n,
                                 Col m, Col hat, Col c, int* cnt) {
  reencode(frozen, n, m, hat);
  int frame_err = 0;
  for (int i = 0; i < n; ++i) {
    if (__ldg(frozen + i)) continue;
    const int v = hat[i];
    const int e = v != c[i];
    cnt[0] += e;
    cnt[2] += v == 0;
    frame_err |= e;
  }
  cnt[1] = frame_err;
}

// The block's five sums into out[blockIdx.x * 5 ...]: warp shuffles, then
// shared memory, in a fixed order (no atomics: the counts are
// deterministic). Every thread of the block must call it.
__device__ inline void store_block_counts(const int* cnt, int* out) {
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

}  // namespace polar
