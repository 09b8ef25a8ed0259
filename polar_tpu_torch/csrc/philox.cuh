// Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as
// easy as 1, 2, 3", SC'11), written out by hand, and the mapping from random
// words to the Monte-Carlo step's message symbols and normals.
//
// Takes the place of the TPU's in-kernel hardware PRNG
// (pltpu.prng_random_bits in polar_tpu/ops/pallas/step_kernel.py). The
// TPU's bits cannot be reproduced, so results are compared in distribution;
// ops/cuda/philox.py computes the same words in torch, so the step kernel
// can be held against its plain version on identical bits.
//
// Word w of frame f's stream is lane w % 4 of
// philox4x32_10(counter = (f, w / 4, call, 0), key = (seed0, seed1)).
// A frame draws 2N words: [0, N) feed the normals, [N, 2N) the message.
#pragma once

#include <cstdint>

namespace polar {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The same Philox4x32-10, for a thread that draws many blocks of one
// frame's stream (the straight-line AWGN pass, channel_grid.cu): the round
// keys are computed once, each multiply is one 32x32 -> 64-bit product
// (mul.wide.u32 gives both halves), and the first round, whose inputs
// (frame, call, 0) and key are the same for every block of the frame, is
// done once: block b enters round 2 as first.x ^ b. Same words as
// philox4x32_10.
struct PhiloxFrame {
  uint32_t kx[10], ky[10];
  uint4 first;  // the state after round 1 for block 0

  __device__ __forceinline__ explicit PhiloxFrame(uint2 k) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      kx[r] = k.x + (uint32_t)r * 0x9E3779B9u;
      ky[r] = k.y + (uint32_t)r * 0xBB67AE85u;
    }
  }

  __device__ __forceinline__ void start(uint32_t frame, uint32_t call) {
    const uint64_t p0 = (uint64_t)0xD2511F53u * frame;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * call;
    first = make_uint4((uint32_t)(p1 >> 32) ^ kx[0], (uint32_t)p1,
                       (uint32_t)(p0 >> 32) ^ ky[0], (uint32_t)p0);
  }

  __device__ __forceinline__ uint4 block(uint32_t b) const {
    uint4 c = first;
    c.x ^= b;
#pragma unroll
    for (int r = 1; r < 10; ++r) {
      const uint64_t p0 = (uint64_t)0xD2511F53u * c.x;
      const uint64_t p1 = (uint64_t)0xCD9E8D57u * c.z;
      c = make_uint4((uint32_t)(p1 >> 32) ^ c.y ^ kx[r], (uint32_t)p1,
                     (uint32_t)(p0 >> 32) ^ c.w ^ ky[r], (uint32_t)p0);
    }
    return c;
  }
};

// Sequential reader of one frame's word stream with a one-block cache: a
// reader that walks words in order computes each Philox block once.
struct PhiloxStream {
  uint2 key;
  uint32_t frame, call;
  int blk;
  uint4 v;

  __device__ PhiloxStream(uint2 key_, uint32_t frame_, uint32_t call_)
      : key(key_), frame(frame_), call(call_), blk(-1) {}

  __device__ __forceinline__ uint32_t word(int w) {
    const int b = w >> 2;
    if (b != blk) {
      blk = b;
      v = philox4x32_10(make_uint4(frame, (uint32_t)b, call, 0u), key);
    }
    const int lane = w & 3;
    return lane == 0 ? v.x : lane == 1 ? v.y : lane == 2 ? v.z : v.w;
  }
};

// Uniform in (0, 1]: the top 24 bits plus half an ulp
// (step_kernel.py:_bits_to_unit). Never 0, so logf is finite; the top 2^8
// words round to exactly 1.0f.
__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return ((float)(b >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

// (cos 2 pi u, sin 2 pi u) by the quadrant-reduced Taylor polynomials of
// step_kernel.py:_sincos_2pi, operation for operation. step.cu is built
// with -fmad=false, so every product and sum rounds as the torch version's.
__device__ __forceinline__ void sincos_2pi(float u, float* c_out,
                                           float* s_out) {
  const float t = 4.0f * u;
  const float k = rintf(t);
  const float phi = (t - k) * (float)(3.14159265358979323846 / 2.0);
  const float x2 = phi * phi;
  const float c =
      1.0f + x2 * ((float)(-1.0 / 2.0) +
                   x2 * ((float)(1.0 / 24.0) +
                         x2 * ((float)(-1.0 / 720.0) +
                               x2 * (float)(1.0 / 40320.0))));
  const float s =
      phi * (1.0f + x2 * ((float)(-1.0 / 6.0) +
                          x2 * ((float)(1.0 / 120.0) +
                                x2 * ((float)(-1.0 / 5040.0) +
                                      x2 * (float)(1.0 / 362880.0)))));
  const int ki = (int)k;
  const bool swap = (ki & 1) == 1;
  const float sign_c = (float)(1 - ((ki + 1) & 2));
  const float sign_s = (float)(1 - (ki & 2));
  *c_out = sign_c * (swap ? s : c);
  *s_out = sign_s * (swap ? c : s);
}

// The cosine output of sincos_2pi with one polynomial: the quadrant picks
// the cosine or the sine coefficients, and the sine's factor phi is a
// product by phi or by 1.0f (exact). Every rounding is sincos_2pi's, so
// the result is its cosine bit for bit (tests/test_torch_channel_kernel.py
// holds the torch twin, channel_kernel.cos_2pi_one_poly, equal on every
// value of bits_to_unit).
__device__ __forceinline__ float cos_2pi(float u) {
  const float t = 4.0f * u;
  const float k = rintf(t);
  const float phi = (t - k) * (float)(3.14159265358979323846 / 2.0);
  const float x2 = phi * phi;
  const int ki = (int)k;
  const bool swap = (ki & 1) == 1;
  const float a1 = swap ? (float)(-1.0 / 6.0) : (float)(-1.0 / 2.0);
  const float a2 = swap ? (float)(1.0 / 120.0) : (float)(1.0 / 24.0);
  const float a3 = swap ? (float)(-1.0 / 5040.0) : (float)(-1.0 / 720.0);
  const float a4 = swap ? (float)(1.0 / 362880.0) : (float)(1.0 / 40320.0);
  const float p = 1.0f + x2 * (a1 + x2 * (a2 + x2 * (a3 + x2 * a4)));
  return (float)(1 - ((ki + 1) & 2)) * (p * (swap ? phi : 1.0f));
}

}  // namespace polar
