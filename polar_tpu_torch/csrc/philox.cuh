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

}  // namespace polar
