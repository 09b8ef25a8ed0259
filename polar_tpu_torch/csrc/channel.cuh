// The channel math of the Monte-Carlo front, shared by the fused step kernel
// (step.cu), the large-N block front (front.cu) and the elementwise channel
// kernels (channel_grid.cu), so that all compute every normal and every LLR
// with the same instructions: the large-N step reproduces the fused step's
// counters on the same Philox words.
//
// Every file is built with -fmad=false: each product and sum below rounds
// on its own, as the plain torch chain (channel.py:channel_llrs) rounds them.
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace polar {

// llr = clamp(rint(scale * (cw + sigma * noise)), -128, 127)
// (polar_tpu/ops/pallas/step_kernel.py:_chan_block_body, testbench.cc:160-165)
__device__ __forceinline__ int8_t quantize(float cw, float noise, float sigma,
                                           float scale) {
  const float y = __fadd_rn(cw, __fmul_rn(sigma, noise));
  const float q = rintf(__fmul_rn(scale, y));
  return (int8_t)fminf(fmaxf(q, -128.0f), 127.0f);
}

// Box-Muller on one radius word and one angle word
// (step_kernel.py:_bits_to_normals): *n0 = r cos, *n1 = r sin. A code of
// N rows takes row i's normal (n0) and row N/2 + i's (n1) from radius word
// i and angle word N/2 + i of the frame's stream.
__device__ __forceinline__ void box_muller(uint32_t radius_word,
                                           uint32_t angle_word, float* n0,
                                           float* n1) {
  const float u1 = bits_to_unit(radius_word);
  const float u2 = bits_to_unit(angle_word);
  const float r = sqrtf(-2.0f * logf(u1));
  float cs, sn;
  sincos_2pi(u2, &cs, &sn);
  *n0 = r * cs;
  *n1 = r * sn;
}

// Cosine-only Box-Muller on two independent words
// (polar_tpu/ops/pallas/channel_kernel.py:_normals): sqrt(-2 ln u1) cos 2 pi u2.
__device__ __forceinline__ float normal_cos(uint32_t radius_word,
                                            uint32_t angle_word) {
  const float r = sqrtf(-2.0f * logf(bits_to_unit(radius_word)));
  float cs, sn;
  sincos_2pi(bits_to_unit(angle_word), &cs, &sn);
  return r * cs;
}

}  // namespace polar
