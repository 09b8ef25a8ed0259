// Fast-SSC decode of one frame by one thread: the device core shared by the
// decoder kernel (decoder.cu) and the Monte-Carlo step kernel (step.cu).
//
// Replaces the body of polar_tpu/ops/pallas/decoder_kernel.py:_SsaBuilder
// (the whole-code SSA decoder, _ssa_decoder_kernel / _ssa_decoder_kernel_cw).
// The TPU kernel unrolls the node tree at trace time and keeps the pyramid in
// VMEM. Here the thread walks the code's byte program (code/compiler.py
// emit_program, the reference's polar_compiler.hh format) at run time. Every
// frame runs the same program, so control flow is uniform across a warp and
// one source serves every code without a rebuild.
//
// Layout: every array is element-major (rows, B) int8 in device memory, row r
// of frame f at p[r * B + f], so a warp's 32 threads touch 32 neighbouring
// bytes at each row (one 32-byte sector). What bounds it on the card: the
// latency of those byte accesses to the soft pyramid and hard stack, which
// stay in device memory (cached in L1/L2). Specializing per code and keeping
// the pyramid in shared memory or registers are later steps.
//
// Arithmetic is in int with explicit clamps; values are stored as int8.
// Saturation order, the -127 guards, SPC's flip of every tied minimum and
// decide(0) = +1 / signum(0) = 0 follow polar_tpu/ops/arith.py:Int8Arith.
#pragma once

#include <cstdint>

namespace polar {

// Opcodes of the byte program (polar_compiler.hh:11-13).
enum : int {
  OP_LEFT = 0,
  OP_RIGHT = 1,
  OP_COMB = 2,
  OP_RATE0 = 3,
  OP_RATE1 = 4,
  OP_REP = 5,
  OP_SPC = 6,
  OP_RATE0_RIGHT = 7,
  OP_RATE0_COMB = 8,
  OP_RATE1_COMB = 9,
  OP_END = 255,
};

// One frame's column of an element-major (rows, B) int8 array.
struct Col {
  int8_t* p;
  long long stride;
  __device__ __forceinline__ int8_t& operator[](int r) const {
    return p[(long long)r * stride];
  }
  __device__ __forceinline__ Col rows(int r0) const {
    return Col{p + (long long)r0 * stride, stride};
  }
};

__device__ __forceinline__ int sat8(int x) { return min(max(x, -128), 127); }
__device__ __forceinline__ int signum(int x) { return min(max(x, -1), 1); }
__device__ __forceinline__ int decide(int x) { return x < 0 ? -1 : 1; }
__device__ __forceinline__ int qabs(int x) { return abs(max(x, -127)); }
// f: sign(a) sign(b) min(qabs(a), qabs(b))
__device__ __forceinline__ int prod(int a, int b) {
  return signum(a) * signum(b) * min(qabs(a), qabs(b));
}
// g: sat8(h * max(a, -127) + b), h a hard value in {-1, 0, +1}
__device__ __forceinline__ int madd(int h, int a, int b) {
  return sat8(h * max(a, -127) + b);
}

// In-place polar transform of len rows: x[j] *= x[j + h] for the lower
// element of every pair, h = 1, 2, 4, ... (ops/transform.py).
__device__ inline void transform(Col x, int len) {
  for (int h = 1; h < len; h <<= 1)
    for (int j = 0; j < len; j += 2 * h)
      for (int i = j; i < j + h; ++i) x[i] = (int8_t)(x[i] * x[i + h]);
}

// Decode one frame.
//   prog: [level, opcodes..., 255], the same bytes for every thread.
//   in:   the root LLRs, rows [0, n); only read.
//   soft: n rows. The input of a node of size len < n sits at rows
//         [len, 2 len) (the reference's soft pyramid, polar_decoder.hh:128);
//         rows [0, len) are free while a leaf of size len runs and serve as
//         its temporary.
//   hard: n rows, the hard-decision stack.
//   mesg: receives the K message bits in emission order.
__device__ inline void fastssc_decode(const uint8_t* __restrict__ prog, int n,
                                      Col in, Col soft, Col hard, Col mesg) {
  int lvl = __ldg(prog);  // level of the node the next opcode applies to
  int hoff = 0;           // its rows in the hard stack
  int moff = 0;           // message cursor
  for (int pc = 1;; ++pc) {
    const int op = __ldg(prog + pc);
    if (op == OP_END) break;
    const int len = 1 << lvl;
    const Col x = len == n ? in : soft.rows(len);  // this node's input
    switch (op) {
      case OP_LEFT: {  // f into the left child's slot, descend
        const int half = len >> 1;
        const Col c = soft.rows(half);
        for (int i = 0; i < half; ++i) c[i] = (int8_t)prod(x[i], x[half + i]);
        --lvl;
        break;
      }
      case OP_RIGHT: {  // at the left child: g into the right child's slot
        const int half = len;
        const Col p = 2 * half == n ? in : soft.rows(2 * half);
        const Col c = soft.rows(half);
        for (int i = 0; i < half; ++i)
          c[i] = (int8_t)madd(hard[hoff + i], p[i], p[half + i]);
        hoff += half;
        break;
      }
      case OP_COMB: {  // at the right child: hard_l *= hard_r, ascend
        const int half = len;
        hoff -= half;
        for (int i = 0; i < half; ++i)
          hard[hoff + i] = (int8_t)(hard[hoff + i] * hard[hoff + half + i]);
        ++lvl;
        break;
      }
      case OP_RATE0:
        for (int i = 0; i < len; ++i) hard[hoff + i] = 1;
        break;
      case OP_RATE1: {  // hard = signum(x), message = T(hard)
        const Col m = mesg.rows(moff);
        for (int i = 0; i < len; ++i) {
          const int8_t h = (int8_t)signum(x[i]);
          hard[hoff + i] = h;
          m[i] = h;
        }
        transform(m, len);
        moff += len;
        break;
      }
      case OP_REP: {  // saturating fold in halves, in that order
        int w = len >> 1;
        for (int i = 0; i < w; ++i) soft[i] = (int8_t)sat8(x[i] + x[w + i]);
        while (w > 1) {
          w >>= 1;
          for (int i = 0; i < w; ++i)
            soft[i] = (int8_t)sat8(soft[i] + soft[w + i]);
        }
        const int8_t bit = (int8_t)signum(soft[0]);
        for (int i = 0; i < len; ++i) hard[hoff + i] = bit;
        mesg[moff++] = bit;
        break;
      }
      case OP_SPC: {  // Wagner: decide, parity, flip every weakest position
        int parity = 1, weak = 128;
        for (int i = 0; i < len; ++i) {
          const int s = x[i];
          parity *= decide(s);
          weak = min(weak, qabs(s));
        }
        for (int i = 0; i < len; ++i) {
          const int s = x[i];
          int h = decide(s);
          if (qabs(s) == weak) h *= parity;
          hard[hoff + i] = (int8_t)h;
          soft[i] = (int8_t)h;
        }
        transform(soft, len);
        for (int i = 1; i < len; ++i) mesg[moff + i - 1] = soft[i];
        moff += len - 1;
        break;
      }
      case OP_RATE0_RIGHT: {  // all-frozen left half: g is a plain sat add
        const int half = len >> 1;
        const Col c = soft.rows(half);
        for (int i = 0; i < half; ++i) c[i] = (int8_t)sat8(x[i] + x[half + i]);
        hoff += half;
        --lvl;
        break;
      }
      case OP_RATE0_COMB: {  // hard = [hard_r, hard_r], ascend
        const int half = len;
        hoff -= half;
        for (int i = 0; i < half; ++i) hard[hoff + i] = hard[hoff + half + i];
        ++lvl;
        break;
      }
      case OP_RATE1_COMB: {  // at the left child: fused g, sign, comb, T
        const int half = len;
        const Col p = 2 * half == n ? in : soft.rows(2 * half);
        const Col m = mesg.rows(moff);
        for (int i = 0; i < half; ++i) {
          const int hl = hard[hoff + i];
          const int hr = signum(madd(hl, p[i], p[half + i]));
          hard[hoff + half + i] = (int8_t)hr;
          hard[hoff + i] = (int8_t)(hl * hr);
          m[i] = (int8_t)hr;
        }
        transform(m, half);
        moff += half;
        ++lvl;
        break;
      }
      default:
        break;
    }
  }
}

// Codeword estimate: scatter the message into a +1-filled column (frozen
// rows stay +1), then transform. Equal to encode(code, u), zero ties
// included (testbench.cc:177-183).
__device__ inline void reencode(const uint8_t* __restrict__ frozen, int n,
                                Col mesg, Col cw) {
  int k = 0;
  for (int i = 0; i < n; ++i) cw[i] = __ldg(frozen + i) ? (int8_t)1 : mesg[k++];
  transform(cw, n);
}

}  // namespace polar
