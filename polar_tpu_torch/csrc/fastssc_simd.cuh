// Fast-SSC decode of a tile of frames by one warp, four frames to a 32-bit
// word: the device core of the whole-code tile decoder (decoder.cu), the
// tile subtree decoder (subtree.cu) and the tile Monte-Carlo step (step.cu).
//
// Replaces the body of polar_tpu/ops/pallas/decoder_kernel.py:_SsaBuilder
// (_ssa_decoder_kernel :404 and _ssa_decoder_kernel_cw :410), as
// fastssc.cuh does for one frame a thread. The reference (SURVEY.md) runs
// one frame per int8 lane of an AVX2 register; here a 32-bit register holds
// four frames, and the byte-SIMD intrinsics (__vaddss4, __vabsss4,
// __vminu4, __vmaxs4, __vcmplts4, ...) do the arithmetic of all four.
//
// Layout. Frames f..f+3 of one row are four neighbouring bytes of the
// element-major (rows, B) int8 arrays, so a word is read and written as it
// lies, with no transpose. A tile is WR words (4 WR frames) wide, and a
// lane holds VW of them (a Vec, one 4 VW-byte access). The tile's soft
// pyramid and hard stack (and, on the cw track, the codeword stack) sit in
// shared memory, n rows of WR words each, row r at [r * WR + w]; only the
// root LLRs, the message and the codeword touch device memory. WR / VW
// lanes share a row, so a warp covers 32 VW / WR rows a pass with
// consecutive accesses, free of bank conflicts, and a node of len rows
// takes len WR / (32 VW) passes. Nodes of fewer rows than a pass leave
// lanes idle. Every op ends with __syncwarp, since the next one reads rows
// other lanes wrote. Inside an op, the polar transforms (rate-1, SPC,
// RATE1_COMB, the cw track's second one, the step's encode) and REP's
// folds run in a register block, with no barrier: a lane keeps its rows of
// up to kP passes in registers (reg_passes, by shape at compile time);
// stage s pairs rows i and i + 2^s, two of the lane's own registers
// where 2^s >= kPass, else the lane kLanesRow << s away by __shfl_xor_sync
// (REP: __shfl_down_sync, the bit broadcast from row 0's lane), and the
// message and cw rows go out from the registers. A node of more rows than
// the block (kBlock) runs its stages below kBlock in register chunks and
// those from kBlock up in shared memory, one pass and one barrier a stage,
// as every stage ran before. The frame-major instances keep REP's folds in
// shared memory (kRegFolds). The block of one pass of words a lane
// (kRegWords = 2) and those choices came from an A/B on an H100 against
// blocks of 2 and 4 passes (slower: more registers, spills in the
// interpreter) and REP's folds in registers everywhere (PERF.md).
// The wrapper's shape, 8 frames a tile and a lane (WR = VW = 2, 32 rows a
// pass), was chosen over six others on an H100: a lane's two words are two
// independent chains, and the small tile keeps more warps on an SM.
// Unrolling a lane's rows four at a time, all loads before any store, ran
// slower there.
//
// The program: the code's byte program (code/compiler.py emit_program), the
// same for every lane, read with one broadcast load per opcode; the walk
// follows fastssc.cuh:fastssc_decode opcode for opcode.
//
// The cw track is built per node, as _SsaBuilder.node(need_cw=True) and
// interp.cu build it: rate-0 +1, rate-1 T(T(hard)), REP the bit broadcast,
// SPC T([+1, v_1..v_{len-1}]), and cw = [cw_l * cw_r, cw_r] at every
// combine. It is not the hard stack, which holds zeros after signum(0).
//
// Exactness: each packed function below equals its scalar namesake in
// fastssc.cuh byte for byte (decoder.cu's polar_simd_selftest checks all
// 65,536 int8 pairs on the card):
//   sat8 add  -> __vaddss4 (signed saturating);
//   qabs      -> __vabsss4 (-128 -> 127, as abs(max(x, -127)));
//   madd      -> h * __vmaxs4(a, -127) by sign masks, h = 0 a zero term,
//                then __vaddss4;
//   prod      -> sign(a) xor sign(b) on min(qabs a, qabs b): a zero operand
//                makes the minimum 0, so signum(0) = 0 needs no mask;
//   decide    -> -1 where x < 0, else +1 (decide(0) = +1);
//   hard and cw products of {-1, 0, +1} by bit masks.
// SPC flips every position whose qabs equals the minimum (every tie); REP
// folds in halves in fastssc_decode's order.
//
// Two callers need more than the whole-code decoder, each a template flag
// that leaves the decoder's instance as it was: ROOT_SMEM takes the root
// input from n on-chip rows (`root`) that the caller fills first (a fused
// parent f or g, or the step's quantized LLRs) in place of device memory;
// EMIT_U = false emits no message rows (a node or step that needs the cw
// track alone).
//
// FRAMES, a third such flag, serves the u track's frame-major entry: the
// root LLRs are (batch, n) and the message (batch, k), so no transpose
// runs around the kernel. Only the device-memory accesses change: a lane
// gathers byte r of each of its 4 VW frames (one byte load a frame, packed
// by __byte_perm) from a pointer to its first frame kept in a register,
// and scatters the message bytes the same way. The lanes of a pass take
// consecutive rows, so a warp's bytes of one frame in one access are
// contiguous (32, one sector, at the (2, 2) shape). An op that reads two
// root rows issues both rows' loads before it packs either (in2): packed
// in turn, the second row's loads waited for the first's. In the A/B on an
// H100 (PERF.md) a 4-byte load of four rows a lane, transposed among four
// lanes by __shfl_xor_sync, ran 6-19 % slower than this; an L2 prefetch of
// the tile's root, __ldg loads and a register pointer for the message as
// well gained nothing or lost. With INTERP, the interpreter's frame-major u
// track: the message is frame-major, and the root too where root_f is set
// (a run rooted at the code's root); else the root lies in the
// interpreter's element-major pyramid, and the hard rows go back
// element-major (put).
//
// FLOAT32. The tile also decodes float32 LLRs in the test bench's other
// arithmetic, min-sum with no saturation (Tile's last parameter,
// F32Lanes below): one frame to a 32-bit word, so a tile of WR words is
// WR frames, and the same schedule, layout and program walk as int8; only
// the lane functions, the gather of a float a frame and the message byte
// differ (decoder.cu f32_frames_kernel, the frame-major u track alone).
//
// What bounds it on the card: the latency of each op's dependent chain
// (shared-memory loads, the emulated byte-SIMD arithmetic, a warp barrier)
// with the few warps an SM can hold: a tile takes 2 n (u) or 3 n (cw) bytes
// a frame, so an SM holds about 114 KB / n frames on the u track. The
// wrapper (ops/cuda/decoder_kernel.py) sizes the tile and sends codes above
// WHOLE_MAX_LEVEL to the one-thread-a-frame walk.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fastssc.cuh"

namespace polar {
namespace simd {

constexpr uint32_t kOnes = 0x01010101u;   // +1 in every byte
constexpr uint32_t kM127 = 0x81818181u;   // -127 in every byte

__device__ __forceinline__ uint32_t sat_add(uint32_t a, uint32_t b) {
  return __vaddss4(a, b);
}
__device__ __forceinline__ uint32_t qabs(uint32_t x) { return __vabsss4(x); }
// 0xFF in every byte that is negative
__device__ __forceinline__ uint32_t neg_mask(uint32_t x) {
  return __vcmplts4(x, 0u);
}
// -x where the byte mask s is 0xFF, else x (x > -128)
__device__ __forceinline__ uint32_t cond_neg(uint32_t x, uint32_t s) {
  return __vsub4(x ^ s, s);
}
__device__ __forceinline__ uint32_t signum(uint32_t x) {
  return __vmins4(__vmaxs4(x, 0xFFFFFFFFu), kOnes);
}
__device__ __forceinline__ uint32_t decide(uint32_t x) {
  return neg_mask(x) | kOnes;
}
__device__ __forceinline__ uint32_t prod(uint32_t a, uint32_t b) {
  return cond_neg(__vminu4(qabs(a), qabs(b)), neg_mask(a ^ b));
}
// h in {-1, 0, +1} per byte
__device__ __forceinline__ uint32_t madd(uint32_t h, uint32_t a, uint32_t b) {
  const uint32_t t = cond_neg(__vmaxs4(a, kM127), neg_mask(h));
  return __vaddss4(t & __vcmpne4(h, 0u), b);
}
// product of two {-1, 0, +1} bytes: 1 in bit 0 where both are non-zero,
// 0xFF where their signs differ as well
__device__ __forceinline__ uint32_t hmul(uint32_t x, uint32_t y) {
  const uint32_t nz = x & y & kOnes;
  return nz | (neg_mask(x ^ y) & (nz * 0xFFu));
}
// SPC's decision: decide(x), flipped where qabs(x) equals the minimum
// `weak` and the parity mask `odd` (0xFF: an odd count of negatives) is set
__device__ __forceinline__ uint32_t spc_flip(uint32_t x, uint32_t weak,
                                             uint32_t odd) {
  return decide(x) ^ (__vcmpeq4(qabs(x), weak) & odd & 0xFEFEFEFEu);
}

// VW words (4 VW frames of one row) that one lane holds, moved as one
// 4 VW-byte access; the packed functions apply to each word.
template <int VW>
struct alignas(4 * VW) Vec {
  uint32_t x[VW];
};

template <int VW>
__device__ __forceinline__ Vec<VW> splat(uint32_t v) {
  Vec<VW> o;
#pragma unroll
  for (int k = 0; k < VW; ++k) o.x[k] = v;
  return o;
}

#define POLAR_SIMD_LIFT1(fn)                                          \
  template <int VW>                                                   \
  __device__ __forceinline__ Vec<VW> fn(const Vec<VW>& a) {           \
    Vec<VW> o;                                                        \
    _Pragma("unroll") for (int k = 0; k < VW; ++k) o.x[k] = fn(a.x[k]); \
    return o;                                                         \
  }
#define POLAR_SIMD_LIFT2(fn)                                            \
  template <int VW>                                                     \
  __device__ __forceinline__ Vec<VW> fn(const Vec<VW>& a,               \
                                        const Vec<VW>& b) {             \
    Vec<VW> o;                                                          \
    _Pragma("unroll") for (int k = 0; k < VW; ++k) o.x[k] =             \
        fn(a.x[k], b.x[k]);                                             \
    return o;                                                           \
  }
#define POLAR_SIMD_LIFT3(fn)                                            \
  template <int VW>                                                     \
  __device__ __forceinline__ Vec<VW> fn(                                \
      const Vec<VW>& a, const Vec<VW>& b, const Vec<VW>& c) {           \
    Vec<VW> o;                                                          \
    _Pragma("unroll") for (int k = 0; k < VW; ++k) o.x[k] =             \
        fn(a.x[k], b.x[k], c.x[k]);                                     \
    return o;                                                           \
  }
POLAR_SIMD_LIFT1(signum)
POLAR_SIMD_LIFT2(sat_add)
POLAR_SIMD_LIFT2(prod)
POLAR_SIMD_LIFT2(hmul)
POLAR_SIMD_LIFT3(madd)
POLAR_SIMD_LIFT3(spc_flip)
#undef POLAR_SIMD_LIFT1
#undef POLAR_SIMD_LIFT2
#undef POLAR_SIMD_LIFT3

// The lane arithmetic of a tile, one struct a number format, each
// function on one 32-bit word. Int8Lanes: the saturating int8 above, four
// frames to a word. F32Lanes: float32 min-sum (polar_helper.hh:63-111, as
// ops/arith.py FloatArith and decode/fastssc.py compute it), one frame to
// a word held as its bits; each operation rounded on its own, in torch's
// order, so the signs of zeros come out as the eager decoder's do: signum
// and prod give +0 for a zero operand (prod: -0 where the other operand is
// negative), hard values are {-1, -0, +0, +1} and meet by products.
// SPC: decide is copysign(1, x) (-0 decides -1), the parity the sign bits'
// xor, weak the least |x| (bit patterns of non-negative floats order as
// the floats do), every tied weakest flips.
struct Int8Lanes {
  using In = int8_t;
  static constexpr int kPerWord = 4;
  static constexpr uint32_t kOne = kOnes;
  static constexpr uint32_t kWeak = 0x7F7F7F7Fu;   // qabs's largest
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return sat_add(a, b);
  }
  static __device__ __forceinline__ uint32_t prod(uint32_t a, uint32_t b) {
    return simd::prod(a, b);
  }
  static __device__ __forceinline__ uint32_t madd(uint32_t h, uint32_t a,
                                                  uint32_t b) {
    return simd::madd(h, a, b);
  }
  static __device__ __forceinline__ uint32_t signum(uint32_t x) {
    return simd::signum(x);
  }
  static __device__ __forceinline__ uint32_t hmul(uint32_t x, uint32_t y) {
    return simd::hmul(x, y);
  }
  // SPC: the parity's mask, the magnitude, the least of two magnitudes
  static __device__ __forceinline__ uint32_t sign(uint32_t x) {
    return neg_mask(x);
  }
  static __device__ __forceinline__ uint32_t mag(uint32_t x) {
    return qabs(x);
  }
  static __device__ __forceinline__ uint32_t least(uint32_t a, uint32_t b) {
    return __vminu4(a, b);
  }
  static __device__ __forceinline__ uint32_t spc(uint32_t x, uint32_t weak,
                                                 uint32_t odd) {
    return spc_flip(x, weak, odd);
  }
  // the message byte of frame j of a word
  static __device__ __forceinline__ int8_t byte(uint32_t w, int j) {
    return (int8_t)(w >> (8 * j));
  }
};

struct F32Lanes {
  using In = float;
  static constexpr int kPerWord = 1;
  static constexpr uint32_t kOne = 0x3F800000u;    // 1.0f
  static constexpr uint32_t kWeak = 0x7F800000u;   // +inf
  static constexpr uint32_t kSign = 0x80000000u;
  static __device__ __forceinline__ float fl(uint32_t w) {
    return __uint_as_float(w);
  }
  static __device__ __forceinline__ uint32_t bits(float x) {
    return __float_as_uint(x);
  }
  // torch.sign: (x > 0) - (x < 0), +0 for either zero
  static __device__ __forceinline__ float sgn(float x) {
    return x > 0.0f ? 1.0f : x < 0.0f ? -1.0f : 0.0f;
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return bits(__fadd_rn(fl(a), fl(b)));
  }
  // sign(a) * sign(b) * min(|a|, |b|), the two products in that order
  static __device__ __forceinline__ uint32_t prod(uint32_t a, uint32_t b) {
    const float s = __fmul_rn(sgn(fl(a)), sgn(fl(b)));
    return bits(__fmul_rn(s, fminf(fabsf(fl(a)), fabsf(fl(b)))));
  }
  // h * a + b with h in {-1, -0, +0, +1}: h * a is exact, so the fused
  // multiply-add rounds once where torch rounds the sum, to the same value
  // and the same signed zero
  static __device__ __forceinline__ uint32_t madd(uint32_t h, uint32_t a,
                                                  uint32_t b) {
    return bits(__fmaf_rn(fl(h), fl(a), fl(b)));
  }
  static __device__ __forceinline__ uint32_t signum(uint32_t x) {
    return bits(sgn(fl(x)));
  }
  static __device__ __forceinline__ uint32_t hmul(uint32_t x, uint32_t y) {
    return bits(__fmul_rn(fl(x), fl(y)));
  }
  static __device__ __forceinline__ uint32_t sign(uint32_t x) {
    return x & kSign;
  }
  static __device__ __forceinline__ uint32_t mag(uint32_t x) {
    return x & ~kSign;
  }
  static __device__ __forceinline__ uint32_t least(uint32_t a, uint32_t b) {
    return min(a, b);
  }
  // copysign(1, x), negated where |x| is the weakest and the parity `odd`
  // (the xor of the node's sign bits) is set
  static __device__ __forceinline__ uint32_t spc(uint32_t x, uint32_t weak,
                                                 uint32_t odd) {
    return ((x & kSign) | kOne) ^ (mag(x) == weak ? odd : 0u);
  }
  static __device__ __forceinline__ int8_t byte(uint32_t w, int) {
    return (int8_t)__float2int_rz(fl(w));
  }
};

// The one tile shape the kernels build: a row of a tile is 2 words (8
// frames), both on one lane. Why this shape: WHOLE_FRAMES in
// ops/cuda/decoder_kernel.py.
constexpr int kTileWR = 2, kTileVW = 2;

// The register block: the words of a node's rows a lane keeps in
// registers for its transform stages and REP's folds, kRegWords / VW
// passes (at least one) of a lane holding VW words of a row.
// ops/cuda/tile_stages.py reg_passes mirrors it.
constexpr int kRegWords = 2;
constexpr int reg_passes(int vw) {
  return kRegWords / vw > 0 ? kRegWords / vw : 1;
}

// One warp's tile: WR words a row, VW of them a lane; CW: the codeword
// track is on; ROOT_SMEM: the root input is on chip; EMIT_U: the message
// rows are stored; INTERP: the interpreter's tile runs (csrc/interp.cu),
// whose bodies lie in one level-positional pyramid: a body's root input
// is the on-chip rows at `root` where that is set, else device memory;
// FRAMES: the root and the message in device memory are frame-major (with
// INTERP the root only where root_f is set); A: the lane arithmetic
// (Int8Lanes; F32Lanes, float32 root LLRs, one frame to a word, on the
// frame-major u track alone: WR frames a tile, a word's row four times
// the bytes).
template <int WR, int VW, bool CW, bool ROOT_SMEM = false, bool EMIT_U = true,
          bool INTERP = false, bool FRAMES = false, typename A = Int8Lanes>
struct Tile {
  static_assert(!FRAMES || (!CW && !ROOT_SMEM && EMIT_U),
                "the frame-major layout serves the u track alone");
  static_assert(A::kPerWord == 4 || (FRAMES && !INTERP),
                "a word of one frame serves the frame-major u track alone");
  using V = Vec<VW>;
  using In = typename A::In;
  static constexpr int kPerWord = A::kPerWord;  // frames a word
  static constexpr int kFrames = kPerWord * WR; // frames a tile
  static constexpr int kRowBytes = 4 * WR;      // bytes a row of a region
  static constexpr int kLanesRow = WR / VW;     // lanes that share a row
  static constexpr int kPass = 32 / kLanesRow;  // rows a warp covers a pass
  // shared regions of n rows a warp: soft, hard, cw (CW), root (ROOT_SMEM)
  static constexpr int kRegions = 2 + CW + ROOT_SMEM;
  // the register block: passes a lane keeps in registers, the rows they
  // cover
  static constexpr int kP = reg_passes(VW);
  static constexpr int kBlock = kP * kPass;
  static_assert((kP & (kP - 1)) == 0, "passes a power of two");
  // REP's folds in the register block too (the frame-major instances keep
  // them in shared memory: there the register folds ran slower)
  static constexpr bool kRegFolds = !FRAMES;
  uint32_t* soft;   // n rows: a node of len < n reads rows [len, 2 len)
  uint32_t* hard;   // n rows: the hard-decision stack
  uint32_t* cw;     // n rows: the codeword stack (CW only)
  uint32_t* root;   // n rows: the root input (ROOT_SMEM; INTERP: a body's
                    // on-chip root, or null)
  const In* llr;       // the root LLRs (n, batch), device memory (else);
                       // FRAMES: (batch, n)
  int8_t* mesg;        // the message (k, batch); FRAMES: (batch, k)
  long long batch;
  const In* root_f;      // FRAMES: this lane's first frame of the root
                         // (INTERP: null where the root is element-major)
  int in_stride;         // FRAMES: bytes a frame of the root (n)
  int out_stride;        // FRAMES: bytes a frame of the message (k)
  int f;               // this lane's first frame
  int r0;              // this lane's first row of a pass
  int w;               // this lane's first word of a row
  bool aligned;        // batch % 16 == 0 and the arrays start on 16 bytes:
                       // every lane's bytes of every row do

  // Binds this lane to its warp's tile of the block: tile blockIdx.x *
  // warps + warp, its regions at kRegions * n * WR words a warp of the
  // block's dynamic shared memory `smem`, in the order of kRegions. False
  // when the whole tile lies past the batch (the warp has no frame).
  // FRAMES: k is the message's rows (aligned_ is not read).
  __device__ __forceinline__ bool bind(uint32_t* smem, int n,
                                       const In* llr_, int8_t* mesg_,
                                       int batch_, int aligned_, int k = 0) {
    const int warp = threadIdx.x >> 5;
    const long long tile = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (tile * kFrames >= batch_) return false;
    place(smem + (size_t)warp * kRegions * n * WR, n, tile, llr_, mesg_,
          batch_, aligned_, k);
    return true;
  }
  // Binds this lane to tile `tile` (which must hold a frame), its regions
  // of n rows from `base`, in the order of kRegions: bind's work, for a
  // warp that walks over tiles itself.
  __device__ __forceinline__ void place(uint32_t* base, int n, long long tile,
                                        const In* llr_, int8_t* mesg_,
                                        int batch_, int aligned_, int k = 0) {
    const int lane = threadIdx.x & 31;
    soft = base;
    hard = base + n * WR;
    cw = CW ? base + 2 * n * WR : nullptr;
    root = ROOT_SMEM ? base + (kRegions - 1) * n * WR : nullptr;
    llr = llr_;
    mesg = mesg_;
    batch = batch_;
    w = lane % kLanesRow * VW;
    r0 = lane / kLanesRow;
    f = (int)(tile * kFrames) + kPerWord * w;
    aligned = aligned_ != 0;
    if constexpr (FRAMES) {
      in_stride = n;
      out_stride = k;
      root_f = llr_ + (long long)f * n;
    }
  }
  // the tile's first frame
  __device__ __forceinline__ int first() const { return f - kPerWord * w; }

  // A lane's words of a device row. The tail of the last tile is masked
  // explicitly: frames at or past `batch` read as 0 and are never stored.
  // FRAMES: load reads the root and store writes the message.
  __device__ __forceinline__ V load(const In* base, int r) const {
    if constexpr (FRAMES && !INTERP) {
      return gather(r);
    } else {
      if constexpr (FRAMES && INTERP)
        if (root_f != nullptr) return gather(r);
      const int8_t* p = base + (long long)r * batch + f;
      if (aligned && f < batch) return *reinterpret_cast<const V*>(p);
      V v = splat<VW>(0u);
      for (int j = 0; j < 4 * VW; ++j)
        if (f + j < batch)
          v.x[j / 4] |= (uint32_t)(uint8_t)p[j] << (8 * (j % 4));
      return v;
    }
  }
  __device__ __forceinline__ void store(int8_t* base, int r, V v) const {
    if constexpr (FRAMES) return scatter(r, v);
    put(base, r, v);
  }
  // A lane's words of an element-major device row, whatever the layout
  __device__ __forceinline__ void put(int8_t* base, int r, V v) const {
    int8_t* p = base + (long long)r * batch + f;
    if (aligned && f < batch) {
      *reinterpret_cast<V*>(p) = v;
      return;
    }
    for (int j = 0; j < 4 * VW; ++j)
      if (f + j < batch) p[j] = (int8_t)(v.x[j / 4] >> (8 * (j % 4)));
  }
  // FRAMES: element r of each of the lane's frames of the root, a byte
  // each packed four frames to a word as load's words are (int8), or a
  // float's bits a word; frames past the batch read 0
  __device__ __forceinline__ V gather(int r) const {
    const In* p = root_f + r;
    const bool full = f + kPerWord * VW <= batch;
    V v;
    if constexpr (kPerWord == 1) {   // a float a frame
#pragma unroll
      for (int k = 0; k < VW; ++k)
        v.x[k] = full || f + k < batch
                     ? __float_as_uint(p[(long long)k * in_stride])
                     : 0u;
    } else {
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        uint32_t b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int fr = 4 * k + j;
          b[j] = full || f + fr < batch
                     ? (uint32_t)(uint8_t)p[(long long)fr * in_stride]
                     : 0u;
        }
        v.x[k] = __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                             __byte_perm(b[2], b[3], 0x0040), 0x5410);
      }
    }
    return v;
  }
  // FRAMES: byte r of each of the lane's frames of the message
  __device__ __forceinline__ void scatter(int r, V v) const {
    int8_t* p = mesg + (long long)f * out_stride + r;
    const bool full = f + kPerWord * VW <= batch;
#pragma unroll
    for (int j = 0; j < kPerWord * VW; ++j)
      if (full || f + j < batch)
        p[(long long)j * out_stride] =
            A::byte(v.x[j / kPerWord], j % kPerWord);
  }
  // A's functions on each word of a lane's Vec
  static __device__ __forceinline__ V add(const V& a, const V& b) {
    V o;
#pragma unroll
    for (int k = 0; k < VW; ++k) o.x[k] = A::add(a.x[k], b.x[k]);
    return o;
  }
  static __device__ __forceinline__ V prod(const V& a, const V& b) {
    V o;
#pragma unroll
    for (int k = 0; k < VW; ++k) o.x[k] = A::prod(a.x[k], b.x[k]);
    return o;
  }
  static __device__ __forceinline__ V hmul(const V& a, const V& b) {
    V o;
#pragma unroll
    for (int k = 0; k < VW; ++k) o.x[k] = A::hmul(a.x[k], b.x[k]);
    return o;
  }
  static __device__ __forceinline__ V madd(const V& h, const V& a,
                                           const V& b) {
    V o;
#pragma unroll
    for (int k = 0; k < VW; ++k) o.x[k] = A::madd(h.x[k], a.x[k], b.x[k]);
    return o;
  }
  static __device__ __forceinline__ V signum(const V& a) {
    V o;
#pragma unroll
    for (int k = 0; k < VW; ++k) o.x[k] = A::signum(a.x[k]);
    return o;
  }
  static __device__ __forceinline__ V spc(const V& x, const V& weak,
                                          const V& odd) {
    V o;
#pragma unroll
    for (int k = 0; k < VW; ++k) o.x[k] = A::spc(x.x[k], weak.x[k], odd.x[k]);
    return o;
  }

  __device__ __forceinline__ V& at(uint32_t* a, int r) const {
    return *reinterpret_cast<V*>(a + r * WR + w);
  }
  // row r of the input of a node whose input starts at pyramid row `base`
  // (0: the root, on chip or in device memory)
  __device__ __forceinline__ V in(int base, int r) const {
    if constexpr (ROOT_SMEM)
      return base == 0 ? at(root, r) : at(soft, base + r);
    else if constexpr (INTERP)
      return base != 0 ? at(soft, base + r)
                       : root != nullptr ? at(root, r) : load(llr, r);
    else
      return base == 0 ? load(llr, r) : at(soft, base + r);
  }

  // FRAMES: rows r1 and r2 of that input, both rows' loads issued before
  // either is packed
  __device__ __forceinline__ void in2(int base, int r1, int r2, V& a,
                                      V& b) const {
    if (base == 0) {
      a = gather(r1);
      b = gather(r2);
    } else {
      a = at(soft, base + r1);
      b = at(soft, base + r2);
    }
  }

  // Passes of the register block a node (or fold) of len rows takes: 1
  // below a pass, len / kPass from it (at most kP where len <= kBlock)
  static __device__ __forceinline__ int passes(int len) {
    return len > kPass ? len / kPass : 1;
  }

  // The transform's stages on np passes of a register block, rows
  // [0, len) (np > 1: len = np kPass), low to high: stage s pairs row i
  // with i + 2^s, the lower row keeping the product; below kPass the
  // partner is the lane kLanesRow << s away (both lanes exchange), from
  // kPass up the lane's own pass p + 2^s / kPass.
  __device__ __forceinline__ void reg_transform(V (&x)[kP], int np,
                                                int len) const {
    const int lim = np > 1 ? kPass : len;
#pragma unroll
    for (int s = 0; (1 << s) < kPass; ++s) {
      if ((1 << s) >= lim) break;
      const bool lower = !(r0 & (1 << s));
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (p >= np) break;
        V o;
#pragma unroll
        for (int k = 0; k < VW; ++k)
          o.x[k] = __shfl_xor_sync(0xFFFFFFFFu, x[p].x[k], kLanesRow << s);
        const V m = hmul(x[p], o);
        if (lower) x[p] = m;
      }
    }
#pragma unroll
    for (int d = 1; d < kP; d <<= 1) {
      if (d >= np) break;
#pragma unroll
      for (int p = 0; p < kP; ++p)
        if (!(p & d) && p + d < kP && p + d < np) x[p] = hmul(x[p], x[p + d]);
    }
  }

  // REP's folds on np passes of a register block holding rows [0, h)
  // (np > 1: h = np kPass), in fastssc_decode's order: row i += row
  // i + h/2, then i + h/4, ..., the lane's own passes first, then by
  // __shfl_down_sync (kLanesRow << s lanes). Returns signum of row 0 on
  // every lane of its words.
  __device__ __forceinline__ V reg_fold(V (&x)[kP], int np, int h) const {
#pragma unroll
    for (int d = kP / 2; d >= 1; d >>= 1) {
      if (d >= np) continue;
#pragma unroll
      for (int p = 0; p < d; ++p) x[p] = add(x[p], x[p + d]);
    }
    const int lim = np > 1 ? kPass : h;
#pragma unroll
    for (int s = kPass / 2; s >= 1; s >>= 1) {
      if (s >= lim) continue;
      V o;
#pragma unroll
      for (int k = 0; k < VW; ++k)
        o.x[k] = __shfl_down_sync(0xFFFFFFFFu, x[0].x[k], s * kLanesRow);
      x[0] = add(x[0], o);
    }
    V bit = signum(x[0]);
    const int src = (threadIdx.x & 31) % kLanesRow;
#pragma unroll
    for (int k = 0; k < VW; ++k)
      bit.x[k] = __shfl_sync(0xFFFFFFFFu, bit.x[k], src);
    return bit;
  }

  // In-place polar transform of rows [0, len) of t, ending with
  // __syncwarp: the stages below kBlock in register chunks of kBlock rows
  // (the rows a lane loads are its own), those from kBlock up one pass of
  // the node's pairs spread over the lanes a stage.
  __device__ __forceinline__ void transform(uint32_t* t, int len) const {
    V x[kP];
    if (len <= kBlock) {
      const int np = passes(len);
#pragma unroll
      for (int p = 0; p < kP; ++p)
        if (p < np)
          x[p] = r0 + p * kPass < len ? at(t, r0 + p * kPass) : splat<VW>(0u);
      reg_transform(x, np, len);
#pragma unroll
      for (int p = 0; p < kP; ++p)
        if (p < np && r0 + p * kPass < len) at(t, r0 + p * kPass) = x[p];
      __syncwarp();
      return;
    }
    for (int c = 0; c < len; c += kBlock) {
#pragma unroll
      for (int p = 0; p < kP; ++p) x[p] = at(t, c + r0 + p * kPass);
      reg_transform(x, kP, kBlock);
#pragma unroll
      for (int p = 0; p < kP; ++p) at(t, c + r0 + p * kPass) = x[p];
    }
    __syncwarp();
    for (int s = __ffs(kBlock) - 1; (1 << s) < len; ++s) {
      const int h = 1 << s;
      for (int i = r0; i < len / 2; i += kPass) {
        const int j = ((i >> s) << (s + 1)) | (i & (h - 1));  // lower row
        at(t, j) = hmul(at(t, j), at(t, j + h));
      }
      __syncwarp();
    }
  }

  // Message row i of a node whose message starts at moff, its rows before
  // `from` frozen
  __device__ __forceinline__ void emit_row(int i, int from, int moff,
                                           const V& v) const {
    if constexpr (EMIT_U)
      if (i >= from) store(mesg, moff + i - from, v);
  }

  // A node's polar transform: row i of its rows [0, len) is get(i) (called
  // once for each of the lane's rows), row i of T goes to put(i, v); with
  // `twice`, row 0 of T made +1 where `one`, T again to put2(i, v). In the
  // register block up to kBlock rows (nothing in shared memory but what
  // get and the puts write), else through the soft rows [0, len).
  template <typename Get, typename Put, typename Put2>
  __device__ __forceinline__ void node_transform(int len, Get&& get,
                                                 Put&& put, bool twice,
                                                 bool one, Put2&& put2) {
    if (len <= kBlock) {
      const V ones = splat<VW>(A::kOne);
      const int np = passes(len);
      V x[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p)
        if (p < np) x[p] = r0 + p * kPass < len ? get(r0 + p * kPass) : ones;
      reg_transform(x, np, len);
#pragma unroll
      for (int p = 0; p < kP; ++p)
        if (p < np && r0 + p * kPass < len) put(r0 + p * kPass, x[p]);
      if (twice) {
        if (one && r0 == 0) x[0] = ones;
        reg_transform(x, np, len);
#pragma unroll
        for (int p = 0; p < kP; ++p)
          if (p < np && r0 + p * kPass < len) put2(r0 + p * kPass, x[p]);
      }
      return;
    }
    for (int i = r0; i < len; i += kPass) at(soft, i) = get(i);
    for (int round = 0;; ++round) {  // one transform's code for both
      __syncwarp();
      transform(soft, len);
      if (round == 1) {
        for (int i = r0; i < len; i += kPass) put2(i, at(soft, i));
        break;
      }
      for (int i = r0; i < len; i += kPass) put(i, at(soft, i));
      if (!twice) break;
      __syncwarp();
      if (one && r0 == 0) at(soft, 0) = splat<VW>(A::kOne);
    }
  }

  // Rows [o, o + len) of `a`, all `v`
  __device__ __forceinline__ void fill(uint32_t* a, int o, int len,
                                       V v) const {
    for (int i = r0; i < len; i += kPass) at(a, o + i) = v;
  }

  __device__ void decode(const uint8_t* __restrict__ prog, int n) {
    const V ones = splat<VW>(A::kOne);
    int lvl = __ldg(prog);
    int hoff = 0, moff = 0;
    for (int pc = 1;; ++pc) {
      const int op = __ldg(prog + pc);
      if (op == OP_END) break;
      const int len = 1 << lvl;
      const int xb = len == n ? 0 : len;   // this node's input
      switch (op) {
        case OP_LEFT: {
          const int half = len >> 1;
          for (int i = r0; i < half; i += kPass) {
            if constexpr (FRAMES && !INTERP) {
              V a, b;
              in2(xb, i, half + i, a, b);
              at(soft, half + i) = prod(a, b);
            } else {
              at(soft, half + i) = prod(in(xb, i), in(xb, half + i));
            }
          }
          --lvl;
          break;
        }
        case OP_RIGHT: {
          const int half = len;
          const int pb = 2 * half == n ? 0 : 2 * half;
          for (int i = r0; i < half; i += kPass) {
            if constexpr (FRAMES && !INTERP) {
              V a, b;
              in2(pb, i, half + i, a, b);
              at(soft, half + i) = madd(at(hard, hoff + i), a, b);
            } else {
              at(soft, half + i) =
                  madd(at(hard, hoff + i), in(pb, i), in(pb, half + i));
            }
          }
          hoff += half;
          break;
        }
        case OP_COMB: {
          const int half = len;
          hoff -= half;
          for (int i = r0; i < half; i += kPass) {
            at(hard, hoff + i) = hmul(at(hard, hoff + i),
                                      at(hard, hoff + half + i));
            if (CW)
              at(cw, hoff + i) = hmul(at(cw, hoff + i), at(cw, hoff + half + i));
          }
          ++lvl;
          break;
        }
        case OP_RATE0:
          fill(hard, hoff, len, ones);
          if (CW) fill(cw, hoff, len, ones);
          break;
        case OP_RATE1: {  // hard = signum(x), message = T(hard)
          node_transform(
              len,
              [&](int i) {
                const V h = signum(in(xb, i));
                at(hard, hoff + i) = h;
                return h;
              },
              [&](int i, const V& u) { emit_row(i, 0, moff, u); }, CW,
              false,  // cw = T(T(hard))
              [&](int i, const V& c) { at(cw, hoff + i) = c; });
          moff += len;
          break;
        }
        case OP_REP: {  // saturating fold in halves, in that order
          int h = len >> 1;
          V bit;
          if (kRegFolds && h <= kBlock) {
            const int np = passes(h);
            V x[kP];
#pragma unroll
            for (int p = 0; p < kP; ++p) {
              const int i = r0 + p * kPass;
              if (p < np && i < h) {
                if constexpr (FRAMES && !INTERP) {
                  V a, b;
                  in2(xb, i, h + i, a, b);
                  x[p] = add(a, b);
                } else {
                  x[p] = add(in(xb, i), in(xb, h + i));
                }
              }
            }
            bit = reg_fold(x, np, h);
          } else {
            for (int i = r0; i < h; i += kPass) {
              if constexpr (FRAMES && !INTERP) {
                V a, b;
                in2(xb, i, h + i, a, b);
                at(soft, i) = add(a, b);
              } else {
                at(soft, i) = add(in(xb, i), in(xb, h + i));
              }
            }
            __syncwarp();
            // to 2 kBlock rows for the register block (else to 1 row)
            while (h > (kRegFolds ? 2 * kBlock : 1)) {
              h >>= 1;
              for (int i = r0; i < h; i += kPass)
                at(soft, i) = add(at(soft, i), at(soft, h + i));
              __syncwarp();
            }
            if constexpr (kRegFolds) {
              h >>= 1;
              V x[kP];
#pragma unroll
              for (int p = 0; p < kP; ++p) {
                const int i = r0 + p * kPass;
                x[p] = add(at(soft, i), at(soft, h + i));
              }
              bit = reg_fold(x, kP, h);
            } else {
              bit = signum(at(soft, 0));
            }
          }
          fill(hard, hoff, len, bit);
          if (CW) fill(cw, hoff, len, bit);
          if (EMIT_U && r0 == 0) store(mesg, moff, bit);
          ++moff;
          break;
        }
        case OP_SPC: {  // Wagner: decide, parity, flip every weakest row
          V odd = splat<VW>(0u), weak = splat<VW>(A::kWeak), x0;
          for (int i = r0; i < len; i += kPass) {
            const V s = in(xb, i);
            if (i == r0) x0 = s;  // the lane's first row: read once
#pragma unroll
            for (int k = 0; k < VW; ++k) {
              odd.x[k] ^= A::sign(s.x[k]);
              weak.x[k] = A::least(weak.x[k], A::mag(s.x[k]));
            }
          }
          for (int o = kLanesRow; o < 32; o <<= 1) {  // across the rows' lanes
#pragma unroll
            for (int k = 0; k < VW; ++k) {
              odd.x[k] ^= __shfl_xor_sync(0xFFFFFFFFu, odd.x[k], o);
              weak.x[k] = A::least(
                  weak.x[k], __shfl_xor_sync(0xFFFFFFFFu, weak.x[k], o));
            }
          }
          node_transform(
              len,
              [&](int i) {
                const V h = spc(i == r0 ? x0 : in(xb, i), weak, odd);
                at(hard, hoff + i) = h;
                return h;
              },
              [&](int i, const V& u) { emit_row(i, 1, moff, u); }, CW,
              true,  // cw = T([+1, v_1..v_{len-1}])
              [&](int i, const V& c) { at(cw, hoff + i) = c; });
          moff += len - 1;
          break;
        }
        case OP_RATE0_RIGHT: {  // all-frozen left half: g is a plain sat add
          const int half = len >> 1;
          for (int i = r0; i < half; i += kPass) {
            if constexpr (FRAMES && !INTERP) {
              V a, b;
              in2(xb, i, half + i, a, b);
              at(soft, half + i) = add(a, b);
            } else {
              at(soft, half + i) = add(in(xb, i), in(xb, half + i));
            }
          }
          hoff += half;
          --lvl;
          break;
        }
        case OP_RATE0_COMB: {  // hard = [hard_r, hard_r], ascend
          const int half = len;
          hoff -= half;
          for (int i = r0; i < half; i += kPass) {
            at(hard, hoff + i) = at(hard, hoff + half + i);
            if (CW) at(cw, hoff + i) = at(cw, hoff + half + i);
          }
          ++lvl;
          break;
        }
        case OP_RATE1_COMB: {  // at the left child: g, sign, comb, T
          const int half = len;
          const int pb = 2 * half == n ? 0 : 2 * half;
          node_transform(
              half,
              [&](int i) {
                const V hl = at(hard, hoff + i);
                V hr;
                if constexpr (FRAMES && !INTERP) {
                  V a, b;
                  in2(pb, i, half + i, a, b);
                  hr = signum(madd(hl, a, b));
                } else {
                  hr = signum(madd(hl, in(pb, i), in(pb, half + i)));
                }
                at(hard, hoff + half + i) = hr;
                at(hard, hoff + i) = hmul(hl, hr);
                return hr;
              },
              [&](int i, const V& u) { emit_row(i, 0, moff, u); }, CW,
              false,  // cw_r = T(T(hr)), cw = [cw_l * cw_r, cw_r]
              [&](int i, const V& c) {
                at(cw, hoff + half + i) = c;
                at(cw, hoff + i) = hmul(at(cw, hoff + i), c);
              });
          moff += half;
          ++lvl;
          break;
        }
        default:
          break;
      }
      __syncwarp();
    }
  }
};

// Launches `kernel` over the tiles of `batch` frames on `stream`, `warps`
// tiles a block, each warp T::kRegions regions of n rows of T's words in
// dynamic shared memory; `args` go to the kernel as its parameters. Returns
// the CUDA error of the attribute call or of the launch.
template <typename T, typename... P, typename... A>
int launch_tiles(void (*kernel)(P...), int n, int batch, int warps,
                 cudaStream_t stream, A... args) {
  static_assert(sizeof...(P) == sizeof...(A), "one argument a parameter");
  const int bytes = warps * T::kRegions * n * T::kRowBytes;
  // above 48 KB a block's dynamic shared memory must be granted first
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)batch + T::kFrames - 1) / T::kFrames;
  const int blocks = (int)((tiles + warps - 1) / warps);
  kernel<<<blocks, 32 * warps, bytes, stream>>>((P)args...);
  return (int)cudaGetLastError();
}

}  // namespace simd
}  // namespace polar
