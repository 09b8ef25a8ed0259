// Interpreter Fast-SSC decoder: a step program over a table of branches,
// run by one tile kernel (interp_tile_kernel).
//
// Replaces polar_tpu/ops/pallas/interp_kernel.py: make_interp_decoder
// (:409, _interp_kernel_entry :521 -> _interp_core :530 -> _run_program
// :163), make_interp_decode_count (:569) and make_interp_subtree (:687,
// _interp_subtree_kernel :667). The TPU kernel keeps the program in SMEM and
// dispatches each step through a pl.when chain over the branch table.
//
// The program (ops/cuda/interp_kernel.py:build_program): int32 words
// (pos >> kl) << 16 | branch, and per branch an int32 descriptor row
// {kind, level, safe, need_hard, cw, u, program offset, mask offset}. Chain
// ops act on one level's rows: f, g and g0 read the static pyramid slot of
// their level and write their child's; comb, comb0 and grate1 read and write
// hard / cw / u at the step's position p. A body decodes a whole node (its
// byte program and mask lie in the flat table): its input is its pyramid
// slot and its scratch the rows below (free: the pyramid is
// level-positional), its hard block hard.rows(p). Its codeword block is the
// transform of its message segment in the u domain, frozen rows +1 (never
// its hard block, which differs where zero LLRs tie); grate1's codeword is
// T(T(hr)) for the same reason. `safe` only lets the TPU skip a no-op
// guard: qabs and madd guard every value. Every frame runs the same words.
//
// The tile kernel. The host cuts the program once (interp_kernel.py
// schedule) at a grid level G (INTERP_GRID_LEVEL, at least kl + 1) into
// entries run in order:
// - grid entries, the words at or above G: a chain op is one pass over its
//   rows x 16-frame chunks of the element-major (rows, B) arrays, spread
//   over the whole grid, one 16-byte access a row and array (a warp moves
//   512 contiguous bytes), the arithmetic the packed byte functions of
//   fastssc_simd.cuh on the item's four words; a grate1 or a leaf body
//   there (REP, SPC, rate-1 of 2^G rows and more) is a few such passes: its
//   transforms one butterfly stage a pass, REP's fold and SPC's parity and
//   least |x| by halving passes (SPC's result in the pyramid's extra row
//   N). A grid barrier (cooperative groups) follows each entry that the
//   next one depends on;
// - tile runs, each maximal run of words below G (one subtree, since the
//   walk is depth-first): a warp runs it on its tile of 8 frames on
//   fastssc_simd.cuh's Tile, the warps walking over the tiles, no barrier
//   inside. The run's soft pyramid below its root (level-positional, as the
//   device pyramid), its hard and cw rows lie in the warp's shared regions;
//   its root slot is read where it lies in device memory; a chain op is a
//   pass over rows spread across the lanes, a body Tile::decode of its byte
//   program on the same regions (the INTERP flag: a body's root input is
//   its slot on chip, or the run's root in device memory). At its end the
//   warp writes its hard and cw rows back. Message bits go to device memory
//   compacted: each body (grate1) starts at its row of the host's mrows (the
//   info rows before its position), so u needs no gather.
// A schedule of one tile run (the code or node below G: the whole program
// is one body or subtree) is a plain launch over the tiles; any other is a
// cudaLaunchCooperativeKernel whose grid the card holds at once (a refused
// launch returns its error to the wrapper, which raises). What bounds it:
// the grid entries' bytes (every row of the levels at or above G passes
// through device memory; utils/interp_probe.py counts the bytes) and
// one barrier each; the tile runs' op latency, one run after another: a
// warp walks its tile's byte programs op by op, each op a chain of
// dependent shared-memory accesses and emulated byte arithmetic (its
// transforms and REP folds in the register block, fastssc_simd.cuh). The
// tile runs are one warp a tile, one wave, so they take the same time at
// any batch up to the card's tiles: on an H100 at Polar(16384, 8192) the
// cw track's tile runs alone take 1.82 / 1.90 ms of its 2.22 / 2.73 ms at
// B = 2048 / 4096, its grid entries 0.49 / 0.95 ms; at Polar(131072,
// 65536), B = 4096, the two halves took about equal times
// (utils/interp_probe.py times each apart; PERF.md section 5). One thread
// a frame, every row in device memory, was 5-29x slower (PERF.md section
// 6, rows 13-15).
//
// The frame-major u track (FRAMES): the root LLRs are (batch, 2^level) and
// u (batch, K), as the decoder's callers hold them, so no transpose runs
// around the kernel; the pyramid and hard stay element-major. The host's
// u-only schedule (interp_kernel.schedule) reads the root only in the
// columns a and b of an entry and writes u only in d and e, and never
// reads u (grate1s and rate-1 leaves transform in the pyramid's free rows,
// the last stage into u). Such an entry is by_row: a warp takes 32
// consecutive rows of one 16-frame chunk, a lane one row. It reads the
// root (on 16 bytes, its grid entries at level 6 and up: the host's
// checks) as 16-byte row segments of 16 frames, turned into the lanes'
// rows through shared memory (root_load), and writes u a byte a frame
// (mesg_store), each byte store of the warp 32 contiguous bytes of one
// frame, one sector; every other access is the element-major item's. A
// tile run takes the message frame-major (Tile's FRAMES scatter), and its
// root frame-major where that is the code's root (a lone run).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fastssc_simd.cuh"

namespace {

namespace cg = cooperative_groups;

enum : int { kBody = 0, kF, kG, kG0, kComb, kComb0, kGrate1 };
constexpr int kDescCols = 8;

// Schedule entry kinds (ops/cuda/interp_kernel.py: schedule), column 0;
// kChain: the next entry follows without a grid barrier.
enum : int {
  kRun = 0, kSF, kSG, kSAdd, kSHmul, kSCopy, kSGrate1, kSStage, kSRate1,
  kSKey, kSKeyRed, kSFlip, kSRepBc, kSFill
};
constexpr int kChain = 0x100;
constexpr int kSchedCols = 8;
constexpr int kRowBits = 20;     // a schedule row: array << 20 | row
constexpr int kArrays = 5;       // in, pyr, hard, cw, u
constexpr int kMaxWarps = 4;     // warps (tiles) a block
// blocks an SM holds at the tile runs' shared memory (2^10 rows a region);
// declared, so that the compiler may give the register block the registers
// of two blocks an SM rather than spill
constexpr int kMinBlocks = 2;

struct TileArgs {
  const int* words;
  const int* desc;
  const uint8_t* table;
  const int* mrows;              // a body's first compacted message row
  const int* sched;
  int n_sched;
  int level, kl, batch, prefill, aligned;
  int region;                    // log2 of a warp's region rows
  int8_t* arr[kArrays];          // in (read only), pyr, hard, cw, u
  int k;                         // FRAMES: bytes a frame of u
};

using polar::simd::Vec;
using V4 = Vec<4>;               // a grid item: 16 frames of one row

// A schedule row's pointer. The array is picked by comparisons, not by an
// index into the parameter's array, which would put the array in local
// memory.
__device__ __forceinline__ int8_t* row_ptr(const TileArgs& a, int v) {
  const int k = v >> kRowBits;
  int8_t* base = k == 0   ? a.arr[0]
                 : k == 1 ? a.arr[1]
                 : k == 2 ? a.arr[2]
                 : k == 3 ? a.arr[3]
                          : a.arr[4];
  return base + (long long)(v & ((1 << kRowBits) - 1)) * a.batch;
}

// FRAMES: root_load gives 16 frames from frame f of root row `row` of
// (batch, 2^level), packed as an element-major item; frames past the batch
// read as 0. A by_row warp's lanes hold 32 consecutive rows of one chunk,
// each half-warp's 16 rows starting on 16 bytes: lane l of a half-warp
// fetches the half's 16 bytes of frame f + l (root_fetch), then writes
// them as column l of a 16 x 16 block in the warp's 512 bytes of shared
// memory (free in a grid entry) and reads back row l (root_stage). (In the
// A/B on an H100, PERF.md section 6, the stage equalled a transpose by
// __shfl_xor_sync and beat a byte a frame.)
__device__ __forceinline__ V4 root_fetch(const TileArgs& a, int row, int f) {
  const unsigned l = threadIdx.x & 15;
  const int fr = f + (int)l;
  return fr < a.batch ? *reinterpret_cast<const V4*>(
                            a.arr[0] + ((long long)fr << a.level) + row - l)
                      : polar::simd::splat<4>(0u);
}
__device__ __forceinline__ V4 root_stage(const V4& w) {
  extern __shared__ uint32_t smem[];
  const unsigned lane = threadIdx.x & 31, l = lane & 15;
  uint8_t* s = reinterpret_cast<uint8_t*>(smem + (threadIdx.x >> 5) * 128) +
               (lane & 16) * 16;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 16; ++j)
    s[j * 16 + l] = (uint8_t)(w.x[j >> 2] >> (8 * (j & 3)));
  __syncwarp();
  return *reinterpret_cast<const V4*>(s + l * 16);
}
__device__ __forceinline__ V4 root_load(const TileArgs& a, int row, int f) {
  return root_stage(root_fetch(a, row, f));
}
// FRAMES: an item to column `row` of u (batch, k), byte j to frame f + j
__device__ __forceinline__ void mesg_store(const TileArgs& a, int row, int f,
                                           const V4& x) {
  int8_t* p = a.arr[4] + (long long)f * a.k + row;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (f + j < a.batch)
      p[(long long)j * a.k] = (int8_t)(x.x[j >> 2] >> (8 * (j & 3)));
}

// 16 frames from frame f of a row: one 16-byte access on the fast path,
// else a byte at a time, the frames past the batch read as 0 and never
// stored; FRAMES: the root's and u's rows are frame-major (RAW: a root
// row's fetch alone)
template <bool FRAMES, bool RAW = false>
__device__ __forceinline__ V4 gload(const TileArgs& a, int v, int f) {
  if constexpr (FRAMES)
    if ((v >> kRowBits) == 0)
      return RAW ? root_fetch(a, v, f) : root_load(a, v, f);
  const int8_t* p = row_ptr(a, v) + f;
  if (a.aligned) return *reinterpret_cast<const V4*>(p);
  V4 x = polar::simd::splat<4>(0u);
  for (int j = 0; j < 16; ++j)
    if (f + j < a.batch) x.x[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
  return x;
}
template <bool FRAMES>
__device__ __forceinline__ void gstore(const TileArgs& a, int v, int f,
                                       const V4& x) {
  if constexpr (FRAMES)
    if ((v >> kRowBits) == 4)
      return mesg_store(a, v & ((1 << kRowBits) - 1), f, x);
  int8_t* p = row_ptr(a, v) + f;
  if (a.aligned) {
    *reinterpret_cast<V4*>(p) = x;
    return;
  }
  for (int j = 0; j < 16; ++j)
    if (f + j < a.batch) p[j] = (int8_t)(x.x[j >> 2] >> (8 * (j & 3)));
}

// SPC's reduction on bytes: bits 0-6 the least |x| (qabs), bit 7 the
// parity of the negatives
__device__ __forceinline__ V4 spc_key(const V4& x) {
  V4 o;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o.x[k] = polar::simd::qabs(x.x[k]) | (x.x[k] & 0x80808080u);
  return o;
}
__device__ __forceinline__ V4 key_comb(const V4& a, const V4& b) {
  V4 o;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o.x[k] = __vminu4(a.x[k] & 0x7F7F7F7Fu, b.x[k] & 0x7F7F7F7Fu) |
             ((a.x[k] ^ b.x[k]) & 0x80808080u);
  return o;
}

// Item i's row r and first frame f. Element-major, a warp's threads take
// consecutive 16-frame chunks of a row (512 contiguous bytes); by_row
// (FRAMES: an entry that reads the root or writes u) a warp takes one
// chunk of 32 consecutive rows, the next warp the next chunk of them, r
// past the entry's rows being no item.
template <bool FRAMES>
__device__ __forceinline__ void item(unsigned i, unsigned chunks, bool by_row,
                                     int& r, int& f) {
  if constexpr (FRAMES)
    if (by_row) {
      const unsigned w = i >> 5;
      r = (int)((w / chunks) << 5 | (i & 31));
      f = (int)(w % chunks) << 4;
      return;
    }
  r = (int)(i / chunks);
  f = (int)(i - (unsigned)r * chunks) << 4;
}

// A chain op's pass (f, g, add, hmul, copy: d = op(a, b[, c]) row by
// row), kUnroll items a thread at a time, every load before any store: a
// pass is latency-bound at the few threads the tile runs' shared memory
// leaves an SM, so each thread keeps kUnroll items' loads in flight. A
// frame-major root is fetched for all of them before any is staged: a
// stage's __syncwarp kept the next fetch from starting (2-4 % of a batch
// at Polar(16384, 8192) on an H100, PERF.md section 6).
constexpr int kUnroll = 4;

template <bool FRAMES>
__device__ __forceinline__ void chain_pass(const TileArgs& A, int op, int ra,
                                           int rb, int rc,
                           int rd, unsigned items, unsigned chunks,
                           bool by_row, int rows) {
  using namespace polar::simd;
  const unsigned stride = gridDim.x * blockDim.x;
  const bool hoist = FRAMES && by_row;
  for (unsigned i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < items;
       i0 += kUnroll * stride) {
    V4 a[kUnroll], b[kUnroll], c[kUnroll];
    int r[kUnroll], f[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned i = i0 + k * stride;
      r[k] = -1;
      if (i >= items) continue;
      item<FRAMES>(i, chunks, by_row, r[k], f[k]);
      if (FRAMES && r[k] >= rows) {
        r[k] = -1;
        continue;
      }
      if (hoist) {
        a[k] = gload<FRAMES, true>(A, ra + r[k], f[k]);
        if (op != kSCopy) b[k] = gload<FRAMES, true>(A, rb + r[k], f[k]);
      } else {
        a[k] = gload<FRAMES>(A, ra + r[k], f[k]);
        if (op != kSCopy) b[k] = gload<FRAMES>(A, rb + r[k], f[k]);
      }
      if (op == kSG) c[k] = gload<FRAMES>(A, rc + r[k], f[k]);
    }
    if constexpr (FRAMES) {
      if (hoist) {
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (r[k] < 0) continue;
          if ((ra >> kRowBits) == 0) a[k] = root_stage(a[k]);
          if (op != kSCopy && (rb >> kRowBits) == 0) b[k] = root_stage(b[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (r[k] < 0) continue;
      V4 o;
      switch (op) {
        case kSF: o = prod(a[k], b[k]); break;
        case kSG: o = madd(c[k], a[k], b[k]); break;
        case kSAdd: o = sat_add(a[k], b[k]); break;
        case kSHmul: o = hmul(a[k], b[k]); break;
        default: o = a[k]; break;  // kSCopy
      }
      gstore<FRAMES>(A, rd + r[k], f[k], o);
    }
  }
}

// One grid entry: its rows x 16-frame chunks spread over the whole grid.
template <bool FRAMES>
__device__ __forceinline__ void grid_pass(const TileArgs& A, const int* e) {
  using namespace polar::simd;
  const int op = __ldg(e) & 0xFF, rows = __ldg(e + 1);
  const int ra = __ldg(e + 2), rb = __ldg(e + 3), rc = __ldg(e + 4),
            rd = __ldg(e + 5), re = __ldg(e + 6), x = __ldg(e + 7);
  const unsigned chunks = (unsigned)(A.batch + 15) >> 4;
  const bool by_row =
      FRAMES && ((ra >= 0 && (ra >> kRowBits) == 0) ||
                 (rb >= 0 && (rb >> kRowBits) == 0) ||
                 (rd >> kRowBits) == 4 || (re >> kRowBits) == 4);
  const unsigned items = by_row ? ((unsigned)(rows + 31) >> 5) * 32 * chunks
                                : (unsigned)rows * chunks;
  if (op >= kSF && op <= kSCopy) {
    chain_pass<FRAMES>(A, op, ra, rb, rc, rd, items, chunks, by_row, rows);
    return;
  }
  const V4 ones = splat<4>(kOnes);
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    int r, f;
    item<FRAMES>(i, chunks, by_row, r, f);
    if (FRAMES && r >= rows) continue;
    switch (op) {
      case kSGrate1: {  // g, sign, combine: hr to the message (or cw) rows
        const V4 hl = gload<FRAMES>(A, rc + r, f);
        const V4 hr = signum(madd(hl, gload<FRAMES>(A, ra + r, f),
                                  gload<FRAMES>(A, rb + r, f)));
        if (re >= 0) {
          gstore<FRAMES>(A, rc + r, f, hmul(hl, hr));
          gstore<FRAMES>(A, re + r, f, hr);
        }
        gstore<FRAMES>(A, rd + r, f, hr);
        break;
      }
      case kSStage: {  // butterfly stage x on pair r, from ra into rd
        const int hs = 1 << x;
        const int j = ((r >> x) << (x + 1)) | (r & (hs - 1));
        const V4 hi = gload<FRAMES>(A, ra + j + hs, f);
        gstore<FRAMES>(A, rd + j, f, hmul(gload<FRAMES>(A, ra + j, f), hi));
        if (rd != ra) gstore<FRAMES>(A, rd + j + hs, f, hi);
        break;
      }
      case kSRate1: {
        const V4 h = signum(gload<FRAMES>(A, ra + r, f));
        if (rc >= 0) gstore<FRAMES>(A, rc + r, f, h);
        gstore<FRAMES>(A, rd + r, f, h);
        break;
      }
      case kSKey:
        gstore<FRAMES>(A, rd + r, f,
                       key_comb(spc_key(gload<FRAMES>(A, ra + r, f)),
                                spc_key(gload<FRAMES>(A, rb + r, f))));
        break;
      case kSKeyRed:
        gstore<FRAMES>(A, rd + r, f,
                       key_comb(gload<FRAMES>(A, ra + r, f),
                                gload<FRAMES>(A, rb + r, f)));
        break;
      case kSFlip: {  // Wagner's flip by the frame's key in row rb
        const V4 k = gload<FRAMES>(A, rb, f),
                 s = gload<FRAMES>(A, ra + r, f);
        V4 h;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          h.x[q] = spc_flip(s.x[q], k.x[q] & 0x7F7F7F7Fu,
                            __vcmpne4(k.x[q] & 0x80808080u, 0u));
        if (rc >= 0) gstore<FRAMES>(A, rc + r, f, h);
        gstore<FRAMES>(A, rd + r, f, h);
        break;
      }
      case kSRepBc: {  // the bit of the fold in row rb, on every row
        const V4 bit = signum(gload<FRAMES>(A, rb, f));
        if (rc >= 0) gstore<FRAMES>(A, rc + r, f, bit);
        if (rd >= 0) gstore<FRAMES>(A, rd + r, f, bit);
        if (re >= 0 && r == 0) gstore<FRAMES>(A, re, f, bit);
        break;
      }
      case kSFill:
        gstore<FRAMES>(A, rd + r, f, ones);
        break;
      default:
        break;
    }
  }
}

template <bool CW, bool U, bool FRAMES>
using InterpTile = polar::simd::Tile<polar::simd::kTileWR,
                                     polar::simd::kTileVW, CW,
                                     /*ROOT_SMEM=*/false, U, /*INTERP=*/true,
                                     FRAMES>;

// One tile run on one tile: words [ws, we) of the subtree rooted at level R,
// position P. The soft pyramid below R (level-positional, rows [2^l,
// 2^(l+1)) the input of level l), and hard and cw rows [P, P + 2^R) lie in
// the warp's regions; the root slot is read where it lies; the message
// goes to device memory, compacted, at each body's row of mrows (FRAMES:
// its column). Inlined, as every device function of the kernel: the Tile's
// members then stay in registers, not in a stack frame each access reads.
template <bool CW, bool U, bool FRAMES>
__device__ __forceinline__ void run_on_tile(const TileArgs& A,
                                            InterpTile<CW, U, FRAMES>& t,
                                            int ws, int we, int R, int P) {
  using namespace polar::simd;
  using T = InterpTile<CW, U, FRAMES>;
  using V = typename T::V;
  uint32_t* const soft = t.soft;
  uint32_t* const hb = t.hard;
  uint32_t* const cb = t.cw;
  const V init = splat<kTileVW>(A.prefill ? kOnes : 0u);
  t.fill(hb, 0, 1 << R, init);
  if (CW) t.fill(cb, 0, 1 << R, init);
  __syncwarp();
  for (int i = ws; i < we; ++i) {
    const int w = __ldg(A.words + i);
    const int q = ((w >> 16) << A.kl) - P;
    const int* d = A.desc + (w & 0xFFFF) * kDescCols;
    const int kind = __ldg(d), lv = __ldg(d + 1);
    const bool need_hard = __ldg(d + 3), do_cw = CW && __ldg(d + 4);
    if (U && (kind == kBody || kind == kGrate1)) {
      if constexpr (FRAMES)
        t.mesg = A.arr[4] + __ldg(A.mrows + i);
      else
        t.mesg = A.arr[4] + (long long)__ldg(A.mrows + i) * A.batch;
    }
    if (kind == kBody) {  // the tile core on the body's rows
      const int n = 1 << lv;
      t.root = lv == R ? nullptr : soft + n * kTileWR;
      t.hard = hb + q * kTileWR;
      if (CW) t.cw = cb + q * kTileWR;
      t.decode(A.table + __ldg(d + 6), n);  // ends with __syncwarp
      t.root = nullptr;
      t.hard = hb;
      t.cw = cb;
      continue;
    }
    const int h = 1 << (lv - 1);
    const bool dev = lv == R;   // the run's root slot, in device memory
    const int sb = 1 << lv;
    auto slot = [&](int r) -> V {
      return dev ? t.load(t.llr, r) : t.at(soft, sb + r);
    };
    switch (kind) {
      case kF:
        for (int r = t.r0; r < h; r += T::kPass)
          t.at(soft, h + r) = prod(slot(r), slot(h + r));
        break;
      case kG:
        for (int r = t.r0; r < h; r += T::kPass)
          t.at(soft, h + r) = madd(t.at(hb, q + r), slot(r), slot(h + r));
        break;
      case kG0:
        for (int r = t.r0; r < h; r += T::kPass)
          t.at(soft, h + r) = sat_add(slot(r), slot(h + r));
        break;
      case kComb:
        for (int r = t.r0; r < h; r += T::kPass) {
          if (need_hard)
            t.at(hb, q + r) = hmul(t.at(hb, q + r), t.at(hb, q + h + r));
          if (do_cw)
            t.at(cb, q + r) = hmul(t.at(cb, q + r), t.at(cb, q + h + r));
        }
        break;
      case kComb0:
        for (int r = t.r0; r < h; r += T::kPass) {
          if (need_hard) t.at(hb, q + r) = t.at(hb, q + h + r);
          if (do_cw) t.at(cb, q + r) = t.at(cb, q + h + r);
        }
        break;
      case kGrate1:  // u = T(hr) in the register block (or soft rows
                     // [0, h), free: below the slot)
        t.node_transform(
            h,
            [&](int r) {
              const V hl = t.at(hb, q + r);
              const V hr = signum(madd(hl, slot(r), slot(h + r)));
              if (need_hard) {
                t.at(hb, q + r) = hmul(hl, hr);
                t.at(hb, q + h + r) = hr;
              }
              return hr;
            },
            [&](int r, const V& u) { t.emit_row(r, 0, 0, u); }, do_cw,
            false,  // cw_r = T(T(hr)), cw = [cw_l * cw_r, cw_r]
            [&](int r, const V& c) {
              t.at(cb, q + h + r) = c;
              t.at(cb, q + r) = hmul(t.at(cb, q + r), c);
            });
        break;
      default:
        break;
    }
    __syncwarp();
  }
  int8_t* hard = A.arr[2];
  int8_t* cw = A.arr[3];
  for (int r = t.r0; r < (1 << R); r += T::kPass) {
    if (hard != nullptr) t.put(hard + (long long)P * A.batch, r, t.at(hb, r));
    if (CW && cw != nullptr)
      t.put(cw + (long long)P * A.batch, r, t.at(cb, r));
  }
  __syncwarp();
}

// A run entry: the warps of the grid walk over the tiles of the batch.
template <bool CW, bool U, bool FRAMES>
__device__ __forceinline__ void tile_runs(const TileArgs& A, const int* e,
                                          uint32_t* smem) {
  using T = InterpTile<CW, U, FRAMES>;
  const int ws = __ldg(e + 2), we = __ldg(e + 3), R = __ldg(e + 4),
            P = __ldg(e + 5);
  const int nreg = 1 << A.region;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  uint32_t* base =
      smem + (size_t)warp * T::kRegions * nreg * polar::simd::kTileWR;
  const int8_t* root = R == A.level
                           ? A.arr[0]
                           : A.arr[1] + ((long long)1 << R) * A.batch;
  const long long tiles = ((long long)A.batch + T::kFrames - 1) / T::kFrames;
  for (long long tile = (long long)blockIdx.x * warps + warp; tile < tiles;
       tile += (long long)gridDim.x * warps) {
    T t;
    t.place(base, nreg, tile, root, A.arr[4], A.batch, A.aligned, A.k);
    if constexpr (FRAMES) {  // the root is frame-major where it is the code's
      t.in_stride = 1 << A.level;
      t.root_f = R == A.level ? A.arr[0] + (long long)t.f * t.in_stride
                              : nullptr;
    }
    run_on_tile<CW, U, FRAMES>(A, t, ws, we, R, P);
  }
}

// The schedule in order, a grid barrier after every entry that is not
// chained to the next. A schedule of one tile run has no barrier and
// launches as a plain grid; any other is launched cooperatively.
template <bool CW, bool U, bool FRAMES>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
    interp_tile_kernel(TileArgs A) {
  extern __shared__ uint32_t smem[];
  for (int k = 0; k < A.n_sched; ++k) {
    const int* e = A.sched + k * kSchedCols;
    const int op = __ldg(e);
    if ((op & 0xFF) == kRun)
      tile_runs<CW, U, FRAMES>(A, e, smem);
    else
      grid_pass<FRAMES>(A, e);
    if (!(op & kChain) && k + 1 < A.n_sched) cg::this_grid().sync();
  }
}

int region_bytes(int cw, int region, int warps) {
  return warps * (2 + cw) * (1 << region) * polar::simd::kTileWR * 4;
}
// A block's dynamic shared memory: the warps' regions, and with FRAMES at
// least 512 bytes a warp for root_load's stage
template <bool CW, bool FRAMES>
int launch_bytes(int region, int warps) {
  const int bytes = region_bytes(CW, region, warps);
  return FRAMES && bytes < 512 * warps ? 512 * warps : bytes;
}

template <bool CW, bool U, bool FRAMES>
int tile_occupancy(int region, int warps, int* per_sm) {
  const int bytes = launch_bytes<CW, FRAMES>(region, warps);
  cudaError_t err = cudaFuncSetAttribute(
      interp_tile_kernel<CW, U, FRAMES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, interp_tile_kernel<CW, U, FRAMES>, 32 * warps, bytes);
}

template <bool CW, bool U, bool FRAMES>
int launch_tile(TileArgs a, int blocks, int warps, int coop,
                cudaStream_t stream) {
  const int bytes = launch_bytes<CW, FRAMES>(a.region, warps);
  // above 48 KB a block's dynamic shared memory must be granted first
  cudaError_t err = cudaFuncSetAttribute(
      interp_tile_kernel<CW, U, FRAMES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  if (coop) {  // refused (cudaErrorCooperativeLaunchTooLarge) if the grid
               // is not resident at once: the error goes to the caller
    void* args[] = {&a};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)interp_tile_kernel<CW, U, FRAMES>, dim3(blocks),
        dim3(32 * warps), args, (size_t)bytes, stream);
  }
  interp_tile_kernel<CW, U, FRAMES><<<blocks, 32 * warps, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

TileArgs tile_args(const void* words, const void* desc, const void* table,
                   const void* mrows, const void* sched, int n_sched,
                   int level, int kl, int batch, int prefill, int aligned,
                   int region, const void* llr, void* pyr, void* hard,
                   void* cw, void* u, int k) {
  TileArgs a;
  a.words = (const int*)words;
  a.desc = (const int*)desc;
  a.table = (const uint8_t*)table;
  a.mrows = (const int*)mrows;
  a.sched = (const int*)sched;
  a.n_sched = n_sched;
  a.level = level;
  a.kl = kl;
  a.batch = batch;
  a.prefill = prefill;
  a.aligned = aligned;
  a.region = region;
  a.arr[0] = (int8_t*)llr;
  a.arr[1] = (int8_t*)pyr;
  a.arr[2] = (int8_t*)hard;
  a.arr[3] = (int8_t*)cw;
  a.arr[4] = (int8_t*)u;
  a.k = k;
  return a;
}

}  // namespace

// The tile kernel on `stream`: the program's words, desc
// (branches x 8), table (uint8) and mrows (a word's first compacted message
// row) with the schedule `sched` (n_sched x 8 int32); llr (2^level, batch)
// in; pyr (2^level + 1, batch) scratch (null without grid entries); hard
// (2^level, batch) scratch or out (null: not kept), cw (2^level, batch) out
// when cw_track, u (K, batch) out, compacted, when u_track; all int8
// element-major; frames != 0 (the u track alone): llr (batch, 2^level) on
// 16 bytes and u (batch, k) frame-major, grid entries from level 6 (the
// host checks both). region: log2 of the
// rows of a warp's shared regions; aligned != 0: batch % 16 == 0 and every
// element-major array on 16 bytes; `blocks` of
// `warps` (1..4) tiles; coop != 0: a cooperative launch (every entry but a
// lone tile run needs one). Returns the CUDA error of the attribute call or
// the launch (cudaErrorCooperativeLaunchTooLarge where the card cannot hold
// the grid at once), or cudaErrorInvalidValue for a track pair (and
// layout) not built.
extern "C" int polar_interp_tile(const void* words, const void* desc,
                                 const void* table, const void* mrows,
                                 const void* sched, int n_sched, int level,
                                 int kl, int batch, int prefill, int aligned,
                                 int region, const void* llr, void* pyr,
                                 void* hard, void* cw, void* u, int cw_track,
                                 int u_track, int frames, int k, int blocks,
                                 int warps, int coop, void* stream) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const TileArgs a = tile_args(words, desc, table, mrows, sched, n_sched,
                               level, kl, batch, prefill, aligned, region,
                               llr, pyr, hard, cw, u, k);
  const cudaStream_t st = (cudaStream_t)stream;
  if (frames)
    return cw_track || !u_track
               ? (int)cudaErrorInvalidValue
               : launch_tile<false, true, true>(a, blocks, warps, coop, st);
  if (cw_track && u_track)
    return launch_tile<true, true, false>(a, blocks, warps, coop, st);
  if (cw_track)
    return launch_tile<true, false, false>(a, blocks, warps, coop, st);
  if (u_track)
    return launch_tile<false, true, false>(a, blocks, warps, coop, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of `warps` warps of the tile kernel (tracks and layout as
// polar_interp_tile, shared regions of 2^region rows) that one SM holds at
// once, into *per_sm. Returns the CUDA error of the attribute or occupancy
// call.
extern "C" int polar_interp_tile_occupancy(int cw_track, int u_track,
                                           int frames, int region, int warps,
                                           int* per_sm) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  if (frames)
    return cw_track || !u_track
               ? (int)cudaErrorInvalidValue
               : tile_occupancy<false, true, true>(region, warps, per_sm);
  if (cw_track && u_track)
    return tile_occupancy<true, true, false>(region, warps, per_sm);
  if (cw_track)
    return tile_occupancy<true, false, false>(region, warps, per_sm);
  if (u_track)
    return tile_occupancy<false, true, false>(region, warps, per_sm);
  return (int)cudaErrorInvalidValue;
}
