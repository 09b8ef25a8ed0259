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
// one barrier each; the tile runs' op latency (as the tile decoders'), one
// run after another. On an H100 at that code and B = 4096 the two halves
// take about equal times (utils/interp_probe.py times each apart). One
// thread a frame, every row in device memory, was 5-29x slower (PERF.md
// section 6, rows 13-15).

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

// 16 frames from frame f of a row: one 16-byte access on the fast path,
// else a byte at a time, the frames past the batch read as 0 and never
// stored
__device__ __forceinline__ V4 gload(const TileArgs& a, int v, int f) {
  const int8_t* p = row_ptr(a, v) + f;
  if (a.aligned) return *reinterpret_cast<const V4*>(p);
  V4 x = polar::simd::splat<4>(0u);
  for (int j = 0; j < 16; ++j)
    if (f + j < a.batch) x.x[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
  return x;
}
__device__ __forceinline__ void gstore(const TileArgs& a, int v, int f,
                                       const V4& x) {
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

// A chain op's pass (f, g, add, hmul, copy: d = op(a, b[, c]) row by
// row), kUnroll items a thread at a time, every load before any store: a
// pass is latency-bound at the few threads the tile runs' shared memory
// leaves an SM, so each thread keeps kUnroll items' loads in flight.
constexpr int kUnroll = 4;

__device__ __forceinline__ void chain_pass(const TileArgs& A, int op, int ra,
                                           int rb, int rc,
                           int rd, unsigned items, unsigned chunks) {
  using namespace polar::simd;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < items;
       i0 += kUnroll * stride) {
    V4 a[kUnroll], b[kUnroll], c[kUnroll];
    int r[kUnroll], f[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned i = i0 + k * stride;
      r[k] = -1;
      if (i >= items) continue;
      r[k] = (int)(i / chunks);
      f[k] = (int)(i - (unsigned)r[k] * chunks) << 4;
      a[k] = gload(A, ra + r[k], f[k]);
      if (op != kSCopy) b[k] = gload(A, rb + r[k], f[k]);
      if (op == kSG) c[k] = gload(A, rc + r[k], f[k]);
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
      gstore(A, rd + r[k], f[k], o);
    }
  }
}

// One grid entry: its rows x 16-frame chunks spread over the whole grid.
__device__ __forceinline__ void grid_pass(const TileArgs& A, const int* e) {
  using namespace polar::simd;
  const int op = __ldg(e) & 0xFF, rows = __ldg(e + 1);
  const int ra = __ldg(e + 2), rb = __ldg(e + 3), rc = __ldg(e + 4),
            rd = __ldg(e + 5), re = __ldg(e + 6), x = __ldg(e + 7);
  const unsigned chunks = (unsigned)(A.batch + 15) >> 4;
  const unsigned items = (unsigned)rows * chunks;
  if (op >= kSF && op <= kSCopy) {
    chain_pass(A, op, ra, rb, rc, rd, items, chunks);
    return;
  }
  const V4 ones = splat<4>(kOnes);
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    const int r = (int)(i / chunks);
    const int f = (int)(i - (unsigned)r * chunks) << 4;
    switch (op) {
      case kSGrate1: {  // g, sign, combine: hr to the message (or cw) rows
        const V4 hl = gload(A, rc + r, f);
        const V4 hr =
            signum(madd(hl, gload(A, ra + r, f), gload(A, rb + r, f)));
        if (re >= 0) {
          gstore(A, rc + r, f, hmul(hl, hr));
          gstore(A, re + r, f, hr);
        }
        gstore(A, rd + r, f, hr);
        break;
      }
      case kSStage: {  // butterfly stage x on pair r, from ra into rd
        const int hs = 1 << x;
        const int j = ((r >> x) << (x + 1)) | (r & (hs - 1));
        const V4 hi = gload(A, ra + j + hs, f);
        gstore(A, rd + j, f, hmul(gload(A, ra + j, f), hi));
        if (rd != ra) gstore(A, rd + j + hs, f, hi);
        break;
      }
      case kSRate1: {
        const V4 h = signum(gload(A, ra + r, f));
        if (rc >= 0) gstore(A, rc + r, f, h);
        gstore(A, rd + r, f, h);
        break;
      }
      case kSKey:
        gstore(A, rd + r, f,
               key_comb(spc_key(gload(A, ra + r, f)),
                        spc_key(gload(A, rb + r, f))));
        break;
      case kSKeyRed:
        gstore(A, rd + r, f,
               key_comb(gload(A, ra + r, f), gload(A, rb + r, f)));
        break;
      case kSFlip: {  // Wagner's flip by the frame's key in row rb
        const V4 k = gload(A, rb, f), s = gload(A, ra + r, f);
        V4 h;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          h.x[q] = spc_flip(s.x[q], k.x[q] & 0x7F7F7F7Fu,
                            __vcmpne4(k.x[q] & 0x80808080u, 0u));
        if (rc >= 0) gstore(A, rc + r, f, h);
        gstore(A, rd + r, f, h);
        break;
      }
      case kSRepBc: {  // the bit of the fold in row rb, on every row
        const V4 bit = signum(gload(A, rb, f));
        if (rc >= 0) gstore(A, rc + r, f, bit);
        if (rd >= 0) gstore(A, rd + r, f, bit);
        if (re >= 0 && r == 0) gstore(A, re, f, bit);
        break;
      }
      case kSFill:
        gstore(A, rd + r, f, ones);
        break;
      default:
        break;
    }
  }
}

template <bool CW, bool U>
using InterpTile = polar::simd::Tile<polar::simd::kTileWR,
                                     polar::simd::kTileVW, CW,
                                     /*ROOT_SMEM=*/false, U, /*INTERP=*/true>;

// One tile run on one tile: words [ws, we) of the subtree rooted at level R,
// position P. The soft pyramid below R (level-positional, rows [2^l,
// 2^(l+1)) the input of level l), and hard and cw rows [P, P + 2^R) lie in
// the warp's regions; the root slot is read where it lies; the message
// goes to device memory, compacted, at each body's row of mrows.
// Inlined, as every device function of the kernel: the Tile's members then
// stay in registers, not in a stack frame each access reads.
template <bool CW, bool U>
__device__ __forceinline__ void run_on_tile(const TileArgs& A,
                                            InterpTile<CW, U>& t, int ws,
                            int we, int R, int P) {
  using namespace polar::simd;
  using T = InterpTile<CW, U>;
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
    if (U && (kind == kBody || kind == kGrate1))
      t.mesg = A.arr[4] + (long long)__ldg(A.mrows + i) * A.batch;
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
      case kGrate1: {  // hr in soft rows [0, h) (free: below the slot)
        for (int r = t.r0; r < h; r += T::kPass) {
          const V hl = t.at(hb, q + r);
          const V hr = signum(madd(hl, slot(r), slot(h + r)));
          if (need_hard) {
            t.at(hb, q + r) = hmul(hl, hr);
            t.at(hb, q + h + r) = hr;
          }
          t.at(soft, r) = hr;
        }
        __syncwarp();
        t.transform(soft, h);  // u = T(hr)
        t.emit(soft, 0, h, 0);
        if (do_cw) {  // cw_r = T(T(hr)), cw = [cw_l * cw_r, cw_r]
          __syncwarp();
          t.transform(soft, h);
          for (int r = t.r0; r < h; r += T::kPass) {
            const V c = t.at(soft, r);
            t.at(cb, q + h + r) = c;
            t.at(cb, q + r) = hmul(t.at(cb, q + r), c);
          }
        }
        break;
      }
      default:
        break;
    }
    __syncwarp();
  }
  int8_t* hard = A.arr[2];
  int8_t* cw = A.arr[3];
  for (int r = t.r0; r < (1 << R); r += T::kPass) {
    if (hard != nullptr) t.store(hard + (long long)P * A.batch, r, t.at(hb, r));
    if (CW && cw != nullptr)
      t.store(cw + (long long)P * A.batch, r, t.at(cb, r));
  }
  __syncwarp();
}

// A run entry: the warps of the grid walk over the tiles of the batch.
template <bool CW, bool U>
__device__ __forceinline__ void tile_runs(const TileArgs& A, const int* e,
                                          uint32_t* smem) {
  using T = InterpTile<CW, U>;
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
    t.place(base, nreg, tile, root, A.arr[4], A.batch, A.aligned);
    run_on_tile<CW, U>(A, t, ws, we, R, P);
  }
}

// The schedule in order, a grid barrier after every entry that is not
// chained to the next. A schedule of one tile run has no barrier and
// launches as a plain grid; any other is launched cooperatively.
template <bool CW, bool U>
__global__ void __launch_bounds__(32 * kMaxWarps)
    interp_tile_kernel(TileArgs A) {
  extern __shared__ uint32_t smem[];
  for (int k = 0; k < A.n_sched; ++k) {
    const int* e = A.sched + k * kSchedCols;
    const int op = __ldg(e);
    if ((op & 0xFF) == kRun)
      tile_runs<CW, U>(A, e, smem);
    else
      grid_pass(A, e);
    if (!(op & kChain) && k + 1 < A.n_sched) cg::this_grid().sync();
  }
}

int region_bytes(int cw, int region, int warps) {
  return warps * (2 + cw) * (1 << region) * polar::simd::kTileWR * 4;
}

template <bool CW, bool U>
int tile_occupancy(int region, int warps, int* per_sm) {
  const int bytes = region_bytes(CW, region, warps);
  cudaError_t err = cudaFuncSetAttribute(
      interp_tile_kernel<CW, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, interp_tile_kernel<CW, U>, 32 * warps, bytes);
}

template <bool CW, bool U>
int launch_tile(TileArgs a, int blocks, int warps, int coop,
                cudaStream_t stream) {
  const int bytes = region_bytes(CW, a.region, warps);
  // above 48 KB a block's dynamic shared memory must be granted first
  cudaError_t err = cudaFuncSetAttribute(
      interp_tile_kernel<CW, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  if (coop) {  // refused (cudaErrorCooperativeLaunchTooLarge) if the grid
               // is not resident at once: the error goes to the caller
    void* args[] = {&a};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)interp_tile_kernel<CW, U>, dim3(blocks),
        dim3(32 * warps), args, (size_t)bytes, stream);
  }
  interp_tile_kernel<CW, U><<<blocks, 32 * warps, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

TileArgs tile_args(const void* words, const void* desc, const void* table,
                   const void* mrows, const void* sched, int n_sched,
                   int level, int kl, int batch, int prefill, int aligned,
                   int region, const void* llr, void* pyr, void* hard,
                   void* cw, void* u) {
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
  return a;
}

}  // namespace

// The tile kernel on `stream`: the program's words, desc
// (branches x 8), table (uint8) and mrows (a word's first compacted message
// row) with the schedule `sched` (n_sched x 8 int32); llr (2^level, batch)
// in; pyr (2^level + 1, batch) scratch (null without grid entries); hard
// (2^level, batch) scratch or out (null: not kept), cw (2^level, batch) out
// when cw_track, u (K, batch) out, compacted, when u_track; all int8
// element-major. region: log2 of the rows of a warp's shared regions;
// aligned != 0: batch % 16 == 0 and every array on 16 bytes; `blocks` of
// `warps` (1..4) tiles; coop != 0: a cooperative launch (every entry but a
// lone tile run needs one). Returns the CUDA error of the attribute call or
// the launch (cudaErrorCooperativeLaunchTooLarge where the card cannot hold
// the grid at once), or cudaErrorInvalidValue for a track pair not built.
extern "C" int polar_interp_tile(const void* words, const void* desc,
                                 const void* table, const void* mrows,
                                 const void* sched, int n_sched, int level,
                                 int kl, int batch, int prefill, int aligned,
                                 int region, const void* llr, void* pyr,
                                 void* hard, void* cw, void* u, int cw_track,
                                 int u_track, int blocks, int warps, int coop,
                                 void* stream) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const TileArgs a = tile_args(words, desc, table, mrows, sched, n_sched,
                               level, kl, batch, prefill, aligned, region,
                               llr, pyr, hard, cw, u);
  const cudaStream_t st = (cudaStream_t)stream;
  if (cw_track && u_track) return launch_tile<true, true>(a, blocks, warps, coop, st);
  if (cw_track) return launch_tile<true, false>(a, blocks, warps, coop, st);
  if (u_track) return launch_tile<false, true>(a, blocks, warps, coop, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of `warps` warps of the tile kernel (tracks as polar_interp_tile,
// shared regions of 2^region rows) that one SM holds at once, into
// *per_sm. Returns the CUDA error of the attribute or occupancy call.
extern "C" int polar_interp_tile_occupancy(int cw_track, int u_track,
                                           int region, int warps,
                                           int* per_sm) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  if (cw_track && u_track) return tile_occupancy<true, true>(region, warps, per_sm);
  if (cw_track) return tile_occupancy<true, false>(region, warps, per_sm);
  if (u_track) return tile_occupancy<false, true>(region, warps, per_sm);
  return (int)cudaErrorInvalidValue;
}
