// Subtree Fast-SSC decoders: one pruned-tree node of the hybrid large-N
// decoder, the tile kernel and the walk.
//
// Both replace polar_tpu/ops/pallas/decoder_kernel.py:make_subtree_decoder
// (:562) in its SSA bodies:
//   fuse none: _ssa_subtree_kernel (:449, u + hard),
//              _ssa_subtree_kernel_cw (:460, u + hard + cw),
//              _ssa_subtree_kernel_cw_nou (:473, hard + cw);
//   fuse f:    the same with _fused_f_soft (:422): the input is the parent's
//              2n-row slot and the parent's f runs first;
//   fuse g:    _ssa_subtree_kernel_g / _g_cw / _g_cw_nou (:500-538): the
//              inputs are the parent's 2n-row slot and the left child's hard
//              (and cw) blocks; the parent's g runs first, and the outputs
//              are the parent's combined [hl*hr, hr] and [cwl*cwr, cwr]
//              2n-row blocks.
// The node's program is emit_program(node, node.level) and its mask
// code/compiler.py:node_frozen(node), read at run time, so one build serves
// every node. A subtree decodes exactly as the same rows of the whole code
// would. The fused prologues produce values in [-127, 127] (f) or saturate
// to [-128, 127] (g); the decoders' qabs and madd guards take either, so the
// fused and unfused paths agree bit for bit.
//
// The tile kernel (fastssc_simd.cuh, as decoder.cu's): one warp decodes a
// tile of 8 frames, four to a 32-bit word, its lanes splitting every node's
// rows 32 a pass. The prologue writes the node's root rows (the slot, or
// the parent's f or g of it) into shared memory, so the pyramid reads the
// parent's slot once; the soft pyramid, the hard stack, the cw stack (built
// per node, no re-encode) and the root take n bytes a frame each. The
// epilogue stores the hard and cw rows, under fuse g first combining them
// with the left blocks by the packed product, which keeps the zeros of
// signum(0). What bounds it: each op's latency with the warps that shared
// memory lets an SM hold; above the wrapper's TILE_SUBTREE_MAX_LEVEL one
// tile no longer fits a block, and the nodes go to the walk. The tail of
// the last tile is masked and rows off the 16-byte word go a byte at a time
// (Tile::load / store), so any B works.
//
// The walk (fastssc.cuh): one thread decodes one frame over (n, B) scratch
// in device memory, then re-encodes its message into the cw block. What
// bounds it: the latency of one thread's dependent byte accesses to its
// pyramid (a level-l node keeps about 3 * 2^l bytes a frame live, in L2 at
// l <= 12 and B = 4096), with one warp for 32 frames. It serves the nodes
// above the tile's limit and is reachable by name (style="walk") for the
// A/B. Both keep the whole node in one launch (prologue, decode, epilogue),
// so the hybrid's top levels see one kernel per node site.

#include <cuda_runtime.h>

#include "fastssc.cuh"
#include "fastssc_simd.cuh"

namespace {

enum : int { kFuseNone = 0, kFuseF = 1, kFuseG = 2 };

template <bool CW, bool EMIT_U>
using SubtreeTile = polar::simd::Tile<polar::simd::kTileWR,
                                      polar::simd::kTileVW, CW, true, EMIT_U>;

__global__ void subtree_decoder_kernel(
    const uint8_t* __restrict__ prog, const uint8_t* __restrict__ frozen,
    int n, int batch, int fuse, const int8_t* in, const int8_t* hard_l,
    const int8_t* cw_l, int8_t* child, int8_t* soft, int8_t* mesg,
    int8_t* hard, int8_t* cw) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= batch) return;
  const long long b = batch;
  // inputs are only read; Col carries a mutable pointer for the scratch
  // arrays it also describes
  polar::Col x{const_cast<int8_t*>(in) + f, b};
  // the node's own hard and cw rows: [0, n), or [n, 2n) of the parent's
  // combined blocks under fuse g
  const long long off = fuse == kFuseG ? (long long)n * b : 0;
  const polar::Col h{hard + off + f, b};
  const polar::Col m{mesg + f, b};
  if (fuse == kFuseF) {  // parent f: the left child's input
    const polar::Col c{child + f, b};
    for (int i = 0; i < n; ++i) c[i] = (int8_t)polar::prod(x[i], x[n + i]);
    x = c;
  } else if (fuse == kFuseG) {  // parent g with the left hard block
    const polar::Col c{child + f, b};
    const polar::Col hl{const_cast<int8_t*>(hard_l) + f, b};
    for (int i = 0; i < n; ++i)
      c[i] = (int8_t)polar::madd(hl[i], x[i], x[n + i]);
    x = c;
  }
  polar::fastssc_decode(prog, n, x, polar::Col{soft + f, b}, h, m);
  if (cw != nullptr) polar::reencode(frozen, n, m, polar::Col{cw + off + f, b});
  if (fuse == kFuseG) {  // the parent's combine
    const polar::Col hl{const_cast<int8_t*>(hard_l) + f, b};
    const polar::Col ho{hard + f, b};
    for (int i = 0; i < n; ++i) ho[i] = (int8_t)(hl[i] * h[i]);
    if (cw != nullptr) {
      const polar::Col cl{const_cast<int8_t*>(cw_l) + f, b};
      const polar::Col co{cw + f, b};
      const polar::Col cr{cw + off + f, b};
      for (int i = 0; i < n; ++i) co[i] = (int8_t)(cl[i] * cr[i]);
    }
  }
}

template <bool CW, bool EMIT_U>
__global__ void tile_subtree_kernel(const uint8_t* __restrict__ prog, int n,
                                    int batch, int fuse, const int8_t* in,
                                    const int8_t* hard_l, const int8_t* cw_l,
                                    int8_t* mesg, int8_t* hard, int8_t* cw,
                                    int aligned) {
  extern __shared__ uint32_t smem[];
  using T = SubtreeTile<CW, EMIT_U>;
  using V = typename T::V;
  namespace s = polar::simd;
  T t;
  // soft, hard, (cw,) root; a whole warp returns: no barrier below
  if (!t.bind(smem, n, nullptr, mesg, batch, aligned)) return;
  for (int r = t.r0; r < n; r += T::kPass) {  // the node's root rows
    V v;
    if (fuse == kFuseF)
      v = s::prod(t.load(in, r), t.load(in, n + r));
    else if (fuse == kFuseG)
      v = s::madd(t.load(hard_l, r), t.load(in, r), t.load(in, n + r));
    else
      v = t.load(in, r);
    t.at(t.root, r) = v;
  }
  __syncwarp();
  t.decode(prog, n);
  // the node's rows [0, n) of each stack: rows [n, 2n) of the parent's
  // combined blocks under fuse g, whose rows [0, n) are the left block's
  // product with them
  const int off = fuse == kFuseG ? n : 0;
  for (int r = t.r0; r < n; r += T::kPass) {
    const V h = t.at(t.hard, r);
    t.store(hard, off + r, h);
    if (fuse == kFuseG) t.store(hard, r, s::hmul(t.load(hard_l, r), h));
    if (CW) {
      const V c = t.at(t.cw, r);
      t.store(cw, off + r, c);
      if (fuse == kFuseG) t.store(cw, r, s::hmul(t.load(cw_l, r), c));
    }
  }
}

}  // namespace

// The tile kernel on `stream`: tiles of 8 frames, `warps` tiles a block,
// warps * 8 * n * (3, or 4 with cw) bytes of shared memory. n = 2^level of
// the node; fuse 0 (none), 1 (f), 2 (g). in: n rows (fuse none) or the
// parent's 2n rows; hard_l, cw_l: the left child's n-row blocks (fuse g;
// cw_l only with cw). Outputs: mesg (k rows) unless null, hard, and cw
// unless null (not both null), n rows or 2n rows under fuse g. All int8,
// element-major (rows, batch). aligned != 0: batch % 16 == 0 and every
// array starts on a 16-byte boundary. Returns the CUDA error of the
// attribute call or of the launch.
extern "C" int polar_tile_subtree(const void* prog, int n, int batch, int fuse,
                                  const void* in, const void* hard_l,
                                  const void* cw_l, void* mesg, void* hard,
                                  void* cw, int warps, int aligned,
                                  void* stream) {
  namespace s = polar::simd;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cw == nullptr)
    return mesg == nullptr
               ? (int)cudaErrorInvalidValue
               : s::launch_tiles<SubtreeTile<false, true>>(
                     tile_subtree_kernel<false, true>, n, batch, warps, st,
                     prog, n, batch, fuse, in, hard_l, cw_l, mesg, hard, cw,
                     aligned);
  return mesg == nullptr
             ? s::launch_tiles<SubtreeTile<true, false>>(
                   tile_subtree_kernel<true, false>, n, batch, warps, st,
                   prog, n, batch, fuse, in, hard_l, cw_l, mesg, hard, cw,
                   aligned)
             : s::launch_tiles<SubtreeTile<true, true>>(
                   tile_subtree_kernel<true, true>, n, batch, warps, st, prog,
                   n, batch, fuse, in, hard_l, cw_l, mesg, hard, cw, aligned);
}

// The walk on `stream`. n = 2^level of the node; fuse 0 (none), 1 (f), 2 (g).
// in: n rows (fuse none) or the parent's 2n rows; hard_l, cw_l: the left
// child's n-row blocks (fuse g; cw_l only with cw). Scratch: child (n rows,
// fused modes only), soft (n rows), mesg (k rows; the u output when the
// caller keeps it). Outputs: hard and, when not null, cw, n rows or 2n rows
// under fuse g. All int8, element-major (rows, batch). Returns
// cudaGetLastError() after the launch.
extern "C" int polar_subtree(const void* prog, const void* frozen, int n,
                             int batch, int fuse, const void* in,
                             const void* hard_l, const void* cw_l, void* child,
                             void* soft, void* mesg, void* hard, void* cw,
                             int threads, void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  subtree_decoder_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)prog, (const uint8_t*)frozen, n, batch, fuse,
      (const int8_t*)in, (const int8_t*)hard_l, (const int8_t*)cw_l,
      (int8_t*)child, (int8_t*)soft, (int8_t*)mesg, (int8_t*)hard,
      (int8_t*)cw);
  return (int)cudaGetLastError();
}
