// Subtree Fast-SSC decoder: one pruned-tree node of the hybrid large-N
// decoder, one thread per frame.
//
// Replaces polar_tpu/ops/pallas/decoder_kernel.py:make_subtree_decoder
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
// code/compiler.py:node_frozen(node); the walk is fastssc_decode
// (fastssc.cuh), so a subtree decodes exactly as the same rows of the whole
// code would. The fused prologues produce values in [-127, 127] (f) or
// saturate to [-128, 127] (g); the walker's qabs and madd guards take
// either, so the fused and unfused paths agree bit for bit.
//
// Layout: element-major (rows, B) int8 in device memory, frame f of row r at
// p[r * B + f]; the last block is masked, so any B works without padding.
// What bounds it on the card: as for the whole-code decoder, the latency of
// one thread's dependent byte accesses to its pyramid; a level-l node keeps
// about 3 * 2^l bytes per frame live, which at l <= 12 and B = 4096 stays in
// the 50 MB L2 instead of device memory. The design keeps the whole node in
// one launch (prologue, walk, re-encode, epilogue), so the hybrid's top
// levels see one kernel per node site.

#include <cuda_runtime.h>

#include "fastssc.cuh"

namespace {

enum : int { kFuseNone = 0, kFuseF = 1, kFuseG = 2 };

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

}  // namespace

// Launch on `stream`. n = 2^level of the node; fuse 0 (none), 1 (f), 2 (g).
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
