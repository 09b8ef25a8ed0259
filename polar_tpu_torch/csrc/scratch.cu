// Scratch-style Fast-SSC decoders: the soft pyramid and the hard stack of a
// tile of frames in shared memory, the root read where it lies in device
// memory, u output (and, for a hybrid node, the node's hard block).
//
// Replaces polar_tpu/ops/pallas/decoder_kernel.py's scratch style:
// _decoder_kernel (:541, make_pallas_decoder(style="scratch"), u output)
// and _subtree_kernel (:550, make_subtree_decoder(style="scratch"): u and
// the node's hard block), both over _KernelBuilder (:112-272). The TPU
// kernel keeps a (2N, tile) soft pyramid and an (N, tile) hard stack in
// VMEM. What carries over is only that idea: the pyramid and the hard stack
// on chip, n soft rows (the root's LLRs are read in device memory, where
// they lie) and n hard rows a frame, 2n bytes; the message goes straight to
// device memory, and the subtree entry stores the hard stack's n rows after
// the decode (signum(0)'s zeros kept). The kernel follows
// fastssc.cuh:fastssc_decode opcode for opcode, so it agrees bit for bit
// with the SSA-style kernels (decoder.cu, subtree.cu).
//
// The tile kernel (scratch_tile_kernel) runs fastssc_simd.cuh's Tile with
// the root in device memory (ROOT_SMEM = false): four frames to a 32-bit
// word, WR words (4 WR frames) a warp's tile, VW of them a lane, so a warp
// covers 32 VW / WR rows a pass. The shapes built: (WR, VW) = (2, 2), 8
// frames, 32 rows a pass (the tile core's own shape: for the whole code it
// is decoder.cu's tile_decoder_kernel<false> instruction for instruction,
// so polar_scratch_decode launches that instance and builds no copy); (4, 1)
// and (8, 1), 16 and 32 frames, 8 and 4 rows a pass; (32, 1), 128 frames,
// each lane its own 4-frame column and one row a pass, a frame-a-thread
// kernel's parallelism at a quarter of its instructions. A warp takes
// 2 n 4 WR bytes of shared memory, so (32, 1) fits a block up to n = 512
// and the narrower shapes to n = 2048. The wrapper
// (ops/cuda/decoder_kernel.py scratch_shape) picks the shape and the warps
// a block by level and batch, so that the grid covers the card where the
// batch has the tiles for it.
//
// The u track also comes frame-major (scratch_frames_kernel, and
// decoder.cu's tile_decoder_frames_kernel at (2, 2)): llr (batch, n) in,
// mesg (batch, k) out, each lane gathering and scattering a byte a frame
// (fastssc_simd.cuh, FRAMES), the decode in shared memory unchanged.
//
// What bounds it: not the bytes (the root and the outputs, about 2 n bytes
// a frame), but each op's chain of dependent shared-memory accesses,
// emulated byte-SIMD arithmetic and warp barrier, with the few warps a
// batch of a few thousand frames gives an SM. The narrow shapes make the
// chain short (a node's rows split over many lanes) and the tiles many;
// the wide ones leave no lane idle on the small nodes that make up most of
// a program's ops. One frame a thread, a byte a row, in blocks of up to
// 128 frames (32 blocks on the card's 132 SMs at B = 4096) was slower at
// every shape timed (PERF.md section 6, rows 3 and 4s).

#include <cuda_runtime.h>

#include "fastssc.cuh"
#include "fastssc_simd.cuh"

// decoder.cu: the whole-code tile kernel, the (2, 2) shape of the u track,
// element-major and frame-major
extern "C" int polar_tile_decode(const void* prog, const void* llr,
                                 void* mesg, void* cw, int n, int batch,
                                 int warps, int aligned, void* stream);
extern "C" int polar_tile_decode_frames(const void* prog, const void* llr,
                                        void* mesg, int n, int k, int batch,
                                        int warps, void* stream);

namespace {

template <int WR, int VW>
using ScratchTile = polar::simd::Tile<WR, VW, /*CW=*/false,
                                      /*ROOT_SMEM=*/false, /*EMIT_U=*/true>;

// One warp decodes a tile: soft and hard stacks on chip, the root in device
// memory, the message by emit; HARD: then the hard stack's n rows out.
template <int WR, int VW, bool HARD>
__global__ void scratch_tile_kernel(const uint8_t* __restrict__ prog, int n,
                                    int batch, const int8_t* llr,
                                    int8_t* mesg, int8_t* hard, int aligned) {
  // the same dynamic shared memory as the byte kernel's smem, in words
  extern __shared__ uint32_t words[];
  using T = ScratchTile<WR, VW>;
  T t;
  // a whole warp returns: no barrier below
  if (!t.bind(words, n, llr, mesg, batch, aligned)) return;
  t.decode(prog, n);  // ends with __syncwarp after the last op
  if (HARD)
    for (int r = t.r0; r < n; r += T::kPass) t.store(hard, r, t.at(t.hard, r));
}

template <int WR, int VW, bool HARD>
int launch_tile(const void* prog, int n, int batch, const void* llr,
                void* mesg, void* hard, int warps, int aligned,
                cudaStream_t stream) {
  return polar::simd::launch_tiles<ScratchTile<WR, VW>>(
      scratch_tile_kernel<WR, VW, HARD>, n, batch, warps, stream,
      (const uint8_t*)prog, n, batch, (const int8_t*)llr, (int8_t*)mesg,
      (int8_t*)hard, aligned);
}

// The tile kernel of shape (wr, vw), with the hard block (hard != nullptr)
// or without it.
int launch_shape(const void* prog, int n, int batch, const void* llr,
                 void* mesg, void* hard, int wr, int vw, int warps,
                 int aligned, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool h = hard != nullptr;
  if (wr == 2 && vw == 2)
    return h ? launch_tile<2, 2, true>(prog, n, batch, llr, mesg, hard, warps,
                                       aligned, st)
             : polar_tile_decode(prog, llr, mesg, nullptr, n, batch, warps,
                                 aligned, stream);
  if (wr == 4 && vw == 1)
    return h ? launch_tile<4, 1, true>(prog, n, batch, llr, mesg, hard, warps,
                                       aligned, st)
             : launch_tile<4, 1, false>(prog, n, batch, llr, mesg, hard,
                                        warps, aligned, st);
  if (wr == 8 && vw == 1)
    return h ? launch_tile<8, 1, true>(prog, n, batch, llr, mesg, hard, warps,
                                       aligned, st)
             : launch_tile<8, 1, false>(prog, n, batch, llr, mesg, hard,
                                        warps, aligned, st);
  if (wr == 32 && vw == 1)
    return h ? launch_tile<32, 1, true>(prog, n, batch, llr, mesg, hard,
                                        warps, aligned, st)
             : launch_tile<32, 1, false>(prog, n, batch, llr, mesg, hard,
                                         warps, aligned, st);
  return (int)cudaErrorInvalidValue;
}

template <int WR, int VW>
using FramesTile = polar::simd::Tile<WR, VW, /*CW=*/false, /*ROOT_SMEM=*/false,
                                     /*EMIT_U=*/true, /*INTERP=*/false,
                                     /*FRAMES=*/true>;

// scratch_tile_kernel<WR, VW, false> on frame-major arrays: llr (batch, n)
// in, mesg (batch, k) out.
template <int WR, int VW>
__global__ void scratch_frames_kernel(const uint8_t* __restrict__ prog, int n,
                                      int k, int batch, const int8_t* llr,
                                      int8_t* mesg) {
  extern __shared__ uint32_t words[];
  FramesTile<WR, VW> t;
  // a whole warp returns: no barrier below
  if (!t.bind(words, n, llr, mesg, batch, 0, k)) return;
  t.decode(prog, n);
}

template <int WR, int VW>
int launch_frames(const void* prog, int n, int k, int batch, const void* llr,
                  void* mesg, int warps, cudaStream_t stream) {
  return polar::simd::launch_tiles<FramesTile<WR, VW>>(
      scratch_frames_kernel<WR, VW>, n, batch, warps, stream,
      (const uint8_t*)prog, n, k, batch, (const int8_t*)llr, (int8_t*)mesg);
}

}  // namespace

// The whole-code decoder on `stream`, u output, the tile kernel: llr (n,
// batch) in, mesg (k, batch) out, int8 element-major; shape (wr, vw) one of
// (2, 2), (4, 1), (8, 1), (32, 1), `warps` tiles of 4 wr frames a block,
// warps * 2 n * 4 wr bytes of shared memory. aligned != 0: batch % (4 vw)
// == 0 and both arrays start on a 4 vw-byte boundary. Returns the CUDA
// error of the attribute call or of the launch (a block refused for its
// shared memory never runs, and only this reports it), or
// cudaErrorInvalidValue for a shape not built.
extern "C" int polar_scratch_decode(const void* prog, int n, int batch,
                                    const void* llr, void* mesg, int wr,
                                    int vw, int warps, int aligned,
                                    void* stream) {
  return launch_shape(prog, n, batch, llr, mesg, nullptr, wr, vw, warps,
                      aligned, stream);
}

// The same on frame-major arrays: llr (batch, n) in, mesg (batch, k) out,
// int8, any alignment.
extern "C" int polar_scratch_decode_frames(const void* prog, int n, int k,
                                           int batch, const void* llr,
                                           void* mesg, int wr, int vw,
                                           int warps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (wr == 2 && vw == 2)
    return polar_tile_decode_frames(prog, llr, mesg, n, k, batch, warps,
                                    stream);
  if (wr == 4 && vw == 1)
    return launch_frames<4, 1>(prog, n, k, batch, llr, mesg, warps, st);
  if (wr == 8 && vw == 1)
    return launch_frames<8, 1>(prog, n, k, batch, llr, mesg, warps, st);
  if (wr == 32 && vw == 1)
    return launch_frames<32, 1>(prog, n, k, batch, llr, mesg, warps, st);
  return (int)cudaErrorInvalidValue;
}

// One hybrid node on `stream`, the tile kernel: in (n, batch), out mesg (k,
// batch) and the node's hard block (n, batch), as polar_scratch_decode
// (aligned: all three arrays).
extern "C" int polar_scratch_subtree(const void* prog, int n, int batch,
                                     const void* in, void* mesg, void* hard,
                                     int wr, int vw, int warps, int aligned,
                                     void* stream) {
  if (hard == nullptr) return (int)cudaErrorInvalidValue;
  return launch_shape(prog, n, batch, in, mesg, hard, wr, vw, warps, aligned,
                      stream);
}
