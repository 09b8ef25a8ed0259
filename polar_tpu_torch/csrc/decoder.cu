// Whole-code Fast-SSC decoder kernels, each with an optional
// codeword-estimate track: the tile kernel and the walk.
//
// Both replace polar_tpu/ops/pallas/decoder_kernel.py:_ssa_decoder_kernel
// (u output, make_pallas_decoder(style="ssa", output="u"), :404) and
// _ssa_decoder_kernel_cw (output in {systematic, codeword, both}, :410).
//
// The tile kernel (fastssc_simd.cuh): one warp decodes a tile of 4 WR
// frames (8), four frames to a 32-bit word, with the byte-SIMD intrinsics;
// its lanes split every node's rows, and the tile's soft pyramid, hard
// stack and codeword stack lie in shared memory. The cw track is built per
// node, with no re-encode at the end. What bounds it: each op's latency,
// with the warps that shared memory lets an SM hold (2 n (u) or 3 n (cw)
// bytes a frame); above WHOLE_MAX_LEVEL (the wrapper,
// ops/cuda/decoder_kernel.py) one cw tile no longer fits a block's shared
// memory, and the codes go to the walk. A block holds `warps` tiles, each
// warp on its own (no block barrier). The tail of the last tile is masked in the kernel:
// frames past the batch read as 0 and are never stored, so any B works
// without padding; where B is not a multiple of 16 (or an array starts off
// a 16-byte boundary) every row access to device memory goes a byte at a
// time.
//
// The walk (fastssc.cuh): one thread decodes one frame, the soft pyramid
// and hard stack in (N, B) int8 scratch in device memory, each row access
// of a warp one 32-byte sector; with cw != nullptr the same thread then
// re-encodes its message into the (N, B) codeword estimate. What bounds it:
// the latency of those dependent byte accesses, and at B = 32768 one thread
// a frame fills a fraction of the card's thread slots. It serves the codes
// above WHOLE_MAX_LEVEL and is reachable by name (style="walk") for the
// A/B. The last block is masked.
//
// The tile kernel's u track also comes frame-major
// (tile_decoder_frames_kernel): the root LLRs (batch, n) in, the message
// (batch, k) out, the decode in shared memory as it is element-major, so
// the frame-major entry (decode/auto.py) runs no transpose around it.
//
// The float kernel (f32_frames_kernel) is the same u track in float32
// min-sum (fastssc_simd.cuh F32Lanes: polar_helper.hh:63-111, as the eager
// decoder computes it with float LLRs): one frame to a 32-bit word, so a
// tile of W words is W frames and a row of a region 4 W bytes; the root
// (batch, n) float32 in, the message (batch, k) int8 in {-1, 0, +1} out.
// The schedule and the shared-memory layout are the int8 tile's; only the
// lane arithmetic, the gather of a float a frame and the message byte
// differ. A tile takes 8 n bytes a frame (two regions of n float rows), so
// a tile of one frame fits a block up to n = 2^14; the wrapper
// (ops/cuda/decoder_kernel.py f32_tile) takes tiles of 4, 2 and 1 frames
// as the level grows.
//
// Both read the code's byte program at run time, so one build serves every
// code. polar_simd_selftest holds every packed function of
// fastssc_simd.cuh against its scalar namesake in fastssc.cuh.

#include <cuda_runtime.h>

#include "fastssc.cuh"
#include "fastssc_simd.cuh"

namespace {

__global__ void fastssc_decoder_kernel(const uint8_t* __restrict__ prog,
                                       const uint8_t* __restrict__ frozen,
                                       const int8_t* llr, int8_t* soft,
                                       int8_t* hard, int8_t* mesg, int8_t* cw,
                                       int n, int batch) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= batch) return;
  const long long b = batch;
  // the root input is only read; Col carries a mutable pointer for the
  // scratch arrays it also describes
  const polar::Col in{const_cast<int8_t*>(llr) + f, b};
  const polar::Col m{mesg + f, b};
  polar::fastssc_decode(prog, n, in, polar::Col{soft + f, b},
                        polar::Col{hard + f, b}, m);
  if (cw != nullptr) polar::reencode(frozen, n, m, polar::Col{cw + f, b});
}

template <bool CW>
using DecoderTile = polar::simd::Tile<polar::simd::kTileWR,
                                      polar::simd::kTileVW, CW>;

template <bool CW>
__global__ void tile_decoder_kernel(const uint8_t* __restrict__ prog,
                                    const int8_t* llr, int8_t* mesg,
                                    int8_t* cw, int n, int batch,
                                    int aligned) {
  extern __shared__ uint32_t smem[];
  using T = DecoderTile<CW>;
  T t;
  // a whole warp returns: no barrier below
  if (!t.bind(smem, n, llr, mesg, batch, aligned)) return;
  t.decode(prog, n);
  if (CW)
    for (int r = t.r0; r < n; r += T::kPass) t.store(cw, r, t.at(t.cw, r));
}

using FramesTile = polar::simd::Tile<polar::simd::kTileWR,
                                     polar::simd::kTileVW, /*CW=*/false,
                                     /*ROOT_SMEM=*/false, /*EMIT_U=*/true,
                                     /*INTERP=*/false, /*FRAMES=*/true>;

// tile_decoder_kernel<false> on frame-major arrays: llr (batch, n) in, mesg
// (batch, k) out.
__global__ void tile_decoder_frames_kernel(const uint8_t* __restrict__ prog,
                                           const int8_t* llr, int8_t* mesg,
                                           int n, int k, int batch) {
  extern __shared__ uint32_t smem[];
  FramesTile t;
  // a whole warp returns: no barrier below
  if (!t.bind(smem, n, llr, mesg, batch, 0, k)) return;
  t.decode(prog, n);
}

template <int W>
using F32Tile = polar::simd::Tile<W, W, /*CW=*/false, /*ROOT_SMEM=*/false,
                                  /*EMIT_U=*/true, /*INTERP=*/false,
                                  /*FRAMES=*/true, polar::simd::F32Lanes>;

// The u track in float32 on frame-major arrays: llr (batch, n) float32
// in, mesg (batch, k) int8 out; a tile W frames, W words a lane.
template <int W>
__global__ void f32_frames_kernel(const uint8_t* __restrict__ prog,
                                  const float* llr, int8_t* mesg, int n,
                                  int k, int batch) {
  extern __shared__ uint32_t smem[];
  F32Tile<W> t;
  // a whole warp returns: no barrier below
  if (!t.bind(smem, n, llr, mesg, batch, 0, k)) return;
  t.decode(prog, n);
}

template <int W>
int launch_f32(const void* prog, const void* llr, void* mesg, int n, int k,
               int batch, int warps, cudaStream_t stream) {
  return polar::simd::launch_tiles<F32Tile<W>>(
      f32_frames_kernel<W>, n, batch, warps, stream, (const uint8_t*)prog,
      (const float*)llr, (int8_t*)mesg, n, k, batch);
}

// Each thread packs four (a, b) pairs of the 65,536 into words and checks
// every packed function's four bytes against the scalar function.
enum : int {
  kSatAdd = 0, kQabs, kSignum, kDecide, kProd, kMadd, kHmul, kSpcFlip,
  kChecks
};

__global__ void simd_selftest_kernel(int* bad) {
  namespace s = polar::simd;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 65536 / 4) return;
  int a[4], b[4];
  uint32_t A = 0, B = 0, HA = 0, HB = 0;
  for (int j = 0; j < 4; ++j) {
    const int p = 4 * i + j;
    a[j] = (int8_t)(p >> 8);
    b[j] = (int8_t)(p & 255);
    A |= (uint32_t)(uint8_t)a[j] << (8 * j);
    B |= (uint32_t)(uint8_t)b[j] << (8 * j);
    // {-1, 0, +1} operands for hmul: every pair of them occurs
    HA |= (uint32_t)(uint8_t)polar::signum(a[j]) << (8 * j);
    HB |= (uint32_t)(uint8_t)polar::signum(b[j]) << (8 * j);
  }
  int cnt[kChecks] = {};
  const uint32_t got[] = {s::sat_add(A, B), s::qabs(A), s::signum(A),
                          s::decide(A), s::prod(A, B), 0u, s::hmul(HA, HB),
                          s::spc_flip(A, s::qabs(B), s::neg_mask(B))};
  for (int j = 0; j < 4; ++j) {
    auto byte = [&](uint32_t v) { return (int)(int8_t)(v >> (8 * j)); };
    const int x = a[j], y = b[j];
    const int want[] = {
        polar::sat8(x + y), polar::qabs(x), polar::signum(x),
        polar::decide(x), polar::prod(x, y), 0,
        polar::signum(x) * polar::signum(y),
        polar::decide(x) *
            (polar::qabs(x) == polar::qabs(y) ? polar::decide(y) : 1)};
    for (int k = 0; k < kChecks; ++k)
      if (k != kMadd) cnt[k] += byte(got[k]) != want[k];
  }
  for (int h = -1; h <= 1; ++h) {  // madd: every pair under each hard value
    const uint32_t H = (uint32_t)(uint8_t)h * 0x01010101u;
    const uint32_t v = s::madd(H, A, B);
    for (int j = 0; j < 4; ++j)
      cnt[kMadd] += (int)(int8_t)(v >> (8 * j)) != polar::madd(h, a[j], b[j]);
  }
  for (int k = 0; k < kChecks; ++k)
    if (cnt[k]) atomicAdd(bad + k, cnt[k]);
}

}  // namespace

// The walk on `stream`. llr (n, batch), soft and hard (n, batch) scratch,
// mesg (k, batch) and, when not null, cw (n, batch): all int8,
// element-major. Returns cudaGetLastError() after the launch.
extern "C" int polar_decode(const void* prog, const void* frozen,
                            const void* llr, void* soft, void* hard,
                            void* mesg, void* cw, int n, int batch,
                            int threads, void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  fastssc_decoder_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)prog, (const uint8_t*)frozen, (const int8_t*)llr,
      (int8_t*)soft, (int8_t*)hard, (int8_t*)mesg, (int8_t*)cw, n, batch);
  return (int)cudaGetLastError();
}

// The tile kernel on `stream`: tiles of 8 frames, two words a lane
// (polar::simd::kTileWR / kTileVW), `warps` tiles a block,
// warps * 8 * n * (2, or 3 with cw) bytes of shared memory. llr (n, batch)
// in; mesg (k, batch) and, when not null, cw (n, batch) out; all int8,
// element-major.
// aligned != 0: batch % 16 == 0 and every array starts on a 16-byte
// boundary. Returns the CUDA error of the attribute call or of the launch.
extern "C" int polar_tile_decode(const void* prog, const void* llr,
                                 void* mesg, void* cw, int n, int batch,
                                 int warps, int aligned, void* stream) {
  namespace s = polar::simd;
  const cudaStream_t st = (cudaStream_t)stream;
  return cw != nullptr
             ? s::launch_tiles<DecoderTile<true>>(
                   tile_decoder_kernel<true>, n, batch, warps, st, prog, llr,
                   mesg, cw, n, batch, aligned)
             : s::launch_tiles<DecoderTile<false>>(
                   tile_decoder_kernel<false>, n, batch, warps, st, prog, llr,
                   mesg, cw, n, batch, aligned);
}

// The tile kernel's u track on frame-major arrays, on `stream`: llr
// (batch, n) in, mesg (batch, k) out, int8, any alignment; tiles and
// shared memory as polar_tile_decode's. Returns the CUDA error of the
// attribute call or of the launch.
extern "C" int polar_tile_decode_frames(const void* prog, const void* llr,
                                        void* mesg, int n, int k, int batch,
                                        int warps, void* stream) {
  return polar::simd::launch_tiles<FramesTile>(
      tile_decoder_frames_kernel, n, batch, warps, (cudaStream_t)stream,
      prog, llr, mesg, n, k, batch);
}

// The float32 u track on `stream`: llr (batch, n) float32 in, mesg (batch,
// k) int8 out, frame-major, any alignment of a float; tiles of w frames (w
// one of 1, 2, 4), `warps` tiles a block, warps * 8 n w bytes of shared
// memory. Returns the CUDA error of the attribute call or of the launch,
// or cudaErrorInvalidValue for a w not built.
extern "C" int polar_f32_decode_frames(const void* prog, const void* llr,
                                       void* mesg, int n, int k, int batch,
                                       int w, int warps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (w) {
    case 1: return launch_f32<1>(prog, llr, mesg, n, k, batch, warps, st);
    case 2: return launch_f32<2>(prog, llr, mesg, n, k, batch, warps, st);
    case 4: return launch_f32<4>(prog, llr, mesg, n, k, batch, warps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The packed-primitive self-test on `stream`: bad (8) int32, zeroed by the
// caller, receives the mismatches of sat_add, qabs, signum, decide, prod,
// madd (h in {-1, 0, +1}), hmul and spc_flip over all 65,536 int8 pairs.
extern "C" int polar_simd_selftest(void* bad, void* stream) {
  simd_selftest_kernel<<<65536 / 4 / 256, 256, 0, (cudaStream_t)stream>>>(
      (int*)bad);
  return (int)cudaGetLastError();
}

// The register block of the tile core's instances (fastssc_simd.cuh
// reg_passes): the rows of a node whose transform stages and REP folds a
// tile of shape (wr, vw) keeps in registers, int8 lanes (f32 == 0) or
// float32 ones; -1 for a shape not built.
extern "C" int polar_tile_block_rows(int wr, int vw, int f32) {
  namespace s = polar::simd;
  if (f32) {
    switch (wr == vw ? wr : 0) {
      case 1: return F32Tile<1>::kBlock;
      case 2: return F32Tile<2>::kBlock;
      case 4: return F32Tile<4>::kBlock;
      default: return -1;
    }
  }
  if (wr == 2 && vw == 2) return s::Tile<2, 2, false>::kBlock;
  if (wr == 4 && vw == 1) return s::Tile<4, 1, false>::kBlock;
  if (wr == 8 && vw == 1) return s::Tile<8, 1, false>::kBlock;
  if (wr == 32 && vw == 1) return s::Tile<32, 1, false>::kBlock;
  return -1;
}
