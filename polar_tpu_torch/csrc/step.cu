// Monte-Carlo BER step kernels:
//
//   tile_step_kernel — the fused step on the tile core (fastssc_simd.cuh):
//     message -> encode -> AWGN -> quantize -> Fast-SSC decode -> the five
//     testbench counters, a warp a tile of 8 frames. Replaces
//     polar_tpu/ops/pallas/step_kernel.py:make_pallas_step
//     (_step_kernel_native :302 / _step_kernel_inject :315, _chain :248,
//     _front :225, _count_and_store :182) up to the wrapper's
//     STEP_TILE_MAX_LEVEL;
//   mc_step_kernel — the same function one thread a frame over the two
//     halves in mc.cuh (the walk): the levels above the tile's, and by name
//     (style="walk") for the A/B;
//   decode_count_tile_kernel — the back half alone, systematic, on the
//     tile core: decode the LLRs on the codeword-estimate track and count
//     against cw. Replaces step_kernel.py:make_pallas_decode_count (:475),
//     _decode_count_kernel (:453), up to the wrapper's WHOLE_MAX_LEVEL;
//   decode_count_kernel — the same one thread a frame (the walk): the
//     levels above the tile's, and by name (style="walk");
//   front_whole_kernel — the front half alone, systematic, one thread a
//     frame: (llr, cw) out. Replaces step_kernel.py:make_pallas_front
//     (:632) above the row-word kernel's level (front.cu:front_rows_kernel,
//     the default) and by name (style="thread").
//
// Math as in testbench.cc:125-192:
//   1. u0 = frozen ? +1 : message symbol;
//   2. cw = T(u0); systematic mode refreezes and transforms again;
//   3. llr = clamp(rint(scale * (cw + sigma * n)), -128, 127), each product
//      and sum rounded on its own (this file is built with -fmad=false);
//   4. decode; the systematic mode re-encodes the message into the
//      codeword estimate and compares it with cw at the info rows, the
//      plain mode compares the message with u0 at the info rows;
//   5. counters, in the bool domain: uncorrected bit errors, frame errors,
//      ambiguity erasures (decoded 0), AWGN sign flips (llr != 0 with a sign
//      other than cw's) and quantization erasures (llr == 0).
// Message symbols and normals come from the inputs (inject mode) or from
// Philox words (native mode, philox.cuh); Box-Muller pairs row i (radius)
// with row N/2 + i (angle) as _bits_to_normals does. The normal and the
// quantizer are channel.cuh's, shared with the large-N front (front.cu).
// The front kernel draws the fused step's words, so the front plus
// decode+count counts what the fused step counts on the same seeds.
//
// The tile step. A warp's lanes draw its 8 frames, each lane whole Philox
// blocks of one frame (4 consecutive message rows; 4 radius rows and their
// Box-Muller partners at N/2 + i), so each block is computed once; they
// write the symbols, then the quantized LLRs, byte by byte into shared rows
// of four frames a word. The encode is Tile::transform on those packed +-1
// words, the decode Tile::decode from the on-chip root, on the cw track in
// systematic mode, where the cw stack's rows are the estimate (no
// re-encode), and on the u track in plain mode, whose message rows go to
// device scratch. The transmitted codeword (systematic) or u0 (plain) goes
// to device scratch (n, B) for the count. Counters are packed: per-byte
// error and zero masks at the info rows (the `info` table), __popc of their
// byte flags, a per-byte OR of the error masks across the lanes
// (shuffles) for the frame errors; the channel counters are counted where
// each LLR is made. Frames past the batch are drawn and decoded but never
// counted or stored. Shared memory: soft pyramid, hard stack, root and, in
// systematic mode, the cw stack, n bytes a frame each. What bounds it: the
// decode's op latency with the warps that leaves an SM, and the draws'
// Philox and Box-Muller work; above the tile's level limit the step runs
// mc_step_kernel.
//
// Decode+count on the tile core. A warp decodes a tile of 8 frames with
// Tile::decode on the cw track, its root rows read from llr in device
// memory as the whole-code tile decoder reads them, soft, hard and cw
// stacks on chip (3 n bytes a frame, so it reaches level 13). The epilogue
// is the tile step's: at each info row the cw stack against the
// transmitted cw as packed byte masks of the live frames, __popc for the bit
// errors and the decoded zeros, the frame errors by a per-byte OR across
// the lanes. The channel counters, which the tile step counts where it
// makes each LLR, come from the inputs: a pass over the n rows of llr and cw
// in packed words (zero bytes by __vcmpeq4, sign flips where bit 7 of
// llr ^ cw is set in a byte whose LLR is not 0), the root rows by then in
// L2 from the decode. Counters per block, no atomics. What bounds it: the
// tile core's op latency (as the whole-code tile decoder on the cw track)
// and one more read of llr and cw.
//
// What bounds the other kernels on the card: like the walk, the latency of
// per-row byte accesses to the frame's columns in device memory; the front
// half adds
// two Philox blocks and one Box-Muller per row pair, the split adds one
// write and one read of llr and cw, (N, B) bytes each. The design keeps
// every stage in the one thread that owns the frame, so nothing crosses
// threads until the counters. Counters are reduced per block (warp
// shuffles, then shared memory) into a (grid, 5) int32 array that the
// wrapper sums: no atomics, so the counts are deterministic.

#include <cuda_runtime.h>

#include "fastssc_simd.cuh"
#include "mc.cuh"

namespace {

// the cw track in systematic mode, the message rows in plain mode
template <bool SYS>
using StepTile = polar::simd::Tile<polar::simd::kTileWR,
                                   polar::simd::kTileVW, SYS, true, !SYS>;

// Byte masks of the tile's frames in the batch: 0xFF in each byte of a
// lane's VW words whose frame is live.
template <typename T>
__device__ __forceinline__ void live_masks(const T& t, int batch,
                                           uint32_t (&live)[polar::simd::kTileVW]) {
#pragma unroll
  for (int v = 0; v < polar::simd::kTileVW; ++v) {
    live[v] = 0;
    for (int j = 0; j < 4; ++j)
      if (t.f + 4 * v + j < batch) live[v] |= 0xFFu << (8 * j);
  }
}

// The tile step's epilogue, shared with decode+count: at info row info[m]
// (the m-th message row) the estimate (the cw stack, or message row m of
// t.mesg) against row info[m] of ref, as byte masks of the live frames:
// cnt[0] bit errors and cnt[2] decoded zeros by __popc of the byte flags,
// cnt[1] frame errors by a per-byte OR of the error masks across the lanes
// that hold a frame's word.
template <bool CW, typename T>
__device__ __forceinline__ void count_info_rows(
    const T& t, const int* __restrict__ info, int k, const int8_t* ref,
    const uint32_t (&live)[polar::simd::kTileVW], int* cnt) {
  using V = typename T::V;
  namespace s = polar::simd;
  constexpr int kVW = polar::simd::kTileVW;
  uint32_t frame_err[kVW];
#pragma unroll
  for (int v = 0; v < kVW; ++v) frame_err[v] = 0;
  for (int m = t.r0; m < k; m += T::kPass) {
    const int i = __ldg(info + m);
    const V hat = CW ? t.at(t.cw, i) : t.load(t.mesg, m);
    const V want = t.load(ref, i);
#pragma unroll
    for (int v = 0; v < kVW; ++v) {
      const uint32_t e = __vcmpne4(hat.x[v], want.x[v]) & live[v];
      const uint32_t z = __vcmpeq4(hat.x[v], 0u) & live[v];
      cnt[0] += __popc(e & s::kOnes);
      cnt[2] += __popc(z & s::kOnes);
      frame_err[v] |= e;
    }
  }
  for (int o = T::kLanesRow; o < 32; o <<= 1) {
#pragma unroll
    for (int v = 0; v < kVW; ++v)
      frame_err[v] |= __shfl_xor_sync(0xFFFFFFFFu, frame_err[v], o);
  }
  if (t.r0 == 0) {
#pragma unroll
    for (int v = 0; v < kVW; ++v) cnt[1] += __popc(frame_err[v] & s::kOnes);
  }
}

__global__ void mc_step_kernel(const uint8_t* __restrict__ prog,
                               const uint8_t* __restrict__ frozen, int n,
                               int batch, int systematic, float sigma,
                               float scale, const int8_t* __restrict__ msg_in,
                               const float* __restrict__ normals_in,
                               const uint32_t* __restrict__ words_in,
                               uint32_t seed0, uint32_t seed1, uint32_t call,
                               int8_t* u_s, int8_t* c_s, int8_t* llr_s,
                               int8_t* soft, int8_t* hard, int8_t* mesg,
                               int* out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  int cnt[polar::kCounters] = {0, 0, 0, 0, 0};
  if (f < batch) {
    const long long b = batch;
    const polar::Col u{u_s + f, b}, c{c_s + f, b}, llr{llr_s + f, b};
    const polar::Col m{mesg + f, b};
    polar::mc_front(frozen, n, f, b, systematic, sigma, scale, msg_in,
                    normals_in, words_in, make_uint2(seed0, seed1), call,
                    true, u, c, llr, cnt);
    polar::fastssc_decode(prog, n, llr, polar::Col{soft + f, b},
                          polar::Col{hard + f, b}, m);
    if (systematic) {
      // codeword estimate into u's column (u0 is no longer needed)
      polar::cw_counts(frozen, n, m, u, c, cnt);
    } else {
      // u-domain estimate against the drawn u-domain message
      int frame_err = 0;
      for (int i = 0, k = 0; i < n; ++i) {
        if (__ldg(frozen + i)) continue;
        const int hat = m[k++];
        const int e = hat != u[i];
        cnt[0] += e;
        cnt[2] += hat == 0;
        frame_err |= e;
      }
      cnt[1] = frame_err;
    }
  }
  polar::store_block_counts(cnt, out);
}

template <bool SYS>
__global__ void tile_step_kernel(
    const uint8_t* __restrict__ prog, const uint8_t* __restrict__ frozen,
    const int* __restrict__ info, int n, int k, int batch, float sigma,
    float scale, const int8_t* __restrict__ msg_in,
    const float* __restrict__ normals_in,
    const uint32_t* __restrict__ words_in, uint32_t seed0, uint32_t seed1,
    uint32_t call, int8_t* tx, int8_t* mesg, int aligned, int* out) {
  extern __shared__ uint32_t smem[];
  using T = StepTile<SYS>;
  namespace s = polar::simd;
  constexpr int kVW = polar::simd::kTileVW;
  int cnt[polar::kCounters] = {0, 0, 0, 0, 0};
  T t;
  // soft, hard, (cw,) root; a whole warp skips, and every warp counts below
  if (t.bind(smem, n, nullptr, mesg, batch, aligned)) {
    // the draws: frame `fl` of the tile, blocks q, q + 4, ... of its rows
    const int lane = threadIdx.x & 31;
    const int fl = lane % T::kFrames, q = lane / T::kFrames;
    constexpr int kStep = 32 / T::kFrames;
    const int f = t.first() + fl;
    const bool live = f < batch;
    const long long b = batch;
    const bool inject = msg_in != nullptr, bits = words_in != nullptr;
    const uint2 key = make_uint2(seed0, seed1);
    int8_t* soft_b = reinterpret_cast<int8_t*>(t.soft) + fl;
    int8_t* root_b = reinterpret_cast<int8_t*>(t.root) + fl;
    constexpr int kRowBytes = T::kFrames;  // a byte a frame
    // 1. u0 = frozen ? +1 : the symbol of word N + i (rows 4j..4j+3 are one
    // Philox block, n >= 4; in bits mode row N + i of words_in)
    for (int j = q; 4 * j < n; j += kStep) {
      polar::PhiloxStream words(key, (uint32_t)f, call);
      for (int i = 4 * j; i < 4 * j + 4; ++i) {
        int8_t sym = 1;
        if (!__ldg(frozen + i)) {
          if (inject || bits) {
            if (live)
              sym = inject ? msg_in[(long long)i * b + f]
                           : (int8_t)(1 - 2 * (int)(
                                 words_in[(long long)(n + i) * b + f] & 1u));
          } else {
            sym = (int8_t)(1 - 2 * (int)(words.word(n + i) & 1u));
          }
        }
        soft_b[i * kRowBytes] = sym;
      }
    }
    __syncwarp();
    // 2. cw = T(u0); systematic: refreeze, T again. The count's reference
    // (u0 or cw) to device scratch.
    if (!SYS) {
      for (int r = t.r0; r < n; r += T::kPass) t.store(tx, r, t.at(t.soft, r));
      __syncwarp();
    }
    t.transform(t.soft, n);
    if (SYS) {
      for (int r = t.r0; r < n; r += T::kPass)
        if (__ldg(frozen + r)) t.at(t.soft, r) = s::splat<kVW>(s::kOnes);
      __syncwarp();
      t.transform(t.soft, n);
      for (int r = t.r0; r < n; r += T::kPass) t.store(tx, r, t.at(t.soft, r));
    }
    // 3. llr = quantize(cw + sigma * normal): rows i (radius word i) and
    // N/2 + i (angle word N/2 + i) of Box-Muller pair i (in bits mode rows i
    // and N/2 + i of words_in), into the root rows; the channel counters of
    // each live LLR
    const int h = n >> 1;
    for (int j = q; 4 * j < h; j += kStep) {
      polar::PhiloxStream radius_words(key, (uint32_t)f, call);
      polar::PhiloxStream angle_words(key, (uint32_t)f, call);
      for (int i = 4 * j; i < min(4 * j + 4, h); ++i) {
        float n0 = 0.0f, n1 = 0.0f;
        if (!inject && !bits) {
          polar::box_muller(radius_words.word(i), angle_words.word(h + i),
                            &n0, &n1);
        } else if (live && bits) {
          polar::box_muller(words_in[(long long)i * b + f],
                            words_in[(long long)(h + i) * b + f], &n0, &n1);
        } else if (live) {
          n0 = normals_in[(long long)i * b + f];
          n1 = normals_in[(long long)(h + i) * b + f];
        }
        const int rows[2] = {i, h + i};
        const float nz[2] = {n0, n1};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cwv = soft_b[rows[e] * kRowBytes];
          const int8_t l = polar::quantize((float)cwv, nz[e], sigma, scale);
          root_b[rows[e] * kRowBytes] = l;
          if (live) {
            cnt[3] += (l != 0) & ((l < 0) != (cwv < 0));
            cnt[4] += l == 0;
          }
        }
      }
    }
    __syncwarp();
    // 4. decode (every op ends with a warp barrier)
    t.decode(prog, n);
    // 5. the estimate against the reference at the info rows
    uint32_t live_mask[kVW];
    live_masks(t, batch, live_mask);
    count_info_rows<SYS>(t, info, k, tx, live_mask, cnt);
  }
  polar::store_block_counts(cnt, out);
}

// decode+count on the tile core: the cw track with the root LLRs in device
// memory and no message rows, soft, hard and cw stacks on chip (3 n bytes a
// frame)
using CountTile = polar::simd::Tile<polar::simd::kTileWR,
                                    polar::simd::kTileVW, true, false, false>;

__global__ void decode_count_tile_kernel(const uint8_t* __restrict__ prog,
                                         const int* __restrict__ info, int n,
                                         int k, int batch, const int8_t* llr,
                                         const int8_t* cw_in, int aligned,
                                         int* out) {
  extern __shared__ uint32_t smem[];
  using T = CountTile;
  using V = T::V;
  namespace s = polar::simd;
  constexpr int kVW = polar::simd::kTileVW;
  int cnt[polar::kCounters] = {0, 0, 0, 0, 0};
  T t;
  // a whole warp skips, and every warp counts below
  if (t.bind(smem, n, llr, nullptr, batch, aligned)) {
    t.decode(prog, n);
    uint32_t live_mask[kVW];
    live_masks(t, batch, live_mask);
    // the channel counters over every row: zero LLR bytes, and sign flips
    // (bit 7 of llr ^ cw) where the LLR is not 0
    for (int r = t.r0; r < n; r += T::kPass) {
      const V l = t.load(llr, r), c = t.load(cw_in, r);
#pragma unroll
      for (int v = 0; v < kVW; ++v) {
        const uint32_t z = __vcmpeq4(l.x[v], 0u) & live_mask[v];
        cnt[3] += __popc((l.x[v] ^ c.x[v]) & ~z & live_mask[v] & 0x80808080u);
        cnt[4] += __popc(z & s::kOnes);
      }
    }
    // the cw stack against the transmitted codeword, as the tile step
    count_info_rows<true>(t, info, k, cw_in, live_mask, cnt);
  }
  polar::store_block_counts(cnt, out);
}

__global__ void front_whole_kernel(const uint8_t* __restrict__ frozen, int n,
                                   int batch, float sigma, float scale,
                                   const int8_t* __restrict__ msg_in,
                                   const float* __restrict__ normals_in,
                                   uint32_t seed0, uint32_t seed1,
                                   uint32_t call, int8_t* llr_s,
                                   int8_t* cw_s) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= batch) return;
  const long long b = batch;
  const polar::Col c{cw_s + f, b};
  int cnt[polar::kCounters] = {0, 0, 0, 0, 0};  // unused here
  polar::mc_front(frozen, n, f, b, 1, sigma, scale, msg_in, normals_in,
                  nullptr, make_uint2(seed0, seed1), call, false, c, c,
                  polar::Col{llr_s + f, b}, cnt);
}

__global__ void decode_count_kernel(const uint8_t* __restrict__ prog,
                                    const uint8_t* __restrict__ frozen, int n,
                                    int batch, const int8_t* llr_s,
                                    const int8_t* cw_s, int8_t* soft,
                                    int8_t* hard, int8_t* mesg, int* out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  int cnt[polar::kCounters] = {0, 0, 0, 0, 0};
  if (f < batch) {
    const long long b = batch;
    // the inputs are only read; Col carries a mutable pointer
    const polar::Col llr{const_cast<int8_t*>(llr_s) + f, b};
    const polar::Col c{const_cast<int8_t*>(cw_s) + f, b};
    for (int i = 0; i < n; ++i) {
      const int l = llr[i], cwv = c[i];
      cnt[3] += (l != 0) & ((l < 0) != (cwv < 0));
      cnt[4] += l == 0;
    }
    const polar::Col s{soft + f, b}, m{mesg + f, b};
    polar::fastssc_decode(prog, n, llr, s, polar::Col{hard + f, b}, m);
    // the codeword estimate into the soft column, free after the decode
    polar::cw_counts(frozen, n, m, s, c, cnt);
  }
  polar::store_block_counts(cnt, out);
}

}  // namespace

// The tile step on `stream`: tiles of 8 frames, `warps` tiles a block,
// warps * 8 * n * (4 systematic, 3 plain) bytes of shared memory; n >= 4.
// info: the k info rows (int32, increasing). Inject, bits and native modes
// as polar_step's. Scratch: tx (n, batch) int8, the transmitted codeword
// (systematic) or u0 (plain); mesg (k, batch) int8 (plain mode only). out
// (blocks, 5) int32, blocks = ceil(ceil(batch / 8) / warps). aligned != 0:
// batch % 16 == 0 and tx and mesg start on 16-byte boundaries. Returns the
// CUDA error of the attribute call or of the launch.
extern "C" int polar_tile_step(const void* prog, const void* frozen,
                               const void* info, int n, int k, int batch,
                               int systematic, float sigma, float scale,
                               const void* msg, const void* normals,
                               const void* words, unsigned int seed0,
                               unsigned int seed1, unsigned int call, void* tx,
                               void* mesg, void* out, int warps, int aligned,
                               void* stream) {
  namespace s = polar::simd;
  const cudaStream_t st = (cudaStream_t)stream;
  return systematic
             ? s::launch_tiles<StepTile<true>>(
                   tile_step_kernel<true>, n, batch, warps, st, prog, frozen,
                   info, n, k, batch, sigma, scale, msg, normals, words,
                   seed0, seed1, call, tx, mesg, aligned, out)
             : s::launch_tiles<StepTile<false>>(
                   tile_step_kernel<false>, n, batch, warps, st, prog, frozen,
                   info, n, k, batch, sigma, scale, msg, normals, words,
                   seed0, seed1, call, tx, mesg, aligned, out);
}

// The walk on `stream`. Inject mode: msg (n, batch) int8 ±1 and normals
// (n, batch) float32; bits mode: words (2n, batch) u32, rows [0, n) the
// normals' (radius rows below n/2, angle rows above), rows [n, 2n) the
// message's; native mode: msg, normals and words null, words from Philox
// keyed by (seed0, seed1) with counter word 2 = call. Scratch u, c, llr,
// soft, hard (n, batch) and mesg (k, batch) int8; out (blocks, 5) int32.
// threads must be a multiple of 32, at most 1024. Returns cudaGetLastError().
extern "C" int polar_step(const void* prog, const void* frozen, int n,
                          int batch, int systematic, float sigma, float scale,
                          const void* msg, const void* normals,
                          const void* words, unsigned int seed0,
                          unsigned int seed1, unsigned int call, void* u,
                          void* c, void* llr,
                          void* soft, void* hard, void* mesg, void* out,
                          int threads, void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  mc_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)prog, (const uint8_t*)frozen, n, batch, systematic,
      sigma, scale, (const int8_t*)msg, (const float*)normals,
      (const uint32_t*)words, seed0, seed1, call, (int8_t*)u, (int8_t*)c,
      (int8_t*)llr, (int8_t*)soft,
      (int8_t*)hard, (int8_t*)mesg, (int*)out);
  return (int)cudaGetLastError();
}

// The systematic front on `stream`: llr and cw (n, batch) int8 out. Inject
// and native modes as polar_step's. Returns cudaGetLastError().
extern "C" int polar_front_whole(const void* frozen, int n, int batch,
                                 float sigma, float scale, const void* msg,
                                 const void* normals, unsigned int seed0,
                                 unsigned int seed1, unsigned int call,
                                 void* llr, void* cw, int threads,
                                 void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  front_whole_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frozen, n, batch, sigma, scale, (const int8_t*)msg,
      (const float*)normals, seed0, seed1, call, (int8_t*)llr, (int8_t*)cw);
  return (int)cudaGetLastError();
}

// Decode+count on the tile core on `stream`: tiles of 8 frames, `warps`
// tiles a block, warps * 8 * 3 n bytes of shared memory. llr and cw (n,
// batch) int8 in; info: the k info rows (int32, increasing); out (blocks,
// 5) int32 in polar_step's order, blocks = ceil(ceil(batch / 8) / warps).
// aligned != 0: batch % 16 == 0 and llr, cw start on 16-byte boundaries.
// Returns the CUDA error of the attribute call or of the launch.
extern "C" int polar_decode_count_tile(const void* prog, const void* info,
                                       int n, int k, int batch,
                                       const void* llr, const void* cw,
                                       void* out, int warps, int aligned,
                                       void* stream) {
  return polar::simd::launch_tiles<CountTile>(
      decode_count_tile_kernel, n, batch, warps, (cudaStream_t)stream, prog,
      info, n, k, batch, llr, cw, aligned, out);
}

// Decode+count on `stream`: llr and cw (n, batch) int8 in; scratch soft,
// hard (n, batch) and mesg (k, batch) int8; out (blocks, 5) int32 in
// polar_step's order. threads as polar_step's. Returns cudaGetLastError().
extern "C" int polar_decode_count(const void* prog, const void* frozen, int n,
                                  int batch, const void* llr, const void* cw,
                                  void* soft, void* hard, void* mesg,
                                  void* out, int threads, void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  decode_count_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)prog, (const uint8_t*)frozen, n, batch,
      (const int8_t*)llr, (const int8_t*)cw, (int8_t*)soft, (int8_t*)hard,
      (int8_t*)mesg, (int*)out);
  return (int)cudaGetLastError();
}
