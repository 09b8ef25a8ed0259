// The Monte-Carlo counter epilogue alone: the five testbench counters
// (testbench.cc:185-192) over (llr_t, cw_t, hat_t) and the frozen mask.
//
// Replaces polar_tpu/ops/pallas/step_kernel.py:make_pallas_count (:544),
// body _count_kernel (:537) over _count_and_store (:182-222), in its
// cw-domain form: at the info rows, hat != cw is an uncorrected error and
// hat == 0 an ambiguity erasure; a frame with any error is a frame error;
// over all rows, llr != 0 with a sign other than cw's is an AWGN error and
// llr == 0 a quantization erasure.
//
// One block owns 32 frames (threadIdx.x) and splits the rows among its
// threadIdx.y lanes, so a frame never spans two blocks: its any-error flag
// is an OR over the block's y lanes in shared memory, and no frame is
// counted twice. Each block writes its five partial sums to its own row of
// a (blocks, 5) int32 array that the wrapper sums: no atomics, so the counts
// are deterministic. What bounds it on the card: the three (N, B) byte
// streams from device memory (a warp reads one 32-byte sector per row of
// each array); the arithmetic is a few compares per byte.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCounters = 5;
constexpr int kFrames = 32;   // blockDim.x
constexpr int kMaxLanes = 32; // blockDim.y at most

__global__ void count_kernel(const int8_t* __restrict__ llr,
                             const int8_t* __restrict__ cw,
                             const int8_t* __restrict__ hat,
                             const uint8_t* __restrict__ frozen, int n,
                             int batch, int* out) {
  const int f = blockIdx.x * kFrames + threadIdx.x;
  int err = 0, amb = 0, awgn = 0, qz = 0, ferr = 0;
  if (f < batch) {
    const long long b = batch;
    for (int r = threadIdx.y; r < n; r += blockDim.y) {
      const long long i = (long long)r * b + f;
      const int l = llr[i], c = cw[i];
      awgn += (l != 0) & ((l < 0) != (c < 0));
      qz += l == 0;
      if (!__ldg(frozen + r)) {
        const int h = hat[i];
        const int e = h != c;
        err += e;
        amb += h == 0;
        ferr |= e;
      }
    }
  }
  __shared__ int part[kCounters - 1][kMaxLanes][kFrames];
  __shared__ int flag[kMaxLanes][kFrames];
  const int x = threadIdx.x, y = threadIdx.y;
  part[0][y][x] = err;
  part[1][y][x] = amb;
  part[2][y][x] = awgn;
  part[3][y][x] = qz;
  flag[y][x] = ferr;
  __syncthreads();
  // fixed-order sums: first over y for each frame column, then over frames
  if (y == 0) {
    int s[kCounters - 1] = {0, 0, 0, 0}, any = 0;
    for (int j = 0; j < (int)blockDim.y; ++j) {
#pragma unroll
      for (int c = 0; c < kCounters - 1; ++c) s[c] += part[c][j][x];
      any |= flag[j][x];
    }
#pragma unroll
    for (int c = 0; c < kCounters - 1; ++c) part[c][0][x] = s[c];
    flag[0][x] = any;
  }
  __syncthreads();
  if (y == 0 && x < kCounters) {
    // out row: uncorrected, frame errors, ambiguity, awgn, quantization
    int s = 0;
    for (int j = 0; j < kFrames; ++j)
      s += x == 1 ? flag[0][j] : part[x == 0 ? 0 : x - 1][0][j];
    out[blockIdx.x * kCounters + x] = s;
  }
}

}  // namespace

// Launch on `stream`: llr, cw, hat (n, batch) int8 element-major, frozen
// (n,) uint8, out (ceil(batch / 32), 5) int32. lanes (1..32) threads share
// a frame's rows. Returns cudaGetLastError().
extern "C" int polar_count(const void* llr, const void* cw, const void* hat,
                           const void* frozen, int n, int batch, int lanes,
                           void* out, void* stream) {
  const int blocks = (batch + kFrames - 1) / kFrames;
  count_kernel<<<blocks, dim3(kFrames, lanes), 0, (cudaStream_t)stream>>>(
      (const int8_t*)llr, (const int8_t*)cw, (const int8_t*)hat,
      (const uint8_t*)frozen, n, batch, (int*)out);
  return (int)cudaGetLastError();
}
