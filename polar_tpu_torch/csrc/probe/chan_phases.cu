// Phase probe of the block front's kernel B (front.cu,
// front_chan_rows_kernel): the same kernel, native mode, word route,
// with parts of its work switched off, timed by CUDA events, so that the
// time of each part shows without a profiler's counters. Not part of the
// library (build.py compiles csrc/*.cu only); utils/front_probe.py builds
// and runs it:
//
//   front_probe [m] [batch] [blk]   (default 17 4096 1024)
//
// prints one line per variant: its name and ms a launch.
#include <cstdio>
#include <cstdlib>

#include "../front.cu"

namespace {

enum : int { kIo = 1, kDraw = 2, kStore = 4 };

// PARTS: kIo (load y, the XOR stages, store cw), kDraw (Philox,
// Box-Muller, quantize), kStore (the LLR stores; without them the LLRs are
// summed into one byte a lane, so the draw is not dropped).
template <int PARTS>
__global__ void __launch_bounds__(256) chan_phases(int n, int batch, int blk,
                                                  float sigma, float scale,
                                                  const int8_t* y,
                                                  int8_t* llr, int8_t* cw) {
  extern __shared__ uint32_t sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int h = n >> 1, P = min(blk, h), S = 2 * P, j0 = blockIdx.y * P;
  const Rows rows{j0, P, h};
  if (PARTS & kIo) {
    load_rows(y, rows, S, batch, 1, sm);
    xor_stages(sm, S, blk);
    store_rows(cw, rows, S, batch, 1, sm);
  } else {
    for (int l = threadIdx.x; l < S; l += blockDim.x)
      sm[l] = (uint32_t)l * 2654435761u ^ blockIdx.x;
    __syncthreads();
  }
  if (!(PARTS & kDraw)) return;
  const int f = blockIdx.x * 32 + lane;
  if (f >= batch) return;
  const long long b = batch;
  polar::PhiloxFrame ph(make_uint2(7u, 9u));
  ph.start((uint32_t)f, 0u);
  int sum = 0;
  for (int i0 = 4 * warp; i0 < P; i0 += 4 * nwarps) {
    const int j = j0 + i0;
    const uint4 vr = ph.block((uint32_t)(j >> 2));
    const uint4 va = ph.block((uint32_t)((h + j) >> 2));
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float n0, n1;
      polar::box_muller(pick(vr, t), pick(va, t), &n0, &n1);
      const int8_t q0 = polar::quantize(
          (sm[i0 + t] >> lane) & 1u ? -1.0f : 1.0f, n0, sigma, scale);
      const int8_t q1 = polar::quantize(
          (sm[P + i0 + t] >> lane) & 1u ? -1.0f : 1.0f, n1, sigma, scale);
      if (PARTS & kStore) {
        llr[(long long)(j + t) * b + f] = q0;
        llr[(long long)(h + j + t) * b + f] = q1;
      } else {
        sum += q0 + q1;
      }
    }
  }
  if (!(PARTS & kStore)) llr[(long long)blockIdx.y * b + f] = (int8_t)sum;
}

template <typename F>
float ms_per_launch(F launch, int reps) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int i = 0; i < reps; ++i) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  return ms / reps;
}

}  // namespace

int main(int argc, char** argv) {
  const int m = argc > 1 ? atoi(argv[1]) : 17;
  const int batch = argc > 2 ? atoi(argv[2]) : 4096;
  const int blk = argc > 3 ? atoi(argv[3]) : 1024;
  const int n = 1 << m, S = 2 * (blk < n / 2 ? blk : n / 2);
  if (batch % 32 || S < 8 || n % blk) {
    fprintf(stderr, "front_probe: batch a multiple of 32, 4 <= blk | n\n");
    return 2;
  }
  const long long ne = (long long)n * batch;
  int8_t *y, *llr, *cw;
  if (cudaMalloc(&y, ne) || cudaMalloc(&llr, ne) || cudaMalloc(&cw, ne)) {
    fprintf(stderr, "front_probe: cudaMalloc failed\n");
    return 1;
  }
  cudaMemset(y, 1, ne);
  const dim3 grid(batch / 32, n / S);
  const int threads = rows_threads(S), smem = 4 * S;
  const float sigma = 1.1885f, scale = 1.4159f;
  struct {
    const char* name;
    void (*kernel)(int, int, int, float, float, const int8_t*, int8_t*,
                   int8_t*);
  } variants[] = {
      {"io+draw+llr stores", chan_phases<kIo | kDraw | kStore>},
      {"io (load y, stages, store cw)", chan_phases<kIo>},
      {"draw+llr stores", chan_phases<kDraw | kStore>},
      {"draw", chan_phases<kDraw>},
  };
  printf("kernel B as built (polar_front_chan_rows, native) m=%d B=%d blk=%d: %.4f ms\n",
         m, batch, blk, ms_per_launch([&] {
           polar_front_chan_rows(n, batch, blk, sigma, scale, y, nullptr, 7u,
                                 9u, 0u, llr, cw, 1, nullptr);
         }, 10));
  for (const auto& v : variants)
    printf("probe %s: %.4f ms\n", v.name, ms_per_launch([&] {
             v.kernel<<<grid, threads, smem>>>(n, batch, blk, sigma, scale,
                                               y, llr, cw);
           }, 10));
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    fprintf(stderr, "front_probe: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
