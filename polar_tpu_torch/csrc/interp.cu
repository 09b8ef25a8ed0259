// Interpreter Fast-SSC decoder: a step program over a table of branches,
// one thread per frame.
//
// Replaces polar_tpu/ops/pallas/interp_kernel.py: make_interp_decoder
// (:409, _interp_kernel_entry :521 -> _interp_core :530 -> _run_program
// :163), make_interp_decode_count (:569) and make_interp_subtree (:687,
// _interp_subtree_kernel :667). The TPU kernel keeps the program in SMEM and
// dispatches each step through a pl.when chain over the branch table; here a
// thread reads each step word from device memory and switches on its
// branch's kind. Every frame runs the same words, so control flow is uniform
// across a warp, and one source serves every code and subtree level.
//
// The program (ops/cuda/interp_kernel.py:build_program): int32 words
// (pos >> kl) << 16 | branch, and per branch an int32 descriptor row
// {kind, level, safe, need_hard, cw, u, program offset, mask offset}. Chain
// ops act on one level's rows: f, g and g0 read the static pyramid slot of
// their level and write their child's; comb, comb0 and grate1 read and write
// hard / cw / u at the step's position p. A body decodes a whole node with
// fastssc_decode (its byte program and mask lie in the flat table): its
// input is its pyramid slot and its scratch the rows below (free: the
// pyramid is level-positional), its hard stack hard.rows(p). Its message
// lands compacted at u.rows(p) (or cw.rows(p) without u) and is expanded in
// place to the u domain, frozen rows +1; its codeword block is the
// transform of that segment (never its hard block, which differs where
// zero LLRs tie). grate1's codeword is T(T(hr)) for the same reason. `safe`
// only lets the TPU skip a no-op guard: qabs and madd guard every value.
//
// Layout: every array element-major (rows, B) int8 in device memory (Col);
// the soft pyramid has N rows, the root's LLRs are read where they lie. What
// bounds it on the card: like the whole-code decoder, the latency of one
// thread's dependent byte accesses to its columns, plus a word and a
// descriptor read per step (the same address in every thread: one
// broadcast). The last block is masked, so any B works without padding.

#include <cuda_runtime.h>

#include "mc.cuh"

namespace {

enum : int { kBody = 0, kF, kG, kG0, kComb, kComb0, kGrate1 };
constexpr int kDescCols = 8;

// Run the step program over one frame's columns. cw and u may have a null
// pointer (the track is off); a body needs one of them for its message.
__device__ void interp_run(const int* __restrict__ words, int n_steps,
                           const int* __restrict__ desc,
                           const uint8_t* __restrict__ table, int level,
                           int kl, polar::Col in, polar::Col pyr,
                           polar::Col hard, polar::Col cw, polar::Col u) {
  for (int i = 0; i < n_steps; ++i) {
    const int w = __ldg(words + i);
    const int p = (w >> 16) << kl;
    const int* d = desc + (w & 0xFFFF) * kDescCols;
    const int kind = __ldg(d), lv = __ldg(d + 1);
    const bool need_hard = __ldg(d + 3), do_cw = __ldg(d + 4),
               do_u = __ldg(d + 5);
    const polar::Col s = lv == level ? in : pyr.rows(1 << lv);  // the slot
    if (kind == kBody) {
      const int len = 1 << lv;
      const uint8_t* prog = table + __ldg(d + 6);
      const uint8_t* mask = table + __ldg(d + 7);
      const polar::Col m = do_u ? u.rows(p) : cw.rows(p);
      polar::fastssc_decode(prog, len, s, pyr, hard.rows(p), m);
      int k = 0;
      for (int r = 0; r < len; ++r) k += !__ldg(mask + r);
      for (int r = len - 1; r >= 0; --r)  // expand in place: k <= r
        m[r] = __ldg(mask + r) ? (int8_t)1 : m[--k];
      if (do_cw) {
        const polar::Col c = cw.rows(p);
        if (do_u)
          for (int r = 0; r < len; ++r) c[r] = m[r];
        polar::transform(c, len);
      }
      continue;
    }
    const int h = 1 << (lv - 1);
    const polar::Col child = pyr.rows(h);
    switch (kind) {
      case kF:
        for (int r = 0; r < h; ++r)
          child[r] = (int8_t)polar::prod(s[r], s[h + r]);
        break;
      case kG:
        for (int r = 0; r < h; ++r)
          child[r] = (int8_t)polar::madd(hard[p + r], s[r], s[h + r]);
        break;
      case kG0:
        for (int r = 0; r < h; ++r)
          child[r] = (int8_t)polar::sat8(s[r] + s[h + r]);
        break;
      case kComb:
        if (need_hard)
          for (int r = 0; r < h; ++r)
            hard[p + r] = (int8_t)(hard[p + r] * hard[p + h + r]);
        if (do_cw)
          for (int r = 0; r < h; ++r)
            cw[p + r] = (int8_t)(cw[p + r] * cw[p + h + r]);
        break;
      case kComb0:
        if (need_hard)
          for (int r = 0; r < h; ++r) hard[p + r] = hard[p + h + r];
        if (do_cw)
          for (int r = 0; r < h; ++r) cw[p + r] = cw[p + h + r];
        break;
      case kGrate1: {  // fused g, sign, combine, transform of the right half
        const bool keep = do_u || do_cw;
        const polar::Col t = do_u ? u.rows(p + h) : cw.rows(p + h);
        for (int r = 0; r < h; ++r) {
          const int hl = hard[p + r];
          const int hr = polar::signum(polar::madd(hl, s[r], s[h + r]));
          if (need_hard) {
            hard[p + r] = (int8_t)(hl * hr);
            hard[p + h + r] = (int8_t)hr;
          }
          if (keep) t[r] = (int8_t)hr;
        }
        if (do_u) polar::transform(t, h);  // u = T(hr)
        if (do_cw) {
          const polar::Col c = cw.rows(p + h);
          if (do_u) {
            for (int r = 0; r < h; ++r) c[r] = t[r];
          } else {
            polar::transform(c, h);
          }
          polar::transform(c, h);  // cw = T(T(hr))
          for (int r = 0; r < h; ++r)
            cw[p + r] = (int8_t)(cw[p + r] * c[r]);
        }
        break;
      }
      default:
        break;
    }
  }
}

// One frame's state: prefill, then the program.
__device__ void interp_frame(const int* words, int n_steps, const int* desc,
                             const uint8_t* table, int level, int kl,
                             int prefill, polar::Col in, polar::Col pyr,
                             polar::Col hard, polar::Col cw, polar::Col u) {
  const int n = 1 << level;
  if (prefill) {  // rate-0 nodes emit no step: their rows stay +1
    for (int r = 0; r < n; ++r) hard[r] = 1;
    if (cw.p != nullptr)
      for (int r = 0; r < n; ++r) cw[r] = 1;
    if (u.p != nullptr)
      for (int r = 0; r < n; ++r) u[r] = 1;
  }
  interp_run(words, n_steps, desc, table, level, kl, in, pyr, hard, cw, u);
}

// The decoder, whole code or one node: u (when on) gathered by `mask` into
// its first K rows, in place (k <= r).
__global__ void interp_decode_kernel(
    const int* __restrict__ words, int n_steps, const int* __restrict__ desc,
    const uint8_t* __restrict__ table, const uint8_t* __restrict__ mask,
    int level, int kl, int batch, int prefill, const int8_t* llr, int8_t* pyr,
    int8_t* hard, int8_t* cw, int8_t* u) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= batch) return;
  const long long b = batch;
  const polar::Col uc{u != nullptr ? u + f : nullptr, b};
  interp_frame(words, n_steps, desc, table, level, kl, prefill,
               polar::Col{const_cast<int8_t*>(llr) + f, b},
               polar::Col{pyr + f, b}, polar::Col{hard + f, b},
               polar::Col{cw != nullptr ? cw + f : nullptr, b}, uc);
  if (u != nullptr)
    for (int r = 0, k = 0; r < (1 << level); ++r)
      if (!__ldg(mask + r)) uc[k++] = uc[r];
}

// Decode on the codeword-estimate track, then the five counters against cw_t
// (csrc/step.cu decode_count_kernel's epilogue, on the cw track).
__global__ void interp_decode_count_kernel(
    const int* __restrict__ words, int n_steps, const int* __restrict__ desc,
    const uint8_t* __restrict__ table, const uint8_t* __restrict__ frozen,
    int level, int kl, int batch, int prefill, const int8_t* llr,
    const int8_t* cw_t, int8_t* pyr, int8_t* hard, int8_t* cw, int* out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  int cnt[polar::kCounters] = {0, 0, 0, 0, 0};
  if (f < batch) {  // no early return: every thread reaches the reduction
    const long long b = batch;
    const polar::Col in{const_cast<int8_t*>(llr) + f, b};
    const polar::Col ref{const_cast<int8_t*>(cw_t) + f, b};
    const polar::Col hat{cw + f, b};
    interp_frame(words, n_steps, desc, table, level, kl, prefill, in,
                 polar::Col{pyr + f, b}, polar::Col{hard + f, b}, hat,
                 polar::Col{nullptr, b});
    int frame_err = 0;
    for (int r = 0; r < (1 << level); ++r) {
      const int l = in[r], c = ref[r];
      cnt[3] += (l != 0) & ((l < 0) != (c < 0));
      cnt[4] += l == 0;
      if (__ldg(frozen + r)) continue;
      const int v = hat[r];
      const int e = v != c;
      cnt[0] += e;
      cnt[2] += v == 0;
      frame_err |= e;
    }
    cnt[1] = frame_err;
  }
  polar::store_block_counts(cnt, out);
}

int launch_decode(const void* words, int n_steps, const void* desc,
                  const void* table, const void* mask, int level, int kl,
                  int batch, int prefill, const void* llr, void* pyr,
                  void* hard, void* cw, void* u, int threads, void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  interp_decode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)words, n_steps, (const int*)desc, (const uint8_t*)table,
      (const uint8_t*)mask, level, kl, batch, prefill, (const int8_t*)llr,
      (int8_t*)pyr, (int8_t*)hard, (int8_t*)cw, (int8_t*)u);
  return (int)cudaGetLastError();
}

}  // namespace

// The whole-code decoder on `stream`. words (n_steps) and desc (branches x 8)
// int32, table and mask uint8 (mask = the code's frozen rows, which u is
// gathered by); llr (N, batch) in; scratch pyr, hard (N, batch); out cw and
// u (N, batch), either null when off; u's first K rows hold the message.
// prefill != 0 sets hard, cw and u to +1 first. All int8, element-major.
// Returns cudaGetLastError() after the launch.
extern "C" int polar_interp_decode(const void* words, int n_steps,
                                   const void* desc, const void* table,
                                   const void* mask, int level, int kl,
                                   int batch, int prefill, const void* llr,
                                   void* pyr, void* hard, void* cw, void* u,
                                   int threads, void* stream) {
  return launch_decode(words, n_steps, desc, table, mask, level, kl, batch,
                       prefill, llr, pyr, hard, cw, u, threads, stream);
}

// One hybrid node on `stream`: as polar_interp_decode with the node's
// program (root hard kept) and mask; hard (2^level, batch) is an output.
extern "C" int polar_interp_subtree(const void* words, int n_steps,
                                    const void* desc, const void* table,
                                    const void* mask, int level, int kl,
                                    int batch, int prefill, const void* llr,
                                    void* pyr, void* hard, void* cw, void* u,
                                    int threads, void* stream) {
  return launch_decode(words, n_steps, desc, table, mask, level, kl, batch,
                       prefill, llr, pyr, hard, cw, u, threads, stream);
}

// Decode+count on `stream`: the program on the cw track (no u), llr and cw_t
// (N, batch) int8 in, scratch pyr, hard, cw (N, batch) int8; frozen the
// code's mask; out (blocks, 5) int32 in csrc/step.cu's counter order.
// threads a multiple of 32, at most 1024. Returns cudaGetLastError().
extern "C" int polar_interp_decode_count(const void* words, int n_steps,
                                         const void* desc, const void* table,
                                         const void* frozen, int level, int kl,
                                         int batch, int prefill,
                                         const void* llr, const void* cw_t,
                                         void* pyr, void* hard, void* cw,
                                         void* out, int threads,
                                         void* stream) {
  const int blocks = (batch + threads - 1) / threads;
  interp_decode_count_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)words, n_steps, (const int*)desc, (const uint8_t*)table,
      (const uint8_t*)frozen, level, kl, batch, prefill, (const int8_t*)llr,
      (const int8_t*)cw_t, (int8_t*)pyr, (int8_t*)hard, (int8_t*)cw,
      (int*)out);
  return (int)cudaGetLastError();
}
