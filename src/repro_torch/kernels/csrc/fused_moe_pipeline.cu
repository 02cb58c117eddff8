// Fused MoE pipeline for Hopper (sm_90a): gather -> grouped SwiGLU with
// dual-sparse minor-half skipping -> deterministic per-token combine.
//
// Replaces the TPU kernel src/repro/kernels/dualsparse_ffn.py::
// fused_moe_pipeline_pallas (streamed body _fused_pipeline_streamed_kernel,
// resident body _fused_pipeline_kernel; both compute the same function, so
// this one kernel serves either value of ``streamed``).
//
// What bounds it on an H100 (f32 weights, the only type the system serves):
//   * decode (T=8, Qwen3-30B-A3B widths): each touched expert streams
//     3 * 2048 * 768 * 4 B ~= 18.9 MB of weights for a handful of rows, so
//     the kernel is bound by device-memory bytes (3.35 TB/s);
//   * prefill (T~1024): ~64 rows per expert reuse each weight tile 64 times,
//     so the kernel is bound by f32 operations on the CUDA cores (67 TFLOP/s;
//     tensor cores take f32 only as TF32, which would change the numbers).
// What this simple design does about that: every weight tile is read once
// per (expert, row block) and reused from shared memory by all rows of the
// block; row blocks past an expert's rows exit before loading anything, and
// MAJOR-only row blocks stop the contraction at the minor half, so 2T-Drop's
// skipped work is never loaded or computed. What it does not do: no TMA, no
// wgmma, no software pipelining, no split-K for the few-row decode case.
// Those are later work.
//
// Three launches on the caller's stream, no atomics (the up and down tiles
// are swiglu_tiles.cuh's, in its pipeline row layout):
//   1. up:     h[pos, u]   = silu(x[tok[pos]] . w1[:, u]) * (x[tok[pos]] . w3[:, u])
//               over the virtual width V = P*f (sub-expert j = u / f), masked
//               per neuron: rows >= counts_full see only u < n_major;
//   2. down:    y[pos, c]   = combine[pos] * sum_u h[pos, u] * w2[u, c];
//   3. combine: out[t, c]   = sum of y[pos, c] over token t's computed
//               positions in increasing sorted order, from 0 (the order the
//               TPU kernel accumulates in), so runs are bit-identical.
// The (N', V) h and (N', d) y staging buffers are per sorted pair; positions
// no row block computes (capacity overflow, dropped pairs, padding) are never
// written and the combine order built by the wrapper excludes them.

#include <cuda_runtime.h>
#include <stddef.h>

#include "swiglu_tiles.cuh"

namespace {

using swiglu_tiles::Problem;

constexpr int COMBINE_THREADS = 256;

// out[t, c] = sum over i < cnt[t] of y[order[start[t] + i], c], in order.
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* y, const int* order, const int* start,
               const int* cnt, float* out, int d) {
  const int t = blockIdx.x;
  const int c = blockIdx.y * COMBINE_THREADS + threadIdx.x;
  if (c >= d) return;
  const int s = start[t];
  const int n = cnt[t];
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc += y[(size_t)order[s + i] * d + c];
  out[(size_t)t * d + c] = acc;
}

}  // namespace

extern "C" {

// Enqueues the three launches on ``stream``. Returns the cudaGetLastError()
// code after the first failing launch, or 0.
int fused_moe_pipeline_launch(
    const void* x, const void* w1, const void* w3, const void* w2,
    const void* group_offsets, const void* counts_full,
    const void* counts_major, const void* tok_sorted,
    const void* combine_sorted, void* h, void* y, const void* order,
    const void* tok_start, const void* tok_count, void* out, int T, int d,
    int f, int E, int P, int n_major, int capacity, void* stream) {
  Problem pb;
  pb.x = static_cast<const float*>(x);
  pb.w1 = static_cast<const float*>(w1);
  pb.w3 = static_cast<const float*>(w3);
  pb.w2 = static_cast<const float*>(w2);
  pb.offs = static_cast<const int*>(group_offsets);
  pb.cf = static_cast<const int*>(counts_full);
  pb.cm = static_cast<const int*>(counts_major);
  pb.tok = static_cast<const int*>(tok_sorted);
  pb.comb = static_cast<const float*>(combine_sorted);
  pb.h = static_cast<float*>(h);
  pb.y = static_cast<float*>(y);
  pb.d = d;
  pb.f = f;
  pb.P = P;
  pb.n_major = n_major;
  pb.n_tiles_sub = (f + swiglu_tiles::BN - 1) / swiglu_tiles::BN;
  pb.capacity = capacity;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cudaError_t err = swiglu_tiles::launch_swiglu<false>(pb, E, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T > 0) {
    const dim3 grid(T, (d + COMBINE_THREADS - 1) / COMBINE_THREADS);
    combine_kernel<<<grid, COMBINE_THREADS, 0, s>>>(
        static_cast<const float*>(y), static_cast<const int*>(order),
        static_cast<const int*>(tok_start), static_cast<const int*>(tok_count),
        static_cast<float*>(out), d);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

const char* fused_moe_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
