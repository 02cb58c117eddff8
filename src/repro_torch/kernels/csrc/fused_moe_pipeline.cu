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
// Three launches on the caller's stream, no atomics:
//   1. up:      h[pos, u]   = silu(x[tok[pos]] . w1[:, u]) * (x[tok[pos]] . w3[:, u])
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

namespace {

constexpr int BN = 64;   // neuron (up) / output-column (down) tile
constexpr int BK = 16;   // contraction tile
constexpr int TN = 4;    // columns per thread
constexpr int COMBINE_THREADS = 256;

struct Problem {
  const float* x;       // (T, d)
  const float* w1;      // (E*P, d, f)
  const float* w3;      // (E*P, d, f)
  const float* w2;      // (E*P, f, d)
  const int* offs;      // (E,) start of each expert's run of sorted positions
  const int* cf;        // (E,) FULL rows (clamped to capacity)
  const int* cm;        // (E,) MAJOR-only rows (clamped)
  const int* tok;       // (N',) source row of each sorted position
  const float* comb;    // (N',) combine weight of each sorted position
  float* h;             // (N', P*f) scratch
  float* y;             // (N', d) scratch
  int d;
  int f;                // neurons per sub-expert
  int P;                // sub-experts per expert
  int n_major;          // virtual neurons [0, n_major) are the MAJOR half
  int n_tiles_sub;      // ceil(f / BN)
};

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

template <int BM, int TM>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
up_kernel(Problem pb) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int j = blockIdx.x / pb.n_tiles_sub;
  const int n0 = (blockIdx.x % pb.n_tiles_sub) * BN;
  const int c_f = pb.cf[e];
  const int n_rows = c_f + pb.cm[e];
  // a tile whose first neuron is MINOR serves only the FULL rows
  const int live = (j * pb.f + n0 < pb.n_major) ? n_rows : c_f;
  if (r0 >= live) return;
  const int base = pb.offs[e];
  const int V = pb.P * pb.f;

  __shared__ int toks[BM];
  __shared__ float As[BK][BM];
  __shared__ float B1s[BK][BN];
  __shared__ float B3s[BK][BN];

  const int tid = threadIdx.x;
  for (int i = tid; i < BM; i += NT) {
    const int r = r0 + i;
    toks[i] = r < live ? pb.tok[base + r] : -1;
  }
  __syncthreads();

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc1[TM][TN];
  float acc3[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      acc1[m][n] = 0.f;
      acc3[m][n] = 0.f;
    }
  }
  const size_t sub = (size_t)e * pb.P + j;
  const float* w1s = pb.w1 + sub * pb.d * pb.f;
  const float* w3s = pb.w3 + sub * pb.d * pb.f;

  for (int k0 = 0; k0 < pb.d; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int row = i / BK, k = k0 + i % BK;
      const int t = toks[row];
      As[i % BK][row] = (t >= 0 && k < pb.d) ? pb.x[(size_t)t * pb.d + k] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int k = k0 + kk, n = n0 + nn;
      const bool ok = k < pb.d && n < pb.f;
      B1s[kk][nn] = ok ? w1s[(size_t)k * pb.f + n] : 0.f;
      B3s[kk][nn] = ok ? w3s[(size_t)k * pb.f + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b1[TN], b3[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = As[kk][ty * TM + m];
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        b1[n] = B1s[kk][tx * TN + n];
        b3[n] = B3s[kk][tx * TN + n];
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          acc1[m][n] = fmaf(a[m], b1[n], acc1[m][n]);
          acc3[m][n] = fmaf(a[m], b3[n], acc3[m][n]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + ty * TM + m;
    if (r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int nl = n0 + tx * TN + n;
      if (nl >= pb.f) continue;
      const int u = j * pb.f + nl;
      const int rows_ok = u < pb.n_major ? n_rows : c_f;
      const float v = r < rows_ok ? silu(acc1[m][n]) * acc3[m][n] : 0.f;
      pb.h[(size_t)(base + r) * V + u] = v;
    }
  }
}

template <int BM, int TM>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
down_kernel(Problem pb) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int c_f = pb.cf[e];
  const int n_rows = c_f + pb.cm[e];
  if (r0 >= n_rows) return;
  const int base = pb.offs[e];
  const int V = pb.P * pb.f;
  // a row block with no FULL row never needs the MINOR half
  const int kend = r0 < c_f ? V : pb.n_major;

  __shared__ float Hs[BK][BM];
  __shared__ float Ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int row = i / BK, kk = i % BK;
      const int u = k0 + kk, r = r0 + row;
      const int rows_ok = u < pb.n_major ? n_rows : c_f;
      // entries no up-tile wrote are selected away, never multiplied
      Hs[kk][row] = (u < kend && r < rows_ok)
                        ? pb.h[(size_t)(base + r) * V + u] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int u = k0 + kk, c = c0 + nn;
      float w = 0.f;
      if (u < kend && c < pb.d) {
        const int j = u / pb.f;
        const int nl = u - j * pb.f;
        w = pb.w2[(((size_t)e * pb.P + j) * pb.f + nl) * pb.d + c];
      }
      Ws[kk][nn] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = Hs[kk][ty * TM + m];
#pragma unroll
      for (int n = 0; n < TN; ++n) b[n] = Ws[kk][tx * TN + n];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + ty * TM + m;
    if (r >= n_rows) continue;
    const float w = pb.comb[base + r];
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int c = c0 + tx * TN + n;
      if (c < pb.d) pb.y[(size_t)(base + r) * pb.d + c] = w * acc[m][n];
    }
  }
}

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

template <int BM, int TM>
cudaError_t launch_ffn(const Problem& pb, int E, int capacity,
                       cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const int row_blocks = (capacity + BM - 1) / BM;
  const dim3 up_grid(pb.P * pb.n_tiles_sub, row_blocks, E);
  up_kernel<BM, TM><<<up_grid, NT, 0, stream>>>(pb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 down_grid((pb.d + BN - 1) / BN, row_blocks, E);
  down_kernel<BM, TM><<<down_grid, NT, 0, stream>>>(pb);
  return cudaGetLastError();
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
  pb.n_tiles_sub = (f + BN - 1) / BN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  // few rows per expert (decode): short row blocks waste fewer FMAs
  cudaError_t err = capacity <= 16 ? launch_ffn<16, 1>(pb, E, capacity, s)
                                   : launch_ffn<64, 4>(pb, E, capacity, s);
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
