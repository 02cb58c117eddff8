// Grouped SwiGLU tiles with dual-sparse minor-half skipping, shared by the
// fused MoE pipeline (fused_moe_pipeline.cu) and the buffer-path grouped
// SwiGLU (grouped_swiglu.cu). float32 on the CUDA cores, no atomics: every
// output element has one writer and a fixed contraction order.
//
// Rows of group e (an expert, or an expert fused from P sub-experts) are
// "positions" base(e) + r for r < capacity:
//   * rows r < counts_full[e] use every neuron of the virtual width V = P*f
//     (sub-expert e*P + j holds neurons [j*f, (j+1)*f));
//   * rows in [counts_full, counts_full + counts_major) use only the MAJOR
//     neurons u < n_major;
//   * rows past both are dead: no tile computes them.
// Counts arrive clamped to the capacity (counts_full + counts_major <= C).
//
// Two row layouts, chosen at compile time (kBuffer):
//   * pipeline (false): base(e) = offs[e], the input row of position p is
//     x[tok[p]], and the down tile writes comb[p] * row into y[p]; positions
//     of dead rows are never written (they belong to the next group);
//   * buffer (true): base(e) = e * capacity, x is the (E, C, d) buffer
//     itself, and the down tile writes the row unscaled into out[p]; dead
//     rows of the group are written as exact zeros.
//
// Two launches: up (h = silu(x.w1) * (x.w3), masked per neuron, into an
// (positions, V) scratch) and down (h . w2). A row block with no row that
// needs a tile exits before loading it: MINOR up tiles for blocks without a
// FULL row, and, in the down contraction, every k past n_major for them.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace swiglu_tiles {
namespace {   // internal linkage: each library has its own copy

constexpr int BN = 64;   // neuron (up) / output-column (down) tile
constexpr int BK = 16;   // contraction tile
constexpr int TN = 4;    // columns per thread

struct Problem {
  const float* x;       // (T, d) pipeline / (E*C, d) buffer
  const float* w1;      // (E*P, d, f)
  const float* w3;      // (E*P, d, f)
  const float* w2;      // (E*P, f, d)
  const int* offs;      // (E,) pipeline: first position of each group
  const int* cf;        // (E,) FULL rows
  const int* cm;        // (E,) MAJOR-only rows
  const int* tok;       // (N',) pipeline: input row of each position
  const float* comb;    // (N',) pipeline: combine weight of each position
  float* h;             // (positions, P*f) scratch
  float* y;             // (positions, d) output rows
  int d;
  int f;                // neurons per sub-expert
  int P;                // sub-experts per group
  int n_major;          // virtual neurons [0, n_major) are the MAJOR half
  int n_tiles_sub;      // ceil(f / BN)
  int capacity;         // rows per group
};

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

template <bool kBuffer>
__device__ __forceinline__ int group_base(const Problem& pb, int e) {
  return kBuffer ? e * pb.capacity : pb.offs[e];
}

// FULL rows and live rows of group e.
__device__ __forceinline__ void group_rows(const Problem& pb, int e,
                                           int* c_f, int* n_rows) {
  *c_f = pb.cf[e];
  *n_rows = pb.cf[e] + pb.cm[e];
}

template <int BM, int TM, bool kBuffer>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
up_kernel(Problem pb) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int j = blockIdx.x / pb.n_tiles_sub;
  const int n0 = (blockIdx.x % pb.n_tiles_sub) * BN;
  int c_f, n_rows;
  group_rows(pb, e, &c_f, &n_rows);
  // a tile whose first neuron is MINOR serves only the FULL rows
  const int live = (j * pb.f + n0 < pb.n_major) ? n_rows : c_f;
  if (r0 >= live) return;
  const int base = group_base<kBuffer>(pb, e);
  const int V = pb.P * pb.f;

  __shared__ int toks[BM];
  __shared__ float As[BK][BM];
  __shared__ float B1s[BK][BN];
  __shared__ float B3s[BK][BN];

  const int tid = threadIdx.x;
  for (int i = tid; i < BM; i += NT) {
    const int r = r0 + i;
    toks[i] = r < live ? (kBuffer ? base + r : pb.tok[base + r]) : -1;
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

template <int BM, int TM, bool kBuffer>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
down_kernel(Problem pb) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  int c_f, n_rows;
  group_rows(pb, e, &c_f, &n_rows);
  const int base = group_base<kBuffer>(pb, e);
  const int tid = threadIdx.x;
  if (r0 >= n_rows) {
    if (kBuffer) {          // a dead row block of the buffer: exact zeros
      for (int i = tid; i < BM * BN; i += NT) {
        const int r = r0 + i / BN, c = c0 + i % BN;
        if (r < pb.capacity && c < pb.d)
          pb.y[(size_t)(base + r) * pb.d + c] = 0.f;
      }
    }
    return;
  }
  const int V = pb.P * pb.f;
  // a row block with no FULL row never needs the MINOR half
  const int kend = r0 < c_f ? V : pb.n_major;

  __shared__ float Hs[BK][BM];
  __shared__ float Ws[BK][BN];

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
    if (kBuffer) {
      if (r >= pb.capacity) continue;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int c = c0 + tx * TN + n;
        if (c < pb.d)
          pb.y[(size_t)(base + r) * pb.d + c] = r < n_rows ? acc[m][n] : 0.f;
      }
    } else {
      if (r >= n_rows) continue;
      const float w = pb.comb[base + r];
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int c = c0 + tx * TN + n;
        if (c < pb.d) pb.y[(size_t)(base + r) * pb.d + c] = w * acc[m][n];
      }
    }
  }
}

template <int BM, int TM, bool kBuffer>
cudaError_t launch_up_down(const Problem& pb, int E, cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const int row_blocks = (pb.capacity + BM - 1) / BM;
  const dim3 up_grid(pb.P * pb.n_tiles_sub, row_blocks, E);
  up_kernel<BM, TM, kBuffer><<<up_grid, NT, 0, stream>>>(pb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 down_grid((pb.d + BN - 1) / BN, row_blocks, E);
  down_kernel<BM, TM, kBuffer><<<down_grid, NT, 0, stream>>>(pb);
  return cudaGetLastError();
}

// Few rows per group (decode): short row blocks waste fewer FMAs.
template <bool kBuffer>
cudaError_t launch_swiglu(const Problem& pb, int E, cudaStream_t stream) {
  return pb.capacity <= 16 ? launch_up_down<16, 1, kBuffer>(pb, E, stream)
                           : launch_up_down<64, 4, kBuffer>(pb, E, stream);
}

}  // namespace
}  // namespace swiglu_tiles
