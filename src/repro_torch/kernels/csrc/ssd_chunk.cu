// Intra-chunk SSD of Mamba2 (the quadratic half of chunked state-space
// duality) for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas
// (body _kernel). Same function, per (batch*head bh, chunk c) of Q steps:
//   dA = dt * a;  cum = cumsum(dA);  L[i][j] = exp(cum_i - cum_j), i >= j
//   y      = (C B^T o L o dt_j) x          (Q, P)
//   states = (B o dt o exp(cum_end - cum))^T x   (N, P)
//   decay  = exp(cum_end)
// x (BH, nc, Q, P), dt (BH, nc, Q), a (BH,), B/C (BH, nc, Q, N) -> y
// (BH, nc, Q, P), states (BH, nc, N, P), decay (BH, nc).
//
// What bounds it on an H100: per chunk the lower triangle does Q(Q+1)/2 *
// 2(N+P) FLOPs on ~4Q(P+2N) bytes, so at Q = 256, N = 64..128 it is bound by
// float32 operations on the CUDA cores, not by bytes. What the design does:
// the TPU block holds the whole chunk, but the (Q, Q) score/decay matrix
// alone is 256 KB at Q = 256, above the 227 KB of shared memory, so the
// output rows are tiled instead. One CTA computes a 64-row x 64-column
// block of y for one chunk: it walks the column blocks from 0 to the
// diagonal (blocks above it are skipped, L is 0 there), builds the 64x64
// C B^T tile from 32-wide N slices in shared memory, scales it by L and
// dt_j into a shared M tile (exp is never taken above the diagonal: it
// overflows there, and inf * 0 would be NaN), and accumulates M x into a
// 4x4 register tile per thread. A second launch computes the states, one
// 64(N) x 64(P) tile per CTA contracted over all Q rows, and the decay.
// Each CTA builds its own cumsum of dA over the chunk, accumulated in
// double and rounded once (as the plain version's chunk_cumsum), so cum is
// the same value whatever order the lanes add in. One writer per output
// element and a fixed summation order: runs are bit-identical.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16: ty picks rows, tx columns
constexpr int kTile = 64;          // rows, columns, P and N tile width
constexpr int kK = 32;             // N slice of the C B^T contraction
constexpr int kPad = kK + 1;       // row stride of the N slices (no bank
                                   // conflict on the column-wise reads)
constexpr int kM = kTile + 1;      // row stride of the M tile

// cum[0..n) = the float32 rounding of the double prefix sums of dt[q] * a,
// with dts[0..n) = dt. Run by warp 0: each lane sums a contiguous segment,
// the segment totals are scanned across the warp, then each lane writes
// its segment's prefixes.
__device__ void chunk_cumsum(const float* __restrict__ dt, float a, int n,
                             float* cum, float* dts) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n);
  const int hi = min(lo + per, n);
  double run = 0.0;
  for (int q = lo; q < hi; ++q) {
    const float v = dt[q];
    dts[q] = v;
    run += static_cast<double>(v * a);
  }
  double incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.0;
  for (int q = lo; q < hi; ++q) {
    acc += static_cast<double>(dts[q] * a);
    cum[q] = static_cast<float>(acc);
  }
}

// y of one (chunk, 64-row block, 64-column block of P).
__global__ void __launch_bounds__(kThreads)
ssd_chunk_y_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const float* __restrict__ bm,
                   const float* __restrict__ cm, float* __restrict__ y,
                   int nc, int Q, int P, int N, int n_rb, int n_pb) {
  extern __shared__ float smem[];
  float* cum = smem;                          // Q
  float* dts = cum + Q;                       // Q
  float* cs = dts + Q;                        // kTile x kPad: C slice
  float* bs = cs + kTile * kPad;              // kTile x kPad: B slice, then
  float* xs = bs;                             // kTile x kTile: x tile
  float* ms = bs + kTile * kTile;             // kTile x kM: M tile

  const int pb = blockIdx.x % n_pb;
  const int rb = (blockIdx.x / n_pb) % n_rb;
  const long chunk = blockIdx.x / (n_pb * n_rb);
  const long bh = chunk / nc;
  const float* xc = x + chunk * Q * P;
  const float* bc = bm + chunk * Q * N;
  const float* cc = cm + chunk * Q * N;
  float* yc = y + chunk * Q * P;
  const int r0 = rb * kTile;
  const int p0 = pb * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  if (threadIdx.x < 32) chunk_cumsum(dt + chunk * Q, a[bh], Q, cum, dts);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 <= r0; c0 += kTile) {   // up to the diagonal block
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kK) {
      for (int idx = threadIdx.x; idx < kTile * kK; idx += kThreads) {
        const int r = idx / kK, k = idx % kK, n = n0 + k;
        const int qi = r0 + r, qj = c0 + r;
        cs[r * kPad + k] = (qi < Q && n < N) ? cc[(long)qi * N + n] : 0.f;
        bs[r * kPad + k] = (qj < Q && n < N) ? bc[(long)qj * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = cs[(ty + 16 * i) * kPad + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * kPad + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
      __syncthreads();
    }
    // M = (C B^T) * L * dt_j on and below the diagonal, 0 above it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = c0 + tx + 16 * j;
        float m = 0.f;
        if (qj <= qi && qi < Q)
          m = s[i][j] * expf(cum[qi] - cum[qj]) * dts[qj];
        ms[(ty + 16 * i) * kM + tx + 16 * j] = m;
      }
    }
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int r = idx / kTile, p = idx % kTile;
      const int qj = c0 + r, pp = p0 + p;
      xs[r * kTile + p] = (qj < Q && pp < P) ? xc[(long)qj * P + pp] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      float mv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mv[i] = ms[(ty + 16 * i) * kM + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xs[k * kTile + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx + 16 * j;
      if (qi < Q && p < P) yc[(long)qi * P + p] = acc[i][j];
    }
  }
}

// states of one (chunk, 64-wide block of N, 64-wide block of P), and the
// chunk's decay from the CTA of the first (N, P) block.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_states_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const float* __restrict__ bm,
                        float* __restrict__ states, float* __restrict__ decay,
                        int nc, int Q, int P, int N, int n_nb, int n_pb) {
  extern __shared__ float smem[];
  float* cum = smem;                          // Q
  float* dts = cum + Q;                       // Q
  float* wq = dts + Q;                        // Q: dt * exp(cum_end - cum)
  float* ws = wq + Q;                         // kK x kTile: B * wq
  float* xs = ws + kK * kTile;                // kK x kTile: x

  const int pb = blockIdx.x % n_pb;
  const int nb = (blockIdx.x / n_pb) % n_nb;
  const long chunk = blockIdx.x / (n_pb * n_nb);
  const long bh = chunk / nc;
  const float* xc = x + chunk * Q * P;
  const float* bc = bm + chunk * Q * N;
  float* sc = states + chunk * N * P;
  const int n0 = nb * kTile;
  const int p0 = pb * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  if (threadIdx.x < 32) chunk_cumsum(dt + chunk * Q, a[bh], Q, cum, dts);
  __syncthreads();
  const float cum_end = cum[Q - 1];
  for (int q = threadIdx.x; q < Q; q += kThreads)
    wq[q] = dts[q] * expf(cum_end - cum[q]);
  if (nb == 0 && pb == 0 && threadIdx.x == 0) decay[chunk] = expf(cum_end);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += kK) {
    for (int idx = threadIdx.x; idx < kK * kTile; idx += kThreads) {
      const int k = idx / kTile, c = idx % kTile, q = q0 + k;
      const int n = n0 + c, p = p0 + c;
      ws[idx] = (q < Q && n < N) ? bc[(long)q * N + n] * wq[q] : 0.f;
      xs[idx] = (q < Q && p < P) ? xc[(long)q * P + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      float wv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = ws[k * kTile + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xs[k * kTile + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx + 16 * j;
      if (n < N && p < P) sc[(long)n * P + p] = acc[i][j];
    }
  }
}

cudaError_t allow_dynamic_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Enqueues the y launch and the states/decay launch on ``stream``. All
// pointers are contiguous float32 device arrays in the shapes above.
// Returns the CUDA error code of the first failure, or 0.
int ssd_chunk_launch(const void* x, const void* dt, const void* a,
                     const void* bm, const void* cm, void* y, void* states,
                     void* decay, int BH, int nc, int Q, int P, int N,
                     void* stream) {
  if (BH == 0 || nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rb = (Q + kTile - 1) / kTile;
  const int n_pb = (P + kTile - 1) / kTile;
  const int n_nb = (N + kTile - 1) / kTile;
  const long chunks = static_cast<long>(BH) * nc;
  if (chunks * n_rb * n_pb > INT_MAX || chunks * n_nb * n_pb > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);

  const size_t y_smem =
      sizeof(float) * (2 * Q + kTile * kPad + kTile * kTile + kTile * kM);
  cudaError_t err = allow_dynamic_smem(
      reinterpret_cast<const void*>(ssd_chunk_y_kernel), y_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_y_kernel<<<static_cast<int>(chunks * n_rb * n_pb), kThreads,
                       y_smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y), nc, Q, P, N,
      n_rb, n_pb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t st_smem = sizeof(float) * (3 * Q + 2 * kK * kTile);
  err = allow_dynamic_smem(
      reinterpret_cast<const void*>(ssd_chunk_states_kernel), st_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_states_kernel<<<static_cast<int>(chunks * n_nb * n_pb), kThreads,
                            st_smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<float*>(states), static_cast<float*>(decay), nc, Q, P, N,
      n_nb, n_pb);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
