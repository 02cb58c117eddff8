// Grouped SwiGLU tiles with dual-sparse minor-half skipping, shared by the
// fused MoE pipeline (fused_moe_pipeline.cu) and the buffer-path grouped
// SwiGLU (grouped_swiglu.cu). They replace the expert FFN of the TPU
// kernels src/repro/kernels/dualsparse_ffn.py:192 grouped_swiglu_pallas
// (body :155) and :498 fused_moe_pipeline_pallas (bodies :282 and :353).
// Products and sums in float32 on the CUDA cores, no atomics: every
// output element has one writer and a fixed contraction order, so launches
// are bit-identical.
//
// The element type T of x, the weights and the h scratch is a template
// parameter: float, or __nv_bfloat16 (the S-ETP wire type, as the TPU
// kernels run it there). Operands are copied into shared memory in their
// own type (a 16-byte cp.async carries 4 floats or 8 bf16 values) and
// widened to float32 as they are multiplied; with bf16, h is rounded to
// bf16 before the down product, as the TPU kernels' h.astype(w2.dtype)
// does. The output rows stay float32 in both.
//
// Rows of group e (an expert, or an expert fused from P sub-experts) are
// "positions" base(e) + r for r < capacity:
//   * rows r < counts_full[e] use every neuron of the virtual width V = P*f
//     (sub-expert e*P + j holds neurons [j*f, (j+1)*f));
//   * rows in [counts_full, counts_full + counts_major) use only the MAJOR
//     neurons u < n_major;
//   * rows past both are dead: no tile computes them.
// Counts are clamped to the capacity here (cf + cm <= C), as the host-side
// clamp would.
//
// Two row layouts, chosen at compile time (kBuffer):
//   * pipeline (false): base(e) = offs[e], the input row of position p is
//     x[tok[p]], and the down tile writes comb[p] * row into y[p]; positions
//     of dead rows are never written (they belong to the next group);
//   * buffer (true): base(e) = e * capacity, x is the (E, C, d) buffer
//     itself, and the down tile writes the row unscaled into out[p]; dead
//     rows of the group are written as exact zeros.
//
// Two launches per row tile: up (h = silu(x.w1) * (x.w3), masked per neuron,
// into a (positions, V) scratch) and down (h . w2).
//
// What bounds them on an H100: the engines hand a group few live rows
// (decode ~1-4, the paged chunk ~3-4, a 128-token prefill-insert ~8), so
// each group streams 3 * d * V * 4 bytes of weights for a handful of rows:
// device-memory bytes (3.35 TB/s) bound those shapes. Only a full prefill
// (~45-64 rows per group) reuses each weight tile enough to be bound by
// float32 FMAs (67 TFLOP/s; the tensor cores would mean TF32).
//
// What the design does about it:
//   * A weight-streaming ring. One CTA owns a (group, neuron strip) in the
//     up launch and a (group, output-column strip) in the down launch and
//     walks the contraction in BK-deep steps through a STAGES-slot ring in
//     dynamic shared memory, filled by 16-byte cp.async copies (neighbouring
//     threads on neighbouring addresses) and drained with
//     cp.async.wait_group: the copies of the next STAGES-1 steps are in
//     flight while one step is multiplied. The group's gathered rows (x for
//     up, h for down) ride in the same ring slots. Each weight tile is
//     multiplied against all live rows of its row tile as it arrives, and
//     only threads that own a live row do FMAs.
//   * The row tile follows the live rows, not the capacity. Both tile
//     shapes are launched; each CTA reads its group's counts and leaves at
//     once when the group belongs to the other regime: groups with at most
//     FEW_ROWS live rows take the few-row tile (FEW_ROWS x BN, FEW_ROWS / 16
//     rows per thread), the others the many-row tile (MANY_ROWS x BN, a
//     4 x 4 register tile per thread, row blocks of MANY_ROWS). No host
//     sync.
//   * Widths that are not multiples of one 16-byte copy (4 floats, 8 bf16
//     values) or misaligned pointers take a scalar edge path in the same
//     kernels: 4-byte cp.async copies for float, plain loads for bf16
//     (cp.async copies no less than 4 bytes).
//   * The bf16 tile is the float tile with narrower copies (a row pitch of
//     BK + 8 keeps each ring row 16-byte aligned) and conversions at the
//     shared-memory reads: its bound is the bf16 tensor cores', which a
//     CUDA-core tile cannot approach.
//   * 2T-Drop's skipped work is never loaded: MINOR up strips leave for row
//     tiles with no FULL row, and row tiles with no FULL row stop the down
//     contraction at n_major.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace swiglu_tiles {
namespace {   // internal linkage: each library has its own copy

constexpr int BN = 64;         // neuron (up) / output-column (down) strip
constexpr int BK = 32;         // contraction step: one ring slot
constexpr int TN = 4;          // columns per thread
constexpr int NT = 256;        // threads per CTA, both tiles
constexpr int ROW_THREADS = NT / (BN / TN);   // threads down the rows: 16
constexpr int FEW_ROWS = 16;   // groups with <= FEW_ROWS live rows: few-row
constexpr int MANY_ROWS = 64;  // row block of the many-row tile

// elements of T in one 16-byte copy
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }

// row pitch of a ring slot's row tile: BK plus one 16-byte copy, so every
// row starts 16-byte aligned (float: BK + 4, as before bf16 existed)
template <typename T>
__host__ __device__ constexpr int lda() { return BK + vec_elems<T>(); }

// ring depth per (launch, tile): the few-row up tile keeps 4 float CTAs
// (56 KB each) on an SM, the others 2-5
__host__ __device__ constexpr int stages(bool up, int BM) {
  return up ? (BM == FEW_ROWS ? 3 : 4) : 4;
}

// CTAs per SM the register budget must allow (65536 / (NT * regs))
__host__ __device__ constexpr int min_ctas(bool up, int BM) {
  return BM == FEW_ROWS ? (up ? 2 : 4) : 2;
}

template <typename T>
__host__ __device__ constexpr int slot_elems(bool up, int BM) {
  return BM * lda<T>() + (up ? 2 : 1) * BK * BN;
}

template <typename T>
__host__ __device__ constexpr int smem_bytes(bool up, int BM) {
  return stages(up, BM) * slot_elems<T>(up, BM) * (int)sizeof(T);
}

template <typename T>
struct Problem {
  const T* x;           // (T, d) pipeline / (E*C, d) buffer
  const T* w1;          // (E*P, d, f)
  const T* w3;          // (E*P, d, f)
  const T* w2;          // (E*P, f, d)
  const int* offs;      // (E,) pipeline: first position of each group
  const int* cf;        // (E,) FULL rows
  const int* cm;        // (E,) MAJOR-only rows
  const int* tok;       // (N',) pipeline: input row of each position
  const float* comb;    // (N',) pipeline: combine weight of each position
  T* h;                 // (positions, P*f) scratch, in the weights' type
  float* y;             // (positions, d) output rows
  int* regime;          // (E,) or null: 1 few-row, 2 many-row tile served e
  int d;
  int f;                // neurons per sub-expert
  int P;                // sub-experts per group
  int n_major;          // virtual neurons [0, n_major) are the MAJOR half
  int n_tiles_sub;      // ceil(f / BN)
  int capacity;         // rows per group
  int vec;              // 16-byte copies (d, f multiples of one; aligned)
};

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// four consecutive elements of shared memory, widened to float32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// float32 -> T (bf16: round to nearest even, as torch's .to() rounds)
template <typename T>
__device__ __forceinline__ T narrow(float v);

template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// stores four consecutive elements (an aligned 16- or 8-byte store)
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0));
}

// one element of the scalar edge path: a 4-byte cp.async for float, a
// plain load for bf16 (visible to the ring's reader after the same
// barrier that orders the asynchronous copies)
__device__ __forceinline__ void copy_one(float* dst, const float* src,
                                         bool ok) {
  cp_async4(dst, src, ok);
}

__device__ __forceinline__ void copy_one(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <bool kBuffer, typename T>
__device__ __forceinline__ int group_base(const Problem<T>& pb, int e) {
  return kBuffer ? e * pb.capacity : pb.offs[e];
}

// FULL rows and live rows of group e, clamped to the capacity.
template <typename T>
__device__ __forceinline__ void group_rows(const Problem<T>& pb, int e,
                                           int* c_f, int* n_rows) {
  const int full = pb.cf[e];
  *c_f = min(full, pb.capacity);
  *n_rows = min(full + pb.cm[e], pb.capacity);
}

// The regime of a group: the few-row tile serves n_rows <= FEW_ROWS.
template <int BM>
__device__ __forceinline__ bool serves(int n_rows) {
  return BM == FEW_ROWS ? n_rows <= FEW_ROWS : n_rows > FEW_ROWS;
}

// Copies the BM x BK row tile of one ring slot: row i starts at element
// rowoff[i] of src (-1: a dead row, zero-filled); columns k0.. below kmax.
template <int BM, typename T>
__device__ __forceinline__ void load_rows(T* As, const T* src,
                                          const long long* rowoff, int k0,
                                          int kmax, bool vec, int tid) {
  constexpr int V = vec_elems<T>();
  constexpr int LD = lda<T>();
  if (vec) {
    for (int i = tid; i < BM * (BK / V); i += NT) {
      const int row = i / (BK / V), kq = V * (i % (BK / V));
      const long long o = rowoff[row];
      const bool ok = o >= 0 && k0 + kq < kmax;
      cp_async16(As + row * LD + kq, ok ? src + o + k0 + kq : src, ok);
    }
  } else {
    for (int i = tid; i < BM * BK; i += NT) {
      const int row = i / BK, kk = i % BK;
      const long long o = rowoff[row];
      const bool ok = o >= 0 && k0 + kk < kmax;
      copy_one(As + row * LD + kk, ok ? src + o + k0 + kk : src, ok);
    }
  }
}

// Copies a BK x BN weight tile: row kk is the contiguous run of BN elements
// at row_ptr(k0 + kk) + c0, present for k0 + kk < kmax, columns below cmax.
template <typename T, typename RowOffset>
__device__ __forceinline__ void load_weights(T* Bs, const T* w,
                                             RowOffset row_off, int k0,
                                             int kmax, int c0, int cmax,
                                             bool vec, int tid) {
  constexpr int V = vec_elems<T>();
  if (vec) {
    for (int i = tid; i < BK * (BN / V); i += NT) {
      const int kk = i / (BN / V), cq = V * (i % (BN / V));
      const int k = k0 + kk, c = c0 + cq;
      const bool ok = k < kmax && c < cmax;
      cp_async16(Bs + kk * BN + cq, ok ? w + row_off(k) + c : w, ok);
    }
  } else {
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, cc = i % BN;
      const int k = k0 + kk, c = c0 + cc;
      const bool ok = k < kmax && c < cmax;
      copy_one(Bs + kk * BN + cc, ok ? w + row_off(k) + c : w, ok);
    }
  }
}

template <int BM, int TM, bool kBuffer, typename T>
__global__ void __launch_bounds__(NT, min_ctas(true, BM))
up_kernel(Problem<T> pb) {
  constexpr int S = stages(true, BM);
  constexpr int SLOT = slot_elems<T>(true, BM);
  constexpr int LD = lda<T>();
  const int e = blockIdx.z;
  int c_f, n_rows;
  group_rows(pb, e, &c_f, &n_rows);
  if (!serves<BM>(n_rows)) return;
  if (pb.regime && blockIdx.x == 0 && blockIdx.y == 0)
    pb.regime[e] = BM == FEW_ROWS ? 1 : 2;
  const int r0 = blockIdx.y * BM;
  const int j = blockIdx.x / pb.n_tiles_sub;
  const int n0 = (blockIdx.x % pb.n_tiles_sub) * BN;
  // a strip whose first neuron is MINOR serves only the FULL rows
  const int live = (j * pb.f + n0 < pb.n_major) ? n_rows : c_f;
  if (r0 >= live) return;
  const int base = group_base<kBuffer>(pb, e);
  const int V = pb.P * pb.f;
  const bool vec = pb.vec != 0;

  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  __shared__ long long rowoff[BM];

  const int tid = threadIdx.x;
  for (int i = tid; i < BM; i += NT) {
    const int r = r0 + i;
    rowoff[i] = r < live
        ? (long long)(kBuffer ? base + r : pb.tok[base + r]) * pb.d : -1;
  }
  __syncthreads();

  const size_t sub = (size_t)e * pb.P + j;
  const T* w1s = pb.w1 + sub * pb.d * pb.f;
  const T* w3s = pb.w3 + sub * pb.d * pb.f;
  const int f = pb.f;
  auto w_row = [f](int k) { return (size_t)k * f; };
  auto load_slot = [&](int slot, int k0) {
    T* As = smem + slot * SLOT;
    load_rows<BM>(As, pb.x, rowoff, k0, pb.d, vec, tid);
    load_weights(As + BM * LD, w1s, w_row, k0, pb.d, n0, f, vec, tid);
    load_weights(As + BM * LD + BK * BN, w3s, w_row, k0, pb.d, n0, f, vec,
                 tid);
  };

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  // only threads that own a live row multiply
  const bool active = r0 + ty * TM < live;
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

  const int nk = (pb.d + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_slot(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    // the slot refilled here was read in step kt-1, which every thread has
    // finished: it passed the barrier above
    const int nxt = kt + S - 1;
    if (nxt < nk) load_slot(nxt % S, nxt * BK);
    cp_async_commit();
    if (!active) continue;
    const T* As = smem + (kt % S) * SLOT;
    const T* B1s = As + BM * LD;
    const T* B3s = B1s + BK * BN;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a4[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m)
        a4[m] = ld4(As + (ty * TM + m) * LD + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b1 = ld4(B1s + (k4 + q) * BN + tx * TN);
        const float4 b3 = ld4(B3s + (k4 + q) * BN + tx * TN);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float a = q == 0 ? a4[m].x : q == 1 ? a4[m].y
                        : q == 2 ? a4[m].z : a4[m].w;
          acc1[m][0] = fmaf(a, b1.x, acc1[m][0]);
          acc1[m][1] = fmaf(a, b1.y, acc1[m][1]);
          acc1[m][2] = fmaf(a, b1.z, acc1[m][2]);
          acc1[m][3] = fmaf(a, b1.w, acc1[m][3]);
          acc3[m][0] = fmaf(a, b3.x, acc3[m][0]);
          acc3[m][1] = fmaf(a, b3.y, acc3[m][1]);
          acc3[m][2] = fmaf(a, b3.z, acc3[m][2]);
          acc3[m][3] = fmaf(a, b3.w, acc3[m][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int nl0 = n0 + tx * TN;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + ty * TM + m;
    if (r >= n_rows) continue;
    float v[TN];
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int u = j * pb.f + nl0 + n;
      const int rows_ok = u < pb.n_major ? n_rows : c_f;
      v[n] = r < rows_ok ? silu(acc1[m][n]) * acc3[m][n] : 0.f;
    }
    T* hrow = pb.h + (size_t)(base + r) * V + j * pb.f;
    if (vec && nl0 + TN <= pb.f) {
      st4(hrow + nl0, v);
    } else {
#pragma unroll
      for (int n = 0; n < TN; ++n)
        if (nl0 + n < pb.f) hrow[nl0 + n] = narrow<T>(v[n]);
    }
  }
}

// Writes TN columns of output row r (buffer layout: exact zeros past the
// live rows; pipeline layout: scaled by the position's combine weight).
template <bool kBuffer, typename T>
__device__ __forceinline__ void store_row(const Problem<T>& pb, int base,
                                          int r, int c, bool live,
                                          const float* acc, bool vec) {
  float v[TN];
  const float w = (!kBuffer && live) ? pb.comb[base + r] : 1.f;
#pragma unroll
  for (int n = 0; n < TN; ++n) v[n] = live ? w * acc[n] : 0.f;
  float* yrow = pb.y + (size_t)(base + r) * pb.d;
  if (vec && c + TN <= pb.d) {
    st4(yrow + c, v);
  } else {
#pragma unroll
    for (int n = 0; n < TN; ++n)
      if (c + n < pb.d) yrow[c + n] = v[n];
  }
}

template <int BM, int TM, bool kBuffer, typename T>
__global__ void __launch_bounds__(NT, min_ctas(false, BM))
down_kernel(Problem<T> pb) {
  constexpr int S = stages(false, BM);
  constexpr int SLOT = slot_elems<T>(false, BM);
  constexpr int LD = lda<T>();
  const int e = blockIdx.z;
  int c_f, n_rows;
  group_rows(pb, e, &c_f, &n_rows);
  if (!serves<BM>(n_rows)) return;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int base = group_base<kBuffer>(pb, e);
  const int tid = threadIdx.x;
  const bool vec = pb.vec != 0;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int c = c0 + tx * TN;
  const float zeros[TN] = {0.f, 0.f, 0.f, 0.f};
  if (kBuffer) {
    // rows past this tile's block that no other CTA of the group covers:
    // the few-row tile owns the whole group, so it zeroes rows BM..C-1
    if (BM == FEW_ROWS) {
      for (int r = BM + ty; r < pb.capacity; r += ROW_THREADS)
        store_row<true>(pb, base, r, c, false, zeros, vec);
    }
    if (r0 >= n_rows) {      // a dead row block of the buffer: exact zeros
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int r = r0 + ty * TM + m;
        if (r < pb.capacity) store_row<true>(pb, base, r, c, false, zeros,
                                             vec);
      }
      return;
    }
  } else if (r0 >= n_rows) {
    return;
  }
  const int V = pb.P * pb.f;
  // a row tile with no FULL row never needs the MINOR half
  const int kend = r0 < c_f ? V : pb.n_major;

  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  __shared__ long long rowoff[BM];
  for (int i = tid; i < BM; i += NT) {
    const int r = r0 + i;
    rowoff[i] = r < n_rows ? (long long)(base + r) * V : -1;
  }
  __syncthreads();

  const int d = pb.d, f = pb.f;
  const size_t sub0 = (size_t)e * pb.P;
  // virtual neuron u lives in sub-expert e*P + u/f, row u%f
  auto w_row = [d, f, sub0](int u) {
    const int jj = u / f;
    return ((sub0 + jj) * f + (u - jj * f)) * (size_t)d;
  };
  auto load_slot = [&](int slot, int k0) {
    T* Hs = smem + slot * SLOT;
    load_rows<BM>(Hs, pb.h, rowoff, k0, V, vec, tid);
    load_weights(Hs + BM * LD, pb.w2, w_row, k0, kend, c0, d, vec, tid);
  };

  // per row, the neurons it may read: all for FULL rows, the MAJOR half for
  // MAJOR-only rows; entries past it were never written by an up tile and
  // are selected away, never multiplied
  int lim[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + ty * TM + m;
    lim[m] = r < c_f ? V : (r < n_rows ? pb.n_major : 0);
  }
  const bool active = r0 + ty * TM < n_rows;
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;
  }

  const int nk = (kend + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_slot(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int nxt = kt + S - 1;
    if (nxt < nk) load_slot(nxt % S, nxt * BK);
    cp_async_commit();
    if (!active) continue;
    const T* Hs = smem + (kt % S) * SLOT;
    const T* Ws = Hs + BM * LD;
    const int k0 = kt * BK;
    // steps wholly below n_major need no selection: every live row reads
    // them (dead rows arrive as zeros)
    const bool masked = k0 + BK > pb.n_major;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a4[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m)
        a4[m] = ld4(Hs + (ty * TM + m) * LD + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b = ld4(Ws + (k4 + q) * BN + tx * TN);
        const int u = k0 + k4 + q;
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          float a = q == 0 ? a4[m].x : q == 1 ? a4[m].y
                  : q == 2 ? a4[m].z : a4[m].w;
          if (masked && u >= lim[m]) a = 0.f;
          acc[m][0] = fmaf(a, b.x, acc[m][0]);
          acc[m][1] = fmaf(a, b.y, acc[m][1]);
          acc[m][2] = fmaf(a, b.z, acc[m][2]);
          acc[m][3] = fmaf(a, b.w, acc[m][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + ty * TM + m;
    if (kBuffer) {
      if (r < pb.capacity)
        store_row<true>(pb, base, r, c, r < n_rows, acc[m], vec);
    } else if (r < n_rows) {
      store_row<false>(pb, base, r, c, true, acc[m], vec);
    }
  }
}

template <int BM, int TM, bool kBuffer, typename T>
cudaError_t launch_tile(const Problem<T>& pb, int E, cudaStream_t stream,
                        bool up) {
  // the few-row tile owns its whole group: one row block
  const int row_blocks =
      BM == FEW_ROWS ? 1 : (pb.capacity + BM - 1) / BM;
  const int bytes = smem_bytes<T>(up, BM);
  // the dynamic shared-memory limit is raised once per kernel
  if (up) {
    static const cudaError_t set = cudaFuncSetAttribute(
        up_kernel<BM, TM, kBuffer, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    const dim3 grid(pb.P * pb.n_tiles_sub, row_blocks, E);
    up_kernel<BM, TM, kBuffer, T><<<grid, NT, bytes, stream>>>(pb);
  } else {
    static const cudaError_t set = cudaFuncSetAttribute(
        down_kernel<BM, TM, kBuffer, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    const dim3 grid((pb.d + BN - 1) / BN, row_blocks, E);
    down_kernel<BM, TM, kBuffer, T><<<grid, NT, bytes, stream>>>(pb);
  }
  return cudaGetLastError();
}

// True when every operand allows 16-byte copies: widths in multiples of
// one copy (4 floats, 8 bf16 values) and 16-byte-aligned base pointers.
template <typename T>
inline bool vector_ok(const Problem<T>& pb) {
  auto aligned = [](const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  constexpr int V = vec_elems<T>();
  return pb.d % V == 0 && pb.f % V == 0 && aligned(pb.x) &&
         aligned(pb.w1) && aligned(pb.w3) && aligned(pb.w2) &&
         aligned(pb.h) && aligned(pb.y);
}

// Up then down; each launches the few-row tile, and the many-row tile when
// the capacity can hold a group past FEW_ROWS rows. T is deduced from pb.
template <bool kBuffer, typename T>
cudaError_t launch_swiglu(Problem<T> pb, int E, cudaStream_t stream) {
  pb.vec = vector_ok(pb) ? 1 : 0;
  const bool many = pb.capacity > FEW_ROWS;
  for (int up = 1; up >= 0; --up) {
    constexpr int FEW_TM = FEW_ROWS / ROW_THREADS;
    constexpr int MANY_TM = MANY_ROWS / ROW_THREADS;
    cudaError_t err =
        launch_tile<FEW_ROWS, FEW_TM, kBuffer>(pb, E, stream, up);
    if (err != cudaSuccess) return err;
    if (many) {
      err = launch_tile<MANY_ROWS, MANY_TM, kBuffer>(pb, E, stream, up);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace swiglu_tiles
