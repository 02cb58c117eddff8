// Grouped SwiGLU tiles with dual-sparse minor-half skipping, shared by the
// fused MoE pipeline (fused_moe_pipeline.cu) and the buffer-path grouped
// SwiGLU (grouped_swiglu.cu). They replace the expert FFN of the TPU
// kernels src/repro/kernels/dualsparse_ffn.py:192 grouped_swiglu_pallas
// (body :155) and :498 fused_moe_pipeline_pallas (bodies :282 and :353).
// No atomics: every output element has one writer and a fixed contraction
// order, so launches are bit-identical.
//
// Two families of tiles, by the element type T of x, the weights and the h
// scratch:
//   * float: sums in float32 throughout. The few-row tile (up_kernel,
//     down_kernel) runs float32 FMAs on the CUDA cores; the many-row tile
//     (up_tf32_kernel, down_tf32_kernel) runs 3xTF32 products on the tensor
//     cores (mma.sync m16n8k8), ~1e-6 from a float32 product;
//   * __nv_bfloat16, the S-ETP wire type (up_mma_kernel, down_mma_kernel):
//     bf16 products summed in float32 on the tensor cores (mma.sync
//     m16n8k16), what the TPU kernels' jnp.dot(..., preferred_element_type
//     =f32) computes there; h is rounded to bf16 (RNE) before the down
//     product, as their h.astype(w2.dtype) does.
// The pipeline layout's output rows are float32 in both; the buffer layout
// writes its output in T (bf16: the float32 sums rounded once, to nearest
// even, the bits torch's .to(torch.bfloat16) gives).
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
//     itself, and the down tile writes the row unscaled into the output;
//     dead rows of the group are written as exact zeros.
//
// Two launches per row tile: up (h = silu(x.w1) * (x.w3), masked per neuron,
// into a (positions, V) scratch) and down (h . w2).
//
// What bounds them on an H100: the engines hand a group few live rows
// (decode ~1-4, the paged chunk ~3-4, a 128-token prefill-insert ~8), so
// each group streams 3 * d * V weights for a handful of rows: device-memory
// bytes (3.35 TB/s) bound those shapes. A full prefill (~45-64 rows per
// group at Qwen3-30B-A3B widths, 500-1500 at DBRX-132B's) reuses each
// weight tile enough to be bound by operations at the float32 tiles' rate:
// three TF32 passes at 495 TFLOP/s, FLOPs / 165 TFLOP/s (the CUDA cores'
// float32 FMAs would give 67); at the bf16 tensor cores' 989 TFLOP/s the
// prefill is bound by bytes.
//
// What the design does about it, in both families:
//   * A weight-streaming ring. One CTA owns a (group, neuron strip) in the
//     up launch and a (group, output-column strip) in the down launch and
//     walks the contraction in BK-deep steps through a ring of slots in
//     dynamic shared memory, filled by 16-byte cp.async copies (neighbouring
//     threads on neighbouring addresses) and drained with
//     cp.async.wait_group: the copies of the next stages-1 steps are in
//     flight while one step is multiplied. The group's gathered rows (x for
//     up, h for down) ride in the same ring slots. Each weight tile is
//     multiplied against all live rows of its row tile as it arrives.
//   * The row tile follows the live rows, not the capacity. Both tile
//     shapes are launched; each CTA reads its group's counts and leaves at
//     once when the group belongs to the other regime: groups with at most
//     FEW_ROWS live rows take the few-row tile (one block of FEW_ROWS rows),
//     the others the many-row tile (row blocks of MANY_ROWS). No host sync.
//   * Widths that are not multiples of one 16-byte copy (4 floats, 8 bf16
//     values) or misaligned pointers take a scalar edge path in the same
//     kernels: 4-byte cp.async copies for float, plain loads for bf16
//     (cp.async copies no less than 4 bytes).
//   * 2T-Drop's skipped work is never loaded: MINOR up strips leave for row
//     tiles with no FULL row, and row tiles with no FULL row stop the down
//     contraction at n_major.
//
// The float few-row tile: 64-wide strips, BK = 32, a 1 x 4 register tile
// per thread; only threads that own a live row do FMAs. Its shapes are
// bound by bytes, which the CUDA cores keep up with.
//
// The float many-row tile (3xTF32):
//   * Each float32 operand v is split as its fragment is read from shared
//     memory into big (v with the 13 low mantissa bits cleared, a TF32
//     value) and small = v - big; the tensor cores sum small.big + big.small
//     + big.big (tf32_mma.cuh), each pass over a warp's fragments before
//     the next, in a fixed k order. One TF32 pass would keep ~11 bits and
//     break the 1e-5 bar at d = 6144. The tensor cores' float32 adds round
//     toward zero, which biases a long sum, so they sum one ring step into
//     a zeroed fragment and float32 adds (round to nearest) carry the
//     steps' sums (tf32_step). Every warp
//     splits what it reads (the weight fragments are read by the four warps
//     down the rows): no second barrier per step, no split copy of the tile.
//   * Rows on the mma's M side, a warp per 16 rows of the 64-row block (4
//     warps down, 2 across the strip); warps with no live row skip their
//     products. Up: 128-neuron strips of w1 and of w3, 64 + 64 neurons a
//     warp; down: 128-column strips, 64 a warp.
//   * The ring: BK = 32 floats (128 B of each weight row) a step, 4 slots;
//     up 43 KB a slot, 1 CTA per SM (172 KB), down 26 KB, 2 CTAs per SM.
//     ldmatrix moves b16 elements and cannot transpose 32-bit ones, so the
//     fragments are read with 32-bit shared loads, and the pitches keep them
//     free of bank conflicts: the row tile's lda<float>() = 36 words (4 mod
//     32: lane (g, t) of the A fragment reads bank 4g + t), the weight
//     tile's TF32_LDB = 136 (8 mod 32: the B fragment reads bank 8t + g).
//   * The grid puts the row blocks fastest, so the CTAs that share a weight
//     strip run together and the strip comes from device memory once, not
//     once per row block (a DBRX-132B prefill group holds 8-24 of them).
//   * Rate on an H100 (700 W) at DBRX-132B widths: 42-47 TFLOP/s of float32
//     products, 125-142 TFLOP/s of TF32 mma: 40-45% of what mma.sync TF32
//     reaches from registers (316, tools/mma_sync_rate.py), ~28% of the
//     3xTF32 bound (165). wgmma and TMA are the next step.
//
// The bf16 tiles:
//   * Their ring moves as many bytes per step as the float one: BK = 64
//     bf16 values (128 B of each weight row, so the d = 2048 contraction
//     takes 32 steps), 128-neuron up strips (w1 and w3) and 128-column down
//     strips, 20-44 KB a slot. Up: 3 slots and 2 CTAs per SM for the
//     few-row tile, 4 slots and 1 CTA for the many-row tile; down (12 steps
//     at V = 768): 3 slots and 3 CTAs, or 4 slots and 2 CTAs, so that CTAs
//     overlap each other's first copies and epilogues. 70-150 KB of copies
//     are in flight on each SM. Every ring row is padded by 16 B, so the
//     eight rows one ldmatrix phase reads fall in distinct banks.
//   * Fragments come from ldmatrix on the ring slots: the weight tiles sit
//     k-major with neurons (columns) contiguous and take ldmatrix.trans; the
//     row tiles sit k-contiguous and take the plain form.
//   * The few-row tile (decode: 1-16 live rows) puts the weights on the
//     mma's 16-row M side and the rows on its N = 8 side (it computes
//     h^T = W^T x^T), so a padded row costs at most 7 slots of an 8-row
//     step; the many-row tile puts the rows on M, a warp per 16 rows, and
//     warps with no live row skip their products.
//   * Masking lives in the copies, never in a product (in the float
//     many-row tile too): every operand element a sum may not use (dead
//     rows, k past the width, the MINOR neurons a MAJOR-only row may not
//     read, which no up tile wrote) is zero-filled in shared memory through
//     cp.async's source size, so stale or uninitialised values (NaN or Inf:
//     NaN * 0 is NaN) never reach a product.
//   * wgmma is not used: at the bf16 rate every shape the engines hand
//     these tiles is bound by bytes, and mma.sync keeps up with the weight
//     stream.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

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
// row starts 16-byte aligned
template <typename T>
__host__ __device__ constexpr int lda() { return BK + vec_elems<T>(); }

// ring depth of the FMA tiles (the float few-row tile) per launch: 3 slots
// up, so that 4 up CTAs (56 KB each) fit an SM, 4 down
__host__ __device__ constexpr int stages(bool up) { return up ? 3 : 4; }

// CTAs per SM the register budget must allow (65536 / (NT * regs))
__host__ __device__ constexpr int min_ctas(bool up) { return up ? 2 : 4; }

template <typename T>
__host__ __device__ constexpr int slot_elems(bool up, int BM) {
  return BM * lda<T>() + (up ? 2 : 1) * BK * BN;
}

template <typename T>
__host__ __device__ constexpr int smem_bytes(bool up, int BM) {
  return stages(up) * slot_elems<T>(up, BM) * (int)sizeof(T);
}

// Y: the type of the output rows y, float32 except for the buffer layout
// on bf16 operands, which writes bf16
template <typename T, typename Y = float>
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
  Y* y;                 // (positions, d) output rows
  int* regime;          // (E,) or null: 1 few-row, 2 many-row tile served e
  int d;
  int f;                // neurons per sub-expert
  int P;                // sub-experts per group
  int n_major;          // virtual neurons [0, n_major) are the MAJOR half
  int n_tiles_sub;      // up strips per sub-expert (set by each launch)
  int capacity;         // rows per group
  int vec;              // 16-byte copies (d, f multiples of one; aligned)
};

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// four consecutive floats of shared memory
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// float32 -> T
template <typename T>
__device__ __forceinline__ T narrow(float v);

template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// stores four consecutive floats (an aligned 16-byte store)
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

template <bool kBuffer, typename T, typename Y>
__device__ __forceinline__ int group_base(const Problem<T, Y>& pb, int e) {
  return kBuffer ? e * pb.capacity : pb.offs[e];
}

// FULL rows and live rows of group e, clamped to the capacity.
template <typename T, typename Y>
__device__ __forceinline__ void group_rows(const Problem<T, Y>& pb, int e,
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

// The FMA tiles: float32 FMAs on the CUDA cores, TM rows per thread;
// launch_fma_tile runs them as the float few-row tile (BM = FEW_ROWS, TM =
// 1).
template <int BM, int TM, bool kBuffer, typename T>
__global__ void __launch_bounds__(NT, min_ctas(true))
up_kernel(Problem<T> pb) {
  constexpr int S = stages(true);
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
__global__ void __launch_bounds__(NT, min_ctas(false))
down_kernel(Problem<T> pb) {
  constexpr int S = stages(false);
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

// ---------------------------------------------------------------------------
// The bf16 tiles: bf16 products, float32 sums, on the tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// the bf16 tiles' problem: bf16 output rows in the buffer layout, float32
// rows (the combine's input) in the pipeline layout
template <bool kBuffer>
using MmaProblem =
    Problem<bf16, typename std::conditional<kBuffer, bf16, float>::type>;

constexpr int MMA_BK = 64;        // contraction step: 128 B of each row
constexpr int MMA_BN_UP = 128;    // neurons per up strip (of w1 and of w3)
constexpr int MMA_BN_DOWN = 128;  // output columns per down strip
constexpr int MMA_PAD = 8;        // 16 B of padding per ring row
constexpr int MMA_LDA = MMA_BK + MMA_PAD;   // row-tile pitch
constexpr int MMA_M = 16;         // many-row tile: rows per warp (mma M)
constexpr int MMA_N = 8;          // few-row tile: rows per mma (mma N)

__host__ __device__ constexpr int mma_bn(bool up) {
  return up ? MMA_BN_UP : MMA_BN_DOWN;
}

// weight-tile pitch (k-major, neurons or columns contiguous)
__host__ __device__ constexpr int mma_ldb(bool up) {
  return mma_bn(up) + MMA_PAD;
}

// ring depth: 3 slots for the few-row tiles, 4 for the many-row tiles
__host__ __device__ constexpr int mma_stages(int BM) {
  return BM == FEW_ROWS ? 3 : 4;
}

// CTAs per SM the shared memory holds (and the register budget must allow):
// up 2 few-row (~110 KB each) or 1 many-row (~175 KB); down 3 few-row
// (~60 KB) or 2 many-row (~105 KB)
__host__ __device__ constexpr int mma_min_ctas(bool up, int BM) {
  return up ? (BM == FEW_ROWS ? 2 : 1) : (BM == FEW_ROWS ? 3 : 2);
}

__host__ __device__ constexpr int mma_slot_elems(bool up, int BM) {
  return BM * MMA_LDA + (up ? 2 : 1) * MMA_BK * mma_ldb(up);
}

__host__ __device__ constexpr int mma_smem_bytes(bool up, int BM) {
  return mma_stages(BM) * mma_slot_elems(up, BM) * (int)sizeof(bf16);
}

// 232448 B of shared memory per CTA, 233472 per SM, 1 KB of each CTA's
// reserved by the system, ~1 KB of static rows tables
static_assert(mma_smem_bytes(true, MANY_ROWS) + 1024 <= 232448,
              "the many-row ring must fit one CTA's shared memory");
static_assert(mma_min_ctas(true, FEW_ROWS) *
                  (mma_smem_bytes(true, FEW_ROWS) + 2048) <= 233472 &&
              mma_min_ctas(false, FEW_ROWS) *
                  (mma_smem_bytes(false, FEW_ROWS) + 2048) <= 233472 &&
              mma_min_ctas(false, MANY_ROWS) *
                  (mma_smem_bytes(false, MANY_ROWS) + 2048) <= 233472,
              "the CTAs per SM must fit one SM's shared memory");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a 16-byte cp.async whose first n bytes come from src; the rest of the 16
// are zero-filled (n = 0: src is not read)
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}

// four 8 x 8 b16 matrices: lane l addresses row l % 8 of matrix l / 8, and
// r[q] receives matrix q (plain: thread t holds row t/4, columns 2(t%4) and
// 2(t%4)+1; trans: rows 2(t%4) and 2(t%4)+1 of column t/4)
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// acc (16 x 8, float32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float* acc, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// This lane's address for an x4 ldmatrix of fragments inside a ring slot.
// A (16 x 16) from a row tile (rows on M, k contiguous), plain form:
// matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15), the mma's A registers in order.
__device__ __forceinline__ const bf16* a_rows(const bf16* As, int row0,
                                              int k0, int lane) {
  return As + (row0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * MMA_LDA + k0 +
         ((lane >> 4) << 3);
}

// A (16 x 16) from a weight tile (k-major; neurons or columns on M), trans
// form: matrices (n 0-7, k 0-7), (n 8-15, k 0-7), (n 0-7, k 8-15),
// (n 8-15, k 8-15).
template <int LDB>
__device__ __forceinline__ const bf16* a_weights(const bf16* Bs, int n0,
                                                 int k0, int lane) {
  return Bs + (k0 + (lane & 7) + ((lane >> 4) << 3)) * LDB + n0 +
         (((lane >> 3) & 1) << 3);
}

// Two B (16 x 8) from a row tile (rows on N, k contiguous), plain form:
// r[0..1] rows 0-7, r[2..3] rows 8-15.
__device__ __forceinline__ const bf16* b_rows(const bf16* As, int k0,
                                              int lane) {
  return As + ((lane & 7) + ((lane >> 4) << 3)) * MMA_LDA + k0 +
         (((lane >> 3) & 1) << 3);
}

// Two B (16 x 8) from a weight tile (k-major; neurons or columns on N),
// trans form: r[0..1] n0..n0+7, r[2..3] n0+8..n0+15.
template <int LDB>
__device__ __forceinline__ const bf16* b_weights(const bf16* Bs, int n0,
                                                 int k0, int lane) {
  return Bs + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDB + n0 +
         ((lane >> 4) << 3);
}

// Copies the BM x MMA_BK row tile of one ring slot: row i from element
// rowoff[i] of src, columns k0.. below rowlim[i] (0: a dead row); every
// other element of the tile is zero-filled.
template <int BM>
__device__ __forceinline__ void mma_load_rows(bf16* As, const bf16* src,
                                              const long long* rowoff,
                                              const int* rowlim, int k0,
                                              bool vec, int tid) {
  constexpr int CH = MMA_BK / 8;    // 16-byte copies per row
  if (vec) {
    for (int i = tid; i < BM * CH; i += NT) {
      const int row = i / CH, kq = 8 * (i % CH);
      const int n = min(max(rowlim[row] - k0 - kq, 0), 8);
      cp_async16_n(As + row * MMA_LDA + kq,
                   n ? src + rowoff[row] + k0 + kq : src, 2 * n);
    }
  } else {
    for (int i = tid; i < BM * MMA_BK; i += NT) {
      const int row = i / MMA_BK, kk = i % MMA_BK;
      const bool ok = k0 + kk < rowlim[row];
      copy_one(As + row * MMA_LDA + kk,
               ok ? src + rowoff[row] + k0 + kk : src, ok);
    }
  }
}

// Copies an MMA_BK x BNW weight tile (pitch BNW + MMA_PAD): row kk is the
// run at w + row_off(k0 + kk) + c0, present for k0 + kk < kmax, columns
// below cmax; the rest zero-filled.
template <int BNW, typename RowOffset>
__device__ __forceinline__ void mma_load_weights(bf16* Bs, const bf16* w,
                                                 RowOffset row_off, int k0,
                                                 int kmax, int c0, int cmax,
                                                 bool vec, int tid) {
  constexpr int LDW = BNW + MMA_PAD;
  if (vec) {
    constexpr int CH = BNW / 8;
    for (int i = tid; i < MMA_BK * CH; i += NT) {
      const int kk = i / CH, cq = 8 * (i % CH);
      const int k = k0 + kk, c = c0 + cq;
      const bool ok = k < kmax && c < cmax;
      cp_async16(Bs + kk * LDW + cq, ok ? w + row_off(k) + c : w, ok);
    }
  } else {
    for (int i = tid; i < MMA_BK * BNW; i += NT) {
      const int kk = i / BNW, cc = i % BNW;
      const int k = k0 + kk, c = c0 + cc;
      const bool ok = k < kmax && c < cmax;
      copy_one(Bs + kk * LDW + cc, ok ? w + row_off(k) + c : w, ok);
    }
  }
}

// Walks nk contraction steps of KSTEP through an S-slot ring:
// load_slot(slot, k0) issues one step's copies, compute(slot) multiplies the
// step in a slot while the copies of the next S-1 steps are in flight.
template <int S, int KSTEP = MMA_BK, typename Load, typename Compute>
__device__ __forceinline__ void mma_ring(int nk, Load load_slot,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_slot(s, s * KSTEP);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    // the slot refilled here was read in step kt-1, which every thread has
    // finished: it passed the barrier above
    const int nxt = kt + S - 1;
    if (nxt < nk) load_slot(nxt % S, nxt * KSTEP);
    cp_async_commit();
    compute(kt % S);
  }
  cp_async_wait<0>();
}

template <int BM, bool kBuffer>
__global__ void __launch_bounds__(NT, mma_min_ctas(true, BM))
up_mma_kernel(MmaProblem<kBuffer> pb) {
  constexpr bool kFew = BM == FEW_ROWS;
  constexpr int SLOT = mma_slot_elems(true, BM);
  constexpr int LDB = mma_ldb(true);
  const int e = blockIdx.z;
  int c_f, n_rows;
  group_rows(pb, e, &c_f, &n_rows);
  if (!serves<BM>(n_rows)) return;
  if (pb.regime && blockIdx.x == 0 && blockIdx.y == 0)
    pb.regime[e] = kFew ? 1 : 2;
  const int r0 = blockIdx.y * BM;
  const int j = blockIdx.x / pb.n_tiles_sub;
  const int n0 = (blockIdx.x % pb.n_tiles_sub) * MMA_BN_UP;
  // a strip whose first neuron is MINOR serves only the FULL rows
  const int live = (j * pb.f + n0 < pb.n_major) ? n_rows : c_f;
  if (r0 >= live) return;
  const int base = group_base<kBuffer>(pb, e);
  const int V = pb.P * pb.f;
  const int f = pb.f;
  const bool vec = pb.vec != 0;

  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  __shared__ long long rowoff[BM];
  __shared__ int rowlim[BM];
  const int tid = threadIdx.x;
  for (int i = tid; i < BM; i += NT) {
    const int r = r0 + i;
    rowoff[i] = r < live
        ? (long long)(kBuffer ? base + r : pb.tok[base + r]) * pb.d : 0;
    rowlim[i] = r < live ? pb.d : 0;
  }
  __syncthreads();

  const size_t sub = (size_t)e * pb.P + j;
  const bf16* w1s = pb.w1 + sub * pb.d * f;
  const bf16* w3s = pb.w3 + sub * pb.d * f;
  auto w_row = [f](int k) { return (size_t)k * f; };
  auto load_slot = [&](int slot, int k0) {
    bf16* As = smem + slot * SLOT;
    bf16* B1s = As + BM * MMA_LDA;
    mma_load_rows<BM>(As, pb.x, rowoff, rowlim, k0, vec, tid);
    mma_load_weights<MMA_BN_UP>(B1s, w1s, w_row, k0, pb.d, n0, f, vec, tid);
    mma_load_weights<MMA_BN_UP>(B1s + MMA_BK * LDB, w3s, w_row, k0, pb.d,
                                n0, f, vec, tid);
  };
  const int nk = (pb.d + MMA_BK - 1) / MMA_BK;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, tig = lane & 3;   // the mma's row / column pair

  if constexpr (kFew) {
    // warp w: neurons [16w, 16w + 16) of w1 and of w3 on M; the rows on N,
    // one 8-row step per 8 live rows
    const int nw = 16 * warp;
    const bool active = n0 + nw < f;
    const int n_steps = (live + MMA_N - 1) / MMA_N;       // 1 or 2
    float acc1[2][4] = {}, acc3[2][4] = {};
    mma_ring<mma_stages(BM)>(nk, load_slot, [&](int slot) {
      if (!active) return;
      const bf16* As = smem + slot * SLOT;
      const bf16* B1s = As + BM * MMA_LDA;
      const bf16* B3s = B1s + MMA_BK * LDB;
#pragma unroll
      for (int ks = 0; ks < MMA_BK; ks += 16) {
        unsigned a1[4], a3[4], b[4];
        ldmatrix_x4_trans(a1, a_weights<LDB>(B1s, nw, ks, lane));
        ldmatrix_x4_trans(a3, a_weights<LDB>(B3s, nw, ks, lane));
        ldmatrix_x4(b, b_rows(As, ks, lane));
        mma_bf16(acc1[0], a1, b);
        mma_bf16(acc3[0], a3, b);
        if (n_steps > 1) {
          mma_bf16(acc1[1], a1, b + 2);
          mma_bf16(acc3[1], a3, b + 2);
        }
      }
    });
    // acc[s][i]: neuron nw + g + 8 (i / 2), row 8 s + 2 tig + i % 2
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = MMA_N * s + 2 * tig + (i & 1);
        const int nl = n0 + nw + g + ((i >> 1) << 3);
        if (r >= n_rows || nl >= f) continue;
        const int u = j * f + nl;
        const int rows_ok = u < pb.n_major ? n_rows : c_f;
        const float v = r < rows_ok ? silu(acc1[s][i]) * acc3[s][i] : 0.f;
        pb.h[(size_t)(base + r) * V + u] = __float2bfloat16_rn(v);
      }
    }
  } else {
    // warp w: rows [16 (w % 4), +16) on M, neurons [64 (w / 4), +64) of w1
    // and of w3 on N (8 steps of 8)
    const int rw = MMA_M * (warp & 3), nw = 64 * (warp >> 2);
    const bool active = r0 + rw < live && n0 + nw < f;
    float acc1[8][4] = {}, acc3[8][4] = {};
    mma_ring<mma_stages(BM)>(nk, load_slot, [&](int slot) {
      if (!active) return;
      const bf16* As = smem + slot * SLOT;
      const bf16* B1s = As + BM * MMA_LDA;
      const bf16* B3s = B1s + MMA_BK * LDB;
#pragma unroll
      for (int ks = 0; ks < MMA_BK; ks += 16) {
        unsigned a[4];
        ldmatrix_x4(a, a_rows(As, rw, ks, lane));
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          unsigned b1[4], b3[4];
          ldmatrix_x4_trans(b1, b_weights<LDB>(B1s, nw + 16 * p, ks, lane));
          ldmatrix_x4_trans(b3, b_weights<LDB>(B3s, nw + 16 * p, ks, lane));
          mma_bf16(acc1[2 * p], a, b1);
          mma_bf16(acc1[2 * p + 1], a, b1 + 2);
          mma_bf16(acc3[2 * p], a, b3);
          mma_bf16(acc3[2 * p + 1], a, b3 + 2);
        }
      }
    });
    // acc[s][i]: row rw + g + 8 (i / 2), neuron nw + 8 s + 2 tig + i % 2
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + rw + g + 8 * half;
        const int nl = n0 + nw + 8 * s + 2 * tig;
        if (r >= n_rows || nl >= f) continue;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int u = j * f + nl + q;
          const int rows_ok = u < pb.n_major ? n_rows : c_f;
          v[q] = r < rows_ok
              ? silu(acc1[s][2 * half + q]) * acc3[s][2 * half + q] : 0.f;
        }
        bf16* hp = pb.h + (size_t)(base + r) * V + j * f + nl;
        if (vec) {       // f a multiple of 8: an aligned pair inside the row
          *reinterpret_cast<__nv_bfloat162*>(hp) =
              __floats2bfloat162_rn(v[0], v[1]);
        } else {
          hp[0] = __float2bfloat16_rn(v[0]);
          if (nl + 1 < f) hp[1] = __float2bfloat16_rn(v[1]);
        }
      }
    }
  }
}

// Exact zeros into rows [z0, z1) of a buffer-layout output, in the BNW
// columns of the strip at c0.
template <int BNW, typename T, typename Y>
__device__ __forceinline__ void zero_rows(const Problem<T, Y>& pb, int base,
                                          int z0, int z1, int c0, int tid) {
  for (int i = tid; i < (z1 - z0) * BNW; i += NT) {
    const int r = z0 + i / BNW, c = c0 + i % BNW;
    if (c < pb.d) pb.y[(size_t)(base + r) * pb.d + c] = narrow<Y>(0.f);
  }
}

// Writes columns c and c + 1 of output row r (pipeline: float32, scaled by
// the position's combine weight; buffer: in Y, exact zeros past the live
// rows).
template <bool kBuffer, typename T, typename Y>
__device__ __forceinline__ void store_pair(const Problem<T, Y>& pb, int base,
                                           int r, int c, bool live, float a0,
                                           float a1, bool vec) {
  const size_t at = (size_t)(base + r) * pb.d + c;
  if constexpr (kBuffer && std::is_same<Y, bf16>::value) {
    const float v0 = live ? a0 : 0.f, v1 = live ? a1 : 0.f;
    if (vec) {           // d a multiple of 8: an aligned pair
      *reinterpret_cast<__nv_bfloat162*>(pb.y + at) =
          __floats2bfloat162_rn(v0, v1);
    } else {
      pb.y[at] = __float2bfloat16_rn(v0);
      if (c + 1 < pb.d) pb.y[at + 1] = __float2bfloat16_rn(v1);
    }
  } else if constexpr (kBuffer) {
    const float v0 = live ? a0 : 0.f, v1 = live ? a1 : 0.f;
    if (vec) {           // d a multiple of 4: an aligned pair
      *reinterpret_cast<float2*>(pb.y + at) = make_float2(v0, v1);
    } else {
      pb.y[at] = v0;
      if (c + 1 < pb.d) pb.y[at + 1] = v1;
    }
  } else {
    const float w = pb.comb[base + r];
    if (vec) {
      *reinterpret_cast<float2*>(pb.y + at) = make_float2(w * a0, w * a1);
    } else {
      pb.y[at] = w * a0;
      if (c + 1 < pb.d) pb.y[at + 1] = w * a1;
    }
  }
}

template <int BM, bool kBuffer>
__global__ void __launch_bounds__(NT, mma_min_ctas(false, BM))
down_mma_kernel(MmaProblem<kBuffer> pb) {
  constexpr bool kFew = BM == FEW_ROWS;
  constexpr int SLOT = mma_slot_elems(false, BM);
  constexpr int LDB = mma_ldb(false);
  const int e = blockIdx.z;
  int c_f, n_rows;
  group_rows(pb, e, &c_f, &n_rows);
  if (!serves<BM>(n_rows)) return;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * MMA_BN_DOWN;
  const int base = group_base<kBuffer>(pb, e);
  const int tid = threadIdx.x;
  const bool vec = pb.vec != 0;
  if constexpr (kBuffer) {
    if (kFew || r0 >= n_rows) {
    // rows no tile of the group computes: a dead row block zeroes its own
    // rows, and the few-row tile, which owns the whole group, also rows
    // BM..C-1
      const int z0 = r0 >= n_rows ? r0 : r0 + BM;
      const int z1 = kFew ? pb.capacity : min(r0 + BM, pb.capacity);
      zero_rows<MMA_BN_DOWN>(pb, base, z0, z1, c0, tid);
    }
  }
  if (r0 >= n_rows) return;
  const int V = pb.P * pb.f;
  const int d = pb.d, f = pb.f;
  // a row tile with no FULL row never needs the MINOR half
  const int kend = r0 < c_f ? V : pb.n_major;

  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  __shared__ long long rowoff[BM];
  __shared__ int rowlim[BM];
  // per row, the neurons it may read: all for FULL rows, the MAJOR half for
  // MAJOR-only rows; the entries past it were never written by an up tile,
  // and the copy zero-fills them
  for (int i = tid; i < BM; i += NT) {
    const int r = r0 + i;
    rowoff[i] = r < n_rows ? (long long)(base + r) * V : 0;
    rowlim[i] = min(kend, r < c_f ? V : (r < n_rows ? pb.n_major : 0));
  }
  __syncthreads();

  const size_t sub0 = (size_t)e * pb.P;
  // virtual neuron u lives in sub-expert e*P + u/f, row u%f
  auto w_row = [d, f, sub0](int u) {
    const int jj = u / f;
    return ((sub0 + jj) * f + (u - jj * f)) * (size_t)d;
  };
  auto load_slot = [&](int slot, int k0) {
    bf16* Hs = smem + slot * SLOT;
    mma_load_rows<BM>(Hs, pb.h, rowoff, rowlim, k0, vec, tid);
    mma_load_weights<MMA_BN_DOWN>(Hs + BM * MMA_LDA, pb.w2, w_row, k0, kend,
                                  c0, d, vec, tid);
  };
  const int nk = (kend + MMA_BK - 1) / MMA_BK;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, tig = lane & 3;

  if constexpr (kFew) {
    // warp w: MT 16-column blocks of the strip on M; the rows on N, one
    // 8-row step per 8 live rows
    constexpr int MT = MMA_BN_DOWN / (16 * (NT / 32));
    const int cw = 16 * MT * warp;
    const bool active = c0 + cw < d;
    const int n_steps = (n_rows + MMA_N - 1) / MMA_N;     // 1 or 2
    float acc[MT][2][4] = {};
    mma_ring<mma_stages(BM)>(nk, load_slot, [&](int slot) {
      if (!active) return;
      const bf16* Hs = smem + slot * SLOT;
      const bf16* Ws = Hs + BM * MMA_LDA;
#pragma unroll
      for (int ks = 0; ks < MMA_BK; ks += 16) {
        unsigned b[4];
        ldmatrix_x4(b, b_rows(Hs, ks, lane));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned a[4];
          ldmatrix_x4_trans(a, a_weights<LDB>(Ws, cw + 16 * m, ks, lane));
          mma_bf16(acc[m][0], a, b);
          if (n_steps > 1) mma_bf16(acc[m][1], a, b + 2);
        }
      }
    });
    // acc[m][s][i]: column cw + 16 m + g + 8 (i / 2), row 8 s + 2 tig + i % 2
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = MMA_N * s + 2 * tig + (i & 1);
          const int c = c0 + cw + 16 * m + g + ((i >> 1) << 3);
          if (c >= d) continue;
          const size_t at = (size_t)(base + r) * d + c;
          if constexpr (kBuffer) {
            if (r < pb.capacity)
              pb.y[at] = __float2bfloat16_rn(r < n_rows ? acc[m][s][i] : 0.f);
          } else if (r < n_rows) {
            pb.y[at] = pb.comb[base + r] * acc[m][s][i];
          }
        }
      }
    }
  } else {
    // warp w: rows [16 (w % 4), +16) on M, half the strip's columns on N
    // (NS steps of 8)
    constexpr int NS = MMA_BN_DOWN / 16;
    const int rw = MMA_M * (warp & 3), cw = 8 * NS * (warp >> 2);
    const bool active = r0 + rw < n_rows && c0 + cw < d;
    float acc[NS][4] = {};
    mma_ring<mma_stages(BM)>(nk, load_slot, [&](int slot) {
      if (!active) return;
      const bf16* Hs = smem + slot * SLOT;
      const bf16* Ws = Hs + BM * MMA_LDA;
#pragma unroll
      for (int ks = 0; ks < MMA_BK; ks += 16) {
        unsigned a[4];
        ldmatrix_x4(a, a_rows(Hs, rw, ks, lane));
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          unsigned b[4];
          ldmatrix_x4_trans(b, b_weights<LDB>(Ws, cw + 16 * p, ks, lane));
          mma_bf16(acc[2 * p], a, b);
          mma_bf16(acc[2 * p + 1], a, b + 2);
        }
      }
    });
    // acc[s][i]: row rw + g + 8 (i / 2), column cw + 8 s + 2 tig + i % 2;
    // warps that skipped hold zeros: the buffer layout's dead rows
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + rw + g + 8 * half;
        const int c = c0 + cw + 8 * s + 2 * tig;
        if (c >= d || r >= (kBuffer ? pb.capacity : n_rows)) continue;
        store_pair<kBuffer>(pb, base, r, c, r < n_rows, acc[s][2 * half],
                            acc[s][2 * half + 1], vec);
      }
    }
  }
}

template <int BM, bool kBuffer>
cudaError_t launch_mma_tile(MmaProblem<kBuffer> pb, int E,
                            cudaStream_t stream, bool up) {
  // the few-row tile owns its whole group: one row block
  const int row_blocks =
      BM == FEW_ROWS ? 1 : (pb.capacity + BM - 1) / BM;
  const int bytes = mma_smem_bytes(up, BM);
  pb.n_tiles_sub = (pb.f + MMA_BN_UP - 1) / MMA_BN_UP;
  // the dynamic shared-memory limit is raised once per kernel
  if (up) {
    static const cudaError_t set = cudaFuncSetAttribute(
        up_mma_kernel<BM, kBuffer>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    const dim3 grid(pb.P * pb.n_tiles_sub, row_blocks, E);
    up_mma_kernel<BM, kBuffer><<<grid, NT, bytes, stream>>>(pb);
  } else {
    static const cudaError_t set = cudaFuncSetAttribute(
        down_mma_kernel<BM, kBuffer>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    const dim3 grid((pb.d + MMA_BN_DOWN - 1) / MMA_BN_DOWN, row_blocks, E);
    down_mma_kernel<BM, kBuffer><<<grid, NT, bytes, stream>>>(pb);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The float many-row tiles: 3xTF32 products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TF32_BN = 128;      // neurons per up strip (of w1 and of w3)
                                  // and output columns per down strip
constexpr int TF32_PAD = 8;       // weight-tile pitch: TF32_BN + 8 words
constexpr int TF32_LDB = TF32_BN + TF32_PAD;
constexpr int TF32_STAGES = 4;    // ring slots

// CTAs per SM the shared memory holds (and the register budget must allow):
// up 1 (~172 KB), down 2 (~104 KB each)
__host__ __device__ constexpr int tf32_min_ctas(bool up) {
  return up ? 1 : 2;
}

__host__ __device__ constexpr int tf32_slot_elems(bool up) {
  return MANY_ROWS * lda<float>() + (up ? 2 : 1) * BK * TF32_LDB;
}

__host__ __device__ constexpr int tf32_smem_bytes(bool up) {
  return TF32_STAGES * tf32_slot_elems(up) * (int)sizeof(float);
}

// lane (g, t) = (lane / 4, lane % 4) reads the A fragment at [row g][k t]
// (bank 4g + t) and the B fragment at [k t][column g] (bank 8t + g)
static_assert(lda<float>() % 32 == 4 && TF32_LDB % 32 == 8,
              "the fragment reads must be free of bank conflicts");
static_assert(TF32_BN == MMA_BN_DOWN, "zero_rows covers one down strip");
static_assert(tf32_smem_bytes(true) + 1024 <= 232448,
              "the up ring must fit one CTA's shared memory");
static_assert(tf32_min_ctas(false) * (tf32_smem_bytes(false) + 2048) <=
                  233472,
              "the down CTAs per SM must fit one SM's shared memory");

// Copies the MANY_ROWS x BK row tile of one ring slot: row i from element
// rowoff[i] of src, columns k0.. below rowlim[i] (0: a dead row); every
// other element of the tile is zero-filled.
__device__ __forceinline__ void tf32_load_rows(float* As, const float* src,
                                               const long long* rowoff,
                                               const int* rowlim, int k0,
                                               bool vec, int tid) {
  constexpr int LD = lda<float>();
  if (vec) {
    constexpr int CH = BK / 4;      // 16-byte copies per row
    for (int i = tid; i < MANY_ROWS * CH; i += NT) {
      const int row = i / CH, kq = 4 * (i % CH);
      const int n = min(max(rowlim[row] - k0 - kq, 0), 4);
      cp_async16_n(As + row * LD + kq, n ? src + rowoff[row] + k0 + kq : src,
                   4 * n);
    }
  } else {
    for (int i = tid; i < MANY_ROWS * BK; i += NT) {
      const int row = i / BK, kk = i % BK;
      const bool ok = k0 + kk < rowlim[row];
      cp_async4(As + row * LD + kk, ok ? src + rowoff[row] + k0 + kk : src,
                ok);
    }
  }
}

// Copies a BK x TF32_BN weight tile (pitch TF32_LDB): row kk is the run at
// w + row_off(k0 + kk) + c0, present for k0 + kk < kmax, columns below cmax;
// the rest zero-filled.
template <typename RowOffset>
__device__ __forceinline__ void tf32_load_weights(float* Bs, const float* w,
                                                  RowOffset row_off, int k0,
                                                  int kmax, int c0, int cmax,
                                                  bool vec, int tid) {
  if (vec) {
    constexpr int CH = TF32_BN / 4;
    for (int i = tid; i < BK * CH; i += NT) {
      const int kk = i / CH, cq = 4 * (i % CH);
      const int k = k0 + kk, c = c0 + cq;
      const bool ok = k < kmax && c < cmax;
      cp_async16(Bs + kk * TF32_LDB + cq, ok ? w + row_off(k) + c : w, ok);
    }
  } else {
    for (int i = tid; i < BK * TF32_BN; i += NT) {
      const int kk = i / TF32_BN, cc = i % TF32_BN;
      const int k = k0 + kk, c = c0 + cc;
      const bool ok = k < kmax && c < cmax;
      cp_async4(Bs + kk * TF32_LDB + cc, ok ? w + row_off(k) + c : w, ok);
    }
  }
}

// The A fragment (16 rows x 8 k) at (row0, k0) of a row tile, split: lane
// (g, t) holds rows g and g + 8 at k t and t + 4.
__device__ __forceinline__ void tf32_a(const float* As, int row0, int k0,
                                       int lane, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  constexpr int LD = lda<float>();
  const float* p = As + (row0 + (lane >> 2)) * LD + k0 + (lane & 3);
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * LD], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * LD + 4], big[3], small[3]);
}

// The NS B fragments (8 k x 8 columns each) at k0, columns n0 + 8 s, of a
// weight tile (k-major, columns contiguous), split: lane (g, t) holds
// column g at k t and t + 4.
template <int NS>
__device__ __forceinline__ void tf32_b(const float* Bs, int n0, int k0,
                                       int lane, uint32_t (&big)[NS][2],
                                       uint32_t (&small)[NS][2]) {
  const float* p = Bs + (k0 + (lane & 3)) * TF32_LDB + n0 + (lane >> 2);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    split_tf32(p[8 * s], big[s][0], small[s][0]);
    split_tf32(p[8 * s + 4 * TF32_LDB], big[s][1], small[s][1]);
  }
}

// acc[s] += A . B[s] for s < NS in 3xTF32: small.big, then big.small, then
// big.big, each pass over the NS fragments before the next, so the mmas
// that follow each other are independent
template <int NS>
__device__ __forceinline__ void mma3_tf32(float (&acc)[NS][4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          const uint32_t (&bb)[NS][2],
                                          const uint32_t (&bs)[NS][2]) {
#pragma unroll
  for (int s = 0; s < NS; ++s) mma_tf32(acc[s], as, bb[s]);
#pragma unroll
  for (int s = 0; s < NS; ++s) mma_tf32(acc[s], ab, bs[s]);
#pragma unroll
  for (int s = 0; s < NS; ++s) mma_tf32(acc[s], ab, bb[s]);
}

// One ring step of a warp: acc[s] += A (16 rows from row0, BK deep) . B (BK
// deep, columns n0 + 8 s .. + 8) for s < NS, in 3xTF32. The tensor cores
// add into their float32 accumulators rounding toward zero, which over a
// long contraction biases the sum (3.5e-5 at d = 2048, past the 1e-5 bar);
// so the step's products are summed on the tensor cores into a zeroed
// fragment, and that is added to acc with float32 adds that round to
// nearest.
template <int NS>
__device__ __forceinline__ void tf32_step(float (&acc)[NS][4],
                                          const float* As, int row0,
                                          const float* Bs, int n0,
                                          int lane) {
  float part[NS][4] = {};
#pragma unroll
  for (int ks = 0; ks < BK; ks += 8) {
    uint32_t ab[4], as[4], bb[NS][2], bs[NS][2];
    tf32_a(As, row0, ks, lane, ab, as);
    tf32_b(Bs, n0, ks, lane, bb, bs);
    mma3_tf32(part, ab, as, bb, bs);
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[s][i] += part[s][i];
  }
}

template <bool kBuffer>
__global__ void __launch_bounds__(NT, tf32_min_ctas(true))
up_tf32_kernel(Problem<float> pb) {
  constexpr int SLOT = tf32_slot_elems(true);
  constexpr int LD = lda<float>();
  const int e = blockIdx.z;
  int c_f, n_rows;
  group_rows(pb, e, &c_f, &n_rows);
  if (!serves<MANY_ROWS>(n_rows)) return;
  if (pb.regime && blockIdx.x == 0 && blockIdx.y == 0) pb.regime[e] = 2;
  // row blocks vary fastest: the CTAs of one weight strip run together
  const int r0 = blockIdx.x * MANY_ROWS;
  const int j = blockIdx.y / pb.n_tiles_sub;
  const int n0 = (blockIdx.y % pb.n_tiles_sub) * TF32_BN;
  // a strip whose first neuron is MINOR serves only the FULL rows
  const int live = (j * pb.f + n0 < pb.n_major) ? n_rows : c_f;
  if (r0 >= live) return;
  const int base = group_base<kBuffer>(pb, e);
  const int V = pb.P * pb.f;
  const int f = pb.f;
  const bool vec = pb.vec != 0;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ long long rowoff[MANY_ROWS];
  __shared__ int rowlim[MANY_ROWS];
  const int tid = threadIdx.x;
  for (int i = tid; i < MANY_ROWS; i += NT) {
    const int r = r0 + i;
    rowoff[i] = r < live
        ? (long long)(kBuffer ? base + r : pb.tok[base + r]) * pb.d : 0;
    rowlim[i] = r < live ? pb.d : 0;
  }
  __syncthreads();

  const size_t sub = (size_t)e * pb.P + j;
  const float* w1s = pb.w1 + sub * pb.d * f;
  const float* w3s = pb.w3 + sub * pb.d * f;
  auto w_row = [f](int k) { return (size_t)k * f; };
  auto load_slot = [&](int slot, int k0) {
    float* As = smem + slot * SLOT;
    float* B1s = As + MANY_ROWS * LD;
    tf32_load_rows(As, pb.x, rowoff, rowlim, k0, vec, tid);
    tf32_load_weights(B1s, w1s, w_row, k0, pb.d, n0, f, vec, tid);
    tf32_load_weights(B1s + BK * TF32_LDB, w3s, w_row, k0, pb.d, n0, f, vec,
                      tid);
  };
  const int nk = (pb.d + BK - 1) / BK;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, tig = lane & 3;   // the mma's row / column pair

  // warp w: rows [16 (w % 4), +16) on M, neurons [64 (w / 4), +64) of w1
  // and of w3 on N (8 fragments of 8)
  const int rw = MMA_M * (warp & 3), nw = 64 * (warp >> 2);
  const bool active = r0 + rw < live && n0 + nw < f;
  float acc1[8][4] = {}, acc3[8][4] = {};
  mma_ring<TF32_STAGES, BK>(nk, load_slot, [&](int slot) {
    if (!active) return;
    const float* As = smem + slot * SLOT;
    const float* B1s = As + MANY_ROWS * LD;
    tf32_step(acc1, As, rw, B1s, nw, lane);
    tf32_step(acc3, As, rw, B1s + BK * TF32_LDB, nw, lane);
  });
  // acc[s][i]: row rw + g + 8 (i / 2), neuron nw + 8 s + 2 tig + i % 2
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + rw + g + 8 * half;
      const int nl = n0 + nw + 8 * s + 2 * tig;
      if (r >= n_rows || nl >= f) continue;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int u = j * f + nl + q;
        const int rows_ok = u < pb.n_major ? n_rows : c_f;
        v[q] = r < rows_ok
            ? silu(acc1[s][2 * half + q]) * acc3[s][2 * half + q] : 0.f;
      }
      float* hp = pb.h + (size_t)(base + r) * V + j * f + nl;
      if (vec) {         // f a multiple of 4: an aligned pair inside the row
        *reinterpret_cast<float2*>(hp) = make_float2(v[0], v[1]);
      } else {
        hp[0] = v[0];
        if (nl + 1 < f) hp[1] = v[1];
      }
    }
  }
}

template <bool kBuffer>
__global__ void __launch_bounds__(NT, tf32_min_ctas(false))
down_tf32_kernel(Problem<float> pb) {
  constexpr int SLOT = tf32_slot_elems(false);
  constexpr int LD = lda<float>();
  const int e = blockIdx.z;
  int c_f, n_rows;
  group_rows(pb, e, &c_f, &n_rows);
  if (!serves<MANY_ROWS>(n_rows)) return;
  // row blocks vary fastest: the CTAs of one weight strip run together
  const int r0 = blockIdx.x * MANY_ROWS;
  const int c0 = blockIdx.y * TF32_BN;
  const int base = group_base<kBuffer>(pb, e);
  const int tid = threadIdx.x;
  const bool vec = pb.vec != 0;
  if (r0 >= n_rows) {     // a dead row block: buffer rows are exact zeros
    if (kBuffer)
      zero_rows<TF32_BN>(pb, base, r0, min(r0 + MANY_ROWS, pb.capacity), c0,
                         tid);
    return;
  }
  const int V = pb.P * pb.f;
  const int d = pb.d, f = pb.f;
  // a row tile with no FULL row never needs the MINOR half
  const int kend = r0 < c_f ? V : pb.n_major;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ long long rowoff[MANY_ROWS];
  __shared__ int rowlim[MANY_ROWS];
  // per row, the neurons it may read: all for FULL rows, the MAJOR half for
  // MAJOR-only rows; the entries past it were never written by an up tile,
  // and the copy zero-fills them
  for (int i = tid; i < MANY_ROWS; i += NT) {
    const int r = r0 + i;
    rowoff[i] = r < n_rows ? (long long)(base + r) * V : 0;
    rowlim[i] = min(kend, r < c_f ? V : (r < n_rows ? pb.n_major : 0));
  }
  __syncthreads();

  const size_t sub0 = (size_t)e * pb.P;
  // virtual neuron u lives in sub-expert e*P + u/f, row u%f
  auto w_row = [d, f, sub0](int u) {
    const int jj = u / f;
    return ((sub0 + jj) * f + (u - jj * f)) * (size_t)d;
  };
  auto load_slot = [&](int slot, int k0) {
    float* Hs = smem + slot * SLOT;
    tf32_load_rows(Hs, pb.h, rowoff, rowlim, k0, vec, tid);
    tf32_load_weights(Hs + MANY_ROWS * LD, pb.w2, w_row, k0, kend, c0, d,
                      vec, tid);
  };
  const int nk = (kend + BK - 1) / BK;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, tig = lane & 3;

  // warp w: rows [16 (w % 4), +16) on M, columns [64 (w / 4), +64) of the
  // strip on N (8 fragments of 8)
  const int rw = MMA_M * (warp & 3), cw = 64 * (warp >> 2);
  const bool active = r0 + rw < n_rows && c0 + cw < d;
  // two halves of 4 fragments a step: the 2 CTAs per SM allow 128
  // registers a thread
  float acc[2][4][4] = {};
  mma_ring<TF32_STAGES, BK>(nk, load_slot, [&](int slot) {
    if (!active) return;
    const float* Hs = smem + slot * SLOT;
    const float* Ws = Hs + MANY_ROWS * LD;
    tf32_step(acc[0], Hs, rw, Ws, cw, lane);
    tf32_step(acc[1], Hs, rw, Ws, cw + 32, lane);
  });
  // acc[s / 4][s % 4][i]: row rw + g + 8 (i / 2), column cw + 8 s + 2 tig
  // + i % 2; warps that skipped hold zeros: the buffer layout's dead rows
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + rw + g + 8 * half;
      const int c = c0 + cw + 8 * s + 2 * tig;
      if (c >= d || r >= (kBuffer ? pb.capacity : n_rows)) continue;
      const float* a = acc[s >> 2][s & 3];
      store_pair<kBuffer>(pb, base, r, c, r < n_rows, a[2 * half],
                          a[2 * half + 1], vec);
    }
  }
}

template <bool kBuffer>
cudaError_t launch_tf32_tile(Problem<float> pb, int E, cudaStream_t stream,
                             bool up) {
  const int row_blocks = (pb.capacity + MANY_ROWS - 1) / MANY_ROWS;
  const int bytes = tf32_smem_bytes(up);
  pb.n_tiles_sub = (pb.f + TF32_BN - 1) / TF32_BN;
  // the dynamic shared-memory limit is raised once per kernel
  if (up) {
    static const cudaError_t set = cudaFuncSetAttribute(
        up_tf32_kernel<kBuffer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (set != cudaSuccess) return set;
    const dim3 grid(row_blocks, pb.P * pb.n_tiles_sub, E);
    up_tf32_kernel<kBuffer><<<grid, NT, bytes, stream>>>(pb);
  } else {
    static const cudaError_t set = cudaFuncSetAttribute(
        down_tf32_kernel<kBuffer>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    const dim3 grid(row_blocks, (pb.d + TF32_BN - 1) / TF32_BN, E);
    down_tf32_kernel<kBuffer><<<grid, NT, bytes, stream>>>(pb);
  }
  return cudaGetLastError();
}

// The float few-row tile: the FMA kernels at BM = FEW_ROWS; it owns its
// whole group, one row block.
template <bool kBuffer>
cudaError_t launch_fma_tile(Problem<float> pb, int E, cudaStream_t stream,
                            bool up) {
  constexpr int TM = FEW_ROWS / ROW_THREADS;
  const int bytes = smem_bytes<float>(up, FEW_ROWS);
  pb.n_tiles_sub = (pb.f + BN - 1) / BN;
  // the dynamic shared-memory limit is raised once per kernel
  if (up) {
    static const cudaError_t set = cudaFuncSetAttribute(
        up_kernel<FEW_ROWS, TM, kBuffer, float>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    const dim3 grid(pb.P * pb.n_tiles_sub, 1, E);
    up_kernel<FEW_ROWS, TM, kBuffer, float><<<grid, NT, bytes, stream>>>(pb);
  } else {
    static const cudaError_t set = cudaFuncSetAttribute(
        down_kernel<FEW_ROWS, TM, kBuffer, float>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    const dim3 grid((pb.d + BN - 1) / BN, 1, E);
    down_kernel<FEW_ROWS, TM, kBuffer, float><<<grid, NT, bytes, stream>>>(
        pb);
  }
  return cudaGetLastError();
}

// True when every operand allows 16-byte copies: widths in multiples of
// one copy (4 floats, 8 bf16 values) and 16-byte-aligned base pointers.
template <typename T, typename Y>
inline bool vector_ok(const Problem<T, Y>& pb) {
  auto aligned = [](const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  constexpr int V = vec_elems<T>();
  return pb.d % V == 0 && pb.f % V == 0 && aligned(pb.x) &&
         aligned(pb.w1) && aligned(pb.w3) && aligned(pb.w2) &&
         aligned(pb.h) && aligned(pb.y);
}

// Up then down; each launches the few-row tile, and the many-row tile when
// the capacity can hold a group past FEW_ROWS rows: the mma.sync bf16 tiles
// for bf16; for float the FMA few-row tile and the 3xTF32 many-row tile. T
// and Y are deduced from pb.
template <bool kBuffer, typename T, typename Y>
cudaError_t launch_swiglu(Problem<T, Y> pb, int E, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  pb.vec = vector_ok(pb) ? 1 : 0;
  const bool many = pb.capacity > FEW_ROWS;
  for (int up = 1; up >= 0; --up) {
    cudaError_t err;
    if constexpr (kMma) {
      err = launch_mma_tile<FEW_ROWS, kBuffer>(pb, E, stream, up);
      if (err == cudaSuccess && many)
        err = launch_mma_tile<MANY_ROWS, kBuffer>(pb, E, stream, up);
    } else {
      err = launch_fma_tile<kBuffer>(pb, E, stream, up);
      if (err == cudaSuccess && many)
        err = launch_tf32_tile<kBuffer>(pb, E, stream, up);
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace swiglu_tiles
