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
//     cores (wgmma m64nNk8), ~1e-6 from a float32 product;
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
//     dynamic shared memory: the copies of the next steps are in flight
//     while one step is multiplied. The FMA and bf16 tiles fill it with
//     16-byte cp.async copies (neighbouring threads on neighbouring
//     addresses) drained with cp.async.wait_group; the float many-row tile
//     with TMA and a producer warpgroup (below). The group's gathered rows
//     (x for up, h for down) ride in the same ring slots. Each weight tile
//     is multiplied against all live rows of its row tile as it arrives.
//   * The row tile follows the live rows, not the capacity. Both tile
//     shapes are launched; each CTA reads its group's counts and leaves at
//     once when the group belongs to the other regime: groups with at most
//     FEW_ROWS live rows take the few-row tile (one block of FEW_ROWS rows),
//     the others the many-row tile (row blocks of MANY_ROWS for bf16, of
//     TF32_ROWS for float). No host sync.
//   * Widths that are not multiples of one 16-byte copy (4 floats, 8 bf16
//     values) or misaligned pointers take a scalar edge path in the same
//     kernels: 4-byte cp.async copies for float (the float many-row tile's
//     weights too, in place of TMA), plain loads for bf16 (cp.async copies
//     no less than 4 bytes).
//   * 2T-Drop's skipped work is never loaded: MINOR up strips leave for row
//     tiles with no FULL row, and row tiles with no FULL row stop the down
//     contraction at n_major.
//
// The float few-row tile: 64-wide strips, BK = 32, a 1 x 4 register tile
// per thread; only threads that own a live row do FMAs. Its shapes are
// bound by bytes, which the CUDA cores keep up with.
//
// The float many-row tile (3xTF32 on wgmma), for sm_90a:
//   * Numerics. Each float32 operand v is split into big (v with its 13 low
//     mantissa bits cleared, a TF32 value) and small = v - big; the tensor
//     cores sum small.big + big.small + big.big (tf32_mma.cuh's split), in
//     a fixed k order, no atomics. One TF32 pass would keep ~11 bits and
//     break the 1e-5 bar at d = 6144. The tensor cores' float32 adds round
//     toward zero, which biases a long sum, so each ring stage (TF32_BK =
//     32 of the contraction) runs its three passes into a fragment that the
//     stage's first wgmma zeroes (scale-d 0), and float32 adds (round to
//     nearest) carry the stages' sums.
//   * Operands. wgmma takes a TF32 operand from shared memory only K-major,
//     and the weights sit (d, V) with neurons contiguous, so the tile
//     computes out^T = W^T . rows^T: the weights are the register A operand
//     (M = 64 neurons or output columns a consumer warpgroup), each
//     consumer reading its fragments from the swizzled weight tile and
//     splitting them in registers; the rows (gathered x for up, h for down,
//     contraction-contiguous) are the K-major shared-memory B operand, big
//     and small parts side by side. Fragment row g + 8 hh of warp wq is M
//     index tf32_m_index(wq, g, hh), so every fragment read of the swizzled
//     tile hits 32 distinct banks.
//   * Warp specialisation. 384 threads: a producer warpgroup (setmaxnreg
//     down to 56 registers: at 40 its loops spill) and two consumer
//     warpgroups (up to 224; at 208 the tile runs ~10% slower). Ring
//     of 4 stages of 48 KB (16 KB of weights: four 32 x 32 boxes; 16 KB of
//     rows, 16 KB of their small parts), 1 CTA per SM, full / ready / empty
//     mbarriers. The producer's first warp issues each stage by TMA under
//     the 128-byte swizzle, completing on the full barrier: lane 0 the
//     weight boxes, the lanes the rows in boxes of 32 (the buffer layout's
//     x and both layouts' h are contiguous by position; the pipeline's
//     gathered rows x[tok[p]] are copied by position into the y scratch by
//     position_key_kernel, which the down launches overwrite after);
//     out-of-bounds neurons, columns, k and rows arrive as zeros. Its
//     other three warps split each landed stage: they zero what a row may
//     not read and write each element's small part beside the tile; the
//     tensor cores read a TF32 operand's top 19 bits, so the row tile
//     itself is the big part (bit-identical to clearing its low bits, on
//     the card). Up: consumer 0 takes w1, consumer 1 w3, for one
//     64-neuron strip (consumer 1's sums reach consumer 0 through the ring
//     for the SwiGLU); down: the two take the halves of a 128-column strip.
//     Operands that do not allow 16-byte copies (odd widths, misaligned
//     pointers) take 4-byte cp.async copies by the issuer warp instead of
//     TMA, into the same layout.
//   * The wgmma width follows the live rows: a row block holds TF32_ROWS =
//     128 rows, and its CTA runs wgmma N = its live rows rounded up to
//     TF32_N_STEP = 32 (32, 64, 96 or 128), so mid-size groups (16-64 rows,
//     bound by bytes) spend no tensor time on dead rows and prefill groups
//     (hundreds of rows, bound by operations) reuse each weight tile 128
//     times.
//   * The grid puts the row blocks fastest, so the CTAs that share a weight
//     strip run together and the strip comes from device memory once, not
//     once per row block. Not persistent: a DBRX-132B prefill CTA runs ~200
//     stages, so a CTA's start (barrier set-up, the first TMA round trip)
//     costs ~1% of its time.
//   * What bounds it: three TF32 passes at 495 TFLOP/s (165 TFLOP/s of
//     float32 products) at prefill; each stage also moves 32 KB from L2
//     (16 KB of weights, 16 KB of rows) and its splitters' 32 KB through
//     shared memory beside the wgmmas' reads. Rate on an H100 (700 W) at
//     DBRX-132B widths: ~91 TFLOP/s of float32 products, ~270 TFLOP/s of
//     TF32 wgmma: ~55% of the 3xTF32 bound (wgmma TF32 from registers
//     reaches ~495 TFLOP/s at N = 128, tools/mma_sync_rate.py). The rows
//     come by TMA like the weights: copies that the producer's threads
//     issue and then wait on hold the tile to their latency (~43% of the
//     bound with cp.async gathers, ~17% slower than its own data path).
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
//   * Masking lives in the copies, never in a product: every operand
//     element a sum may not use (dead rows, k past the width, the MINOR
//     neurons a MAJOR-only row may not read, which no up tile wrote) is
//     zero-filled in shared memory through cp.async's source size (in the
//     float many-row tile: TMA's out-of-bounds fill, and the splitters
//     zero the rest before the stage is released), so stale or
//     uninitialised values (NaN or Inf: NaN * 0 is NaN) never reach a
//     product.
//   * wgmma is not used: at the bf16 rate every shape the engines hand
//     these tiles is bound by bytes, and mma.sync keeps up with the weight
//     stream.
#pragma once

#include <cuda.h>
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
  int n_pos;            // positions: rows of h and y (N' pipeline, E*C
                        // buffer)
  const T* xs;          // pipeline, float32 many-row tile: x's rows gathered
                        // by position (into the y scratch), else null
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
// columns of the strip at c0, by the CTA's THREADS threads.
template <int BNW, int THREADS = NT, typename T, typename Y>
__device__ __forceinline__ void zero_rows(const Problem<T, Y>& pb, int base,
                                          int z0, int z1, int c0, int tid) {
  for (int i = tid; i < (z1 - z0) * BNW; i += THREADS) {
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
// The float many-row tiles: 3xTF32 wgmma, fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int TF32_BK = 32;        // contraction step: one ring stage, 128 B
                                   // of every weight and row
constexpr int TF32_M = 64;         // wgmma M: the neurons (up) or output
                                   // columns (down) of a consumer warpgroup
constexpr int TF32_ROWS = 128;     // row block: the widest wgmma N
constexpr int TF32_N_STEP = 32;    // wgmma N follows the live rows by 32
constexpr int TF32_STAGES = 4;     // ring stages
constexpr int TF32_LOADERS = 128;  // the producer warpgroup: its first
constexpr int TF32_ISSUERS = 32;   // warp issues the copies, the other
                                   // three split the landed rows
constexpr int TF32_CONSUMERS = 256;   // two consumer warpgroups
constexpr int TF32_NT = TF32_LOADERS + TF32_CONSUMERS;
constexpr int TF32_PRODUCER_REGS = 56;    // setmaxnreg: the consumers
constexpr int TF32_CONSUMER_REGS = 224;   // take the producer's spares
constexpr int TF32_BOX = 32;       // floats in one 128-byte swizzled row
constexpr int TF32_BOX_BYTES = TF32_BK * 128;     // a TMA box: BK rows
constexpr int TF32_W_BYTES = 4 * TF32_BOX_BYTES;  // a stage's weight tile
constexpr int TF32_R_BYTES = TF32_ROWS * 128;     // its row tile, per part
constexpr int TF32_STAGE_BYTES = TF32_W_BYTES + 2 * TF32_R_BYTES;

// the ring's dynamic shared memory, 1 KB of it spent on aligning the ring
// to 1024 B (the period of the 128-byte swizzle)
__host__ __device__ constexpr int tf32_smem_bytes() {
  return TF32_STAGES * TF32_STAGE_BYTES + 1024;
}

// the barriers and the row tables: static shared memory
struct Tf32Shared {
  uint64_t full[TF32_STAGES];     // a stage's weights and rows landed
  uint64_t ready[TF32_STAGES];    // its rows split
  uint64_t empty[TF32_STAGES];    // both consumers left the stage
  int rowsrc[TF32_ROWS];          // each row's row of x or h (-1: dead)
  int rowlim[TF32_ROWS];          // the contraction it may read
};

static_assert(tf32_smem_bytes() + (int)sizeof(Tf32Shared) + 1024 <= 232448,
              "the ring must fit one CTA's shared memory");
// setmaxnreg only moves the registers the CTA was launched with (65536 /
// 384 a thread, rounded down to 8: 168): a consumer's increase waits
// forever for registers that no producer released
static_assert(TF32_PRODUCER_REGS * TF32_LOADERS +
                  TF32_CONSUMER_REGS * TF32_CONSUMERS <=
                  65536 / TF32_NT / 8 * 8 * TF32_NT,
              "setmaxnreg must stay within the CTA's launch registers");
static_assert(2 * TF32_M == 4 * TF32_BOX && TF32_BK * 4 == 128,
              "a stage holds four 32 x 32 boxes of weights");

// Byte offset of 16-byte chunk c (floats 4c..4c+3) of row r in a tile of
// 128-byte rows stored with TMA's 128-byte swizzle (the tile 1024-byte
// aligned): the chunk index XOR r % 8. Weight boxes are k rows of 32
// neurons or columns; row tiles are rows of 32 contraction elements.
__host__ __device__ constexpr int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// The M index (0..63: a neuron or output column of the consumer's strip)
// of fragment row g + 8 hh of warp wq: warps 2b and 2b + 1 read box b, at
// chunk 4 (g / 4) + hh + 2 (wq % 2), word g % 4 of its rows, so the 32
// lanes of every fragment read fall in 32 distinct banks.
__host__ __device__ constexpr int tf32_m_index(int wq, int g, int hh) {
  return TF32_BOX * (wq >> 1) + 4 * (4 * (g >> 2) + hh + 2 * (wq & 1)) +
         (g & 3);
}

// the wgmma N of a row block with this many live rows
__device__ __forceinline__ int tf32_width(int rows) {
  return min((rows + TF32_N_STEP - 1) / TF32_N_STEP * TF32_N_STEP,
             TF32_ROWS);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// arrives and adds tx bytes that the barrier's phase must also see land
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(tx) : "memory");
}

// waits for the phase of the given parity to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// the thread's shared-memory writes, seen by the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// A box of 32 x 32 floats from a 2D / 3D tensor map into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers at this point of the program: the compiler may not move
// their reads or writes across it (the wgmma operands are read and written
// asynchronously, between the issue and the wait).
template <int K>
__device__ __forceinline__ void pin(float (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int K>
__device__ __forceinline__ void pin(uint32_t (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// The shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: rows of 128 B, 8-row groups 1024 B apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x N, float32; N / 2 a thread) = a (64 x 8 TF32, registers) . B (8 x
// N TF32, shared memory, K-major) + (scale_d ? d : 0), one warpgroup.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void run(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
  }
};

// A consumer's ring: stage s at base + s * TF32_STAGE_BYTES holds the
// weight tile (four boxes), the row tile's big parts, its small parts.
struct Tf32Ring {
  char* base;
  uint64_t* full;
  uint64_t* ready;
  uint64_t* empty;
  __device__ __forceinline__ char* stage(int s) const {
    return base + s * TF32_STAGE_BYTES;
  }
};

// Aligns the ring and (thread 0) starts its barriers: a full barrier
// completes on the issuers' arrivals, thread 0's with the stage's bytes,
// and those bytes; a ready barrier on the splitters' arrivals; an empty
// barrier on the two consumers' 256. The caller syncs the CTA after.
__device__ __forceinline__ Tf32Ring tf32_ring(float4* smem, Tf32Shared& sh,
                                              int tid) {
  const uint32_t a = smem_u32(smem);
  Tf32Ring ring{reinterpret_cast<char*>(smem) + (((a + 1023) & ~1023u) - a),
                sh.full, sh.ready, sh.empty};
  if (tid == 0) {
    for (int s = 0; s < TF32_STAGES; ++s) {
      mbar_init(sh.full + s, TF32_ISSUERS + 1);
      mbar_init(sh.ready + s, TF32_LOADERS - TF32_ISSUERS);
      mbar_init(sh.empty + s, TF32_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return ring;
}

// cp.async's completion as an arrival on bar: the barrier's phase waits
// for every copy this thread issued before (the count holds the arrival)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// The producer warpgroup. Its first warp, the issuer, loads each stage
// once the consumers have left its slot: when every operand allows
// 16-byte copies, by TMA (issue_tma: lane 0 the weight boxes, the lanes the
// rows by position in boxes of 32, straight into the swizzled row tile;
// tx_bytes in all, out-of-bounds elements zeros), else by 4-byte cp.async
// copies (issue_copies). The other three warps, the
// splitters, wait for the stage to land, zero what a row may not read
// (dead rows, k past the width, the MINOR h of MAJOR-only rows: rowlim),
// and write each element's small part (v less v with its 13 low mantissa
// bits cleared) beside it; then release the stage to the consumers. The
// tensor cores read a TF32 operand's top 19 bits, so the row tile itself
// is the big part.
template <typename IssueTma, typename IssueCopies>
__device__ __forceinline__ void tf32_produce(
    const Tf32Ring& ring, int nk, int nsel, const int* rowlim, bool vec,
    int tx_bytes, int lt, IssueTma issue_tma, IssueCopies issue_copies) {
  // a stage's slot, once both consumers have left it
  auto slot_of = [&](int s) {
    const int slot = s % TF32_STAGES;
    if (s >= TF32_STAGES)
      mbar_wait(ring.empty + slot, (s / TF32_STAGES - 1) & 1);
    return slot;
  };
  // one loop a path, so that neither holds the other's registers
  if (lt < TF32_ISSUERS && vec) {
    for (int s = 0; s < nk; ++s) {
      const int slot = slot_of(s);
      if (lt == 0) mbar_arrive_tx(ring.full + slot, tx_bytes);
      __syncwarp();
      issue_tma(ring.stage(slot), s * TF32_BK, ring.full + slot, lt);
      mbar_arrive(ring.full + slot);
    }
  } else if (lt < TF32_ISSUERS) {
    for (int s = 0; s < nk; ++s) {
      const int slot = slot_of(s);
      if (lt == 0) mbar_arrive(ring.full + slot);
      issue_copies(ring.stage(slot), s * TF32_BK, lt);
      cp_async_arrive(ring.full + slot);
    }
  } else {
    const int chunks = nsel * (TF32_BK / 4);
    for (int s = 0; s < nk; ++s) {
      const int slot = s % TF32_STAGES;
      mbar_wait(ring.full + slot, (s / TF32_STAGES) & 1);
      char* rows = ring.stage(slot) + TF32_W_BYTES;
      const int k0 = s * TF32_BK;
#pragma unroll 1
      for (int q = lt - TF32_ISSUERS; q < chunks;
           q += TF32_LOADERS - TF32_ISSUERS) {
        float4* at = reinterpret_cast<float4*>(rows + sw128(q >> 3, q & 7));
        float4 v = *at;
        const int lim = rowlim[q >> 3] - (k0 + 4 * (q & 7));
        if (lim < 4) {
          if (lim <= 0) v.x = 0.f;
          if (lim <= 1) v.y = 0.f;
          if (lim <= 2) v.z = 0.f;
          v.w = 0.f;
          *at = v;
        }
        uint4 b, sm;
        split_tf32(v.x, b.x, sm.x);
        split_tf32(v.y, b.y, sm.y);
        split_tf32(v.z, b.z, sm.z);
        split_tf32(v.w, b.w, sm.w);
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(at) +
                                  TF32_R_BYTES) = sm;
      }
      fence_proxy_async();
      mbar_arrive(ring.ready + slot);
    }
  }
}

// The A fragment (16 M rows x 8 k) of warp wq at k step kk of a stage,
// from the consumer's two weight boxes (k rows, M contiguous), split: a[v]
// holds M row g + 8 (v % 2) at k t + 4 (v / 2), lane (g, t).
__device__ __forceinline__ void tf32_a(const char* w, int wq, int kk,
                                       int lane, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const char* box = w + (wq >> 1) * TF32_BOX_BYTES;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int k = 8 * kk + t + 4 * (v >> 1);
    const int c = 4 * (g >> 2) + (v & 1) + 2 * (wq & 1);
    split_tf32(*reinterpret_cast<const float*>(box + sw128(k, c) +
                                               4 * (g & 3)),
               big[v], small[v]);
  }
}

// A consumer warpgroup's contraction: acc (64 x N, the wgmma fragment) =
// its 64 M rows of the weight tile (transposed) . the row tile (its first
// N rows, transposed), over nk stages. Each stage's three passes (small .
// big, big . small, big . big for every k step, in k order) run into a
// fragment that the stage's first wgmma zeroes (scale-d 0): the tensor
// cores' adds round toward zero, which would bias a long sum; float32 adds
// (round to nearest) carry the stages' sums into acc. The two consumers
// run their stages independently, so one's carry overlaps the other's
// wgmmas.
template <int N>
__device__ __forceinline__ void tf32_consume(float (&acc)[N / 2],
                                             const Tf32Ring& ring, int nk,
                                             int cons, int wq, int lane) {
  float part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = part[i] = 0.f;
  for (int s = 0; s < nk; ++s) {
    const int slot = s % TF32_STAGES;
    mbar_wait(ring.full + slot, (s / TF32_STAGES) & 1);
    mbar_wait(ring.ready + slot, (s / TF32_STAGES) & 1);
    const char* base = ring.stage(slot);
    uint32_t ab[TF32_BK / 8][4], as[TF32_BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < TF32_BK / 8; ++kk) {
      tf32_a(base + cons * 2 * TF32_BOX_BYTES, wq, kk, lane, ab[kk], as[kk]);
      pin(ab[kk]);
      pin(as[kk]);
    }
    const uint64_t big = sw128_desc(base + TF32_W_BYTES);
    const uint64_t small = sw128_desc(base + TF32_W_BYTES + TF32_R_BYTES);
    pin(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TF32_BK / 8; ++kk) {
      // a k step is 32 B of each row: 2 in the descriptor's 16-byte units
      Wgmma<N>::run(part, as[kk], big + 2 * kk, kk);
      Wgmma<N>::run(part, ab[kk], small + 2 * kk, 1);
      Wgmma<N>::run(part, ab[kk], big + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(part);
    mbar_arrive(ring.empty + slot);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
  }
}

// The up tile's consumers: consumer 0 sums x . w1, consumer 1 x . w3 for
// the strip's 64 neurons; consumer 1 hands its sums over through the
// ring, and consumer 0 writes h = silu(x . w1) * (x . w3), masked per
// neuron, for the live rows.
template <int N>
__device__ __forceinline__ void tf32_up_consumer(
    const Problem<float>& pb, const Tf32Ring& ring, int nk, int ct, int r0,
    int base, int j, int n0, int c_f, int n_rows) {
  const int cons = ct >> 7, wt = ct & 127, wq = wt >> 5, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[N / 2];
  tf32_consume<N>(acc, ring, nk, cons, wq, lane);
  float* ex = reinterpret_cast<float*>(ring.base);
  named_sync(1, TF32_CONSUMERS);        // both have left the ring
  if (cons == 1) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) ex[i * 128 + wt] = acc[i];
  }
  named_sync(2, TF32_CONSUMERS);
  if (cons == 1) return;
  const int f = pb.f, V = pb.P * f;
  // acc[4 jn + 2 hh + v]: M row g + 8 hh, row 8 jn + 2 t + v of the block
#pragma unroll
  for (int jn = 0; jn < N / 8; ++jn) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int nl = n0 + tf32_m_index(wq, g, hh);
      const int u = j * f + nl;
      const int rows_ok = u < pb.n_major ? n_rows : c_f;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = 4 * jn + 2 * hh + v;
        const int r = r0 + 8 * jn + 2 * t + v;
        if (r >= n_rows || nl >= f) continue;
        pb.h[(size_t)(base + r) * V + u] =
            r < rows_ok ? silu(acc[i]) * ex[i * 128 + wt] : 0.f;
      }
    }
  }
}

// The down tile's consumers: consumer c sums h . w2 for columns c0 + 64 c
// .. + 64 and writes them (pipeline: scaled by the combine weight, live
// rows only; buffer: every row of the block, exact zeros past the live
// rows, those past the wgmma's N too).
template <int N, bool kBuffer>
__device__ __forceinline__ void tf32_down_consumer(
    const Problem<float>& pb, const Tf32Ring& ring, int nk, int ct, int r0,
    int base, int c0, int n_rows) {
  const int cons = ct >> 7, wt = ct & 127, wq = wt >> 5, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[N / 2];
  tf32_consume<N>(acc, ring, nk, cons, wq, lane);
  const int d = pb.d, cw = c0 + TF32_M * cons;
#pragma unroll
  for (int jn = 0; jn < N / 8; ++jn) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = cw + tf32_m_index(wq, g, hh);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = 4 * jn + 2 * hh + v;
        const int r = r0 + 8 * jn + 2 * t + v;
        if (c >= d) continue;
        const size_t at = (size_t)(base + r) * d + c;
        if (kBuffer) {
          if (r < pb.capacity) pb.y[at] = r < n_rows ? acc[i] : 0.f;
        } else if (r < n_rows) {
          pb.y[at] = pb.comb[base + r] * acc[i];
        }
      }
    }
  }
  if (kBuffer) {
    const int z0 = r0 + N, z1 = min(r0 + TF32_ROWS, pb.capacity);
    for (int q = wt; q < (z1 - z0) * TF32_M; q += 128) {
      const int c = cw + q % TF32_M;
      if (c < d) pb.y[(size_t)(base + z0 + q / TF32_M) * d + c] = 0.f;
    }
  }
}

// the tensor maps: up w1 (a), w3 (b) and x's rows (r), down w2 (a) and
// h's rows (r)
struct Tf32Maps {
  CUtensorMap a;
  CUtensorMap b;
  CUtensorMap r;
};

// The 4-byte cp.async copies of a stage (the operands do not allow 16-byte
// copies, so TMA cannot take them): the weight tile's n_w elements
// (weight(i, &dst) returns the source of element i, null out of bounds),
// and the row tile's first nsel rows from src (ld elements a row), zero-
// filled past each row's limit. Lane lane of the issuer warp.
template <typename Weight>
__device__ __forceinline__ void tf32_copies(char* st, int k0, int lane,
                                            int n_w, Weight weight,
                                            const float* src, size_t ld,
                                            const Tf32Shared& sh, int nsel) {
  for (int i = lane; i < n_w; i += TF32_ISSUERS) {
    float* dst;
    const float* w = weight(i, &dst);
    cp_async4(dst, w ? w : src, w != nullptr);
  }
  char* rows = st + TF32_W_BYTES;
  for (int q = lane; q < nsel * TF32_BK; q += TF32_ISSUERS) {
    const int row = q / TF32_BK, k = k0 + q % TF32_BK;
    const bool ok = k < sh.rowlim[row];
    cp_async4(reinterpret_cast<float*>(rows + sw128(row, q % TF32_BK / 4)) +
                  q % 4,
              ok ? src + (size_t)sh.rowsrc[row] * ld + k : src, ok);
  }
}

template <bool kBuffer>
__global__ void __launch_bounds__(TF32_NT, 1)
up_tf32_kernel(Problem<float> pb, const __grid_constant__ Tf32Maps maps) {
  const int e = blockIdx.z;
  int c_f, n_rows;
  group_rows(pb, e, &c_f, &n_rows);
  if (!serves<MANY_ROWS>(n_rows)) return;
  if (pb.regime && blockIdx.x == 0 && blockIdx.y == 0) pb.regime[e] = 2;
  // row blocks vary fastest: the CTAs of one weight strip run together
  const int r0 = blockIdx.x * TF32_ROWS;
  const int j = blockIdx.y / pb.n_tiles_sub;
  const int n0 = (blockIdx.y % pb.n_tiles_sub) * TF32_M;
  // a strip whose first neuron is MINOR serves only the FULL rows
  const int live = (j * pb.f + n0 < pb.n_major) ? n_rows : c_f;
  if (r0 >= live) return;
  const int base = group_base<kBuffer>(pb, e);
  const int d = pb.d, f = pb.f;
  const int nsel = tf32_width(live - r0);

  extern __shared__ float4 smem4[];
  __shared__ Tf32Shared sh;
  const int tid = threadIdx.x;
  for (int i = tid; i < TF32_ROWS; i += TF32_NT) {
    const int r = r0 + i;
    sh.rowsrc[i] = r < live ? (kBuffer ? base + r : pb.tok[base + r]) : -1;
    sh.rowlim[i] = r < live ? d : 0;
  }
  const Tf32Ring ring = tf32_ring(smem4, sh, tid);
  __syncthreads();
  const int nk = (d + TF32_BK - 1) / TF32_BK;
  const int sub = e * pb.P + j;

  if (tid < TF32_LOADERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(TF32_PRODUCER_REGS));
    // the rows by position in boxes of 32: the buffer itself, or the
    // pipeline's x[tok] gathered by position_key_kernel (pb.xs)
    auto issue_tma = [&](char* st, int k0, uint64_t* bar, int lane) {
      if (lane == 0) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          tma_load_3d(st + b * TF32_BOX_BYTES, b < 2 ? &maps.a : &maps.b,
                      n0 + TF32_BOX * (b & 1), k0, sub, bar);
      }
      for (int i = lane; i < nsel / TF32_BOX; i += TF32_ISSUERS)
        tma_load_2d(st + TF32_W_BYTES + i * TF32_BOX_BYTES, &maps.r, k0,
                    base + r0 + TF32_BOX * i, bar);
    };
    const float* w1s = pb.w1 + (size_t)sub * d * f;
    const float* w3s = pb.w3 + (size_t)sub * d * f;
    auto issue_copies = [&](char* st, int k0, int lane) {
      auto weight = [&](int i, float** dst) -> const float* {
        const int m = i / (TF32_BK * TF32_M), kk = i / TF32_M % TF32_BK;
        const int n = i % TF32_M, k = k0 + kk;
        *dst = reinterpret_cast<float*>(
                   st + (2 * m + n / TF32_BOX) * TF32_BOX_BYTES +
                   sw128(kk, n % TF32_BOX / 4)) + n % 4;
        return k < d && n0 + n < f ? (m ? w3s : w1s) + (size_t)k * f + n0 + n
                                   : nullptr;
      };
      tf32_copies(st, k0, lane, 2 * TF32_BK * TF32_M, weight, pb.x, d, sh,
                  nsel);
    };
    tf32_produce(ring, nk, nsel, sh.rowlim, pb.vec != 0,
                 TF32_W_BYTES + nsel * 128, tid, issue_tma, issue_copies);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(TF32_CONSUMER_REGS));
    const int ct = tid - TF32_LOADERS;
    switch (nsel) {
      case 32:
        tf32_up_consumer<32>(pb, ring, nk, ct, r0, base, j, n0, c_f, n_rows);
        break;
      case 64:
        tf32_up_consumer<64>(pb, ring, nk, ct, r0, base, j, n0, c_f, n_rows);
        break;
      case 96:
        tf32_up_consumer<96>(pb, ring, nk, ct, r0, base, j, n0, c_f, n_rows);
        break;
      default:
        tf32_up_consumer<128>(pb, ring, nk, ct, r0, base, j, n0, c_f,
                              n_rows);
    }
  }
}

template <bool kBuffer>
__global__ void __launch_bounds__(TF32_NT, 1)
down_tf32_kernel(Problem<float> pb, const __grid_constant__ Tf32Maps maps) {
  const int e = blockIdx.z;
  int c_f, n_rows;
  group_rows(pb, e, &c_f, &n_rows);
  if (!serves<MANY_ROWS>(n_rows)) return;
  // row blocks vary fastest: the CTAs of one weight strip run together
  const int r0 = blockIdx.x * TF32_ROWS;
  const int c0 = blockIdx.y * 2 * TF32_M;
  const int base = group_base<kBuffer>(pb, e);
  const int tid = threadIdx.x;
  if (r0 >= n_rows) {     // a dead row block: buffer rows are exact zeros
    if (kBuffer)
      zero_rows<2 * TF32_M, TF32_NT>(
          pb, base, r0, min(r0 + TF32_ROWS, pb.capacity), c0, tid);
    return;
  }
  const int d = pb.d, f = pb.f, V = pb.P * f;
  // a row block with no FULL row never needs the MINOR half
  const int kend = r0 < c_f ? V : pb.n_major;
  const int nsel = tf32_width(n_rows - r0);

  extern __shared__ float4 smem4[];
  __shared__ Tf32Shared sh;
  // per row, the neurons it may read: all for FULL rows, the MAJOR half for
  // MAJOR-only rows; the entries past it were never written by an up tile,
  // and the splitters zero them
  for (int i = tid; i < TF32_ROWS; i += TF32_NT) {
    const int r = r0 + i;
    sh.rowsrc[i] = r < n_rows ? base + r : -1;
    sh.rowlim[i] = min(kend, r < c_f ? V : (r < n_rows ? pb.n_major : 0));
  }
  const Tf32Ring ring = tf32_ring(smem4, sh, tid);
  __syncthreads();
  const int nk = (kend + TF32_BK - 1) / TF32_BK;

  if (tid < TF32_LOADERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(TF32_PRODUCER_REGS));
    // virtual neuron u of group e is row e * V + u of w2 as (E*P*f, d);
    // rows past kend meet zeroed h
    const int row0 = e * V;
    auto issue_tma = [&](char* st, int k0, uint64_t* bar, int lane) {
      if (lane == 0) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          tma_load_2d(st + b * TF32_BOX_BYTES, &maps.a, c0 + TF32_BOX * b,
                      row0 + k0, bar);
      }
      for (int i = lane; i < nsel / TF32_BOX; i += TF32_ISSUERS)
        tma_load_2d(st + TF32_W_BYTES + i * TF32_BOX_BYTES, &maps.r, k0,
                    base + r0 + TF32_BOX * i, bar);
    };
    auto issue_copies = [&](char* st, int k0, int lane) {
      auto weight = [&](int i, float** dst) -> const float* {
        const int kk = i / (2 * TF32_M), n = i % (2 * TF32_M);
        const int k = k0 + kk;
        *dst = reinterpret_cast<float*>(st + n / TF32_BOX * TF32_BOX_BYTES +
                                        sw128(kk, n % TF32_BOX / 4)) + n % 4;
        return k < kend && c0 + n < d ? pb.w2 + (size_t)(row0 + k) * d + c0 + n
                                      : nullptr;
      };
      tf32_copies(st, k0, lane, TF32_BK * 2 * TF32_M, weight, pb.h, V, sh,
                  nsel);
    };
    tf32_produce(ring, nk, nsel, sh.rowlim, pb.vec != 0,
                 TF32_W_BYTES + nsel * 128, tid, issue_tma, issue_copies);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(TF32_CONSUMER_REGS));
    const int ct = tid - TF32_LOADERS;
    switch (nsel) {
      case 32:
        tf32_down_consumer<32, kBuffer>(pb, ring, nk, ct, r0, base, c0,
                                        n_rows);
        break;
      case 64:
        tf32_down_consumer<64, kBuffer>(pb, ring, nk, ct, r0, base, c0,
                                        n_rows);
        break;
      case 96:
        tf32_down_consumer<96, kBuffer>(pb, ring, nk, ct, r0, base, c0,
                                        n_rows);
        break;
      default:
        tf32_down_consumer<128, kBuffer>(pb, ring, nk, ct, r0, base, c0,
                                         n_rows);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the
// libraries link no libcuda of their own); null if the driver lacks it
typedef CUresult (*Tf32Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                               void*, const cuuint64_t*, const cuuint64_t*,
                               const cuuint32_t*, const cuuint32_t*,
                               CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion,
                               CUtensorMapFloatOOBfill);

inline Tf32Encode tf32_encode() {
  static const Tf32Encode fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<Tf32Encode>(p);
  }();
  return fn;
}

// A float32 tensor map of rank 2 or 3 over w (dims innermost first,
// strides in bytes of the outer dims) in boxes of 32 x box_rows (x 1)
// under the 128-byte swizzle; elements out of bounds arrive as zeros.
inline bool tf32_map(CUtensorMap* map, const float* w, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     int box_rows) {
  const Tf32Encode encode = tf32_encode();
  const cuuint32_t box[3] = {TF32_BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                const_cast<float*>(w), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kBuffer>
cudaError_t launch_tf32_tile(Problem<float> pb, int E, cudaStream_t stream,
                             bool up) {
  const int row_blocks = (pb.capacity + TF32_ROWS - 1) / TF32_ROWS;
  const int bytes = tf32_smem_bytes();
  pb.n_tiles_sub = (pb.f + TF32_M - 1) / TF32_M;
  const cuuint64_t d = pb.d, f = pb.f, V = (cuuint64_t)pb.P * pb.f;
  const cuuint64_t subs = (cuuint64_t)E * pb.P;
  Tf32Maps maps{};
  // TMA when the operands allow 16-byte copies (pb.vec: widths in whole
  // copies, aligned pointers), else the issuer warp's cp.async copies
  if (pb.vec) {
    bool ok;
    if (up) {
      const cuuint64_t dims[3] = {f, d, subs};
      const cuuint64_t strides[2] = {f * 4, d * f * 4};
      const cuuint64_t x_dims[2] = {d, (cuuint64_t)pb.n_pos};
      const cuuint64_t x_strides[1] = {d * 4};
      ok = tf32_map(&maps.a, pb.w1, 3, dims, strides, TF32_BK) &&
           tf32_map(&maps.b, pb.w3, 3, dims, strides, TF32_BK) &&
           tf32_map(&maps.r, kBuffer ? pb.x : pb.xs, 2, x_dims, x_strides,
                    TF32_BOX);
    } else {
      const cuuint64_t dims[2] = {d, subs * f};
      const cuuint64_t strides[1] = {d * 4};
      const cuuint64_t h_dims[2] = {V, (cuuint64_t)pb.n_pos};
      const cuuint64_t h_strides[1] = {V * 4};
      ok = tf32_map(&maps.a, pb.w2, 2, dims, strides, TF32_BK) &&
           tf32_map(&maps.r, pb.h, 2, h_dims, h_strides, TF32_BOX);
    }
    if (!ok) return cudaErrorInvalidValue;
  }
  // the dynamic shared-memory limit is raised once per kernel
  if (up) {
    static const cudaError_t set = cudaFuncSetAttribute(
        up_tf32_kernel<kBuffer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (set != cudaSuccess) return set;
    const dim3 grid(row_blocks, pb.P * pb.n_tiles_sub, E);
    up_tf32_kernel<kBuffer><<<grid, TF32_NT, bytes, stream>>>(pb, maps);
  } else {
    static const cudaError_t set = cudaFuncSetAttribute(
        down_tf32_kernel<kBuffer>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    const dim3 grid(row_blocks, (pb.d + 2 * TF32_M - 1) / (2 * TF32_M), E);
    down_tf32_kernel<kBuffer><<<grid, TF32_NT, bytes, stream>>>(pb, maps);
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
         aligned(pb.h) && aligned(pb.y) && aligned(pb.xs);
}

// Up then down; each launches the few-row tile, and the many-row tile when
// the capacity can hold a group past FEW_ROWS rows: the mma.sync bf16 tiles
// for bf16; for float the FMA few-row tile and the 3xTF32 wgmma many-row
// tile. T and Y are deduced from pb.
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
