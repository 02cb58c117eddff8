// Fused MoE pipeline for Hopper (sm_90a): gather -> grouped SwiGLU with
// dual-sparse minor-half skipping -> deterministic per-token combine.
//
// Replaces the TPU kernel src/repro/kernels/dualsparse_ffn.py:498
// fused_moe_pipeline_pallas (streamed body _fused_pipeline_streamed_kernel
// at :353, resident body _fused_pipeline_kernel at :282; both compute the
// same function, so this one kernel serves either value of ``streamed``).
//
// What bounds it on an H100:
//   * decode (T=8, Qwen3-30B-A3B widths) and a slot engine's prefill-insert
//     (T <= 128, ~8 rows per expert): each touched expert streams
//     3 * 2048 * 768 weights (18.9 MB in float32, 9.4 MB in bf16) for a
//     handful of rows, so the kernel is bound by device-memory bytes
//     (3.35 TB/s);
//   * prefill (T~1024): ~45-64 rows per expert reuse each weight tile that
//     often. On float32 operands (the single-card serving path) that is
//     bound by operations: the many-row tile runs its products as three
//     TF32 passes on the tensor cores (3xTF32, FLOPs / 165 TFLOP/s; one
//     TF32 pass would change the numbers). On bf16 operands (the S-ETP wire
//     type) the products run on the bf16 tensor cores (989 TFLOP/s), and
//     the prefill is bound by bytes too.
// What the design does about that (swiglu_tiles.cuh, pipeline row layout):
// the up and down launches stream each group's weights through a ring of
// shared-memory stages, several steps in flight per CTA, with the rows
// x[tok[p]] gathered into the same stages (for the float32 many-row tile,
// from the copy the position-key launch makes by position, so that TMA
// moves them in boxes of 32 rows); the row tile is chosen on the
// device from each group's live rows (a few-row tile for groups of at most
// 16 rows, row blocks above), so few-row groups spend no products on dead
// rows. Float32 operands take an FMA few-row tile and a 3xTF32 wgmma
// many-row tile (TMA-fed, warp-specialised; its wgmma width follows the
// live rows); bf16 operands take mma.sync tiles; every ring step carries
// 128 bytes of each weight row. Rows past an expert's count are never
// loaded, and MAJOR-only row tiles stop the contraction at the minor half,
// so 2T-Drop's skipped work is neither read nor computed.
//
// Three steps on the caller's stream, no atomics:
//   1. up:      h[pos, u] = silu(x[tok[pos]] . w1[:, u]) * (x[tok[pos]] . w3[:, u])
//               over the virtual width V = P*f (sub-expert j = u / f), masked
//               per neuron: rows >= counts_full see only u < n_major;
//   2. down:    y[pos, c] = combine[pos] * sum_u h[pos, u] * w2[u, c];
//   3. combine: out[t, c] = sum of y[pos, c] over token t's computed
//               positions in increasing sorted order, from 0 (the order the
//               TPU kernel accumulates in), so runs are bit-identical.
// Steps 1 and 2 are one launch per row tile each. The (N', V) h and (N', d)
// y staging buffers are per sorted pair; positions no row tile computes
// (capacity overflow, dropped pairs, padding) are never written. A first
// launch marks each position with its token or -1 (not computed) and, for
// the float32 many-row tile, copies each of its positions' x rows into
// the y scratch in position order (the tile reads them by TMA, in boxes of
// 32 rows; the down launches overwrite y after), and the combine gathers
// each token's marked positions in order on the device, so
// the wrapper runs no torch op of its own besides allocating (and, for
// bf16 operands, casting the float32 output to bf16).

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

#include "swiglu_tiles.cuh"

namespace {

template <typename T>
using Problem = swiglu_tiles::Problem<T>;

constexpr int KEY_THREADS = 256;   // a warp a position
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_LIST = 1024;   // positions summed per pass

// key[p] = tok[p] if some row tile computes position p, else -1: p lies in
// group g = the last group with offs[g] <= p (0 if none), and is computed
// when p - offs[g] < min(cf[g] + cm[g], capacity). With xs (float32
// operands), a computed position of a group past FEW_ROWS rows (the
// many-row tile's) also gets its row: xs[p, :] = x[tok[p], :]. A warp a
// position.
__global__ void __launch_bounds__(KEY_THREADS)
position_key_kernel(const int* tok, const int* offs, const int* cf,
                    const int* cm, int n_pos, int E, int capacity, int* key,
                    const float* x, float* xs, int d) {
  const int p = blockIdx.x * (KEY_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (p >= n_pos) return;
  int lo = 0, hi = E;               // the first group with offs > p
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (offs[mid] <= p) lo = mid + 1; else hi = mid;
  }
  const int g = max(lo - 1, 0);
  const int rows = min(cf[g] + cm[g], capacity);
  const bool computed = p - offs[g] < rows;
  if (lane == 0) key[p] = computed ? tok[p] : -1;
  if (xs == nullptr || !computed || rows <= swiglu_tiles::FEW_ROWS) return;
  // xs and x allow 16-byte copies whenever xs is given (d a multiple of 4)
  const float4* src =
      reinterpret_cast<const float4*>(x + (size_t)tok[p] * d);
  float4* dst = reinterpret_cast<float4*>(xs + (size_t)p * d);
  for (int c = lane; c < d / 4; c += 32) dst[c] = src[c];
}

// Fills key (N',) and, with xs, the float32 many-row tile's rows, as
// position_key_kernel does.
int position_keys(const void* tok_sorted, const void* group_offsets,
                  const void* counts_full, const void* counts_major,
                  void* key, int n_pos, int E, int capacity, const float* x,
                  float* xs, int d, cudaStream_t stream) {
  if (n_pos == 0) return 0;
  const int per_block = KEY_THREADS / 32;
  position_key_kernel<<<(n_pos + per_block - 1) / per_block, KEY_THREADS, 0,
                        stream>>>(
      static_cast<const int*>(tok_sorted),
      static_cast<const int*>(group_offsets),
      static_cast<const int*>(counts_full),
      static_cast<const int*>(counts_major), n_pos, E, capacity,
      static_cast<int*>(key), x, xs, d);
  return static_cast<int>(cudaGetLastError());
}

// out[t, :] = the sum of y[p, :] over the positions p with key[p] == t, in
// increasing p, from 0. The CTAs of token t (blockIdx.x; blockIdx.y splits
// the columns when there are few tokens) scan the keys in order, gather up
// to COMBINE_LIST matching positions into shared memory (a ballot per warp
// keeps their order), add those rows, and carry the sum in out[t] to the
// next pass: each column has one writer and a fixed order.
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* y, const int* key, int n_pos, float* out,
               int d) {
  constexpr int WARPS = COMBINE_THREADS / 32;
  __shared__ int list[COMBINE_LIST];
  __shared__ int warp_hits[WARPS];
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int p0 = 0;
  bool first = true;
  while (first || p0 < n_pos) {
    int n_list = 0;
    // gather whole chunks while the list has room for one more
    for (; p0 < n_pos && n_list + COMBINE_THREADS <= COMBINE_LIST;
         p0 += COMBINE_THREADS) {
      const int p = p0 + tid;
      const bool hit = p < n_pos && key[p] == t;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_hits[warp] = __popc(ballot);
      __syncthreads();
      int before = n_list;
      for (int w = 0; w < warp; ++w) before += warp_hits[w];
      if (hit) list[before + __popc(ballot & ((1u << lane) - 1))] = p;
      for (int w = 0; w < WARPS; ++w) n_list += warp_hits[w];
      __syncthreads();
    }
    for (int c = blockIdx.y * COMBINE_THREADS + tid; c < d;
         c += gridDim.y * COMBINE_THREADS) {
      float acc = first ? 0.f : out[(size_t)t * d + c];
      for (int i = 0; i < n_list; ++i) acc += y[(size_t)list[i] * d + c];
      out[(size_t)t * d + c] = acc;
    }
    first = false;
    __syncthreads();
  }
}

// The pipeline's operands as the C interface passes them.
struct Operands {
  const void *x, *w1, *w3, *w2, *offs, *cf, *cm, *tok, *comb;
  void *h, *y, *regime;
  int d, f, P, n_major, capacity, n_pos;
};

// The tiles' problem in element type T.
template <typename T>
Problem<T> tiles_problem(const Operands& o) {
  Problem<T> pb;
  pb.x = static_cast<const T*>(o.x);
  pb.w1 = static_cast<const T*>(o.w1);
  pb.w3 = static_cast<const T*>(o.w3);
  pb.w2 = static_cast<const T*>(o.w2);
  pb.offs = static_cast<const int*>(o.offs);
  pb.cf = static_cast<const int*>(o.cf);
  pb.cm = static_cast<const int*>(o.cm);
  pb.tok = static_cast<const int*>(o.tok);
  pb.comb = static_cast<const float*>(o.comb);
  pb.h = static_cast<T*>(o.h);
  pb.y = static_cast<float*>(o.y);
  pb.regime = static_cast<int*>(o.regime);
  pb.d = o.d;
  pb.f = o.f;
  pb.P = o.P;
  pb.n_major = o.n_major;
  pb.capacity = o.capacity;
  pb.n_pos = o.n_pos;
  pb.xs = nullptr;
  return pb;
}

}  // namespace

extern "C" {

// Fills key (N',) as position_key_kernel does. Returns the
// cudaGetLastError() code, or 0.
int fused_moe_pipeline_position_keys(
    const void* tok_sorted, const void* group_offsets,
    const void* counts_full, const void* counts_major, void* key, int n_pos,
    int E, int capacity, void* stream) {
  return position_keys(tok_sorted, group_offsets, counts_full, counts_major,
                       key, n_pos, E, capacity, nullptr, nullptr, 0,
                       static_cast<cudaStream_t>(stream));
}

// Enqueues the launches on ``stream``: the position keys, each row tile's
// up and down, and the combine. x, w1, w3, w2 and the scratch ``h``
// (N', P*f) are float32 (``bf16`` == 0) or bfloat16 (``bf16`` != 0);
// ``combine_sorted``, the scratch ``y`` (N', d) and ``out`` (T, d) are
// float32, ``key`` (N',) int32 scratch; ``regime`` is null or an (E,) int32
// buffer that receives, per group, 1 (few-row tile) or 2 (many-row tile).
// Returns the cudaGetLastError() code after the first failing launch, or 0.
int fused_moe_pipeline_launch(
    const void* x, const void* w1, const void* w3, const void* w2,
    const void* group_offsets, const void* counts_full,
    const void* counts_major, const void* tok_sorted,
    const void* combine_sorted, void* h, void* y, void* key, void* out,
    void* regime, int T, int n_pos, int d, int f, int E, int P,
    int n_major, int capacity, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operands ops{x, w1, w3, w2, group_offsets, counts_full, counts_major,
                     tok_sorted, combine_sorted, h, y, regime, d, f, P,
                     n_major, capacity, n_pos};
  Problem<float> pb = tiles_problem<float>(ops);
  // float32 operands past FEW_ROWS rows, when every operand allows 16-byte
  // copies (the many-row tile's TMA path): that tile's rows are gathered by
  // position into the y scratch, which the down launches overwrite after
  float* xs = nullptr;
  if (!bf16 && capacity > swiglu_tiles::FEW_ROWS &&
      swiglu_tiles::vector_ok(pb))
    pb.xs = xs = pb.y;
  int err = position_keys(tok_sorted, group_offsets, counts_full,
                          counts_major, key, n_pos, E, capacity,
                          static_cast<const float*>(x), xs, d, s);
  if (err != 0) return err;
  err = static_cast<int>(
      bf16 ? swiglu_tiles::launch_swiglu<false>(
                 tiles_problem<__nv_bfloat16>(ops), E, s)
           : swiglu_tiles::launch_swiglu<false>(pb, E, s));
  if (err != 0) return err;
  if (T > 0) {
    // a few tokens spread their columns over more CTAs (~1024 in all)
    const int col_blocks =
        std::min((d + COMBINE_THREADS - 1) / COMBINE_THREADS,
                 std::max(1, 1024 / T));
    combine_kernel<<<dim3(T, col_blocks), COMBINE_THREADS, 0, s>>>(
        static_cast<const float*>(y), static_cast<const int*>(key), n_pos,
        static_cast<float*>(out), d);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

const char* fused_moe_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
