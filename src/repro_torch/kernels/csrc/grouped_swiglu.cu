// Grouped SwiGLU over pre-gathered expert buffers for Hopper (sm_90a), with
// dual-sparse minor-half skipping: the expert FFN of the MoE buffer path
// (gather_rows -> this kernel -> unpermute + combine).
//
// Replaces the TPU kernel src/repro/kernels/dualsparse_ffn.py:192
// grouped_swiglu_pallas (body _kernel at :155). Same function: x (E, C, d)
// buffers, group e's rows r < counts_full[e] use every neuron of the
// virtual width P*f (sub-expert e*P + j holds neurons [j*f, (j+1)*f)), rows
// in [counts_full, counts_full + counts_major) only the MAJOR neurons, rows
// at or past both come out as exact zeros (the TPU kernel zero-inits every
// output tile before it accumulates). Counts past C are clamped on the
// device.
//
// Element types as in swiglu_tiles.cuh: float32 operands and output, or
// bfloat16 operands (the S-ETP wire type) with float32 sums and a bfloat16
// output, rounded once from the float32 sums.
//
// What bounds it on an H100: at the paged engine's decode (C = 8) and chunk
// (T = C = 64, ~3-4 live rows per group) each live group streams
// 3 * d * V weights for a few rows, so it is bound by device-memory bytes;
// at prefill capacity (C ~ 128, ~45-64 rows per group) each weight tile is
// reused by that many rows, so float32 operands are bound by operations
// (3xTF32 on the tensor cores), while bf16 operands, on the bf16 tensor
// cores, stay bound by bytes. What the design does about that: the up and
// down tiles of
// swiglu_tiles.cuh in its buffer row layout stream the weights through a
// ring of cp.async shared-memory slots, and pick the row tile on the device
// from each group's live rows, not from C: a group of at most 16 rows runs
// one 16-row tile, larger groups 64-row blocks (for float32 an FMA few-row
// tile and a 3xTF32 many-row tile, mma.sync tiles for bf16). Row tiles past a group's live rows load
// nothing, and MAJOR-only row tiles skip the MINOR up strips and stop the
// down contraction at n_major. Unlike the fused pipeline it reads x from
// the (E, C, d) buffer and writes the (E, C, d) output directly (no
// gather, no combine). One writer per output element, a fixed k order:
// runs are bit-identical.

#include <cuda_runtime.h>
#include <stddef.h>

#include "swiglu_tiles.cuh"

namespace {

// The up and down launches of every row tile, in element type T.
template <typename T>
int run_tiles(const void* x, const void* w1, const void* w3, const void* w2,
              const void* counts_full, const void* counts_major, void* h,
              void* out, void* regime, int E, int C, int d, int f, int P,
              int n_major, cudaStream_t stream) {
  swiglu_tiles::Problem<T, T> pb;   // the output in the operands' type
  pb.x = static_cast<const T*>(x);
  pb.w1 = static_cast<const T*>(w1);
  pb.w3 = static_cast<const T*>(w3);
  pb.w2 = static_cast<const T*>(w2);
  pb.offs = nullptr;
  pb.cf = static_cast<const int*>(counts_full);
  pb.cm = static_cast<const int*>(counts_major);
  pb.tok = nullptr;
  pb.comb = nullptr;
  pb.h = static_cast<T*>(h);
  pb.y = static_cast<T*>(out);
  pb.regime = static_cast<int*>(regime);
  pb.d = d;
  pb.f = f;
  pb.P = P;
  pb.n_major = n_major;
  pb.capacity = C;
  return static_cast<int>(swiglu_tiles::launch_swiglu<true>(pb, E, stream));
}

}  // namespace

extern "C" {

// Enqueues the up and down launches on ``stream``. ``bf16`` gives the type
// of x, the weights, the scratch ``h`` (E*C, P*f) and the (E, C, d) result
// ``out``: float32 (``bf16`` == 0) or bfloat16 (``bf16`` != 0; the sums
// stay float32 and are rounded to nearest even once, into ``out``);
// ``regime`` null or an (E,) int32 buffer that receives, per group, 1
// (few-row tile) or 2 (many-row tile). Returns the cudaGetLastError() code
// after the first failing launch, or 0.
int grouped_swiglu_launch(const void* x, const void* w1, const void* w3,
                          const void* w2, const void* counts_full,
                          const void* counts_major, void* h, void* out,
                          void* regime, int E, int C, int d, int f, int P,
                          int n_major, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_tiles<__nv_bfloat16>(x, w1, w3, w2, counts_full, counts_major,
                                    h, out, regime, E, C, d, f, P, n_major,
                                    s);
  return run_tiles<float>(x, w1, w3, w2, counts_full, counts_major, h, out,
                          regime, E, C, d, f, P, n_major, s);
}

// Dynamic shared memory of one CTA (its cp.async ring) of the up (up != 0)
// or down launch of the few-row (few != 0) or many-row tile, for float32
// (bf16 == 0) or bfloat16 operands.
int grouped_swiglu_ring_bytes(int up, int few, int bf16) {
  const int BM = few ? swiglu_tiles::FEW_ROWS : swiglu_tiles::MANY_ROWS;
  if (bf16) return swiglu_tiles::mma_smem_bytes(up != 0, BM);
  return few ? swiglu_tiles::smem_bytes<float>(up != 0, BM)
             : swiglu_tiles::tf32_smem_bytes(up != 0);
}

const char* grouped_swiglu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
