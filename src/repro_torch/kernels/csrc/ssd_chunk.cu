// Intra-chunk SSD of Mamba2 (the quadratic half of chunked state-space
// duality) for Hopper (sm_90a), float32 in and out.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas
// (body _kernel). Same function, per (batch*head bh, chunk c) of Q steps:
//   dA = dt * a;  cum = cumsum(dA);  L[i][j] = exp(cum_i - cum_j), i >= j
//   y      = (C B^T o L o dt_j) x          (Q, P)
//   states = (B o dt o exp(cum_end - cum))^T x   (N, P)
//   decay  = exp(cum_end)
// x (BH, nc, Q, P), dt (BH, nc, Q), a (BH,) -> y (BH, nc, Q, P), states
// (BH, nc, N, P), decay (BH, nc). B and C come grouped: (BG, nc, Q, N) with
// BH = BG * rep, and head bh reads group row bh / rep (Mamba2's n_groups
// heads share one B and C; BG = BH is the TPU kernel's own layout).
//
// What bounds it on an H100: per chunk and head the lower triangle's M x
// (Q(Q+1)/2 * 2P FLOPs) and the states product (2NPQ) on ~4Q(2P+1) bytes,
// and per chunk and group the C B^T triangle (Q(Q+1)/2 * 2N): at Q = 256,
// N = 64..128 this is operations, not bytes, at the float32 CUDA-core rate,
// and C B^T, the same for every head of a group, is 1/2 to 2/3 of them when
// formed per head. Run as three TF32 passes on the tensor cores (below),
// the operations take about as long as the bytes at N = 128 and less at
// N = 64, so the bound is then set by both, or by the bytes.
//
// What the design does about it:
//   * C B^T once per (group, chunk). A first launch writes the lower 64x64
//     tiles of S = C B^T to an L2-resident scratch (BG, nc, Q, Qs), and each
//     (bh, chunk)'s cumsum: dt * a accumulated in double and rounded once
//     (as the plain version's chunk_cumsum), so the decays agree with it bit
//     for bit whatever order the lanes add in; with it w = dt *
//     exp(cum_end - cum), v (below) and the decay. Then one launch for y and
//     one for the states.
//   * The products run on the tensor cores as 3xTF32: each float32 operand
//     v is split into a TF32 big part and the exact remainder small, and the
//     product is small*big + big*small + big*big (mma.sync m16n8k8, float32
//     accumulators), which keeps ~20 of float32's 24 bits; a single TF32
//     pass keeps ~11 and would break the 1e-5 bar.
//   * A CTA is four warps and owns a 64x64 output tile, a warp a 16x64 strip
//     (8 fragments). The operand tiles stream through a 2-slot cp.async ring,
//     32 deep in the contraction; fragment reads use padded row strides and
//     are free of bank conflicts. The operand all four warps share (x, or
//     w o x for the states) is split into (big, small) pairs once per CTA
//     and read as one 8-byte load per pair; each warp splits only its own
//     rows of the other operand.
//   * A y CTA walks two heads of a group for one 64-row block. Per head it
//     builds M = S o L o dt_j fragment by fragment in registers from the S
//     tile. Where a column chunk lies wholly left of a warp's rows, L is
//     factored through the chunk's last column r: exp(cum_i - cum_j) =
//     exp(cum_i - cum_r) * exp(cum_r - cum_j), both factors <= 1, the second
//     (times dt_j) precomputed as v_j: no exp per element there. On the
//     diagonal, exp is taken for j <= i only (it overflows above, and the
//     select drops it before any product). Chunks above a warp's rows are
//     skipped; no tile is skipped because of the values in the data. Heavy
//     row blocks are launched first.
//   * A states CTA does B^T (w o x) for a 64(N) x 64(P) tile, two heads.
// One writer per output element and a fixed summation order: runs are
// bit-identical. No atomics.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarpRows = 16;     // rows of a warp's strip (one fragment)
constexpr int kTile = 64;         // output rows and columns per CTA
constexpr int kThreads = 32 * (kTile / kWarpRows);
constexpr int kKC = 32;           // contraction depth of one ring step
constexpr int kHeadsPerCta = 2;   // heads of a group one y / states CTA runs
constexpr int kStages = 2;        // ring slots
constexpr int kLdR = kKC + 4;     // [row][k] tiles: stride 4 mod 32 banks
constexpr int kLdK = kTile + 8;   // [k][col] tiles: stride 8 mod 32 banks
constexpr int kLdS = 2 * kTile + 8;  // split [k][col][big, small] pairs
constexpr int kTileFloats = kTile * kLdR > kKC * kLdK ? kTile * kLdR
                                                      : kKC * kLdK;
// A ring slot: the A-side tile, the x tile, and the step's vectors (cum_j,
// dt_j, v_j for y; w_q for the states). Past the slots, the split x tile.
constexpr int kVec = 3 * kKC;
constexpr int kStageFloats = 2 * kTileFloats + kVec;
constexpr int kSplitFloats = kKC * kLdS;
constexpr size_t kSmemBytes =
    sizeof(float) * (kStages * kStageFloats + kSplitFloats);
static_assert((kTileFloats * 4) % 16 == 0 && (kStageFloats * 4) % 16 == 0,
              "ring slots must keep 16-byte alignment");

struct Params {
  const float* x;
  const float* dt;
  const float* a;
  const float* bm;
  const float* cm;
  float* y;
  float* states;
  float* decay;
  float* scores;   // (BG, nc, Q, Qs) scratch: lower tiles of C B^T
  float* cum;      // (BH, nc, Q) scratch: float32 cumsum of dt * a
  float* w;        // (BH, nc, Q) scratch: dt * exp(cum_end - cum)
  float* v;        // (BH, nc, Q) scratch: dt_j * exp(cum_r - cum_j), r the
                   // last step of j's kKC-column chunk
  int BH, BG, rep, nc, Q, P, N, Qs;
  int n_rb, n_pb, n_nb, n_tri, hpc, n_hb;
  int n_score_ctas;
  int vec_x, vec_bc;   // 16-byte copies of x (P % 4 == 0) and B/C (N % 4)
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A [row][k] tile: row r < rmax at src + r * ld, columns k0 + k below kmax;
// the rest zero-filled. 16-byte copies need ld and kmax multiples of 4 (or
// reach only padding columns that the caller never uses unmasked).
__device__ __forceinline__ void load_rk(float* t, const float* src, long ld,
                                        int rmax, int k0, int kmax,
                                        bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kTile * (kKC / 4); i += kThreads) {
      const int r = i / (kKC / 4), kq = 4 * (i % (kKC / 4));
      const bool ok = r < rmax && k0 + kq < kmax;
      cp_async16(t + r * kLdR + kq, ok ? src + r * ld + k0 + kq : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kKC; i += kThreads) {
      const int r = i / kKC, k = i % kKC;
      const bool ok = r < rmax && k0 + k < kmax;
      cp_async4(t + r * kLdR + k, ok ? src + r * ld + k0 + k : src, ok);
    }
  }
}

// A [k][col] tile: row k0 + k below kmax at src + (k0 + k) * ld, columns
// c < cmax; the rest zero-filled.
__device__ __forceinline__ void load_kc(float* t, const float* src, long ld,
                                        int k0, int kmax, int cmax,
                                        bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kKC * (kTile / 4); i += kThreads) {
      const int k = i / (kTile / 4), cq = 4 * (i % (kTile / 4));
      const bool ok = k0 + k < kmax && cq < cmax;
      cp_async16(t + k * kLdK + cq, ok ? src + (k0 + k) * ld + cq : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kKC * kTile; i += kThreads) {
      const int k = i / kTile, c = i % kTile;
      const bool ok = k0 + k < kmax && c < cmax;
      cp_async4(t + k * kLdK + c, ok ? src + (k0 + k) * ld + c : src, ok);
    }
  }
}

// kKC values src[k0 + k] below kmax into v[k] (zero past it), by the
// threads from ``first`` on.
__device__ __forceinline__ void load_vec(float* v, const float* src, int k0,
                                         int kmax, int first) {
  const int k = threadIdx.x - first;
  if (k >= 0 && k < kKC) {
    const bool ok = k0 + k < kmax;
    cp_async4(v + k, ok ? src + k0 + k : src, ok);
  }
}

// Splits the [k][col] x tile of a ring slot into (big, small) pairs at
// out[k][2 col], scaling row k by scale[k] first when ``scale`` is given
// (the states' w). All threads; the caller syncs before the pairs are read.
__device__ __forceinline__ void split_tile(float* out, const float* t,
                                           const float* scale) {
  for (int i = threadIdx.x; i < kKC * (kTile / 4); i += kThreads) {
    const int k = i / (kTile / 4), c = 4 * (i % (kTile / 4));
    float4 q = *reinterpret_cast<const float4*>(t + k * kLdK + c);
    if (scale) {
      const float f = scale[k];
      q.x *= f;
      q.y *= f;
      q.z *= f;
      q.w *= f;
    }
    uint32_t b[4], s[4];
    split_tf32(q.x, b[0], s[0]);
    split_tf32(q.y, b[1], s[1]);
    split_tf32(q.z, b[2], s[2]);
    split_tf32(q.w, b[3], s[3]);
    uint4* o = reinterpret_cast<uint4*>(out + k * kLdS + 2 * c);
    o[0] = make_uint4(b[0], s[0], b[1], s[1]);
    o[1] = make_uint4(b[2], s[2], b[3], s[3]);
  }
}

enum Mode { kScores = 0, kY = 1, kStates = 2 };

// The y mode's per-row values of a warp's two rows (wr + g, + 8): their
// chunk positions, cum_i, and u_i = exp(cum_i - cum_r) of the step.
struct RowCum {
  int row[2];
  float cum[2];
  float u[2];
};

// One ring step of one warp: acc (8 fragments of its 16 x 64 strip) +=
// A[16 rows, kKC] * Bop[kKC, 64 cols] in 3xTF32, where
//   kScores: A = C tile [row][k], Bop[k][col] = B tile [col][k], both split
//            here;
//   kY:      A = M built from the S tile [row][k] and the step vectors
//            (cum_j, dt_j, v_j): OFFDIAG (every column left of every row)
//            M = S * u_i * v_j, else M = S * exp(cum_i - cum_j) * dt_j for
//            j <= i < Q and 0 elsewhere; Bop = the split x tile;
//   kStates: A = B tile [k][row] (B^T), Bop = the split w o x tile.
template <int MODE, bool OFFDIAG>
__device__ __forceinline__ void mma_step(float (&acc)[8][4], const float* ta,
                                         const float* tb, const float* vec,
                                         int wr, int k0, int Q,
                                         const RowCum& rc) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rlo = wr + g, rhi = rlo + 8;
#pragma unroll
  for (int ks = 0; ks < kKC; ks += 8) {
    const int klo = ks + t, khi = klo + 4;
    float v[4];
    if (MODE == kStates) {
      v[0] = ta[klo * kLdK + rlo];
      v[1] = ta[klo * kLdK + rhi];
      v[2] = ta[khi * kLdK + rlo];
      v[3] = ta[khi * kLdK + rhi];
    } else {
      v[0] = ta[rlo * kLdR + klo];
      v[1] = ta[rhi * kLdR + klo];
      v[2] = ta[rlo * kLdR + khi];
      v[3] = ta[rhi * kLdR + khi];
    }
    if (MODE == kY) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1, kk = q < 2 ? klo : khi;
        if (OFFDIAG) {
          v[q] = v[q] * rc.u[h] * vec[2 * kKC + kk];
        } else {
          const int i = rc.row[h], j = k0 + kk;
          const float e = __expf(rc.cum[h] - vec[kk]);
          v[q] = (j <= i && i < Q) ? v[q] * e * vec[kKC + kk] : 0.f;
        }
      }
    }
    uint32_t ab[4], as[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(v[q], ab[q], as[q]);
    uint32_t bb[8][2], bs[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 8 * nt + g;
      if (MODE == kScores) {
        split_tf32(tb[c * kLdR + klo], bb[nt][0], bs[nt][0]);
        split_tf32(tb[c * kLdR + khi], bb[nt][1], bs[nt][1]);
      } else {
        const uint2 lo = *reinterpret_cast<const uint2*>(tb + klo * kLdS +
                                                         2 * c);
        const uint2 hi = *reinterpret_cast<const uint2*>(tb + khi * kLdS +
                                                         2 * c);
        bb[nt][0] = lo.x;
        bs[nt][0] = lo.y;
        bb[nt][1] = hi.x;
        bs[nt][1] = hi.y;
      }
    }
    // three passes over the 8 fragments: no product waits on the one
    // before it; the small terms first, big * big last
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[nt], as, bb[nt]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[nt], ab, bs[nt]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[nt], ab, bb[nt]);
  }
}

// Writes a warp's 16 x 64 strip to out[(row) * ld + col] for rows below
// rmax and columns below cmax, then zeroes the accumulators. Neighbouring
// columns go out as one 8-byte store where out and ld allow it.
__device__ __forceinline__ void store_tile(float (&acc)[8][4], float* out,
                                           long ld, int wr, int rmax,
                                           int cmax) {
  const bool pairs =
      ld % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr + 8 * h + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 8 * nt + 2 * t;
      if (pairs && r < rmax && c + 1 < cmax) {
        *reinterpret_cast<float2*>(out + r * ld + c) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      } else {
        if (r < rmax && c < cmax) out[r * ld + c] = acc[nt][2 * h];
        if (r < rmax && c + 1 < cmax)
          out[r * ld + c + 1] = acc[nt][2 * h + 1];
      }
      acc[nt][2 * h] = 0.f;
      acc[nt][2 * h + 1] = 0.f;
    }
  }
}

// The ring over n_jobs x nk steps: issue(step, slot) enqueues one step's
// cp.async copies, compute(step, slot) multiplies it, and finish(job) runs
// after a job's last step.
template <typename Issue, typename Compute, typename Finish>
__device__ __forceinline__ void run_ring(float* ring, int n_jobs, int nk,
                                         Issue issue, Compute compute,
                                         Finish finish) {
  const int total = n_jobs * nk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue(s, ring + s * kStageFloats);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    const int next = s + kStages - 1;
    if (next < total) issue(next, ring + (next % kStages) * kStageFloats);
    cp_async_commit();
    compute(s, ring + (s % kStages) * kStageFloats);
    if (s % nk == nk - 1) finish(s / nk);
  }
  cp_async_wait<0>();
}

// cum[0..n) = float32 rounding of the double prefix sums of dt[q] * a; then
// w[q] = dt[q] * exp(cum_end - cum[q]), v[q] = dt[q] * exp(cum_r - cum[q])
// with r = min(q | (kKC - 1), n - 1), and *decay = exp(cum_end). One warp:
// each lane sums a contiguous segment, the segment totals are scanned
// across the warp, then each lane writes its segment's prefixes.
__device__ void chunk_prefix(const float* __restrict__ dt, float a, int n,
                             float* cum, float* w, float* v, float* decay) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n);
  const int hi = min(lo + per, n);
  double run = 0.0;
  for (int q = lo; q < hi; ++q) run += static_cast<double>(dt[q] * a);
  double incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.0;
  for (int q = lo; q < hi; ++q) {
    acc += static_cast<double>(dt[q] * a);
    cum[q] = static_cast<float>(acc);
  }
  // cum_end as the lane that owns step n - 1 rounded it
  const float cum_end =
      __shfl_sync(0xffffffffu, static_cast<float>(acc), (n - 1) / per);
  __syncwarp();
  for (int q = lo; q < hi; ++q) {
    const float cq = cum[q];
    w[q] = dt[q] * expf(cum_end - cq);
    v[q] = dt[q] * expf(cum[min(q | (kKC - 1), n - 1)] - cq);
  }
  if (lane == 0) *decay = expf(cum_end);
}

// Launch 1: the lower 64x64 tiles of S = C B^T per (group, chunk), then one
// warp per (bh, chunk) for cum, w, v and the decay.
__global__ void __launch_bounds__(kThreads)
ssd_prep_kernel(Params p) {
  extern __shared__ __align__(16) float ring[];
  if (blockIdx.x >= p.n_score_ctas) {
    const long ch = static_cast<long>(kThreads / 32) *
                        (blockIdx.x - p.n_score_ctas) + (threadIdx.x >> 5);
    if (ch >= static_cast<long>(p.BH) * p.nc) return;
    const long bh = ch / p.nc;
    chunk_prefix(p.dt + ch * p.Q, p.a[bh], p.Q, p.cum + ch * p.Q,
                 p.w + ch * p.Q, p.v + ch * p.Q, p.decay + ch);
    return;
  }
  int tt = blockIdx.x % p.n_tri, rb = 0;
  while (tt > rb) tt -= ++rb;
  const int cb = tt;
  const long chg = blockIdx.x / p.n_tri;        // bg * nc + c
  const int r0 = rb * kTile, c0 = cb * kTile;
  const float* cbase = p.cm + (chg * p.Q + r0) * p.N;
  const float* bbase = p.bm + (chg * p.Q + c0) * p.N;
  const int wr = kWarpRows * (threadIdx.x >> 5);
  const RowCum rc{};
  float acc[8][4] = {};
  run_ring(
      ring, 1, (p.N + kKC - 1) / kKC,
      [&](int s, float* slot) {
        load_rk(slot, cbase, p.N, p.Q - r0, s * kKC, p.N,
                          p.vec_bc);
        load_rk(slot + kTileFloats, bbase, p.N, p.Q - c0, s * kKC,
                          p.N, p.vec_bc);
      },
      [&](int s, float* slot) {
        mma_step<kScores, false>(acc, slot, slot + kTileFloats, nullptr, wr,
                                 s * kKC, p.Q, rc);
      },
      [&](int) {
        store_tile(acc, p.scores + (chg * p.Q + r0) * p.Qs + c0, p.Qs, wr,
                   p.Q - r0, p.Q - c0);
      });
}

// The heads of a CTA: bh0 .. bh0 + n_h - 1, all of group bg.
__device__ __forceinline__ void head_block(const Params& p, int bg, int hb,
                                           long* bh0, int* n_h) {
  *bh0 = static_cast<long>(bg) * p.rep + hb * p.hpc;
  *n_h = min(p.hpc, p.rep - hb * p.hpc);
}

// Launch 2: y of one (group, chunk, 64-row block, 64 of P) for a block of
// the group's heads, one head after another. Heavy row blocks (more column
// chunks) are launched first.
__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(Params p) {
  extern __shared__ __align__(16) float ring[];
  float* split = ring + kStages * kStageFloats;
  const int per_rb = p.BG * p.nc * p.n_pb * p.n_hb;
  const int rb = p.n_rb - 1 - static_cast<int>(blockIdx.x / per_rb);
  int rest = blockIdx.x % per_rb;
  const int hb = rest % p.n_hb;
  rest /= p.n_hb;
  const int pb = rest % p.n_pb;
  const long chg = rest / p.n_pb;               // bg * nc + c
  const int bg = static_cast<int>(chg / p.nc);
  const int c = static_cast<int>(chg % p.nc);
  long bh0;
  int n_h;
  head_block(p, bg, hb, &bh0, &n_h);
  const int r0 = rb * kTile, p0 = pb * kTile;
  const int nk = (min(r0 + kTile, p.Q) + kKC - 1) / kKC;  // columns < r0+64
  const int wr = kWarpRows * (threadIdx.x >> 5);
  const int g = (threadIdx.x & 31) >> 2;
  const float* sbase = p.scores + (chg * p.Q + r0) * p.Qs;
  float acc[8][4] = {};
  RowCum rc;
  run_ring(
      ring, n_h, nk,
      [&](int s, float* slot) {
        const long ch = (bh0 + s / nk) * p.nc + c;
        const int k0 = (s % nk) * kKC;
        float* vec = slot + 2 * kTileFloats;
        load_rk(slot, sbase, p.Qs, p.Q - r0, k0, p.Q, true);
        load_kc(slot + kTileFloats, p.x + ch * p.Q * p.P + p0, p.P, k0, p.Q,
                p.P - p0, p.vec_x);
        load_vec(vec, p.cum + ch * p.Q, k0, p.Q, 0);
        load_vec(vec + kKC, p.dt + ch * p.Q, k0, p.Q, kKC);
        load_vec(vec + 2 * kKC, p.v + ch * p.Q, k0, p.Q, 2 * kKC);
      },
      [&](int s, float* slot) {
        const int k0 = (s % nk) * kKC;
        const float* vec = slot + 2 * kTileFloats;
        split_tile(split, slot + kTileFloats, nullptr);
        __syncthreads();
        if (s % nk == 0) {
          const float* cum = p.cum + ((bh0 + s / nk) * p.nc + c) * p.Q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = r0 + wr + 8 * h + g;
            rc.row[h] = i;
            rc.cum[h] = i < p.Q ? cum[i] : 0.f;
          }
        }
        // column chunks wholly above the warp's rows, or rows past Q: M = 0
        if (k0 > r0 + wr + kWarpRows - 1 || r0 + wr >= p.Q) return;
        if (k0 + kKC - 1 < r0 + wr) {             // left of every row
          const float cum_r = vec[kKC - 1];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            rc.u[h] = rc.row[h] < p.Q ? expf(rc.cum[h] - cum_r) : 0.f;
          mma_step<kY, true>(acc, slot, split, vec, wr, k0, p.Q, rc);
        } else {
          mma_step<kY, false>(acc, slot, split, vec, wr, k0, p.Q, rc);
        }
      },
      [&](int job) {
        const long ch = (bh0 + job) * p.nc + c;
        store_tile(acc, p.y + (ch * p.Q + r0) * p.P + p0, p.P, wr, p.Q - r0,
                   p.P - p0);
      });
}

// Launch 3: states of one (group, chunk, 64 of N, 64 of P) for a block of
// the group's heads: B^T (w o x), the contraction over all Q steps.
__global__ void __launch_bounds__(kThreads)
ssd_states_kernel(Params p) {
  extern __shared__ __align__(16) float ring[];
  float* split = ring + kStages * kStageFloats;
  int rest = blockIdx.x;
  const int hb = rest % p.n_hb;
  rest /= p.n_hb;
  const int pb = rest % p.n_pb;
  rest /= p.n_pb;
  const int nb = rest % p.n_nb;
  const long chg = rest / p.n_nb;
  const int bg = static_cast<int>(chg / p.nc);
  const int c = static_cast<int>(chg % p.nc);
  long bh0;
  int n_h;
  head_block(p, bg, hb, &bh0, &n_h);
  const int n0 = nb * kTile, p0 = pb * kTile;
  const int nk = (p.Q + kKC - 1) / kKC;
  const int wr = kWarpRows * (threadIdx.x >> 5);
  const float* bbase = p.bm + chg * p.Q * p.N + n0;
  const RowCum rc{};
  float acc[8][4] = {};
  run_ring(
      ring, n_h, nk,
      [&](int s, float* slot) {
        const long ch = (bh0 + s / nk) * p.nc + c;
        const int k0 = (s % nk) * kKC;
        load_kc(slot, bbase, p.N, k0, p.Q, p.N - n0, p.vec_bc);
        load_kc(slot + kTileFloats, p.x + ch * p.Q * p.P + p0, p.P,
                          k0, p.Q, p.P - p0, p.vec_x);
        load_vec(slot + 2 * kTileFloats, p.w + ch * p.Q, k0, p.Q, 0);
      },
      [&](int s, float* slot) {
        split_tile(split, slot + kTileFloats,
                             slot + 2 * kTileFloats);
        __syncthreads();
        if (n0 + wr >= p.N) return;                // rows past N
        mma_step<kStates, false>(acc, slot, split, nullptr, wr,
                                 (s % nk) * kKC, p.Q, rc);
      },
      [&](int job) {
        const long ch = (bh0 + job) * p.nc + c;
        store_tile(acc, p.states + (ch * p.N + n0) * p.P + p0, p.P, wr,
                   p.N - n0, p.P - p0);
      });
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// Enqueues the three launches on ``stream``. x, dt, a, y, states, decay as
// above; bm/cm (BG, nc, Q, N) with BH % BG == 0; scores (BG, nc, Q, Qs)
// with the rows padded to Qs, a multiple of 4 floats >= Q; cum, w and v
// (BH, nc, Q) float32 scratch. All arrays contiguous float32 on the
// device. Returns the CUDA error code of the first failure, or 0.
int ssd_chunk_launch(const void* x, const void* dt, const void* a,
                     const void* bm, const void* cm, void* y, void* states,
                     void* decay, void* scores, void* cum, void* w, void* v,
                     int BH, int BG, int nc, int Q, int P, int N, int Qs,
                     void* stream) {
  if (BH == 0 || nc == 0) return 0;
  if (BG <= 0 || BH % BG != 0 || Qs < Q || Qs % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(scores)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{};
  p.x = static_cast<const float*>(x);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.bm = static_cast<const float*>(bm);
  p.cm = static_cast<const float*>(cm);
  p.y = static_cast<float*>(y);
  p.states = static_cast<float*>(states);
  p.decay = static_cast<float*>(decay);
  p.scores = static_cast<float*>(scores);
  p.cum = static_cast<float*>(cum);
  p.w = static_cast<float*>(w);
  p.v = static_cast<float*>(v);
  p.BH = BH;
  p.BG = BG;
  p.rep = BH / BG;
  p.nc = nc;
  p.Q = Q;
  p.P = P;
  p.N = N;
  p.Qs = Qs;
  p.n_rb = (Q + kTile - 1) / kTile;
  p.n_pb = (P + kTile - 1) / kTile;
  p.n_nb = (N + kTile - 1) / kTile;
  p.n_tri = p.n_rb * (p.n_rb + 1) / 2;
  p.hpc = min(kHeadsPerCta, p.rep);
  p.n_hb = (p.rep + p.hpc - 1) / p.hpc;
  p.vec_x = P % 4 == 0 && aligned16(x);
  p.vec_bc = N % 4 == 0 && aligned16(bm) && aligned16(cm);

  const long groups = static_cast<long>(BG) * nc;
  const long score_ctas = groups * p.n_tri;
  const long warps = kThreads / 32;
  const long prep_ctas =
      score_ctas + (static_cast<long>(BH) * nc + warps - 1) / warps;
  const long y_ctas = groups * p.n_rb * p.n_pb * p.n_hb;
  const long st_ctas = groups * p.n_nb * p.n_pb * p.n_hb;
  if (prep_ctas > INT_MAX || y_ctas > INT_MAX || st_ctas > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  p.n_score_ctas = static_cast<int>(score_ctas);

  const void* kernels[3] = {reinterpret_cast<const void*>(ssd_prep_kernel),
                            reinterpret_cast<const void*>(ssd_y_kernel),
                            reinterpret_cast<const void*>(ssd_states_kernel)};
  const long grid[3] = {prep_ctas, y_ctas, st_ctas};
  // the shared-memory attribute once per device (a runtime call each)
  static int configured = -1;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = 0; k < 3 && device != configured; ++k) {
    err = cudaFuncSetAttribute(kernels[k],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  configured = device;
  for (int k = 0; k < 3; ++k) {
    void* args[] = {&p};
    err = cudaLaunchKernel(kernels[k], dim3(static_cast<unsigned>(grid[k])),
                           dim3(kThreads), args, kSmemBytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
