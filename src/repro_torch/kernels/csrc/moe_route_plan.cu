// Routing, 2T-Drop keep mask and dispatch plan of one MoE layer call for
// Hopper (sm_90a): everything between the router logits and the fused MoE
// kernel (fused_moe_pipeline.cu), in two launches.
//
// Replaces no TPU kernel: the JAX package computes the routing
// (core/gating.py), the keep mask (core/drop.py) and the sort plan
// (core/dispatch.py) in jnp, which XLA fuses into a few device ops. In
// PyTorch the same composition is ~100 small ops a layer call, each 10-30 us
// of host time for a few us of device work (64 tokens x 128 experts at a
// Qwen3 decode step), so the layer waits on the host. This file computes it
// in two launches with no read-back.
//
// What bounds it on an H100: neither bytes nor operations. The logits are
// (T, E) float32 (32 KB at T=64, E=128; 128 KB at DBRX's T=2048, E=16) and
// the outputs a few bytes a pair, so the bound is a few us; the time is two
// launch latencies and the plan's one-CTA passes over N = T*K pairs.
//
// Launch 1 (route): one warp per token row. The softmax follows PyTorch's
// warp softmax for rows of at most 1024 (each lane holds the elements
// lane + 32*i, a lane's exps summed in order, then an xor butterfly), top-k
// takes the largest probability with the lower index first among equals
// (lax.top_k's rule, gating.top_k's stable sort), the K values are summed
// in order, norm = vals / max(sum, 1e-20) and the 2T mode of each pair is
// norm > t_minor ? FULL : norm > t_major ? MAJOR : DROP (strict > on both).
// Writes idx, mode and combine (norm, or vals without renormalisation) per
// original pair.
//
// Launch 2 (plan, one CTA): the stable counting sort of dispatch.
// sort_dispatch over the original-expert view of fuse_sub_pairs: bucket
// group*2 + major_only for kept pairs, 2E for dropped ones, arrival order
// kept inside each bucket. Each warp owns a contiguous run of pairs; it
// counts its run per bucket (match_any: one lane adds a group of equal
// buckets), the counts are scanned bucket-major and warp-minor, and each
// warp walks its run again, ranking each pair by its warp's running base
// plus the lower lanes of its match group. No atomics where order matters;
// the integer sums of the counters use shared-memory atomics, whose result
// does not depend on order. From the bucket counts alone: group_offsets,
// the kernel's counts (clamped to capacity), the overflow in sub-pair units,
// the kept/dropped sub-pair counts and the kept-pair histogram over
// sub-expert ids.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int ROUTE_WARPS = 8;        // token rows per CTA of launch 1
constexpr int PLAN_WARPS = 32;        // warps of launch 2's CTA, at most
constexpr int PLAN_SMEM = 46 * 1024;  // its dynamic shared memory, at most
                                      // (48 KB less the static part)
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Threshold {
  const float* p;   // null: the scalar v
  long long st;     // stride per token
  long long sk;     // stride per pair
  float v;
};

// by value: a member function's ``this`` would put the kernel parameter
// in local memory
__device__ __forceinline__ float threshold_at(Threshold th, int t, int k) {
  return th.p ? th.p[t * th.st + k * th.sk] : th.v;
}

// (v, i) before (w, j): the larger probability, the lower index on a tie
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

template <int ITER>
__global__ void __launch_bounds__(ROUTE_WARPS * 32)
moe_route_kernel(const float* __restrict__ logits, int T, int E, int K,
                 int renorm, Threshold t_major, Threshold t_minor,
                 int* __restrict__ idx_out, int* __restrict__ mode_out,
                 float* __restrict__ comb_out) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * ROUTE_WARPS + (threadIdx.x >> 5);
  if (t >= T) return;                 // the whole warp leaves together
  const float* row = logits + static_cast<size_t>(t) * E;
  float e[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int j = lane + it * 32;
    e[it] = j < E ? row[j] : -INFINITY;
  }
  // softmax: the order of PyTorch's warp softmax
  float mx = e[0];
#pragma unroll
  for (int it = 1; it < ITER; ++it) mx = mx > e[it] ? mx : e[it];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(FULL_MASK, mx, off);
    mx = mx < o ? o : mx;
  }
  float sum = 0.0f;
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    e[it] = expf(e[it] - mx);
    sum += e[it];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(FULL_MASK, sum, off);
#pragma unroll
  for (int it = 0; it < ITER; ++it) e[it] = e[it] / sum;

  // top-k, one selection a round; lane k (k + 32) keeps the k-th pair, so
  // K <= 64
  unsigned taken = 0;
  float denom = 0.0f, v_lo = 0.0f, v_hi = 0.0f;
  int i_lo = 0, i_hi = 0;
  for (int k = 0; k < K; ++k) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int j = lane + it * 32;
      if (j < E && !((taken >> it) & 1u) && better(e[it], j, bv, bi)) {
        bv = e[it];
        bi = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL_MASK, bv, off);
      const int oi = __shfl_xor_sync(FULL_MASK, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
    denom += bv;
    if (k == lane) {
      v_lo = bv;
      i_lo = bi;
    } else if (k == lane + 32) {
      v_hi = bv;
      i_hi = bi;
    }
  }
  const float den = denom < 1e-20f ? 1e-20f : denom;
  for (int k = lane; k < K; k += 32) {
    const float v = k == lane ? v_lo : v_hi;
    const float norm = v / den;
    const int mode = norm > threshold_at(t_minor, t, k) ? 2
                     : norm > threshold_at(t_major, t, k) ? 1 : 0;
    const int at = t * K + k;
    idx_out[at] = k == lane ? i_lo : i_hi;
    mode_out[at] = mode;
    comb_out[at] = renorm ? norm : v;
  }
}

// bucket of a pair: group*2 + major_only when kept, 2E when dropped
__device__ __forceinline__ int bucket_of(int g, int mode, int E) {
  return mode > 0 ? 2 * g + (mode == 1) : 2 * E;
}

__global__ void __launch_bounds__(PLAN_WARPS * 32)
moe_plan_kernel(const int* __restrict__ idx, const int* __restrict__ mode,
                const float* __restrict__ comb, int N, int K, int E, int P,
                int capacity, int pad, int* __restrict__ offs,
                int* __restrict__ cf_out, int* __restrict__ cm_out,
                int* __restrict__ tok_out, float* __restrict__ comb_sorted,
                int* __restrict__ load, int* __restrict__ scalars) {
  extern __shared__ int smem[];
  __shared__ int sums[3];             // overflow, kept FULL, kept MAJOR-only
  const int B = 2 * E + 1;
  const int NW = blockDim.x >> 5;
  int* cnt = smem;                    // [NW][B] counts, then running bases
  int* boff = smem + NW * B;          // [B] bucket totals, then offsets
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < NW * B; i += blockDim.x) cnt[i] = 0;
  if (threadIdx.x < 3) sums[threadIdx.x] = 0;
  __syncthreads();

  const int seg = (N + NW - 1) / NW;
  const int lo = min(warp * seg, N), hi = min(lo + seg, N);
  int* mine = cnt + warp * B;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int b = i < hi ? bucket_of(idx[i], mode[i], E) : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, b);
    if (b >= 0 && lane == __ffs(peers) - 1) mine[b] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // per bucket: each warp's exclusive base among the warps, and the total
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    int run = 0;
    for (int w = 0; w < NW; ++w) {
      const int c = cnt[w * B + b];
      cnt[w * B + b] = run;
      run += c;
    }
    boff[b] = run;
  }
  __syncthreads();
  if (warp == 0) {                    // exclusive scan of the totals
    const int per = (B + 31) / 32;
    const int b0 = min(lane * per, B), b1 = min(b0 + per, B);
    int s = 0;
    for (int b = b0; b < b1; ++b) s += boff[b];
    int incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += o;
    }
    int run = incl - s;
    for (int b = b0; b < b1; ++b) {
      const int c = boff[b];
      boff[b] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NW * B; i += blockDim.x)
    cnt[i] += boff[i % B];

  for (int g = threadIdx.x; g < E; g += blockDim.x) {
    const int full = boff[2 * g + 1] - boff[2 * g];
    const int major = boff[2 * g + 2] - boff[2 * g + 1];
    offs[g] = boff[2 * g];
    const int cf = min(full, capacity);
    cf_out[g] = cf;
    cm_out[g] = min(full + major, capacity) - cf;
    load[g * P] = full + major;
    for (int j = 1; j < P; ++j) load[g * P + j] = full;
    // kept pairs past capacity, in sub-pairs: a FULL row is P halves
    const int over = P * max(full - capacity, 0)
                     + major - min(max(capacity - full, 0), major);
    atomicAdd(&sums[0], over);
    atomicAdd(&sums[1], P * full);
    atomicAdd(&sums[2], major);
  }
  __syncthreads();

  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int m = i < hi ? mode[i] : 0;
    const int b = i < hi ? bucket_of(idx[i], m, E) : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, b);
    const int pos = b >= 0 ? mine[b] + __popc(peers & ((1u << lane) - 1u))
                           : 0;
    __syncwarp();
    if (b >= 0 && lane == __ffs(peers) - 1) mine[b] += __popc(peers);
    __syncwarp();
    if (b >= 0) {
      tok_out[pos] = i / K;
      comb_sorted[pos] = m > 0 ? comb[i] : 0.0f;
    }
  }
  for (int p = N + threadIdx.x; p < N + pad; p += blockDim.x) {
    tok_out[p] = 0;
    comb_sorted[p] = 0.0f;
  }
  if (threadIdx.x == 0) {
    scalars[0] = sums[0];
    scalars[1] = sums[1];
    scalars[2] = sums[2];
    scalars[3] = N * P - sums[1] - sums[2];
  }
}

template <int ITER>
cudaError_t launch_route(const float* logits, int T, int E, int K,
                         int renorm, Threshold tm, Threshold tn, int* idx,
                         int* mode, float* comb, cudaStream_t s) {
  const int blocks = (T + ROUTE_WARPS - 1) / ROUTE_WARPS;
  moe_route_kernel<ITER><<<blocks, ROUTE_WARPS * 32, 0, s>>>(
      logits, T, E, K, renorm, tm, tn, idx, mode, comb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The warps of the plan launch's CTA for N pairs over E experts: one per
// 64 pairs (fewer counts to clear and scan at decode), at most PLAN_WARPS
// and as many as PLAN_SMEM holds ([warps][2E + 1] counts and the 2E + 1
// offsets); 0 when not even one warp fits.
int moe_route_plan_warps(int N, int E) {
  const int B = 2 * E + 1;
  const int fit = (PLAN_SMEM / 4 - B) / B;
  const int want = std::min(std::max((N + 63) / 64, 1), PLAN_WARPS);
  return fit < 1 ? 0 : std::min(fit, want);
}

// Enqueues both launches on ``stream``. logits (T, E) float32; each
// threshold a float32 pointer read at [t * st + k * sk], or null for the
// scalar ``v``; idx, mode (T*K) int32 and comb (T*K) float32 receive the
// routing; offs, cf, cm (E), tok_sorted (T*K + pad), load (E*P) and
// scalars (4: overflow, kept FULL, kept MAJOR-only, dropped sub-pairs)
// int32 and comb_sorted (T*K + pad) float32 the plan. E <= 1024, K <=
// min(E, 64) (checked by the caller). Returns the cudaGetLastError() code
// after the first failing launch, or 0.
int moe_route_plan_launch(
    const void* logits, const void* t_major, long long tm_st,
    long long tm_sk, float tm_v, const void* t_minor, long long tn_st,
    long long tn_sk, float tn_v, void* idx, void* mode, void* comb,
    void* offs, void* cf, void* cm, void* tok_sorted, void* comb_sorted,
    void* load, void* scalars, int T, int E, int K, int P, int renorm,
    int capacity, int pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Threshold tm{static_cast<const float*>(t_major), tm_st, tm_sk, tm_v};
  const Threshold tn{static_cast<const float*>(t_minor), tn_st, tn_sk, tn_v};
  const float* lg = static_cast<const float*>(logits);
  int* ix = static_cast<int*>(idx);
  int* md = static_cast<int*>(mode);
  float* cb = static_cast<float*>(comb);
  cudaError_t err = cudaSuccess;
  if (T > 0) {
    const int iter = (E + 31) / 32;
    if (iter <= 1)
      err = launch_route<1>(lg, T, E, K, renorm, tm, tn, ix, md, cb, s);
    else if (iter <= 2)
      err = launch_route<2>(lg, T, E, K, renorm, tm, tn, ix, md, cb, s);
    else if (iter <= 4)
      err = launch_route<4>(lg, T, E, K, renorm, tm, tn, ix, md, cb, s);
    else if (iter <= 8)
      err = launch_route<8>(lg, T, E, K, renorm, tm, tn, ix, md, cb, s);
    else if (iter <= 16)
      err = launch_route<16>(lg, T, E, K, renorm, tm, tn, ix, md, cb, s);
    else
      err = launch_route<32>(lg, T, E, K, renorm, tm, tn, ix, md, cb, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int warps = moe_route_plan_warps(T * K, E);
  const size_t smem = sizeof(int) * static_cast<size_t>(warps + 1) *
                      static_cast<size_t>(2 * E + 1);
  moe_plan_kernel<<<1, warps * 32, smem, s>>>(
      ix, md, cb, T * K, K, E, P, capacity, pad, static_cast<int*>(offs),
      static_cast<int*>(cf), static_cast<int*>(cm),
      static_cast<int*>(tok_sorted), static_cast<float*>(comb_sorted),
      static_cast<int*>(load), static_cast<int*>(scalars));
  return static_cast<int>(cudaGetLastError());
}

const char* moe_route_plan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
