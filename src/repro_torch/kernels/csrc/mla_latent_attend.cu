// MLA's absorbed attention over the paged latent pool, for Hopper (sm_90a):
// the scores of each query row against its slot's latent and rope-key rows,
// read in place through the page table up to the row's own position, the
// softmax, and the output in latent space.
//
// Replaces no TPU kernel: attention has no kernel in the JAX package
// (src/repro/models/attention.py leaves it to XLA). It exists because the
// PyTorch composition (ref.mla_latent_attend_ref) gathers every slot's
// pages up to the read length, copies them to float32 and runs the scores
// and the output as float32 batched products over all of them, masked rows
// included: ~25 host ops a layer call and, at 32 slots x 5120 rows, ~1.5 GB
// of device traffic a layer call for a few live rows.
//
// The function, per query row n (N of them, H heads) of group g (the rows
// of a group share one page-table row; G groups of N / G rows each):
//   s[t]  = scale * (q_lat[n, h] . c[t] + q_rope[n, h] . kr[t]),
//           t = 0 .. min(last[n], T - 1)
//   p     = bf16(exp(s - max s) / sum exp(s - max s))      (rounded after
//           the division, as the plain version rounds its softmax)
//   o[n, h] = sum_t p[t] * c[t]                            float32
// with c[t] the latent row of position t of the group's slot: page
// table[g][t / ps], row t % ps. q_lat, q_rope float32; c, kr bf16. The
// page size ps is any multiple of 8: pages are read in boxes of
// pb = gcd(ps, 32) rows, so a key tile of either pass holds whole boxes.
//
// What bounds it on an H100: decode (one row per slot, 16 heads) is bytes,
// the live latent and rope rows (1152 B a position at DeepSeek-V2-Lite's
// widths); a prompt chunk (256 rows x 16 heads over the slot's prefix) is
// operations: (3 x 576 + 512) x 2 FLOPs per (row, head, visible key) with
// the three-term query below.
//
// What the design does about it:
//   * Nothing is gathered: every launch reads the pool's bf16 pages where
//     they lie, only up to each query's position. Written besides o: the
//     float32 scores of the keys each row sees, a max and a sum of exp per
//     row and key slab, and, when the keys are split, partial outputs.
//   * The scores at float32 accuracy on the tensor cores: the float32 query
//     is split into three bf16 terms whose sum is exactly the query; the
//     keys are bf16 already, so each term's product with a key is exact in
//     the float32 accumulator (mma.sync m16n8k16, bf16 in, float32
//     accumulate). Each ring stage's score products (64 dims) go into
//     fragments that start from zero and are added to the running sums
//     with round-to-nearest float32 adds (the tensor cores' accumulators
//     round toward zero, and a long contraction left in one fragment
//     drifts).
//   * The output: p is rounded to bf16 after its division (a product with
//     the row's reciprocal sum, as a softmax normalises), and c is bf16, so
//     one bf16 pass takes exactly the products the plain version takes; a
//     fragment sums a split's keys (at most 5120 exact products a column).
//   * Three launches. (1) scores: a CTA owns a tile of 16 x WM (query,
//     head) rows of one group (WM = 1 a decoding slot of 16 heads, 3 at 40
//     heads, 4 in a chunk) and a split of the keys. Its q tile stays in
//     shared memory as float32 and is split into the three terms in
//     registers, fragment by fragment (an exact split: the leading 16
//     bits, those of the remainder, the rest); the key rows stream through
//     a ring 64 dims deep (128-byte rows: 4 stages, 2 for a decoding
//     slot's tile, two CTAs an SM), one TMA box a pb rows (128-byte
//     swizzle), issued by a warp of its own (a lane a box, the page table
//     read a stage ahead) into slots the consumer warps release on mbarriers;
//     each consumer warp owns 16 rows x 64 keys; CTAs of one split start
//     at different key tiles. Keys past the tile's last visible one are
//     never read. Each lane keeps a running max and sum of exp of the
//     scores it writes. (2) weighted: a CTA owns the same row tile, 256 latent
//     columns and a split of the keys; it merges the score pass's partial
//     statistics of its rows, streams scores (one TMA box a stage) and
//     latent rows (a box per pb rows and 64 columns, 128-byte swizzle)
//     through a 6-stage ring, forms p once a stage into a shared tile
//     (zero past each row's position) while the warps multiply the
//     previous one; each warp owns 16 rows x 64 columns. (3) when the keys
//     were split, the partial outputs are summed in split order.
//   * The host picks the row tile and the key splits from the shapes and
//     the SM count alone (mla_attend.plan), so that decode (32 slots x 16
//     heads) and a chunk (4096 rows) both fill the card.
//   * Fragment reads are free of bank conflicts: the swizzled TMA tiles,
//     and padded row strides (80, 2336 or 1184 bytes) elsewhere. One writer
//     per output element and a fixed summation order: runs are
//     bit-identical. No atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KS = 64;               // dims per stage of the score pass
// its ring's stages: 2 for a decoding slot's 16-row tile (two CTAs an
// SM), 4 for wider tiles (one)
template <int WM>
__host__ __device__ constexpr int ring1() {
  return WM == 1 ? 2 : 4;
}
constexpr int BK = 32;               // keys per stage of the weighted pass
constexpr int RING3 = 6;             // its ring's stages
constexpr int P_STRIDE = BK + 8;     // bf16 per row of its p tile
constexpr int COLS = 256;            // latent columns per weighted CTA
constexpr int CBOX = 64;             // latent columns per TMA box there
constexpr int SUM_THREADS = 256;     // threads per CTA of the split sum

// The TMA maps of a call: the pools as (pages * ps, width) bf16 in boxes
// of pb rows and 64 dims under the 128-byte swizzle (the latent, both passes;
// the rope key where it is 64 wide, else 32 dims under the 64-byte
// swizzle); the scores as (N * H, ld_s) float32 in boxes of BK keys x one
// row tile.
struct Maps {
  CUtensorMap c64;
  CUtensorMap kr;
  CUtensorMap s;
};

struct Args {
  const float* q_lat;    // (N, H, R) with strides q_sn, q_sh, last dim 1
  const float* q_rope;   // (N, H, DR) with strides r_sn, r_sh, last dim 1
  long long q_sn, q_sh, r_sn, r_sh;
  const int* table;      // (G, n_logical) physical page ids
  const int* last;       // (N,) each query row's last visible position
  float* scores;         // (N * H, ld_s)
  float2* stats;         // (n_split1, wn1, N * H) partial max, sum of exp
  float* part;           // (n_split3, N * H, R) when the keys are split
  float* out;            // (N * H, R)
  int H, S, G, n_logical, ps, T, ld_s;
  int pb;                // rows a TMA box of the pools: gcd(ps, 32)
  int split1, split3, n_split3;
  int n_rows;            // N * H
  int wn1;               // key slabs per split of the score pass
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, L2 only; zero-filled where !valid (src is
// not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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

// a ring's barriers: full (one arrival, the issuing lane, and the bytes)
// and, where given, empty (one arrival per consuming warp)
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int n, int consumers) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      mbar_init(full + i, 1);
      if (empty) mbar_init(empty + i, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// a box of a 2D tensor map at (c0 inner, c1 outer), completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// d += a * b on one 16x8x16 fragment: bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + mid + lo exactly, for a pair (a, b) packed two to a register
// (a in the low half): hi is x's leading 16 bits (a bf16, x truncated),
// mid the leading 16 bits of the remainder x - hi (exact in float32), lo
// the rest, at most 8 significant bits, exact in bf16.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);
  const float ra = a - __uint_as_float(ua & 0xffff0000u);
  const float rb = b - __uint_as_float(ub & 0xffff0000u);
  const uint32_t ura = __float_as_uint(ra), urb = __float_as_uint(rb);
  mid = __byte_perm(ura, urb, 0x7632);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      ra - __uint_as_float(ura & 0xffff0000u),
      rb - __uint_as_float(urb & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The row tile of this CTA: rows [gr0, gr0 + rows) of the flattened
// (N * H) rows, all of group g, and the last key any of them sees.
struct Tile {
  int g, rows;
  long long gr0;
  int kmax;
};

template <int BM>
__device__ __forceinline__ Tile row_tile(const Args& a) {
  Tile t;
  const int rows_g = a.S * a.H;
  const int tpg = (rows_g + BM - 1) / BM;
  t.g = blockIdx.x / tpg;
  const int fr0 = (blockIdx.x % tpg) * BM;
  t.rows = min(BM, rows_g - fr0);
  t.gr0 = static_cast<long long>(t.g) * rows_g + fr0;
  t.kmax = 0;
  const int gr0 = static_cast<int>(t.gr0);
  for (int n = gr0 / a.H; n <= (gr0 + t.rows - 1) / a.H; ++n)
    t.kmax = max(t.kmax, min(a.last[n], a.T - 1));
  return t;
}

__device__ __forceinline__ int row_limit(const Args& a, int gr) {
  return min(a.last[gr / a.H], a.T - 1);
}

// one score into a running max m and sum of exp(s - m)
__device__ __forceinline__ void online(float s, float& m, float& l) {
  if (s > m) {
    l = l * expf(m - s) + 1.f;
    m = s;
  } else {
    l += expf(s - m);
  }
}

// (m, l) with another running max and sum (either may be empty: -inf, 0)
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

// ---------------------------------------------------------------------------
// (1) scores
// ---------------------------------------------------------------------------

template <int R, int DR, int WM, int WN>
constexpr int score_smem() {
  return ring1<WM>() * (64 * WN * KS * 2 + 16) + 16 * WM * (R + DR + 8) * 4;
}

// The A fragment of one 16x16 step, its three bf16 terms: a0 (row g, keys
// 2c, 2c + 1), a1 (g + 8), a2 (g, 2c + 8), a3 (g + 8, 2c + 8) from the
// float32 q tile row-major at q (row g, column 2c already applied)
template <int STRIDE>
__device__ __forceinline__ void split_fragment(const float* q,
                                               uint32_t (&t)[3][4]) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const float2 v = *reinterpret_cast<const float2*>(
        q + (f & 1) * 8 * STRIDE + (f >> 1) * 8);
    split_pair(v.x, v.y, t[0][f], t[1][f], t[2][f]);
  }
}

// Element offset of dims 8c..8c+7 of key row k in a score stage of D dims:
// rows of 128 B (D 64) under TMA's 128-byte swizzle, or of 64 B (D 32)
// under the 64-byte swizzle (boxes of pb >= 8 rows, 1024-byte aligned): the
// 16-byte chunk index XOR k % 8, or (k / 2) % 4.
template <int D>
__device__ __forceinline__ int stage_offset(int k, int c) {
  return D == 64 ? k * 64 + ((c ^ (k & 7)) << 3)
                 : k * 32 + ((c ^ ((k >> 1) & 3)) << 3);
}

// A warp's 16 rows x 64 keys of one stage of D dims: the three terms of
// its q fragment against the stage's key rows, into tmp
template <int D, int A_STRIDE>
__device__ __forceinline__ void stage_products(const bf16* Bt, const float* Aw,
                                               int wn, int lane,
                                               float (&tmp)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4][4];
#pragma unroll
    for (int np = 0; np < 4; ++np)
      ldsm_x4(b[np], Bt + stage_offset<D>(wn * 64 + np * 16 + (lane & 7) +
                                              ((lane >> 4) << 3),
                                          kk * 2 + ((lane >> 3) & 1)));
    uint32_t af[3][4];
    split_fragment<A_STRIDE>(Aw + kk * 16, af);
#pragma unroll
    for (int term = 2; term >= 0; --term) {   // the smallest first
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        mma_bf16(tmp[2 * np], af[term], b[np][0], b[np][1]);
        mma_bf16(tmp[2 * np + 1], af[term], b[np][2], b[np][3]);
      }
    }
  }
}

template <int R, int DR, int WM, int WN>
__global__ void __launch_bounds__((WM * WN + 1) * 32, WM == 1 ? 2 : 1)
    mla_score_kernel(const Args a, const __grid_constant__ Maps maps) {
  constexpr int CONSUMERS = WM * WN;              // warps; one more issues
  constexpr int NT = (CONSUMERS + 1) * 32;
  constexpr int RING = ring1<WM>();
  constexpr int BM = 16 * WM, BN = 64 * WN;
  constexpr int KD = R + DR, A_STRIDE = KD + 8;   // floats
  // stages of 64 dims over the latent, then one over the rope key (64 or
  // 32 dims)
  constexpr int NKS_C = R / KS, NKS = NKS_C + 1, DR_STAGE = DR;
  constexpr int STAGE = BN * KS;                  // bf16 a stage, at most
  static_assert(R % KS == 0 && (DR == 64 || DR == 32),
                "latent widths of 64s and rope keys of 64 or 32");
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem);       // [RING][BN][KS] swizzled
  float* As = reinterpret_cast<float*>(Bs + RING * STAGE);  // [BM][A_STRIDE]
  uint64_t* full = reinterpret_cast<uint64_t*>(As + BM * A_STRIDE);
  uint64_t* empty = full + RING;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const Tile tl = row_tile<BM>(a);
  const int k0 = blockIdx.y * a.split1;
  if (k0 > tl.kmax) return;
  const int k1 = min(k0 + a.split1, tl.kmax + 1);   // keys [k0, k1)
  const int n_kt = (k1 - k0 + BN - 1) / BN;
  const int steps = n_kt * NKS;
  // CTAs of one split walk its key tiles from different starts
  const int rot = blockIdx.x % n_kt;
  init_ring(full, empty, RING, CONSUMERS);

  // the q tile, float32, by cp.async (rows past the tile: zeros)
  for (int ch = tid; ch < BM * (KD / 4); ch += NT) {
    const int row = ch / (KD / 4), col = (ch % (KD / 4)) * 4;
    const float* src = a.q_lat;
    if (row < tl.rows) {
      const int gr = static_cast<int>(tl.gr0) + row;
      const long long n = gr / a.H, h = gr % a.H;
      src = col < R ? a.q_lat + n * a.q_sn + h * a.q_sh + col
                    : a.q_rope + n * a.r_sn + h * a.r_sh + (col - R);
    }
    cp_async16(As + row * A_STRIDE + col, src, row < tl.rows);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // Stage u: a stage's dims of a key tile, one TMA box a pb rows (boxes
  // past the split are not loaded: their columns are never written). The
  // last warp issues, lane b box b, each lane reading its pool row a call
  // ahead, into a slot the consumers have released.
  auto key_tile = [&](int u) { return k0 + ((u / NKS + rot) % n_kt) * BN; };
  auto boxes_of = [&](int kt) {
    return (min(kt + BN, k1) - kt + a.pb - 1) / a.pb;
  };
  auto row_of = [&](int u) {
    if (u >= steps) return -1;
    const int kt = key_tile(u);
    const int t = kt + lane * a.pb;
    return lane < boxes_of(kt)
               ? a.table[tl.g * a.n_logical + t / a.ps] * a.ps + t % a.ps
               : -1;
  };
  if (warp == CONSUMERS) {
    int row = row_of(0);
    for (int u = 0; u < steps; ++u) {
      const int kt = key_tile(u), s = u % NKS, slot = u % RING;
      if (u >= RING) mbar_wait(empty + slot, (u / RING - 1) & 1);
      const bool lat = s < NKS_C;
      const int dims = lat ? KS : DR_STAGE;
      if (lane == 0)
        mbar_arrive_tx(full + slot, boxes_of(kt) * a.pb * dims * 2);
      __syncwarp();
      if (row >= 0)
        tma_load_2d(Bs + slot * STAGE + lane * a.pb * dims,
                    lat ? &maps.c64 : &maps.kr, lat ? s * KS : 0, row,
                    full + slot);
      row = row_of(u + 1);
    }
    return;
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // a stage's products, added to acc with round-to-nearest adds
  float tmp[8][4];
  // running max and sum of exp of the scores this lane writes, rows g and
  // g + 8 of its warp's fragment
  float rm[2] = {-INFINITY, -INFINITY}, rl[2] = {0.f, 0.f};

  const float* Aw = As + (wm * 16 + (lane >> 2)) * A_STRIDE + 2 * (lane & 3);
  for (int u = 0; u < steps; ++u) {
    mbar_wait(full + u % RING, (u / RING) & 1);
    const int s = u % NKS;
    const bf16* Bt = Bs + (u % RING) * STAGE;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[j][e] = 0.f;
    if (s < NKS_C)
      stage_products<KS, A_STRIDE>(Bt, Aw + s * KS, wn, lane, tmp);
    else
      stage_products<DR_STAGE, A_STRIDE>(Bt, Aw + s * KS, wn, lane, tmp);
    // the slot is read: release it to the issuing warp
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + u % RING);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += tmp[j][e];
    if (s == NKS - 1) {   // the key tile is done: write what each row sees
      const int kt = key_tile(u) + wn * 64;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 16 + (lane >> 2) + half * 8;
        if (row < tl.rows) {
          const int gr = static_cast<int>(tl.gr0) + row;
          const int lim = min(row_limit(a, gr), k1 - 1);
          float* dst = a.scores + static_cast<long long>(gr) * a.ld_s;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key = kt + j * 8 + 2 * (lane & 3);
            const float v0 = acc[j][2 * half] * a.scale;
            const float v1 = acc[j][2 * half + 1] * a.scale;
            if (key + 1 <= lim) {
              *reinterpret_cast<float2*>(dst + key) = make_float2(v0, v1);
              online(v0, rm[half], rl[half]);
              online(v1, rm[half], rl[half]);
            } else if (key <= lim) {
              dst[key] = v0;
              online(v0, rm[half], rl[half]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
  }
  // the quad's four lanes hold a row's 64 keys of each key tile: merged,
  // one partial (max, sum of exp) per row, split and key slab
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, rm[half], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, rl[half], o);
      merge(rm[half], rl[half], m2, l2);
    }
    const int row = wm * 16 + (lane >> 2) + half * 8;
    if ((lane & 3) == 0 && row < tl.rows)
      a.stats[(static_cast<long long>(blockIdx.y) * WN + wn) * a.n_rows +
              tl.gr0 + row] = make_float2(rm[half], rl[half]);
  }
}

// ---------------------------------------------------------------------------
// (3) weighted: o = p @ c
// ---------------------------------------------------------------------------

template <int WM>
constexpr int weighted_smem() {
  return RING3 * (BK * COLS * 2 + 16 * WM * BK * 4) +
         2 * 16 * WM * P_STRIDE * 2 + RING3 * 8;
}

// Element offset of columns 8c..8c+7 (c < 32) of key k (< BK) in a latent
// stage of the weighted pass: boxes of pb keys x 64 columns (128 B rows
// under TMA's 128-byte swizzle, 1024-byte aligned), key-box-major, the
// column boxes of a key box side by side: the chunk index XOR k % 8.
__device__ __forceinline__ int sw128(int k, int c, int pb) {
  const int r = k % pb;
  return ((k / pb) * (COLS / CBOX) + (c >> 3)) * pb * CBOX + r * CBOX +
         (((c & 7) ^ (r & 7)) << 3);
}

template <int R, int WM>
__global__ void __launch_bounds__(WM * 128, WM == 1 ? 2 : 1)
    mla_weighted_kernel(const Args a, const __grid_constant__ Maps maps) {
  constexpr int NT = WM * 128, BM = 16 * WM;
  constexpr int C_STAGE = BK * COLS;              // bf16 a stage
  constexpr int S_STAGE = BM * BK;                // floats a stage
  constexpr int PAIRS = BM * BK / 2;
  constexpr int P_PER_T = PAIRS / NT;
  static_assert(R % COLS == 0, "the latent width must be a multiple of 256");
  static_assert(PAIRS % NT == 0, "p pairs per thread");
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);       // [RING3][C_STAGE]
  float* Ss = reinterpret_cast<float*>(Cs + RING3 * C_STAGE);
                                                  // [RING3][BM][BK]
  bf16* Ps = reinterpret_cast<bf16*>(Ss + RING3 * S_STAGE);
                                                  // [2][BM][P_STRIDE]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ps + 2 * BM * P_STRIDE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const Tile tl = row_tile<BM>(a);
  const int col0 = blockIdx.y * COLS;
  const int z = blockIdx.z;
  const int k0 = z * a.split3;
  if (k0 > tl.kmax) return;
  const int k1 = min(k0 + a.split3, tl.kmax + 1);
  const int steps = (k1 - k0 + BK - 1) / BK;
  init_ring(full, nullptr, RING3, 0);

  // this thread's p pairs (row, keys 2c, 2c + 1 of the stage): the row's
  // last key in this split, its max and the reciprocal of its sum
  int prow[P_PER_T], plim[P_PER_T];
  float pm[P_PER_T], pinv[P_PER_T];
#pragma unroll
  for (int i = 0; i < P_PER_T; ++i) {
    prow[i] = (tid + i * NT) / (BK / 2);
    plim[i] = -1;
    pm[i] = 0.f;
    pinv[i] = 0.f;
    if (prow[i] < tl.rows) {
      // the score pass's partials of the splits that reach the row
      const int gr = static_cast<int>(tl.gr0) + prow[i];
      const int lim = row_limit(a, gr);
      float m = -INFINITY, l = 0.f;
      for (int part = 0; part < (lim / a.split1 + 1) * a.wn1; ++part) {
        const float2 st =
            a.stats[static_cast<long long>(part) * a.n_rows + gr];
        merge(m, l, st.x, st.y);
      }
      plim[i] = min(lim, k1 - 1);
      pm[i] = m;
      pinv[i] = 1.f / l;
    }
  }

  // Stage u: BK keys, a TMA box per (pb keys, 64 columns) and one of the
  // row tile's scores (rows and keys past the tensors arrive as zeros).
  // Every box of the stage is loaded, from page 0 past the slot's table: p
  // is zero there, and its products must be finite. Warp 0 issues, lane
  // BOXES j + b the box (j, b); each lane reads its pool row a call ahead.
  constexpr int BOXES = COLS / CBOX;
  const int stage_boxes = BK / a.pb;
  auto row_of = [&](int u) {
    const int t = k0 + u * BK + (lane / BOXES) * a.pb, p = t / a.ps;
    return u < steps && lane < stage_boxes * BOXES
               ? (p < a.n_logical ? a.table[tl.g * a.n_logical + p] : 0) *
                         a.ps +
                     t % a.ps
               : -1;
  };
  int row = warp == 0 ? row_of(0) : -1;
  auto issue = [&](int u) {
    if (u < steps) {
      const int kb = k0 + u * BK, slot = u % RING3;
      if (lane == 0) mbar_arrive_tx(full + slot, C_STAGE * 2 + S_STAGE * 4);
      __syncwarp();
      if (row >= 0)
        tma_load_2d(Cs + slot * C_STAGE + lane * a.pb * CBOX, &maps.c64,
                    col0 + (lane % BOXES) * CBOX, row, full + slot);
      if (lane == 31)
        tma_load_2d(Ss + slot * S_STAGE, &maps.s, kb,
                    static_cast<int>(tl.gr0), full + slot);
    }
    row = row_of(u + 1);
  };

  // p of stage v from its scores, once per CTA: bf16(exp(s - m) / l),
  // zero past each row's position
  auto weights = [&](int v) {
    const float* src = Ss + (v % RING3) * S_STAGE;
    bf16* dst = Ps + (v & 1) * BM * P_STRIDE;
#pragma unroll
    for (int i = 0; i < P_PER_T; ++i) {
      const int kp = ((tid + i * NT) % (BK / 2)) * 2;
      const int key = k0 + v * BK + kp;
      const float2 sv =
          *reinterpret_cast<const float2*>(src + prow[i] * BK + kp);
      const float p0 = key <= plim[i] ? expf(sv.x - pm[i]) * pinv[i] : 0.f;
      const float p1 =
          key + 1 <= plim[i] ? expf(sv.y - pm[i]) * pinv[i] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(dst + prow[i] * P_STRIDE + kp) =
          __floats2bfloat162_rn(p0, p1);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (warp == 0)
    for (int u = 0; u < RING3 - 1; ++u) issue(u);
  mbar_wait(full, 0);
  weights(0);
  for (int u = 0; u < steps; ++u) {
    if (u + 1 < steps)
      mbar_wait(full + (u + 1) % RING3, ((u + 1) / RING3) & 1);
    // p of stage u is visible, and every warp is past stage u - 1: its
    // slots take stage u + RING3 - 1
    __syncthreads();
    if (warp == 0) issue(u + RING3 - 1);
    if (u + 1 < steps) weights(u + 1);
    const bf16* Ct = Cs + (u % RING3) * C_STAGE;
    const bf16* Pt = Ps + (u & 1) * BM * P_STRIDE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, Pt + (wm * 16 + (lane & 15)) * P_STRIDE + kk * 16 +
                      (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, Ct + sw128(kk * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8,
                                    wn * 8 + np * 2 + (lane >> 4), a.pb));
        mma_bf16(acc[2 * np], af, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
      }
    }
  }

  const long long n_rows = a.n_rows;
  float* base = a.n_split3 > 1 ? a.part + z * n_rows * R : a.out;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = wm * 16 + (lane >> 2) + half * 8;
    if (row < tl.rows) {
      float* dst = base + (tl.gr0 + row) * R + col0 + wn * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + j * 8 + 2 * (lane & 3)) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// (4) the key splits' partial outputs, summed in split order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SUM_THREADS)
    mla_split_sum_kernel(const Args a, long long n_rows, int R) {
  const long long i =
      static_cast<long long>(blockIdx.x) * SUM_THREADS + threadIdx.x;
  const int q = R / 4;
  if (i >= n_rows * q) return;
  const long long gr = i / q;
  const int col = static_cast<int>(i % q) * 4;
  const int splits = row_limit(a, static_cast<int>(gr)) / a.split3 + 1;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(
        a.part + (z * n_rows + gr) * R + col);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(a.out + gr * R + col) = s;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// the dynamic shared memory attribute once per kernel and device
cudaError_t allow_smem(const void* kernel, int bytes, int& configured) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == configured) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = device;
  return err;
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links no libcuda of its own); null where it is missing
typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                           void*, const cuuint64_t*, const cuuint64_t*,
                           const cuuint32_t*, const cuuint32_t*,
                           CUtensorMapInterleave, CUtensorMapSwizzle,
                           CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

Encode encoder() {
  static const Encode fn = [] {
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
    return reinterpret_cast<Encode>(p);
  }();
  return fn;
}

// A 2D map over rows of `width` elements (`elem` bytes) in boxes of
// box_w x box_h; elements out of bounds arrive as zeros
bool map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
            int elem, long long width, long long rows, long long row_bytes,
            int box_w, int box_h, CUtensorMapSwizzle swizzle) {
  const Encode encode = encoder();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h)};
  const cuuint32_t step[2] = {1, 1};
  (void)elem;
  return encode &&
         encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int R, int DR, int WM>
cudaError_t launch_tiles(Args a, const Maps& maps, int n_tiles, int n_split1,
                         cudaStream_t s) {
  constexpr int WN = WM == 1 ? 4 : 2;
  a.wn1 = WN;
  constexpr int s1 = score_smem<R, DR, WM, WN>();
  constexpr int s3 = weighted_smem<WM>();
  static_assert(s1 <= 232448 && s3 <= 232448, "shared memory");
  static int conf1 = -1, conf3 = -1;
  const void* k1 = reinterpret_cast<const void*>(
      mla_score_kernel<R, DR, WM, WN>);
  const void* k3 = reinterpret_cast<const void*>(mla_weighted_kernel<R, WM>);
  cudaError_t err = allow_smem(k1, s1, conf1);
  if (err != cudaSuccess) return err;
  err = allow_smem(k3, s3, conf3);
  if (err != cudaSuccess) return err;
  const long long n_rows = a.n_rows;
  mla_score_kernel<R, DR, WM, WN>
      <<<dim3(n_tiles, n_split1), (WM * WN + 1) * 32, s1, s>>>(a, maps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_weighted_kernel<R, WM>
      <<<dim3(n_tiles, R / COLS, a.n_split3), WM * 128, s3, s>>>(a, maps);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split3 == 1) return err;
  const long long n = n_rows * (R / 4);
  mla_split_sum_kernel<<<static_cast<unsigned>(
                             (n + SUM_THREADS - 1) / SUM_THREADS),
                         SUM_THREADS, 0, s>>>(a, n_rows, R);
  return cudaGetLastError();
}

template <int R, int DR>
cudaError_t launch_width(const Args& a, const Maps& maps, int wm, int n_tiles,
                         int n_split1, cudaStream_t s) {
  switch (wm) {
    case 1: return launch_tiles<R, DR, 1>(a, maps, n_tiles, n_split1, s);
    case 2: return launch_tiles<R, DR, 2>(a, maps, n_tiles, n_split1, s);
    case 3: return launch_tiles<R, DR, 3>(a, maps, n_tiles, n_split1, s);
    case 4: return launch_tiles<R, DR, 4>(a, maps, n_tiles, n_split1, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Enqueues the launches on ``stream``. q_lat (N, H, R) and q_rope (N, H, DR)
// float32 with row strides (q_sn, q_sh) / (r_sn, r_sh) in elements and unit
// last stride, 16-byte aligned rows; c (pages, ps, R) and kr (pages, ps,
// DR) bf16 contiguous, ps a multiple of 8; table (G, n_logical) and last (N,)
// int32; float32 scratch: scores (N * H, ld_s), stats (n_split1, wn, N * H,
// 2) with wn 4 where wm is 1 and 2 otherwise, part (n_split3, N * H, R)
// (unused when n_split3 is 1); out (N * H, R) float32. (R, DR) is (512, 64)
// or (256, 32); wm (1 to 4) sets the row tile (16 * wm rows); split1 /
// split3 the keys per split of the score and weighted passes (multiples of
// 64 * wn and of 32), n_split1 / n_split3 their counts. Returns the CUDA
// error code of the first failure, or 0.
int mla_latent_attend_launch(
    const void* q_lat, const void* q_rope, long long q_sn, long long q_sh,
    long long r_sn, long long r_sh, const void* c, const void* kr,
    const void* table, const void* last, void* scores, void* stats,
    void* part, void* out, int R, int DR, int H, int S, int G, int n_logical,
    int pages, int ps, int T, int ld_s, int wm, int split1, int n_split1,
    int split3, int n_split3, float scale, void* stream) {
  if (G == 0 || S == 0 || H == 0) return 0;
  if (T < 1 || ps < 8 || ps % 8 != 0 || ld_s < T ||
      ld_s % 4 != 0 || split1 < 1 || split3 < 1 || n_split1 < 1 ||
      n_split3 < 1 || split1 % 128 != 0 || split3 % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q_lat = static_cast<const float*>(q_lat);
  a.q_rope = static_cast<const float*>(q_rope);
  a.q_sn = q_sn;
  a.q_sh = q_sh;
  a.r_sn = r_sn;
  a.r_sh = r_sh;
  a.table = static_cast<const int*>(table);
  a.last = static_cast<const int*>(last);
  a.scores = static_cast<float*>(scores);
  a.stats = static_cast<float2*>(stats);
  a.part = static_cast<float*>(part);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.S = S;
  a.G = G;
  a.n_logical = n_logical;
  a.ps = ps;
  a.pb = ps % 32 == 0 ? 32 : ps % 16 == 0 ? 16 : 8;
  a.T = T;
  a.ld_s = ld_s;
  a.split1 = split1;
  a.split3 = split3;
  a.n_split3 = n_split3;
  a.scale = scale;
  a.n_rows = G * S * H;
  const int n_tiles = G * ((S * H + 16 * wm - 1) / (16 * wm));
  const long long rows = static_cast<long long>(pages) * ps;
  Maps maps;
  if (!map_2d(&maps.c64, c, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, R, rows,
              R * 2LL, CBOX, a.pb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_2d(&maps.kr, kr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, DR, rows,
              DR * 2LL, DR, a.pb,
              DR == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !map_2d(&maps.s, scores, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ld_s,
              a.n_rows, ld_s * 4LL, BK, 16 * wm,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (R == 512 && DR == 64)
    err = launch_width<512, 64>(a, maps, wm, n_tiles, n_split1, s);
  else if (R == 256 && DR == 32)
    err = launch_width<256, 32>(a, maps, wm, n_tiles, n_split1, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* mla_latent_attend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
