// K12: the pileup of a read batch and the 10-genotype model with its
// finish, per tile of positions, in one launch.
//
// Replaces, on the fused exact tier and in fused_pileup_call /
// fused_emit_chunk, the XLA-fused pileup (:37) and `_agg_quals_f32` of
// bs_call_tpu/ops/kernels/pileup_device.py and the Pallas kernel `_kernel`
// of bs_call_tpu/ops/kernels/genotype_pallas.py (:48), the fusion that
// genotype_pallas.py:19-22 plans ("folding the pileup scatter and the
// aggregation into the same kernel"). Outputs are bit for bit those of
// its plain version, `device_pileup_plain` then
// `call_genotypes_pileup_plain`: counts2 [n_pos,2,8] i32, qual_sum
// [n_pos,8] f32, mapq2_sum [n_pos] f32 (K3 and the host compare read
// them), gt_prob [n_pos,10] T, max_gt i32, margin T, off_sum T and
// quals_u8 [n_pos,8].
//
// Input (pileup_device.py layout): rd [R,L] u8 with base = rd & 3 and
// q = rd >> 2, L a multiple of 16 in [64, 2048]; starts, ori, strand,
// mapq [R] i32, the live rows sorted by start (pad_read_batch); tiles
// [n_tiles,2] i32, for each tile the first row and one past the last row
// whose span [start, start + L) meets it (pileup_device.tile_rows). Per
// read, bytes outside the first..last live byte (q > 0, q != FLT_QUAL)
// are trimmed; a byte inside counts when q >= min_qual, q != FLT_QUAL and
// 0 <= start + j < n_pos; its category is BASE_TAB_ST[strand][base].
//
// Bound. At R = 4096, L = 256, n_pos = 32,832, f64: 1.1 MB of reads in
// (rows re-read by neighbouring tiles come from L2) and 6.9 MB of planes
// out, ~2.4 us at 3.35 TB/s; ~26 MFLOP of FP64, ~0.8 us. A chunk is 257
// tiles, one wave of CTAs at two a SM, so the kernel's time is one CTA's
// critical path: the tile table, the rows' copy, the scatter, the planes,
// the model's chain of f64 divisions, logs and exps. The design shortens
// that path by spreading each phase over the SM's idle warp slots. On an
// H100 80GB HBM3 at 700 W that chunk takes ~0.0125 ms in f64, ~5x the
// bound; the model is the larger half, its six log tasks a position
// about a third of the whole.
//
// Design. One CTA of 512 threads (16 warps) per tile of kTile = 128
// positions, two CTAs an SM (at most 64 registers a thread), 32 warps an
// SM.
// * Staging. Thread 0 reads the tile's rows r0..r1 and issues one bulk
//   copy (the Tensor Memory Accelerator, on an mbarrier) of up to
//   kStageBytes of contiguous rows; a tile with more rows (long L, deep
//   positions) takes further stages, double-buffered: stage b+1 is in
//   flight while the warps scatter stage b. While a copy flies, one
//   thread a row reads its start, ori, strand and mapq from device memory
//   and computes the part of the row that falls in the tile. With
//   min_qual >= 1 every byte that counts is live, so the trim cannot
//   change a sum and is skipped; with min_qual < 1 that thread finds its
//   row's first and last live byte in the staged copy (lane per row, 16
//   bytes a load, rotated so a warp's loads spread over the banks).
// * Scatter. A warp takes a staged row (rows w, w + 16, ...: at most
//   ceil(rows / 16) in series), a lane a position in each of the tile's
//   four quarters of 32, the four unrolled (and two rows at a time), so a
//   row's meta is read once and a quarter's bytes are one aligned warp
//   access; the meta carries the row's counts2 plane for each base code,
//   so a byte's plane is one shift. Shared-memory integer atomics add
//   each counted byte to the accumulators: counts2 [2*8][pos] and
//   qual_sum [8][pos] i32, and mapq^2 as four 16-bit chunks in u32
//   words, each far from overflow within one stage of at most kMaxRows
//   rows, folded after each stage into a u64 held by the position's
//   thread. The sums are integers, so the order the atomics land in
//   changes no bit. Each row's instructions, not the atomic unit, bound
//   this phase: packing the sums into fewer atomics, or none (a slice a
//   row subset), measured no faster.
// * Planes. Each tile writes its pileup planes once, coalesced; every
//   position is written, so the planes need no zero-fill. The same pass
//   forms each (position, category)'s count and rounded quality, the
//   model's inputs, in shared memory (where the staged rows were).
// * Model, on K2's task split (csrc/genotype.cu), four warps covering the
//   tile's 128 positions, one lane a position, in four rows of warps
//   (w = tid / 128): the methylation-informative logs as six (half, j)
//   tasks a position (`get_z1`, `side_log`), two on each of rows 1-3,
//   while row 0 adds the prior and the non-informative categories
//   (`accumulate_plain`, the first terms of the reference's order); then
//   row 0 adds the methylation-informative terms (`accumulate_meth`) and
//   takes the argmax; the exponentials, genotypes w, w + 4, w + 8 on row
//   w; row 0 sums the off-max terms in genotype order and takes log1p;
//   the posterior divisions spread over the rows; gt_prob leaves in
//   16-byte stores. The phases hand values over through shared memory;
//   each value is the same expression on the same operands, in the same
//   order, as one thread a position computes it.
//
// Numerics are the plain version's and K2's: quality rounding
// floorf(0.5f + qs/(float)n) with __fdiv_rn/__fadd_rn; qual_sum and
// mapq2_sum are cast to f32 once, round to nearest, from exact integer
// sums. mapq2_sum rounds once here where an ordered f32 sum rounds at
// every add, so the two part above 2^24; K3 flags those rows for the
// host. The safe log, the first-max argmax, the margin and log1p(off) are
// genotype_model.cuh's.
//
// Tensor cores do not apply: the work has no matrix product. The one-hot
// matmuls of the Pallas kernel were a TPU workaround for a table gather
// (genotype_pallas.py:56-58); here a quality row is an indexed load from
// shared memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "genotype_model.cuh"

namespace {

using namespace bsct;

constexpr int kTile = 128;          // positions per CTA
constexpr int kStride = kTile + 4;  // shared planes: [slot][position]
constexpr int kThreads = 512;       // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kThreads / kTile;  // rows of warps over the tile
constexpr int kStageBytes = 24576;  // one staged batch of read rows
constexpr int kDynSmem = 2 * kStageBytes;  // two stages; then the model's
constexpr int kMaxRows = 256;       // rows a stage
constexpr int kMinL = 64, kMaxL = 2048;
constexpr int kFltQual = 63;        // FLT_QUAL: trimmed / masked base
constexpr int kHalfTasks = 6;       // (half, j): z_j of get_Z, two logs
constexpr int kVec = 16;            // bytes a thread stores of gt_prob

static_assert(kTile % 32 == 0 && kRows == 4, "four rows of four warps");
static_assert(kMaxRows <= kThreads, "a thread a staged row");

// the model's values between its phases, in the staging buffers
template <typename T>
struct ModelSmem {
  T logs[4][3][kTile];  // [half * 2 + side][slot][position]
  T ll[kNG][kTile];
  // the exponentials [genotype][position], then the tile's gt_prob rows
  // [position][genotype]
  T out[kNG * kTile];
  T best[kTile], lse[kTile];  // max and log1p(off_sum)
  int cnt[8][kTile];  // a category's count over both orientations
  int q[8][kTile];    // its rounded quality (unclamped)
  int mx[kTile];
};
static_assert(sizeof(ModelSmem<double>) <= kDynSmem, "model scratch");

// BASE_TAB_ST (bs_call_tpu_torch/constants.py) as arithmetic: a C2T read
// (strand 1) moves T and C of an odd base code to categories 5 and 7, a
// G2A read (strand 2) A and G of an even one to 4 and 6:
// {0,1,2,3}, {0,5,2,7}, {4,1,6,3}
__device__ __forceinline__ int category(int st, int base) {
  return base + 4 * (st != 0 && ((base ^ (st == 2)) & 1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the mbarrier that a stage's bulk copy completes: one arrival (the
// thread that issues it) and its bytes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// rows [r, r + n) of rd, n * L contiguous bytes (a multiple of 16, from a
// 16-byte aligned rd), into buf by one bulk copy completing on bar; the
// buffer was last read through the generic proxy, hence the fence
__device__ __forceinline__ void stage_rows(uint8_t* buf, const uint8_t* rd,
                                           int r, int n, int L,
                                           uint64_t* bar) {
  const unsigned bytes = (unsigned)(n * L);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(buf)),
      "l"(rd + (long long)r * L), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the first and last live byte (q > 0, q != FLT_QUAL) of a staged row,
// 16 bytes a load; each lane starts at another chunk, so the loads of a
// warp's rows (L apart) fall in distinct banks. hi < 0: no live byte.
__device__ __forceinline__ void live_span(const uint8_t* row, int L,
                                          int* lo, int* hi) {
  const int n = L / 16;
  int a = INT_MAX, b = -1;
  for (int c = 0; c < n; ++c) {
    int k = c + (threadIdx.x & 31);
    k = k < n ? k : k % n;
    const uint4 v = reinterpret_cast<const uint4*>(row)[k];
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int q = (w[u >> 2] >> (8 * (u & 3) + 2)) & 63;
      if (q > 0 && q != kFltQual) {
        a = min(a, 16 * k + u);
        b = max(b, 16 * k + u);
      }
    }
  }
  *lo = a;
  *hi = b;
}

// kVec bytes of values, moved as one word
template <typename T>
struct alignas(kVec) Vec {
  T v[kVec / sizeof(T)];
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) pileup_genotype_kernel(
    const uint8_t* __restrict__ rd, const int* __restrict__ starts,
    const int* __restrict__ ori, const int* __restrict__ strand,
    const int* __restrict__ mapq, const int* __restrict__ tiles, int L,
    int n_pos, int min_qual, const int* __restrict__ ref,
    const T* __restrict__ tab, const T* __restrict__ prior, double l,
    double t, int* __restrict__ counts2, float* __restrict__ qual_sum,
    float* __restrict__ mapq2_sum, T* __restrict__ gt_prob,
    int* __restrict__ max_gt, T* __restrict__ margin,
    T* __restrict__ off_sum, uint8_t* __restrict__ quals_u8) {
  extern __shared__ __align__(128) uint8_t s_dyn[];  // kDynSmem
  __shared__ int s_counts[16 * kStride];  // [ori*8 + cat][position]
  __shared__ int s_qsum[8 * kStride];     // [cat][position]
  __shared__ unsigned s_mq2[4][kTile];    // mapq^2's 16-bit chunks
  // a staged row: start, its span in the tile j0..j1, and its counts2
  // plane (ori * 8 + category) for each base code, a nibble each
  __shared__ int4 s_row[2][kMaxRows];
  __shared__ uint2 s_rmq2[2][kMaxRows];   // its mapq^2, lo and hi words
  __shared__ T s_tab[kNQ * 4];
  __shared__ T s_prior[5 * kNG];
  __shared__ __align__(8) uint64_t s_bar[2];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * kTile;
  const int np = min(kTile, n_pos - t0);  // positions of this tile
  const int r0 = tiles[2 * blockIdx.x];
  const int r1 = tiles[2 * blockIdx.x + 1];
  const int per = min(kStageBytes / L, kMaxRows);  // rows a stage
  const int n_stage = r1 > r0 ? (r1 - r0 + per - 1) / per : 0;
  if (tid == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    if (n_stage > 0) stage_rows(s_dyn, rd, r0, min(per, r1 - r0), L, s_bar);
  }
  for (int j = tid; j < 16 * kStride; j += kThreads) s_counts[j] = 0;
  for (int j = tid; j < 8 * kStride; j += kThreads) s_qsum[j] = 0;
  for (int j = tid; j < 4 * kTile; j += kThreads) (&s_mq2[0][0])[j] = 0;
  load_tables(tab, prior, s_tab, s_prior);
  const int p = tid % kTile;  // the position of this thread (model, mapq2)
  const int w = tid / kTile;  // its row of warps
  const bool live = p < np;
  const int r = w == 0 && live ? clamp_int(ref[t0 + p], 0, 4) : 0;
  unsigned long long mq2 = 0;  // the position's mapq^2 sum (row 0)
  __syncthreads();  // the barriers and the zeroed accumulators

  // ---- the pileup: stages of the rows that meet the tile ----
  for (int b = 0; b < n_stage; ++b) {
    const int rb = r0 + b * per;
    const int nr = min(per, r1 - rb);
    const int s = b & 1;
    uint8_t* buf = s_dyn + s * kStageBytes;
    if (tid == 0 && b + 1 < n_stage) {
      stage_rows(s_dyn + (s ^ 1) * kStageBytes, rd, rb + per,
                 min(per, r1 - rb - per), L, s_bar + (s ^ 1));
    }
    if (tid < nr) {  // one thread a row: its meta and its span in the tile
      const int start = starts[rb + tid];
      const int m = mapq[rb + tid];
      int lo = 0, hi = L - 1;
      if (min_qual < 1) {  // only then can a trimmed byte count
        mbar_wait(s_bar + s, (b >> 1) & 1);
        live_span(buf + tid * L, L, &lo, &hi);
      }
      const unsigned long long m2 =
          (unsigned long long)((long long)m * m);
      const int st = min(max(strand[rb + tid], 0), 2);
      const int o8 = ori[rb + tid] != 0 ? 8 : 0;
      int plane = 0;  // ori * 8 + BASE_TAB_ST[st][base], a nibble a base
#pragma unroll
      for (int base = 0; base < 4; ++base)
        plane |= (o8 + category(st, base)) << (4 * base);
      s_row[s][tid] = make_int4(
          start, max(lo, t0 - start), min(hi, t0 + np - 1 - start), plane);
      s_rmq2[s][tid] = make_uint2((unsigned)m2, (unsigned)(m2 >> 32));
    }
    mbar_wait(s_bar + s, (b >> 1) & 1);
    __syncthreads();  // the stage's rows and meta
#pragma unroll 2
    for (int k = warp; k < nr; k += kWarps) {
      const int4 m = s_row[s][k];
      const uint2 c = s_rmq2[s][k];
      const uint8_t* row = buf + k * L;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pq = 32 * u + lane;
        const int j = pq + t0 - m.x;
        if (j < m.y || j > m.z) continue;
        const int v = row[j];
        const int q = v >> 2;
        if (q < min_qual || q == kFltQual) continue;
        const int oc = (m.w >> (4 * (v & 3))) & 15;  // ori * 8 + category
        atomicAdd(&s_counts[oc * kStride + pq], 1);
        atomicAdd(&s_qsum[(oc & 7) * kStride + pq], q);
        atomicAdd(&s_mq2[0][pq], c.x & 0xffffu);
        if (c.x >> 16) atomicAdd(&s_mq2[1][pq], c.x >> 16);
        if (c.y) {
          atomicAdd(&s_mq2[2][pq], c.y & 0xffffu);
          atomicAdd(&s_mq2[3][pq], c.y >> 16);
        }
      }
    }
    __syncthreads();  // the stage is scattered: its buffer may refill
    if (w == 0) {  // fold the stage's mapq^2 chunks, exact in a u64
      mq2 += (unsigned long long)s_mq2[0][p] +
             ((unsigned long long)s_mq2[1][p] << 16) +
             ((unsigned long long)s_mq2[2][p] << 32) +
             ((unsigned long long)s_mq2[3][p] << 48);
#pragma unroll
      for (int c = 0; c < 4; ++c) s_mq2[c][p] = 0;
    }
  }

  // ---- the pileup planes, written once, and the model's inputs ----
  ModelSmem<T>& sm = *reinterpret_cast<ModelSmem<T>*>(s_dyn);
  for (int j = tid; j < np * 16; j += kThreads) {
    counts2[(long long)t0 * 16 + j] = s_counts[(j & 15) * kStride + (j >> 4)];
  }
  for (int j = tid; j < np * 8; j += kThreads) {
    const int c = j & 7, pp = j >> 3;
    const float qs = __int2float_rn(s_qsum[c * kStride + pp]);
    const int cnt = s_counts[c * kStride + pp] + s_counts[(8 + c) * kStride + pp];
    const int qq = round_qual(qs, cnt);
    qual_sum[(long long)t0 * 8 + j] = qs;
    quals_u8[(long long)t0 * 8 + j] = (uint8_t)qq;
    sm.cnt[c][pp] = cnt;
    sm.q[c][pp] = qq;
  }
  if (w == 0 && live) mapq2_sum[t0 + p] = __ull2float_rn(mq2);
  __syncthreads();

  // ---- the model: the methylation-informative logs, (half, j) tasks,
  // two on each of rows 1-3: z_j of the half's get_Z, and the log slot it
  // feeds on both sides; row 0 meanwhile adds the prior and the
  // non-informative categories, the first terms of the reference's order ----
  if (live && w == 0) {
    T nc[8];
    int q[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      nc[c] = T(sm.cnt[c][p]);
      q[c] = clamp_int(sm.q[c][p], 0, kNQ - 1);
    }
#pragma unroll
    for (int c = 4; c < 8; ++c) {
      nc[c] = T(0);
      q[c] = 0;
    }
    T k[8], lnk[8], lnkh[8], lnk1[8];
    qual_terms(q, s_tab, k, lnk, lnkh, lnk1);
    T ll[kNG];
    accumulate_plain(nc, lnk, lnkh, lnk1, s_prior + r * kNG, ll);
#pragma unroll
    for (int g = 0; g < kNG; ++g) sm.ll[g][p] = ll[g];
  } else if (live) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int task = (w - 1) + 3 * u;
      const int h = task / 3, j = task % 3;
      // the C->T half is (nA, nB) = (n5, n7), the G->A half (n6, n4)
      const int cA = h == 0 ? 5 : 6, cB = h == 0 ? 7 : 4;
      const T nA = T(sm.cnt[cA][p]), nB = T(sm.cnt[cB][p]);
      const T kA = s_tab[clamp_int(sm.q[cA][p], 0, kNQ - 1) * 4];
      const T kB = s_tab[clamp_int(sm.q[cB][p], 0, kNQ - 1) * 4];
      const T z = get_z1(j, nA, nB, kA, kB, l, t);
      const int slot = (j + 1) % 3;
      if (nA > T(0)) sm.logs[2 * h][slot][p] = side_log(0, slot, z, kA);
      if (nB > T(0)) sm.logs[2 * h + 1][slot][p] = side_log(1, slot, z, kB);
    }
  }
  __syncthreads();

  // ---- the log-likelihoods and their maximum: row 0 ----
  if (w == 0 && live) {
    T nc[8];
    int q[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      nc[c] = c < 4 ? T(0) : T(sm.cnt[c][p]);
      q[c] = c < 4 ? 0 : clamp_int(sm.q[c][p], 0, kNQ - 1);
    }
    T k[8], lnk[8], lnkh[8], lnk1[8];
    qual_terms(q, s_tab, k, lnk, lnkh, lnk1);
    T c5[3], c7[3], c6[3], c4[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c5[j] = sm.logs[0][j][p];
      c7[j] = sm.logs[1][j][p];
      c6[j] = sm.logs[2][j][p];
      c4[j] = sm.logs[3][j][p];
    }
    T ll[kNG];
#pragma unroll
    for (int g = 0; g < kNG; ++g) ll[g] = sm.ll[g][p];
    accumulate_meth(nc, lnk, lnkh, lnk1, c5, c7, c6, c4, ll);
    T best;
    sm.mx[p] = argmax(ll, &best);
    sm.best[p] = best;
#pragma unroll
    for (int g = 0; g < kNG; ++g) sm.ll[g][p] = ll[g];
  }
  __syncthreads();

  // ---- the exponentials: genotypes w, w + kRows, ... on row w ----
  if (live) {
    const T best = sm.best[p];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int g = w + kRows * u;
      if (g < kNG) sm.out[g * kTile + p] = mexp(sm.ll[g][p] - best);
    }
  }
  __syncthreads();

  // ---- the finish in genotype order (genotype_model.c:231-245): row 0 ----
  if (w == 0 && live) {
    const int mx = sm.mx[p];
    T second = T(-INFINITY);
    T off = T(0);
#pragma unroll
    for (int g = 0; g < kNG; ++g) {
      if (g != mx) {
        second = fmax(second, sm.ll[g][p]);
        off = off + sm.out[g * kTile + p];
      }
    }
    sm.lse[p] = mlog1p(off);
    max_gt[t0 + p] = mx;
    margin[t0 + p] = sm.best[p] - second;
    off_sum[t0 + p] = off;
  }
  __syncthreads();

  // ---- the posteriors: genotypes w, w + kRows, ... on row w ----
  if (live) {
    const T best = sm.best[p], s = sm.lse[p];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int g = w + kRows * u;
      if (g < kNG) sm.out[p * kNG + g] = (sm.ll[g][p] - best - s) / T(kLn10);
    }
  }
  __syncthreads();

  // ---- gt_prob out: the tile's rows are one run of np * 10 values,
  // kVec bytes a thread ----
  constexpr int kV = kVec / sizeof(T);
  T* out = gt_prob + (long long)t0 * kNG;  // 16-byte aligned: t0 % 128 == 0
  const int n_out = np * kNG;
  for (int j = tid * kV; j < n_out; j += kThreads * kV) {
    if (j + kV <= n_out) {
      *reinterpret_cast<Vec<T>*>(out + j) =
          *reinterpret_cast<const Vec<T>*>(sm.out + j);
    } else {
      for (int u = 0; j + u < n_out; ++u) out[j + u] = sm.out[j + u];
    }
  }
}

template <typename T>
int launch(const uint8_t* rd, const int* starts, const int* ori,
           const int* strand, const int* mapq, const int* tiles, int R,
           int L, int n_pos, int min_qual, const int* ref, const T* tab,
           const T* prior, double l, double t, int* counts2, float* qual_sum,
           float* mapq2_sum, T* gt_prob, int* max_gt, T* margin, T* off_sum,
           uint8_t* quals_u8, void* stream) {
  if (R < 0 || L < kMinL || L > kMaxL || L % 16 || n_pos <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  // above 48 KB of shared memory a CTA, on the current device
  const cudaError_t rc = cudaFuncSetAttribute(
      pileup_genotype_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDynSmem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned n_tiles = (unsigned)((n_pos + kTile - 1) / kTile);
  pileup_genotype_kernel<T>
      <<<n_tiles, kThreads, kDynSmem, (cudaStream_t)stream>>>(
          rd, starts, ori, strand, mapq, tiles, L, n_pos, min_qual, ref, tab,
          prior, l, t, counts2, qual_sum, mapq2_sum, gt_prob, max_gt, margin,
          off_sum, quals_u8);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bsct_pileup_genotype_tile() { return kTile; }

int bsct_pileup_genotype_f32(const uint8_t* rd, const int* starts,
                             const int* ori, const int* strand,
                             const int* mapq, const int* tiles, int R, int L,
                             int n_pos, int min_qual, const int* ref,
                             const float* tab, const float* prior, double l,
                             double t, int* counts2, float* qual_sum,
                             float* mapq2_sum, float* gt_prob, int* max_gt,
                             float* margin, float* off_sum,
                             uint8_t* quals_u8, void* stream) {
  return launch<float>(rd, starts, ori, strand, mapq, tiles, R, L, n_pos,
                       min_qual, ref, tab, prior, l, t, counts2, qual_sum,
                       mapq2_sum, gt_prob, max_gt, margin, off_sum, quals_u8,
                       stream);
}

int bsct_pileup_genotype_f64(const uint8_t* rd, const int* starts,
                             const int* ori, const int* strand,
                             const int* mapq, const int* tiles, int R, int L,
                             int n_pos, int min_qual, const int* ref,
                             const double* tab, const double* prior,
                             double l, double t, int* counts2,
                             float* qual_sum, float* mapq2_sum,
                             double* gt_prob, int* max_gt, double* margin,
                             double* off_sum, uint8_t* quals_u8,
                             void* stream) {
  return launch<double>(rd, starts, ori, strand, mapq, tiles, R, L, n_pos,
                        min_qual, ref, tab, prior, l, t, counts2, qual_sum,
                        mapq2_sum, gt_prob, max_gt, margin, off_sum,
                        quals_u8, stream);
}

}  // extern "C"
