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
// Design. One CTA of 256 threads per tile of kTile = 128 positions.
// * Pileup. The tile's accumulators live in shared memory: counts2
//   [2*8][128] i32, qual_sum [8][128] i32, mapq2 [128] as two u32 words
//   (104 B a position), position-minor with a padded stride so that the
//   lanes' consecutive positions hit distinct banks. The tile's rows, and
//   their start, ori, strand and mapq, are staged into shared memory with
//   cp.async in 8 KB batches, double-buffered: batch b+1 is in flight
//   while the warps scatter batch b. One warp takes one staged row: it
//   finds the row's first and last live byte over the whole row (warp
//   min/max reductions), then its lanes walk the part of the row that
//   falls in the tile and add with shared-memory integer atomics. The
//   sums are integers, so the order the atomics land in changes no bit,
//   and the hot positions' contention stays on the SM instead of in L2.
//   A row meets at most ceil(L/128)+1 tiles, so each read byte is loaded
//   at most 3 times at L = 256.
// * Writes. Each tile writes its pileup planes once, coalesced; every
//   position is written, so the planes need no zero-fill.
// * Model on the same tile, straight from shared memory, two threads per
//   position (adjacent lanes): each computes one half of the
//   methylation-informative logs (genotype_model.cuh `half_logs`, the
//   C->T half on even lanes, the G->A half on odd ones, the same code on
//   other inputs), the pair swaps them with shuffles, and both accumulate
//   the ten log-likelihoods in the reference's order; each then takes the
//   exponentials of five genotypes for the off-max sum, swaps them, and
//   sums all ten in genotype order; each writes five of gt_prob. This
//   halves the serial chain of f64 log/exp per thread and doubles the
//   warps in flight against K2's one thread per position.
//
// Numerics are the plain version's and K2's: quality rounding
// floorf(0.5f + qs/(float)n) with __fdiv_rn/__fadd_rn; qual_sum and mapq2_sum are cast to f32 once,
// round to nearest, from exact integer sums. mapq2_sum rounds once here
// where an ordered f32 sum rounds at every add, so the two part above
// 2^24; K3 flags those rows for the host. The safe log, the first-max
// argmax, the margin and log1p(off) are genotype_model.cuh's.
//
// Tensor cores do not apply: the work has no matrix product. The one-hot
// matmuls of the Pallas kernel were a TPU workaround for a table gather
// (genotype_pallas.py:56-58); here a quality row is an indexed load from
// shared memory.
//
// Bound. At R = 4096, L = 256, n_pos = 32,832, f64: 1.1 MB of reads in
// (rows re-read by neighbouring tiles come from L2) and 6.9 MB of planes
// out, ~2.4 us at 3.35 TB/s; ~26 MFLOP of FP64, ~0.8 us.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "genotype_model.cuh"

namespace {

using namespace bsct;

constexpr int kTile = 128;         // positions per CTA
constexpr int kStride = kTile + 1;  // shared planes: [slot][position], padded
constexpr int kThreads = 256;      // 8 warps; 2 threads a position
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 8192;  // one staged batch of read rows
constexpr int kMinL = 64, kMaxL = 2048;
constexpr int kMaxRows = kStageBytes / kMinL;  // rows in one batch
constexpr int kFltQual = 63;       // FLT_QUAL: trimmed / masked base

static_assert(kThreads == 2 * kTile, "two threads per position");

// BASE_TAB_ST (bs_call_tpu_torch/constants.py) as arithmetic: a C2T read
// (strand 1) moves T and C of an odd base code to categories 5 and 7, a
// G2A read (strand 2) A and G of an even one to 4 and 6:
// {0,1,2,3}, {0,5,2,7}, {4,1,6,3}
__device__ __forceinline__ int category(int st, int base) {
  return base + 4 * (st != 0 && ((base ^ (st == 2)) & 1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// rows [r, r + n) of rd (n * L contiguous bytes, a multiple of 16) into
// buf, and their start, ori, strand and mapq into meta[n][4]
__device__ __forceinline__ void stage_rows(
    uint8_t* buf, int (*meta)[4], const uint8_t* rd, const int* starts,
    const int* ori, const int* strand, const int* mapq, int r, int n,
    int L) {
  const uint8_t* src = rd + (long long)r * L;
  const int bytes = n * L;
  for (int o = threadIdx.x * 16; o < bytes; o += kThreads * 16) {
    cp_async16(buf + o, src + o);
  }
  for (int j = threadIdx.x; j < 4 * n; j += kThreads) {
    const int c = j & 3;
    const int* col = c == 0 ? starts : c == 1 ? ori : c == 2 ? strand : mapq;
    cp_async4(&meta[j >> 2][c], col + r + (j >> 2));
  }
}

// one warp: trim one staged row and add its bytes in [t0, t_end) to the
// tile's shared accumulators. The planes are position-minor with a padded
// stride, so the lanes' consecutive positions fall in distinct banks; the
// u64 mapq^2 sum is two u32 words, the low one's carries added to the
// high one, which keeps it exact.
__device__ __forceinline__ void scatter_row(
    const uint8_t* row, int L, const int meta[4], int t0, int t_end,
    int min_qual, int* s_counts, int* s_qsum, unsigned* s_mq2_lo,
    unsigned* s_mq2_hi) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = -1;
  for (int j = lane * 4; j < L; j += 128) {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + j);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int q = (w >> (8 * b + 2)) & 63;
      if (q > 0 && q != kFltQual) {
        lo = min(lo, j + b);
        hi = max(hi, j + b);
      }
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (hi < 0) return;  // no live byte in this row
  const int start = meta[0];
  const int o8 = meta[1] != 0 ? 8 : 0;
  const int st = min(max(meta[2], 0), 2);
  const unsigned long long mq2 =
      (unsigned long long)((long long)meta[3] * meta[3]);
  const unsigned mq2_lo = (unsigned)mq2, mq2_hi = (unsigned)(mq2 >> 32);
  const int j0 = max(lo, t0 - start);
  const int j1 = min(hi, t_end - 1 - start);
  for (int j = j0 + lane; j <= j1; j += 32) {
    const int b = row[j];
    const int q = b >> 2;
    if (q < min_qual || q == kFltQual) continue;
    const int p = start + j - t0;
    const int cat = category(st, b & 3);
    atomicAdd(&s_counts[(o8 + cat) * kStride + p], 1);
    atomicAdd(&s_qsum[cat * kStride + p], q);
    const unsigned old = atomicAdd(&s_mq2_lo[p], mq2_lo);
    const unsigned carry = old + mq2_lo < old;
    if (mq2_hi + carry) atomicAdd(&s_mq2_hi[p], mq2_hi + carry);
  }
}

template <typename T>
__device__ __forceinline__ T pick(bool h, T odd, T even) {
  return h ? odd : even;
}

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
  __shared__ int s_counts[16 * kStride];  // [ori*8 + cat][position]
  __shared__ int s_qsum[8 * kStride];     // [cat][position]
  __shared__ unsigned s_mq2_lo[kTile], s_mq2_hi[kTile];
  __shared__ __align__(16) uint8_t s_rows[2][kStageBytes];
  __shared__ int s_meta[2][kMaxRows][4];
  __shared__ T s_tab[kNQ * 4];
  __shared__ T s_prior[5 * kNG];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * kTile;
  const int np = min(kTile, n_pos - t0);  // positions of this tile
  for (int j = tid; j < 16 * kStride; j += kThreads) s_counts[j] = 0;
  for (int j = tid; j < 8 * kStride; j += kThreads) s_qsum[j] = 0;
  for (int j = tid; j < kTile; j += kThreads) s_mq2_lo[j] = s_mq2_hi[j] = 0;
  load_tables(tab, prior, s_tab, s_prior);

  // ---- pileup: staged batches of the rows that meet the tile ----
  const int r0 = tiles[2 * blockIdx.x];
  const int r1 = tiles[2 * blockIdx.x + 1];
  const int per = kStageBytes / L;  // rows per batch
  const int n_batch = r1 > r0 ? (r1 - r0 + per - 1) / per : 0;
  if (n_batch > 0) {
    stage_rows(s_rows[0], s_meta[0], rd, starts, ori, strand, mapq, r0,
               min(per, r1 - r0), L);
  }
  cp_async_commit();
  __syncthreads();  // the zeroed accumulators
  for (int b = 0; b < n_batch; ++b) {
    const int rb = r0 + b * per;
    if (b + 1 < n_batch) {
      stage_rows(s_rows[(b + 1) & 1], s_meta[(b + 1) & 1], rd, starts, ori,
                 strand, mapq, rb + per, min(per, r1 - rb - per), L);
    }
    cp_async_commit();
    cp_async_wait<1>();  // batch b has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    const uint8_t* buf = s_rows[b & 1];
    const int nr = min(per, r1 - rb);
    for (int k = warp; k < nr; k += kWarps) {
      scatter_row(buf + k * L, L, s_meta[b & 1][k], t0, t0 + np, min_qual,
                  s_counts, s_qsum, s_mq2_lo, s_mq2_hi);
    }
    __syncthreads();  // buffer b & 1 is refilled at iteration b + 1
  }
  cp_async_wait<0>();

  // ---- the tile's pileup planes, written once ----
  for (int j = tid; j < np * 16; j += kThreads) {
    counts2[(long long)t0 * 16 + j] = s_counts[(j & 15) * kStride + (j >> 4)];
  }
  for (int j = tid; j < np * 8; j += kThreads) {
    qual_sum[(long long)t0 * 8 + j] =
        __int2float_rn(s_qsum[(j & 7) * kStride + (j >> 3)]);
  }
  for (int j = tid; j < np; j += kThreads) {
    mapq2_sum[t0 + j] = __ull2float_rn(
        (unsigned long long)s_mq2_hi[j] << 32 | s_mq2_lo[j]);
  }

  // ---- the model, two threads a position ----
  const int p = tid >> 1;
  const bool h = tid & 1;  // odd lane: the G->A half
  const bool live = p < np;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (!live) return;  // both lanes of a pair leave together
  const long long i = t0 + p;
  T nc[8];
  int q[8];
  unsigned long long qb = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cnt = s_counts[c * kStride + p] + s_counts[(8 + c) * kStride + p];
    const int qq = round_qual(__int2float_rn(s_qsum[c * kStride + p]), cnt);
    qb |= (unsigned long long)(uint8_t)qq << (8 * c);
    nc[c] = T(cnt);
    q[c] = clamp_int(qq, 0, kNQ - 1);
  }
  if (!h) reinterpret_cast<unsigned long long*>(quals_u8)[i] = qb;
  T k[8], lnk[8], lnkh[8], lnk1[8];
  qual_terms(q, s_tab, k, lnk, lnkh, lnk1);
  T a[3] = {T(0), T(0), T(0)}, b[3] = {T(0), T(0), T(0)};
  half_logs(pick(h, nc[6], nc[5]), pick(h, nc[4], nc[7]),
            pick(h, k[6], k[5]), pick(h, k[4], k[7]), l, t, a, b);
  T c5[3], c7[3], c6[3], c4[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T oa = __shfl_xor_sync(mask, a[j], 1);
    const T ob = __shfl_xor_sync(mask, b[j], 1);
    c5[j] = pick(h, oa, a[j]);
    c7[j] = pick(h, ob, b[j]);
    c6[j] = pick(h, a[j], oa);
    c4[j] = pick(h, b[j], ob);
  }
  T ll[kNG];
  accumulate(nc, lnk, lnkh, lnk1, s_prior + clamp_int(ref[i], 0, 4) * kNG,
             c5, c7, c6, c4, ll);

  // finish (genotype_model.c:231-245): the exponentials split in halves
  T best;
  const int mx = argmax(ll, &best);
  T mine[5], e[kNG];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    mine[j] = pick(h, ll[5 + j], ll[j]);
    const T ej = mexp(mine[j] - best);
    const T other = __shfl_xor_sync(mask, ej, 1);
    e[j] = pick(h, other, ej);
    e[5 + j] = pick(h, ej, other);
  }
  T second = T(-INFINITY);
  T off = T(0);
#pragma unroll
  for (int g = 0; g < kNG; ++g) {
    if (g != mx) {
      second = fmax(second, ll[g]);
      off = off + e[g];
    }
  }
  const T s = mlog1p(off);
  T* out = gt_prob + i * kNG + (h ? 5 : 0);
#pragma unroll
  for (int j = 0; j < 5; ++j) out[j] = (mine[j] - best - s) / T(kLn10);
  if (h) {
    off_sum[i] = off;
  } else {
    max_gt[i] = mx;
    margin[i] = best - second;
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
  const unsigned n_tiles = (unsigned)((n_pos + kTile - 1) / kTile);
  pileup_genotype_kernel<T><<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
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
