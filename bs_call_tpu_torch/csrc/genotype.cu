// K2: the 10-genotype bisulfite likelihood model with its finish fused in,
// on pileup columns (the column tier, and every position under
// --no-exact).
//
// Replaces bs_call_tpu/ops/kernels/genotype_pallas.py `_kernel` (launched
// by `genotype_ll_pallas`, finished by `call_genotypes_pallas`), and on
// the exact tier the double-float32 `genotype_ll_dd` + host `dd_finish`
// of bs_call_tpu/ops/genotype_dd.py: Hopper has native FP64, so the exact
// tier is real f64 here. Same math as bs_call_tpu/ops/genotype.py
// (genotype_model.c:23-246).
//
// Entry: counts [N,8] i32, quals [N,8] i32, ref [N] i32 -> gt_prob [N,10],
// max_gt [N] i32, margin [N], off_sum [N] in T (f64 on the exact column
// tier, f32 under --no-exact). Out-of-range quals and ref clamp to the
// tables.
//
// Bound. 68 bytes read and 10*sizeof(T)+12 written a position: 0.0016 ms
// (f64) at 32,832 positions on an H100 SXM. The arithmetic, up to 12 log,
// 10 exp, 1 log1p and 16 divisions a position, is about a microsecond of
// the card's FP64 rate a chunk, but each is a libdevice sequence of
// dependent operations behind a branch. One thread a position (the design
// before this one) ran a position's whole chain in one thread, 8 warps an
// SM: latency, not throughput, set its time.
//
// Design. One CTA of 128 threads (four warps) per tile of kTile = 32
// positions: a chunk of 32,832 positions is 1,026 CTAs, eight on each SM
// (at most 64 registers a thread), 31 warps an SM, all resident at once.
// A position's work runs in phases spread over the warps, one lane a
// position in every warp, the values passed between phases through shared
// memory, so a warp diverges only on the data:
// * staging: the tile's counts and quals rows (32 bytes each) go to shared
//   memory with 16-byte cp.async, or 4-byte cp.async from a source that
//   is not 16-byte aligned (a tensor that starts inside its storage); the
//   quality table and the prior too (`load_tables`);
// * the methylation-informative logs as six tasks a position, (half, j):
//   z_j of the half's get_Z (one division) and the log slot it feeds on
//   each side (`get_z1`, `side_log`), tasks w and w + 4 on warp w;
// * warp 0: the quality terms, `accumulate` and `argmax`;
// * the exponentials exp(ll_g - best), genotypes w, w + 4, w + 8 on warp w;
// * warp 0: the runner-up and the off-max sum in genotype order, skipping
//   the maximum, log1p(off); max_gt, margin and off_sum stored;
// * the posteriors (ll_g - best - log1p(off)) / ln 10, genotypes w, w + 4,
//   w + 8 on warp w, into shared memory as the tile's gt_prob rows;
// * out: those rows are one run of 320 values, 16 bytes a thread, so a
//   warp's store is 512 contiguous bytes.
// Every value is computed by the same expression on the same operands as
// one thread a position computes it, so the outputs are that design's bit
// for bit; `accumulate` stays whole on one thread, since the compiler
// shares a category's product n*ln k across genotypes there, which a
// genotype computed alone would fuse into an FMA instead. One exception
// in f32: where an exponential's result is subnormal, one thread a
// position fused its last scaling into the off-sum's add (one rounding)
// while here, as in the plain version, it is rounded first.
//
// The model's device functions are genotype_model.cuh's, shared with K12
// (pileup_genotype.cu), which computes the pileup and the model of the
// fused tier in one launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "genotype_model.cuh"

namespace {

using namespace bsct;

constexpr int kTile = 32;              // positions a CTA: one a lane
constexpr int kWarps = 4;              // warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kHalfTasks = 6;          // (half, j): z_j of get_Z, two logs
constexpr int kVec = 16;               // bytes a thread stores of gt_prob

static_assert(kTile == 32, "a warp covers the tile");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [0, np) of 8 ints from src into dst: 16-byte copies from a 16-byte
// aligned source, 4-byte copies from any other
__device__ __forceinline__ void stage_rows(int* dst, const int* src,
                                           int np) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int j = threadIdx.x; j < 2 * np; j += kThreads)
      cp_async16(dst + 4 * j, src + 4 * j);
  } else {
    for (int j = threadIdx.x; j < 8 * np; j += kThreads)
      cp_async4(dst + j, src + j);
  }
}

// kVec bytes of values, moved as one word
template <typename T>
struct alignas(kVec) Vec {
  T v[kVec / sizeof(T)];
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
    genotype_column_kernel(const int* __restrict__ counts,
                           const int* __restrict__ quals,
                           const int* __restrict__ ref, long long n,
                           const T* __restrict__ tab,
                           const T* __restrict__ prior, double l, double t,
                           T* __restrict__ gt_prob, int* __restrict__ max_gt,
                           T* __restrict__ margin, T* __restrict__ off_sum) {
  __shared__ __align__(16) int s_counts[kTile * 8];  // the tile's rows
  __shared__ __align__(16) int s_quals[kTile * 8];
  __shared__ T s_tab[kNQ * 4];
  __shared__ T s_prior[5 * kNG];
  __shared__ T s_logs[4][3][kTile];  // [half * 2 + side][slot][position]
  __shared__ T s_ll[kNG][kTile];
  // the exponentials [genotype][position], then the tile's gt_prob rows
  // [position][genotype]
  __shared__ __align__(16) T s_out[kNG * kTile];
  __shared__ T s_best[kTile], s_log1p[kTile];
  __shared__ int s_mx[kTile];

  const long long t0 = (long long)blockIdx.x * kTile;
  const int np = (int)min((long long)kTile, n - t0);  // this tile's rows
  stage_rows(s_counts, counts + t0 * 8, np);
  stage_rows(s_quals, quals + t0 * 8, np);
  load_tables(tab, prior, s_tab, s_prior);
  const int p = threadIdx.x % kTile;  // the position
  const int w = threadIdx.x / kTile;  // the warp: its tasks
  const bool live = p < np;
  const int r = w == 0 && live ? clamp_int(ref[t0 + p], 0, 4) : 0;
  cp_async_wait_all();
  __syncthreads();

  // ---- the methylation-informative logs: (half, j) tasks over the warps:
  // z_j of the half's get_Z, and the log slot it feeds on both sides ----
  if (live) {
    const int* row = s_counts + p * 8;
    const int* qrow = s_quals + p * 8;
    for (int task = w; task < kHalfTasks; task += kWarps) {
      const int h = task / 3, j = task % 3;
      // the C->T half is (nA, nB) = (n5, n7), the G->A half (n6, n4)
      const int cA = h == 0 ? 5 : 6, cB = h == 0 ? 7 : 4;
      const T nA = T(row[cA]), nB = T(row[cB]);
      const T kA = s_tab[clamp_int(qrow[cA], 0, kNQ - 1) * 4];
      const T kB = s_tab[clamp_int(qrow[cB], 0, kNQ - 1) * 4];
      const T z = get_z1(j, nA, nB, kA, kB, l, t);
      const int slot = (j + 1) % 3;
      if (nA > T(0)) s_logs[2 * h][slot][p] = side_log(0, slot, z, kA);
      if (nB > T(0)) s_logs[2 * h + 1][slot][p] = side_log(1, slot, z, kB);
    }
  }
  __syncthreads();

  // ---- the log-likelihoods and their maximum: warp 0 ----
  if (w == 0 && live) {
    T nc[8];
    int q[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      nc[c] = T(s_counts[p * 8 + c]);
      q[c] = clamp_int(s_quals[p * 8 + c], 0, kNQ - 1);
    }
    T k[8], lnk[8], lnkh[8], lnk1[8];
    qual_terms(q, s_tab, k, lnk, lnkh, lnk1);
    T c5[3], c7[3], c6[3], c4[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c5[j] = s_logs[0][j][p];
      c7[j] = s_logs[1][j][p];
      c6[j] = s_logs[2][j][p];
      c4[j] = s_logs[3][j][p];
    }
    T ll[kNG];
    accumulate(nc, lnk, lnkh, lnk1, s_prior + r * kNG, c5, c7, c6, c4, ll);
    T best;
    s_mx[p] = argmax(ll, &best);
    s_best[p] = best;
#pragma unroll
    for (int g = 0; g < kNG; ++g) s_ll[g][p] = ll[g];
  }
  __syncthreads();

  // ---- the exponentials: genotypes w, w + kWarps, ... on warp w ----
  if (live) {
    const T best = s_best[p];
    for (int g = w; g < kNG; g += kWarps)
      s_out[g * kTile + p] = mexp(s_ll[g][p] - best);
  }
  __syncthreads();

  // ---- the finish in genotype order: warp 0 ----
  if (w == 0 && live) {
    const int mx = s_mx[p];
    T second = T(-INFINITY);
    T off = T(0);
#pragma unroll
    for (int g = 0; g < kNG; ++g) {
      if (g != mx) {
        second = fmax(second, s_ll[g][p]);
        off = off + s_out[g * kTile + p];
      }
    }
    s_log1p[p] = mlog1p(off);
    max_gt[t0 + p] = mx;
    margin[t0 + p] = s_best[p] - second;
    off_sum[t0 + p] = off;
  }
  __syncthreads();

  // ---- the posteriors: genotypes w, w + kWarps, ... on warp w ----
  if (live) {
    const T best = s_best[p], s = s_log1p[p];
    for (int g = w; g < kNG; g += kWarps)
      s_out[p * kNG + g] = (s_ll[g][p] - best - s) / T(kLn10);
  }
  __syncthreads();

  // ---- gt_prob out: the tile's rows are one run of np * 10 values,
  // kVec bytes a thread, so a warp's store is 512 contiguous bytes ----
  constexpr int kV = kVec / sizeof(T);
  T* out = gt_prob + t0 * kNG;  // 16-byte aligned: t0 is a multiple of 32
  const int n_out = np * kNG;
  for (int j = threadIdx.x * kV; j < n_out; j += kThreads * kV) {
    if (j + kV <= n_out) {
      *reinterpret_cast<Vec<T>*>(out + j) =
          *reinterpret_cast<const Vec<T>*>(s_out + j);
    } else {
      for (int u = 0; j + u < n_out; ++u) out[j + u] = s_out[j + u];
    }
  }
}

template <typename T>
int launch_column(const int* counts, const int* quals, const int* ref,
                  long long n, const T* tab, const T* prior, double l,
                  double t, T* gt_prob, int* max_gt, T* margin, T* off_sum,
                  void* stream) {
  if (n > 0) {
    const unsigned tiles = (unsigned)((n + kTile - 1) / kTile);
    genotype_column_kernel<T><<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
        counts, quals, ref, n, tab, prior, l, t, gt_prob, max_gt, margin,
        off_sum);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bsct_genotype_column_f32(const int* counts, const int* quals,
                             const int* ref, long long n, const float* tab,
                             const float* prior, double l, double t,
                             float* gt_prob, int* max_gt, float* margin,
                             float* off_sum, void* stream) {
  return launch_column<float>(counts, quals, ref, n, tab, prior, l, t,
                              gt_prob, max_gt, margin, off_sum, stream);
}

int bsct_genotype_column_f64(const int* counts, const int* quals,
                             const int* ref, long long n, const double* tab,
                             const double* prior, double l, double t,
                             double* gt_prob, int* max_gt, double* margin,
                             double* off_sum, void* stream) {
  return launch_column<double>(counts, quals, ref, n, tab, prior, l, t,
                               gt_prob, max_gt, margin, off_sum, stream);
}

}  // extern "C"
