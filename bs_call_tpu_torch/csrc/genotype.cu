// K2: the 10-genotype bisulfite likelihood model with its finish fused in.
//
// Replaces bs_call_tpu/ops/kernels/genotype_pallas.py `_kernel` (launched
// by `genotype_ll_pallas`, finished by `call_genotypes_pallas`), and on
// the exact tier the double-float32 `genotype_ll_dd` + host `dd_finish`
// of bs_call_tpu/ops/genotype_dd.py: Hopper has native FP64, so the exact
// tier is real f64 here. Same math as bs_call_tpu/ops/genotype.py
// (genotype_model.c:23-246).
//
// Design. One thread per position. Each block copies the [44,4] quality
// table and the [5,10] prior into shared memory; the 8 category counts,
// their table terms and the 10 log-likelihoods stay in registers. The
// Pallas kernel fetched table terms with one-hot matmuls, a workaround
// for the TPU's matrix unit (genotype_pallas.py:56-58); here a quality is
// a direct indexed load from shared memory. The argmax / runner-up margin
// / off-max exponent sum / log10 posterior finish runs in the same thread,
// so the [N,10] plane is written once and never read back.
//
// Bound. Per position about 200 flops, up to 14 log, 9 exp and 1 log1p,
// against about 100 bytes read (column entry: 8+8 int32 + ref) and
// 10*sizeof(T)+12 bytes written. In f64 that is bound by the FP64 units
// and the log/exp sequences, not by memory; in f32 by the f32 special
// functions and the stores. Nothing here is tuned yet: the block keeps
// ll in registers and spends no shared memory beyond the tables.
//
// Two entries:
//   column: counts [N,8] i32, quals [N,8] i32, ref [N] i32 (host-built
//           pileup columns: the column tier and --no-exact);
//   pileup: counts2 [N,2,8] i32, qual_sum [N,8] f32, ref [N] i32 (K1's
//           output): counts summed over orientation, quals rounded with
//           the reference's f32 rule floorf(0.5f + qs/(float)n) in
//           round-to-nearest intrinsics (never --use_fast_math), and the
//           quals written out as uint8 for the engine's host compare.
// Outputs: gt_prob [N,10], max_gt [N] i32, margin [N], off_sum [N] in T.
//
// Semantics kept from the reference: get_Z replaces a zero denominator
// with 1 and clips to [-1,1]; the safe log is log(max(x, FLT_MIN or
// DBL_MIN)); argmax keeps the first maximum (strict >); margin is best
// minus runner-up (a tie gives 0, which sends the row to the scalar
// oracle on the host); off_sum = sum_{g != max} exp(ll_g - max);
// gt_prob = (ll - max - log1p(off_sum)) / ln 10.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNQ = 44;  // MAX_QUAL + 1
constexpr int kNG = 10;  // genotypes AA AC AG AT CC CG CT GG GT TT
constexpr int kBlock = 256;
constexpr double kLn10 = 2.30258509299404568402;

// NONINF_SEL (bs_call_tpu/ops/tables.py): 2 -> ln(1+k), 1 -> ln(.5+k),
// 0 -> ln k, for observed base A,C,G,T and each genotype
__constant__ signed char kSel[4][kNG] = {
    {2, 1, 1, 1, 0, 0, 0, 0, 0, 0},
    {0, 1, 0, 0, 2, 1, 1, 0, 0, 0},
    {0, 0, 1, 0, 0, 1, 0, 2, 1, 0},
    {0, 0, 0, 1, 0, 0, 1, 0, 1, 2},
};

__device__ __forceinline__ float mlog(float x) { return logf(x); }
__device__ __forceinline__ double mlog(double x) { return log(x); }
__device__ __forceinline__ float mexp(float x) { return expf(x); }
__device__ __forceinline__ double mexp(double x) { return exp(x); }
__device__ __forceinline__ float mlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double mlog1p(double x) { return log1p(x); }
__device__ __forceinline__ float mtiny(float) { return FLT_MIN; }
__device__ __forceinline__ double mtiny(double) { return DBL_MIN; }

template <typename T>
__device__ __forceinline__ T safe_log(T x) {
  return mlog(fmax(x, mtiny(x)));
}

template <typename T>
__device__ __forceinline__ T clip1(T x) {
  return fmin(fmax(x, T(-1)), T(1));
}

// get_Z (genotype_model.c:23-42): z[0..2] for the three (w, p) cases.
// Constants are formed in double and rounded to T once, exactly as the
// plain version's Python scalars are.
template <typename T>
__device__ __forceinline__ void get_z(T x1, T x2, T k1, T k2, double l,
                                      double t, T z[3]) {
  const double lpt = l + t;
  const double lmt = l - t;
  T d = (x1 + x2) * T(lmt);
  if (d == T(0)) d = T(1);
  const T a1[3] = {T(lpt) + T(2) * k2, T(2.0 + lpt) + T(4) * k2,
                   T(lpt) + T(4) * k2};
  const T a2[3] = {T(2.0 - lpt) + T(2) * k1, T(2.0 - lpt) + T(4) * k1,
                   T(2.0 - lpt) + T(4) * k1};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T s = clip1((x1 * a1[j] - x2 * a2[j]) / d);
    z[j] = T(0.5) * (T(lmt) * s + T(2) - T(lpt));
  }
}

template <typename T>
__device__ __forceinline__ void add_cat(T ll[kNG], T ni, const T coef[kNG]) {
  if (ni > T(0)) {
#pragma unroll
    for (int g = 0; g < kNG; ++g) ll[g] = ll[g] + ni * coef[g];
  }
}

// ll [10] for one position from counts n[8], clamped quals q[8], ref.
template <typename T>
__device__ void model(const T n[8], const int q[8], int ref, const T* s_tab,
                      const T* s_prior, double l, double t, T ll[kNG]) {
  T k[8], lnk[8], lnkh[8], lnk1[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const T* row = s_tab + q[c] * 4;
    k[c] = row[0];
    lnk[c] = row[1];
    lnkh[c] = row[2];
    lnk1[c] = row[3];
  }
#pragma unroll
  for (int g = 0; g < kNG; ++g) ll[g] = s_prior[ref * kNG + g];

  // non-informative categories (genotype_model.c:109-164)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T coef[kNG];
#pragma unroll
    for (int g = 0; g < kNG; ++g) {
      const int s = kSel[i][g];
      coef[g] = s == 2 ? lnk1[i] : (s == 1 ? lnkh[i] : lnk[i]);
    }
    add_cat(ll, n[i], coef);
  }

  // methylation-informative categories (genotype_model.c:165-230)
  T zct[3], zga[3];
  get_z(n[5], n[7], k[5], k[7], l, t, zct);
  get_z(n[6], n[4], k[6], k[4], l, t, zga);
  const T Z0 = zct[0], Z1 = zct[1], Z2 = zct[2];
  const T Z3 = zga[0], Z4 = zga[1], Z5 = zga[2];
  const T one = T(1), half = T(0.5);

  if (n[4] > T(0)) {
    const T k4 = k[4];
    const T t58 = safe_log(half * (one - Z5) + k4);
    const T c[kNG] = {lnk1[4], lnkh[4], safe_log(one - half * Z4 + k4),
                      lnkh[4], lnk[4],  t58,
                      lnk[4],  safe_log(one - Z3 + k4), t58, lnk[4]};
    add_cat(ll, n[4], c);
  }
  if (n[5] > T(0)) {
    const T k5 = k[5];
    const T t15 = safe_log(half * Z2 + k5);
    const T c[kNG] = {lnk[5], t15, lnk[5], lnk[5], safe_log(Z0 + k5), t15,
                      safe_log(half * Z1 + k5), lnk[5], lnk[5], lnk[5]};
    add_cat(ll, n[5], c);
  }
  if (n[6] > T(0)) {
    const T k6 = k[6];
    const T t58b = safe_log(half * Z5 + k6);
    const T c[kNG] = {lnk[6], lnk[6], safe_log(half * Z4 + k6), lnk[6],
                      lnk[6], t58b,   lnk[6], safe_log(Z3 + k6),
                      t58b,   lnk[6]};
    add_cat(ll, n[6], c);
  }
  if (n[7] > T(0)) {
    const T k7 = k[7];
    const T t15b = safe_log(half * (one - Z2) + k7);
    const T c[kNG] = {lnk[7], t15b, lnk[7], lnkh[7],
                      safe_log(one - Z0 + k7), t15b,
                      safe_log(one - half * Z1 + k7), lnk[7], lnkh[7],
                      lnk1[7]};
    add_cat(ll, n[7], c);
  }
}

// argmax / margin / off_sum / log10 posteriors (genotype_model.c:231-245)
template <typename T>
__device__ __forceinline__ void finish(const T ll[kNG], long long i,
                                       T* gt_prob, int* max_gt, T* margin,
                                       T* off_sum) {
  int mx = 0;
  T best = ll[0];
#pragma unroll
  for (int g = 1; g < kNG; ++g) {
    if (ll[g] > best) {
      best = ll[g];
      mx = g;
    }
  }
  T second = T(-INFINITY);
  T off = T(0);
#pragma unroll
  for (int g = 0; g < kNG; ++g) {
    if (g != mx) {
      second = fmax(second, ll[g]);
      off = off + mexp(ll[g] - best);
    }
  }
  const T s = mlog1p(off);
#pragma unroll
  for (int g = 0; g < kNG; ++g) {
    gt_prob[i * kNG + g] = (ll[g] - best - s) / T(kLn10);
  }
  max_gt[i] = mx;
  margin[i] = best - second;
  off_sum[i] = off;
}

template <typename T>
__device__ __forceinline__ void load_tables(const T* tab, const T* prior,
                                            T* s_tab, T* s_prior) {
  for (int j = threadIdx.x; j < kNQ * 4; j += blockDim.x) s_tab[j] = tab[j];
  for (int j = threadIdx.x; j < 5 * kNG; j += blockDim.x)
    s_prior[j] = prior[j];
  __syncthreads();
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    genotype_column_kernel(const int* __restrict__ counts,
                           const int* __restrict__ quals,
                           const int* __restrict__ ref, long long n,
                           const T* __restrict__ tab,
                           const T* __restrict__ prior, double l, double t,
                           T* __restrict__ gt_prob, int* __restrict__ max_gt,
                           T* __restrict__ margin, T* __restrict__ off_sum) {
  __shared__ T s_tab[kNQ * 4];
  __shared__ T s_prior[5 * kNG];
  load_tables(tab, prior, s_tab, s_prior);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T nc[8];
  int q[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    nc[c] = T(counts[i * 8 + c]);
    q[c] = clamp_int(quals[i * 8 + c], 0, kNQ - 1);
  }
  T ll[kNG];
  model(nc, q, clamp_int(ref[i], 0, 4), s_tab, s_prior, l, t, ll);
  finish(ll, i, gt_prob, max_gt, margin, off_sum);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    genotype_pileup_kernel(const int* __restrict__ counts2,
                           const float* __restrict__ qual_sum,
                           const int* __restrict__ ref, long long n,
                           const T* __restrict__ tab,
                           const T* __restrict__ prior, double l, double t,
                           T* __restrict__ gt_prob, int* __restrict__ max_gt,
                           T* __restrict__ margin, T* __restrict__ off_sum,
                           uint8_t* __restrict__ quals_u8) {
  __shared__ T s_tab[kNQ * 4];
  __shared__ T s_prior[5 * kNG];
  load_tables(tab, prior, s_tab, s_prior);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T nc[8];
  int q[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cnt = counts2[i * 16 + c] + counts2[i * 16 + 8 + c];
    int qq = 0;
    if (cnt > 0) {
      // _agg_quals_f32: floorf(0.5f + qual_sum / (float)count), each
      // step rounded to nearest in f32
      qq = (int)floorf(
          __fadd_rn(0.5f, __fdiv_rn(qual_sum[i * 8 + c], __int2float_rn(cnt))));
    }
    quals_u8[i * 8 + c] = (uint8_t)qq;
    nc[c] = T(cnt);
    q[c] = clamp_int(qq, 0, kNQ - 1);
  }
  T ll[kNG];
  model(nc, q, clamp_int(ref[i], 0, 4), s_tab, s_prior, l, t, ll);
  finish(ll, i, gt_prob, max_gt, margin, off_sum);
}

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kBlock - 1) / kBlock);
}

template <typename T>
int launch_column(const int* counts, const int* quals, const int* ref,
                  long long n, const T* tab, const T* prior, double l,
                  double t, T* gt_prob, int* max_gt, T* margin, T* off_sum,
                  void* stream) {
  if (n > 0) {
    genotype_column_kernel<T>
        <<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(
            counts, quals, ref, n, tab, prior, l, t, gt_prob, max_gt, margin,
            off_sum);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pileup(const int* counts2, const float* qual_sum, const int* ref,
                  long long n, const T* tab, const T* prior, double l,
                  double t, T* gt_prob, int* max_gt, T* margin, T* off_sum,
                  uint8_t* quals_u8, void* stream) {
  if (n > 0) {
    genotype_pileup_kernel<T>
        <<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(
            counts2, qual_sum, ref, n, tab, prior, l, t, gt_prob, max_gt,
            margin, off_sum, quals_u8);
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

int bsct_genotype_pileup_f32(const int* counts2, const float* qual_sum,
                             const int* ref, long long n, const float* tab,
                             const float* prior, double l, double t,
                             float* gt_prob, int* max_gt, float* margin,
                             float* off_sum, uint8_t* quals_u8,
                             void* stream) {
  return launch_pileup<float>(counts2, qual_sum, ref, n, tab, prior, l, t,
                              gt_prob, max_gt, margin, off_sum, quals_u8,
                              stream);
}

int bsct_genotype_pileup_f64(const int* counts2, const float* qual_sum,
                             const int* ref, long long n, const double* tab,
                             const double* prior, double l, double t,
                             double* gt_prob, int* max_gt, double* margin,
                             double* off_sum, uint8_t* quals_u8,
                             void* stream) {
  return launch_pileup<double>(counts2, qual_sum, ref, n, tab, prior, l, t,
                               gt_prob, max_gt, margin, off_sum, quals_u8,
                               stream);
}

}  // extern "C"
