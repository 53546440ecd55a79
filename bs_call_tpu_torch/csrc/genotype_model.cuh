// The 10-genotype bisulfite likelihood model, as device functions shared
// by K2 (genotype.cu, a tile of 32 positions a CTA of four warps) and K12
// (pileup_genotype.cu, a tile of 128 positions a CTA of 16 warps), both
// on the same task split. Same math as
// bs_call_tpu_torch/ops/genotype.py (genotype_model.c:23-246).
//
// The model splits into two halves that share nothing but the inputs:
// the C->T half (categories 5 and 7, get_Z on counts 5 and 7) and the
// G->A half (categories 6 and 4, get_Z on counts 6 and 4), three safe logs
// per category. Within a half, z_j of get_Z feeds one log slot of each
// side (`get_z1`, `side_log`), a (half, j) task. `accumulate` then adds every
// category's terms to the prior in the reference's order, so one thread
// that computes every log and threads that compute a part each and hand
// them over (K2 and K12 a (half, j) task each, through shared memory)
// give the same bits. Its two parts, the prior and categories 0-3
// (`accumulate_plain`, which needs no log) and categories 4-7
// (`accumulate_meth`), keep that order when run apart, as K12 runs the
// first beside the log tasks. Each log is computed only where its category count
// is > 0, as the reference does. The finish (genotype_model.c:231-245) is
// written out in each kernel, as its threads share it.
//
// Semantics kept from the reference: get_Z replaces a zero denominator
// with 1 and clips to [-1,1]; the safe log is log(max(x, FLT_MIN or
// DBL_MIN)); argmax keeps the first maximum (strict >); margin is best
// minus runner-up (a tie gives 0, which sends the row to the scalar
// oracle on the host); off_sum = sum_{g != max} exp(ll_g - max), summed in
// genotype order; gt_prob = (ll - max - log1p(off_sum)) / ln 10.

#pragma once

#include <cfloat>
#include <cmath>

namespace bsct {

constexpr int kNQ = 44;  // MAX_QUAL + 1
constexpr int kNG = 10;  // genotypes AA AC AG AT CC CG CT GG GT TT
constexpr double kLn10 = 2.30258509299404568402;

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

// get_Z (genotype_model.c:23-42): z[j] for the (w, p) case j of three.
// Constants are formed in double and rounded to T once, exactly as the
// plain version's Python scalars are.
template <typename T>
__device__ __forceinline__ T get_z1(int j, T x1, T x2, T k1, T k2, double l,
                                    double t) {
  const double lpt = l + t;
  const double lmt = l - t;
  T d = (x1 + x2) * T(lmt);
  if (d == T(0)) d = T(1);
  const T a1 = j == 0   ? T(lpt) + T(2) * k2
               : j == 1 ? T(2.0 + lpt) + T(4) * k2
                        : T(lpt) + T(4) * k2;
  const T a2 = j == 0 ? T(2.0 - lpt) + T(2) * k1 : T(2.0 - lpt) + T(4) * k1;
  const T s = clip1((x1 * a1 - x2 * a2) / d);
  return T(0.5) * (T(lmt) * s + T(2) - T(lpt));
}

template <typename T>
__device__ __forceinline__ void add_cat(T ll[kNG], T ni, const T coef[kNG]) {
  if (ni > T(0)) {
#pragma unroll
    for (int g = 0; g < kNG; ++g) ll[g] = ll[g] + ni * coef[g];
  }
}

// Log `slot` of one side of a half, from the half's z[(slot + 2) % 3]
// of get_Z(nA, nB, kA, kB) and the side's k: side 0 is
// a = {log(z2/2+kA), log(z0+kA), log(z1/2+kA)}, side 1 is
// b = {log((1-z2)/2+kB), log(1-z0+kB), log(1-z1/2+kB)}.
template <typename T>
__device__ __forceinline__ T side_log(int side, int slot, T z, T k) {
  const T one = T(1), half = T(0.5);
  if (side == 0) return safe_log(slot == 1 ? z + k : half * z + k);
  return safe_log(slot == 0   ? half * (one - z) + k
                  : slot == 1 ? one - z + k
                              : one - half * z + k);
}

// the quality-table row of each category: k, ln k, ln(k+1/2), ln(k+1)
template <typename T>
__device__ __forceinline__ void qual_terms(const int q[8], const T* s_tab,
                                           T k[8], T lnk[8], T lnkh[8],
                                           T lnk1[8]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const T* row = s_tab + q[c] * 4;
    k[c] = row[0];
    lnk[c] = row[1];
    lnkh[c] = row[2];
    lnk1[c] = row[3];
  }
}

// ll [10] = prior + the non-informative categories' terms (0-3), in the
// reference's order: the first part of `accumulate`, which needs no log
template <typename T>
__device__ __forceinline__ void accumulate_plain(
    const T n[8], const T lnk[8], const T lnkh[8], const T lnk1[8],
    const T* prior_row, T ll[kNG]) {
  // NONINF_SEL (bs_call_tpu_torch/ops/tables.py): 2 -> ln(1+k),
  // 1 -> ln(.5+k), 0 -> ln k, for observed base A,C,G,T and each
  // genotype; read at constant indices, so it folds into the code
  const signed char sel[4][kNG] = {
      {2, 1, 1, 1, 0, 0, 0, 0, 0, 0},
      {0, 1, 0, 0, 2, 1, 1, 0, 0, 0},
      {0, 0, 1, 0, 0, 1, 0, 2, 1, 0},
      {0, 0, 0, 1, 0, 0, 1, 0, 1, 2},
  };
#pragma unroll
  for (int g = 0; g < kNG; ++g) ll[g] = prior_row[g];

  // non-informative categories (genotype_model.c:109-164)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T coef[kNG];
#pragma unroll
    for (int g = 0; g < kNG; ++g) {
      const int s = sel[i][g];
      coef[g] = s == 2 ? lnk1[i] : (s == 1 ? lnkh[i] : lnk[i]);
    }
    add_cat(ll, n[i], coef);
  }
}

// ll [10] += the methylation-informative categories' terms (4-7), in the
// reference's order: the second part of `accumulate`; c5/c7 are the C->T
// half's a/b, c6/c4 the G->A half's a/b
template <typename T>
__device__ __forceinline__ void accumulate_meth(
    const T n[8], const T lnk[8], const T lnkh[8], const T lnk1[8],
    const T c5[3], const T c7[3], const T c6[3], const T c4[3], T ll[kNG]) {
  // methylation-informative categories (genotype_model.c:165-230)
  if (n[4] > T(0)) {
    const T c[kNG] = {lnk1[4], lnkh[4], c4[2], lnkh[4], lnk[4],
                      c4[0],   lnk[4],  c4[1], c4[0],   lnk[4]};
    add_cat(ll, n[4], c);
  }
  if (n[5] > T(0)) {
    const T c[kNG] = {lnk[5], c5[0], lnk[5], lnk[5], c5[1],
                      c5[0],  c5[2], lnk[5], lnk[5], lnk[5]};
    add_cat(ll, n[5], c);
  }
  if (n[6] > T(0)) {
    const T c[kNG] = {lnk[6], lnk[6], c6[2], lnk[6], lnk[6],
                      c6[0],  lnk[6], c6[1], c6[0],  lnk[6]};
    add_cat(ll, n[6], c);
  }
  if (n[7] > T(0)) {
    const T c[kNG] = {lnk[7], c7[0], lnk[7], lnkh[7], c7[1],
                      c7[0],  c7[2], lnk[7], lnkh[7], lnk1[7]};
    add_cat(ll, n[7], c);
  }
}

// ll [10] = prior + every category's terms, in the reference's order
template <typename T>
__device__ __forceinline__ void accumulate(
    const T n[8], const T lnk[8], const T lnkh[8], const T lnk1[8],
    const T* prior_row, const T c5[3], const T c7[3], const T c6[3],
    const T c4[3], T ll[kNG]) {
  accumulate_plain(n, lnk, lnkh, lnk1, prior_row, ll);
  accumulate_meth(n, lnk, lnkh, lnk1, c5, c7, c6, c4, ll);
}

// first-maximum argmax of ll
template <typename T>
__device__ __forceinline__ int argmax(const T ll[kNG], T* best) {
  int mx = 0;
  T b = ll[0];
#pragma unroll
  for (int g = 1; g < kNG; ++g) {
    if (ll[g] > b) {
      b = ll[g];
      mx = g;
    }
  }
  *best = b;
  return mx;
}

template <typename T>
__device__ __forceinline__ void load_tables(const T* tab, const T* prior,
                                            T* s_tab, T* s_prior) {
  for (int j = threadIdx.x; j < kNQ * 4; j += blockDim.x) s_tab[j] = tab[j];
  for (int j = threadIdx.x; j < 5 * kNG; j += blockDim.x)
    s_prior[j] = prior[j];
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// _agg_quals_f32: floorf(0.5f + qual_sum / (float)count), each step
// rounded to nearest in f32 (never --use_fast_math); 0 where count == 0
__device__ __forceinline__ int round_qual(float qual_sum, int count) {
  if (count <= 0) return 0;
  return (int)floorf(
      __fadd_rn(0.5f, __fdiv_rn(qual_sum, __int2float_rn(count))));
}

}  // namespace bsct
