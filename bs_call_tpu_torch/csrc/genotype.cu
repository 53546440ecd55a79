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
// against about 68 bytes read (counts and quals [8] int32, ref) and
// 10*sizeof(T)+12 bytes written. In f64 that is bound by the FP64 units
// and the log/exp sequences, not by memory; in f32 by the f32 special
// functions and the stores. Nothing here is tuned yet: the block keeps
// ll in registers and spends no shared memory beyond the tables.
//
// Entry (the column tier and --no-exact, on host-built pileup columns):
// counts [N,8] i32, quals [N,8] i32, ref [N] i32 -> gt_prob [N,10],
// max_gt [N] i32, margin [N], off_sum [N] in T.
//
// The model and the finish are the device functions of genotype_model.cuh,
// shared with K12 (pileup_genotype.cu), which computes the pileup and the
// model of the fused tier in one launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "genotype_model.cuh"

namespace {

using namespace bsct;

constexpr int kBlock = 256;

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
  __syncthreads();
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
