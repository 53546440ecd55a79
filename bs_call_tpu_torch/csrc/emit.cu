// K3: the emit fields of the fused exact tier.
//
// Replaces the XLA program bs_call_tpu/ops/kernels/emit_device.py
// `emit_fields_dd` (with `_fisher_dd` and `_cg_codes`), which ran in
// double-float32 on the TPU with guard bands, a 2^-53-grid emulation for
// GQ, a dd log1p and a log2 rebuild of the winner's GL. The H100 computes
// f64 natively, so this kernel follows the host emit prep
// (bs_call_tpu/native/bsc_emit.cpp:54-128) and the host Fisher test
// (bsc_stats.cpp:41-99, 391-399) operation for operation in f64. The
// plain version, with the reasons for every risk bit, is
// `emit_fields_plain` in bs_call_tpu_torch/ops/kernels/emit_device.py;
// both must agree on every row that neither flags.
//
// Inputs, per position i < n (one chunk of the fused tier):
//   the model's   gt_prob [n,10] f64, max_gt [n] i32, margin [n] f64,
//                 off_sum [n] f64 (K12's, or K2's)
//   the pileup's  counts2 [n,2,8] i32, mapq2_sum [n] f32 (K12's, or K1's)
//   ref [n] i32 (0..4), the emit tables (ops/emit_tables.py: `packed`
//   int32 in PACKED_ORDER, lfact [256] f64), and quirk (the reference's
//   counts[0][6] in the GT genotype's Fisher table).
// Output: one byte buffer, struct of arrays in the order of
// ops/kernels/emit_cuda.py LAYOUT (offsets below), so the chunk's fields
// come back in one D2H copy.
//
// Design. One thread per position; the int tables and lfact sit in
// shared memory. A thread reads its K2 outputs and counts, the +-1
// neighbours' counts and max_gt for the CG automaton, and on het rows
// walks the Fisher tails sequentially (at most FISHER_IMAX steps a tail;
// longer walks and lfact arguments >= 256, which need lgamma, are
// flagged for the host). Rounding is controlled where it reaches a
// quantization: nvcc contracts a*b+c into an FMA by default and the
// host's carry does not, so the Fisher carry, the phred chain and the FS
// quantization use __dmul_rn / __dadd_rn / __ddiv_rn, and the f32
// division of MQ __fdiv_rn (never --use_fast_math).
//
// Bound. About 300 bytes read and 50 written per position, a few
// exp/log per row and a data-dependent loop on het rows (a few percent
// of a real pileup): latency of the f64 special functions and warp
// divergence on the Fisher walk, not memory bandwidth. Nothing is tuned:
// het-row compaction and the like wait for a later version.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kNG = 10;
constexpr double kLog10 = 2.30258509299404568402;  // bs_call.h:36
constexpr int kLfactN = 256;
constexpr long long kFisherImax = 512;
constexpr double kTieMargin = 1e-9;
constexpr float kMq2Exact = 16777216.0f;  // 2^24
// error bands: ops/kernels/emit_device.py GQ_BAND, FS_BAND, CLAMP_BAND,
// GL_BAND
constexpr double kGqBand = 10.0 / kLog10 * 0x1p-53;
constexpr double kFsBand = 1e-9;
constexpr double kClampBand = 1e-9;
constexpr double kGlBand = 8 * 0x1p-52;

// offsets of the int tables in `packed` (ops/emit_tables.py PACKED_ORDER)
constexpr int kHet = 0, kCflag = 10, kGflag = 20, kMacValid = 30,
              kFtabA = 40, kFtabB = 120, kMacA = 200, kMacB = 280,
              kGlIdx = 360, kGlLen = 610, kTabN = 660;

__device__ __forceinline__ double lfact(long long x, const double* s_lf) {
  return x < kLfactN ? s_lf[x] : lgamma((double)x + 1.0);
}

// the reference's carry for i < steps:
// l *= (u-i)(v-i) / ((w+i+1)(z+i+1)); p += l  (integer products in 64 bits)
__device__ double walk(double l, double p, long long u, long long v,
                       long long w, long long z, long long steps) {
  for (long long i = 0; i < steps; ++i) {
    const double r = __ddiv_rn((double)((u - i) * (v - i)),
                               (double)((w + i + 1) * (z + i + 1)));
    l = __dmul_rn(l, r);
    p = __dadd_rn(p, l);
  }
  return p;
}

__device__ __forceinline__ double term(double knst, long long a, long long b,
                                       long long c, long long d,
                                       const double* s_lf) {
  return exp(__dsub_rn(
      __dsub_rn(__dsub_rn(__dsub_rn(knst, lfact(a, s_lf)), lfact(b, s_lf)),
                lfact(c, s_lf)),
      lfact(d, s_lf)));
}

// log10 of the two-sided Fisher p of [c0 c1; c2 c3], clamped below at
// 1e-20 (bsc_fisher_batch); sets risk where the host may differ
__device__ double fisher_log10(long long c0, long long c1, long long c2,
                               long long c3, const double* s_lf,
                               bool& risk) {
  const long long row0 = c0 + c1, row1 = c2 + c3;
  const long long col0 = c0 + c2, col1 = c1 + c3;
  const long long n = row0 + row1;
  if (n == 0) return 0.0;  // p = 1
  if (n >= kLfactN) risk = true;
  const double delta =
      __dsub_rn((double)c0, __ddiv_rn((double)(row0 * col0), (double)n));
  const double knst = __dsub_rn(
      __dadd_rn(__dadd_rn(__dadd_rn(lfact(col0, s_lf), lfact(col1, s_lf)),
                          lfact(row0, s_lf)),
                lfact(row1, s_lf)),
      lfact(n, s_lf));
  const bool pos = delta > 0.0;
  double l = term(knst, c0, c1, c2, c3, s_lf);
  long long steps = pos ? min(c1, c2) : min(c0, c3);
  if (steps > kFisherImax) {
    risk = true;
    steps = kFisherImax;
  }
  double p = pos ? walk(l, l, c1, c2, c0, c3, steps)
                 : walk(l, l, c0, c3, c1, c2, steps);
  long long k, mn;
  if (pos) {
    k = (long long)ceil(2.0 * delta);
    mn = min(c0, c3);
  } else {
    k = (long long)ceil(-2.0 * delta);
    if (!k) k = 1;
    mn = min(c1, c2);
  }
  if (k <= mn) {
    const long long a = pos ? c0 - k : c0 + k;
    const long long b = pos ? c1 + k : c1 - k;
    const long long c = pos ? c2 + k : c2 - k;
    const long long d = pos ? c3 - k : c3 + k;
    l = term(knst, a, b, c, d, s_lf);
    p = __dadd_rn(p, l);
    steps = mn - k;
    if (steps > kFisherImax) {
      risk = true;
      steps = kFisherImax;
    }
    p = pos ? walk(l, p, a, d, b, c, steps) : walk(l, p, b, c, a, d, steps);
  }
  if (fabs(p - 1e-20) <= 1e-20 * kClampBand) risk = true;
  if (p < 1.0e-20) p = 1.0e-20;
  return __ddiv_rn(log(p), kLog10);
}

__device__ __forceinline__ bool near_int(double y, double band) {
  const double f = y - floor(y);
  return f < band || f > 1.0 - band;
}

// the host's GL value: clamp below at -99.999 in f64, then f32
__device__ __forceinline__ float gl_cast(double v) {
  return __double2float_rn(v < -99.999 ? -99.999 : v);
}

// 1-based genotype code of position j (0 = uncovered)
__device__ __forceinline__ int gt1_at(const int* counts2, const int* max_gt,
                                      long long j) {
  int s = 0;
#pragma unroll
  for (int c = 0; c < 16; ++c) s += counts2[j * 16 + c];
  return s > 0 ? min(max(max_gt[j], 0), kNG - 1) + 1 : 0;
}

__global__ void __launch_bounds__(kBlock)
    emit_fields_kernel(const double* __restrict__ gt_prob,
                       const int* __restrict__ max_gt,
                       const double* __restrict__ margin,
                       const double* __restrict__ off,
                       const int* __restrict__ counts2,
                       const float* __restrict__ mapq2_sum,
                       const int* __restrict__ ref, long long n,
                       const int* __restrict__ tab,
                       const double* __restrict__ lf, int quirk,
                       uint8_t* __restrict__ out) {
  __shared__ int s_tab[kTabN];
  __shared__ double s_lf[kLfactN];
  for (int j = threadIdx.x; j < kTabN; j += blockDim.x) s_tab[j] = tab[j];
  for (int j = threadIdx.x; j < kLfactN; j += blockDim.x) s_lf[j] = lf[j];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // packed outputs (emit_cuda.py LAYOUT)
  double* o_fs = reinterpret_cast<double*>(out);
  float* o_gl = reinterpret_cast<float*>(out + 8 * n);
  int* o_dp1 = reinterpret_cast<int*>(out + 28 * n);
  int* o_mq = reinterpret_cast<int*>(out + 32 * n);
  uint8_t* u8 = out + 36 * n;
  uint8_t* o_risk = u8;
  uint8_t* o_covered = u8 + n;
  uint8_t* o_gt1 = u8 + 2 * n;
  uint8_t* o_max_gt = u8 + 3 * n;
  uint8_t* o_ref5 = u8 + 4 * n;
  uint8_t* o_phred = u8 + 5 * n;
  uint8_t* o_qd = u8 + 6 * n;
  uint8_t* o_fs_int = u8 + 7 * n;
  uint8_t* o_flt = u8 + 8 * n;
  uint8_t* o_mac1 = u8 + 9 * n;
  uint8_t* o_gl_len = u8 + 10 * n;
  uint8_t* o_cg_code = u8 + 11 * n;
  uint8_t* o_cond_cg = u8 + 12 * n;
  uint8_t* o_het = u8 + 13 * n;

  int c2[16];
  int cnt[8];
  int n_all = 0;
#pragma unroll
  for (int c = 0; c < 16; ++c) c2[c] = counts2[i * 16 + c];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    cnt[c] = c2[c] + c2[8 + c];
    n_all += cnt[c];
  }
  const bool covered = n_all > 0;
  const int mx = min(max(max_gt[i], 0), kNG - 1);
  bool risk = false;

  // MQ: (int)(0.5 + sqrt((double)(mapq2 / (float)n))), exact below 2^24
  int mq = 0;
  if (covered) {
    const float m2 = mapq2_sum[i];
    mq = (int)__dadd_rn(
        0.5, sqrt((double)__fdiv_rn(m2, __int2float_rn(n_all))));
    if (m2 >= kMq2Exact) risk = true;
  }

  // GQ from the host's winner rewrite gp = -log(1 + off) / ln 10
  const double gp_w = __ddiv_rn(-log(__dadd_rn(1.0, off[i])), kLog10);
  const double x = __dmul_rn(gp_w, kLog10);
  const double z1 = exp(x);
  int ph;
  if (z1 >= 1.0) {
    ph = 255;
    if (x != 0.0) risk = true;
  } else {
    const double om = __dsub_rn(1.0, z1);
    const double ph_f = __ddiv_rn(__dmul_rn(-10.0, log(om)), kLog10);
    const long long t = (long long)ph_f;
    ph = t > 255 ? 255 : (int)t;
    const double band = kGqBand * (1.0 + 4.0 * fabs(x)) / om + 1e-11;
    if (ph_f < 256.0 && near_int(ph_f, band)) risk = true;
  }
  const int dp1 = cnt[0] + cnt[1] + cnt[2] + cnt[3];
  const int qd = dp1 > 0 ? ph / dp1 : ph;

  // FS: the Fisher strand test on het rows
  const bool het = covered && s_tab[kHet + mx];
  double fs = 0.0;
  if (het) {
    long long f0 = 0, f1 = 0, f2 = 0, f3 = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int ma = s_tab[kFtabA + mx * 8 + c];
      const int mb = s_tab[kFtabB + mx * 8 + c];
      f0 += (long long)c2[c] * ma;
      f1 += (long long)c2[c] * mb;
      f2 += (long long)c2[8 + c] * ma;
      f3 += (long long)c2[8 + c] * mb;
    }
    if (quirk && mx == 8) f2 = (long long)c2[8 + 2] + c2[8 + 4] + c2[6];
    bool fr = false;
    fs = fisher_log10(f0, f1, f2, f3, s_lf, fr);
    if (fr) risk = true;
  }
  const double fs_q = __dadd_rn(__dmul_rn(-fs, 10.0), 0.5);
  const int fs_int = (int)(long long)fs_q;
  if (het && near_int(fs_q, kFsBand)) risk = true;

  const int flt = (ph < 20 ? 1 : 0) | (qd < 2 ? 2 : 0) |
                  (fs_int > 60 ? 4 : 0) | (mq < 40 ? 8 : 0);
  bool mac1 = false;
  if (flt == 0 && s_tab[kMacValid + mx]) {
    long long sa = 0, sb = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      sa += (long long)cnt[c] * s_tab[kMacA + mx * 8 + c];
      sb += (long long)cnt[c] * s_tab[kMacB + mx * 8 + c];
    }
    mac1 = sa <= 1 || sb <= 1;
  }

  // GL: K2's f64 posteriors, the winner slot rewritten as the host does
  const int r = min(max(ref[i], 0), 4);
  const int key = mx * 5 + r;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int idx = s_tab[kGlIdx + key * 5 + k];
    float g;
    if (idx == -2) {
      g = __double2float_rn(-99.999);
    } else {
      const int safe = idx >= 0 ? idx : 0;
      const double v = safe == mx ? gp_w : gt_prob[i * kNG + safe];
      g = gl_cast(v);
      if (safe == mx) {
        const double e = fabs(v) * kGlBand;
        if (gl_cast(v - e) != g || gl_cast(v + e) != g) risk = true;
      }
    }
    o_gl[i * 5 + k] = g;
  }

  // genotype codes and the CG-status automaton (bsc_emit.cpp:107-126)
  const int a2 = covered ? mx + 1 : 0;
  const int a1 = i > 0 ? gt1_at(counts2, max_gt, i - 1) : 0;
  const int a3 = i + 1 < n ? gt1_at(counts2, max_gt, i + 1) : 0;
  const int g1c = a1 > 0 ? a1 - 1 : 0;
  const int g3c = a3 > 0 ? a3 - 1 : 0;
  const bool ccg = (a2 == 5 && a3 == 8) || (a2 == 8 && a1 == 5);
  int code;
  if (ccg) code = 'G';
  else if (a2 == 5) code = a3 > 0 ? (s_tab[kGflag + g3c] ? 'H' : 'N') : '?';
  else if (a2 == 8) code = a1 > 0 ? (s_tab[kCflag + g1c] ? 'H' : 'N') : '?';
  else if (s_tab[kCflag + mx])
    code = a3 > 0 ? (s_tab[kGflag + g3c] ? 'H' : 'N') : '?';
  else if (s_tab[kGflag + mx])
    code = a1 > 0 ? (s_tab[kCflag + g1c] ? 'H' : 'N') : '.';
  else code = '.';

  // the chunk's edges lack their CG context; ll ties go to the oracle
  if (i == 0 || i == n - 1) risk = true;
  if (margin[i] < kTieMargin) risk = true;

  o_fs[i] = fs;
  o_dp1[i] = dp1;
  o_mq[i] = mq;
  o_risk[i] = risk;
  o_covered[i] = covered;
  o_gt1[i] = (uint8_t)a2;
  o_max_gt[i] = (uint8_t)mx;
  o_ref5[i] = (uint8_t)r;
  o_phred[i] = (uint8_t)ph;
  o_qd[i] = (uint8_t)qd;
  o_fs_int[i] = (uint8_t)fs_int;
  o_flt[i] = (uint8_t)flt;
  o_mac1[i] = mac1;
  o_gl_len[i] = (uint8_t)s_tab[kGlLen + key];
  o_cg_code[i] = (uint8_t)code;
  o_cond_cg[i] = ccg;
  o_het[i] = het;
}

}  // namespace

extern "C" int bsct_emit_fields(const double* gt_prob, const int* max_gt,
                                const double* margin, const double* off,
                                const int* counts2, const float* mapq2_sum,
                                const int* ref, long long n, const int* tab,
                                const double* lfact, int quirk, uint8_t* out,
                                void* stream) {
  if (n > 0) {
    const unsigned int blocks = (unsigned int)((n + kBlock - 1) / kBlock);
    emit_fields_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
        gt_prob, max_gt, margin, off, counts2, mapq2_sum, ref, n, tab, lfact,
        quirk, out);
  }
  return (int)cudaGetLastError();
}
