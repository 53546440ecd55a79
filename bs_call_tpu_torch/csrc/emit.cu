// K3: the emit fields of the fused exact tier.
//
// Replaces the XLA program bs_call_tpu/ops/kernels/emit_device.py
// `emit_fields_dd` (:256, with `_fisher_dd` :90 and `_cg_codes` :495),
// which ran in double-float32 on the TPU with guard bands, a 2^-53-grid
// emulation for GQ, a dd log1p and a log2 rebuild of the winner's GL. The
// H100 computes f64 natively, so this kernel follows the host emit prep
// (bs_call_tpu/native/bsc_emit.cpp:54-128) and the host Fisher test
// (bsc_stats.cpp:41-99, 391-399) operation for operation in f64. The
// plain version, with the reasons for every risk bit, is
// `emit_fields_plain` in bs_call_tpu_torch/ops/kernels/emit_device.py;
// both must agree on every row that neither flags.
//
// Inputs, per position i < n (one chunk of the fused tier):
//   the model's   gt_prob [n,10] f64, max_gt [n] i32, margin [n] f64,
//                 off_sum [n] f64 (K12's)
//   the pileup's  counts2 [n,2,8] i32, mapq2_sum [n] f32 (K12's)
//   ref [n] i32 (0..4), the emit tables (ops/emit_tables.py: `packed`
//   int32 in PACKED_ORDER, lfact [256] f64), quirk (the reference's
//   counts[0][6] in the GT genotype's Fisher table), and ctx, null or a
//   device int32 [2]: the 1-based genotype codes of the positions just
//   before and just after the chunk, -1 where unknown. A position-sharded
//   caller (ops/kernels/emit_device.py `sharded_fused_ll_emit`) copies a
//   neighbour slab's border codes there, device to device, so no host
//   round trip stands between that slab's K12 and this K3.
// Output: one byte buffer, struct of arrays in the order of
// ops/kernels/emit_cuda.py LAYOUT (offsets below), so the chunk's fields
// come back in one D2H copy. On a row flagged `risk`, fs_hi, fs_int, flt
// and mac1 are unspecified (a flagged row may skip its Fisher test; the
// host recomputes every flagged row); every other field, gt1 among them
// (the host reads the neighbours' codes of every row), is computed as on
// any row.
//
// Bound. 172 bytes in (gt_prob 80, counts2 64, margin and off 8 each,
// max_gt, mapq2_sum and ref 4 each) and 50 out a position: 0.0022 ms at
// 32,832 positions on an H100 SXM. The f64 work is far below that at the
// card's FP64 rate, but it comes as long dependent chains (a few libdevice
// exp/log a row, correctly rounded divisions, a Fisher walk of up to ~250
// serial steps on het rows) on a chunk that fills one wave of CTAs:
// latency, not bandwidth, sets the time.
//
// Design. One CTA of 256 threads per tile of kT = 128 positions.
// * Staging. Thread 0 issues one bulk copy (the Tensor Memory
//   Accelerator) per array into shared memory, completing on an
//   mbarrier: the int tables, lfact, and the tile's counts2 and gt_prob
//   rows, the two arrays a thread would otherwise read at a 64- and
//   80-byte stride. A source that is not 16-byte aligned (a tensor that
//   starts inside its storage) is copied by all threads with 4-byte
//   cp.async instead. The per-row scalars (off, margin, max_gt,
//   mapq2_sum, ref) are read by each row's thread, coalesced, and the
//   light threads run GQ's log/exp chain on `off` while the copies fly.
//   Two threads read the genotype codes of the rows just outside the
//   tile (the CG automaton's neighbours) from device memory, or from ctx
//   at the chunk's ends (0, uncalled, where it is unknown).
// * Warps 0-3, the light pass, one thread a position: MQ, GQ, dp1, QD,
//   GL, gl_len, ref5, gt1 (shared with the neighbours through shared
//   memory), the CG code, cond_cg, and every risk bit that does not
//   depend on the Fisher test.
// * Warps 4-7 at the same time, the Fisher test. One thread a position
//   computes het and the Fisher table. Het rows not already flagged
//   (chunk edges whose ctx is unknown, ll ties, mapq2_sum >= 2^24, a
//   table total >= 256, which would need lgamma) go into a shared queue:
//   warp ballot, popc, one shared atomic a warp. A flagged het row keeps
//   its risk bit and skips the test; with the total below 256 no tail is
//   longer than 127 steps, so the plain version's FISHER_IMAX clamp never
//   applies here. One thread a queued row computes its two terms (the exp
//   calls) and its
//   tails. The walks then split: a step's factor (u-i)(v-i) /
//   ((w+i+1)(z+i+1)) does not depend on the carry, so threads compute
//   all the tile's factors in parallel (the divisions) into shared
//   memory, and each queued row's thread then runs only its carry, one
//   multiply and one add a step, in the reference's order. A tile whose
//   walks take at most 256 steps (a WGBS chunk's, mostly) does this in
//   the Fisher warps beside the light pass; a longer one (a het-rich
//   chunk's) after it, with the divisions spread over all 256 threads.
//   A row's walk does not depend on its place in the queue or on the
//   split, so no bit moves.
// * After a barrier the light threads finish their rows (fs, fs_int, the
//   FS and clamp bands, flt, mac1). Each field is stored by its rows'
//   threads, so a warp's store is contiguous; GL, 20 bytes a row, goes
//   through shared memory and out with 16-byte stores (word stores at
//   an unaligned head and tail).
//
// Rounding is controlled where it reaches a quantization: nvcc contracts
// a*b+c into an FMA by default and the host's carry does not, so the
// Fisher carry, the phred chain and the FS quantization use __dmul_rn /
// __dadd_rn / __ddiv_rn, and the f32 division of MQ __fdiv_rn (never
// --use_fast_math). The GQ and GL band expressions, which nvcc may
// contract, are written as in the previous one-thread-a-position K3, so
// the risk bits are that kernel's.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 128;            // positions a tile (one CTA)
constexpr int kThreads = 2 * kT;   // warps 0-3 light pass, 4-7 Fisher
constexpr int kNG = 10;
constexpr double kLog10 = 2.30258509299404568402;  // bs_call.h:36
constexpr int kLfactN = 256;
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a named barrier over `count` threads (a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// the mbarrier that a tile's bulk copies complete: one arrival (the
// thread that issues them) and their bytes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one bulk copy by the Tensor Memory Accelerator: nbytes, a multiple of
// 16, between 16-byte aligned addresses, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned nbytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(nbytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A tile's arrays go to shared memory in one bulk copy each where the
// source is 16-byte aligned (all sizes here are multiples of 16): thread 0
// issues them all. A source that is not (a tensor that starts inside its
// storage) is copied by all threads with 4-byte cp.async.
struct Staged {
  void* dst;
  const void* src;
  int nbytes;
};

template <int kN>
__device__ __forceinline__ void stage_tile(const Staged (&arrays)[kN],
                                           uint64_t* bar, int tid) {
  if (tid == 0) {
    unsigned bytes = 0;
#pragma unroll
    for (int k = 0; k < kN; ++k)
      if (aligned16(arrays[k].src)) bytes += arrays[k].nbytes;
    mbar_arrive_expect(bar, bytes);
#pragma unroll
    for (int k = 0; k < kN; ++k)
      if (aligned16(arrays[k].src))
        bulk_copy(arrays[k].dst, arrays[k].src, arrays[k].nbytes, bar);
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (aligned16(arrays[k].src)) continue;
    uint8_t* d = static_cast<uint8_t*>(arrays[k].dst);
    const uint8_t* s = static_cast<const uint8_t*>(arrays[k].src);
    for (int j = 4 * tid; j < arrays[k].nbytes; j += 4 * kThreads)
      cp_async4(d + j, s + j);
  }
}

__device__ __forceinline__ void load_counts2(const int4* s_c2, int r,
                                             int* c2) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = s_c2[4 * r + q];
    c2[4 * q] = v.x;
    c2[4 * q + 1] = v.y;
    c2[4 * q + 2] = v.z;
    c2[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ double term(double knst, int a, int b, int c,
                                       int d, const double* s_lf) {
  return exp(__dsub_rn(
      __dsub_rn(__dsub_rn(__dsub_rn(knst, s_lf[a]), s_lf[b]), s_lf[c]),
      s_lf[d]));
}

// a tail of the Fisher walk: (u, v, w, z), a byte each (the table's
// total is below 256)
__device__ __forceinline__ int pack_tail(int u, int v, int w, int z) {
  return u | v << 8 | w << 16 | z << 24;
}

// step i of a tail's carry l *= (u-i)(v-i) / ((w+i+1)(z+i+1))
// (bsc_stats.cpp:55): its factor, which does not depend on the carry
__device__ __forceinline__ double step_factor(int t, int i) {
  const int u = t & 255, v = (t >> 8) & 255, w = (t >> 16) & 255,
            z = (t >> 24) & 255;
  return __ddiv_rn((double)((u - i) * (v - i)),
                   (double)((w + i + 1) * (z + i + 1)));
}

// The two-sided Fisher test of [c0 c1; c2 c3] (bsc_stats.cpp:41-99),
// a table of 1..255 reads, up to its walk: the first term l0, the second
// tail's term l2 (have2), and both tails (packed, and their steps s1,
// s2). The reference's order is p = l0, the first tail's carry, then
// p += l2 and the second tail's carry from l = l2.
struct FisherRow {
  double l0, l2;
  int t1, t2, s1, s2;
  bool have2;
};

__device__ FisherRow fisher_setup(int c0, int c1, int c2, int c3,
                                  const double* s_lf) {
  const int row0 = c0 + c1, row1 = c2 + c3;
  const int col0 = c0 + c2, col1 = c1 + c3;
  const int n = row0 + row1;
  const double delta =
      __dsub_rn((double)c0, __ddiv_rn((double)(row0 * col0), (double)n));
  const double knst = __dsub_rn(
      __dadd_rn(__dadd_rn(__dadd_rn(s_lf[col0], s_lf[col1]), s_lf[row0]),
                s_lf[row1]),
      s_lf[n]);
  const bool pos = delta > 0.0;
  FisherRow f;
  f.l0 = term(knst, c0, c1, c2, c3, s_lf);
  f.t1 = pos ? pack_tail(c1, c2, c0, c3) : pack_tail(c0, c3, c1, c2);
  f.s1 = pos ? min(c1, c2) : min(c0, c3);
  // the mirrored tail, from k = ceil(2|delta|) steps the other way
  int k, mn;
  if (pos) {
    k = (int)ceil(2.0 * delta);
    mn = min(c0, c3);
  } else {
    k = (int)ceil(-2.0 * delta);
    if (!k) k = 1;
    mn = min(c1, c2);
  }
  f.have2 = k <= mn;
  f.l2 = 0.0;
  f.t2 = 0;
  f.s2 = 0;
  if (f.have2) {
    const int a = pos ? c0 - k : c0 + k;
    const int b = pos ? c1 + k : c1 - k;
    const int c = pos ? c2 + k : c2 - k;
    const int d = pos ? c3 - k : c3 + k;
    f.l2 = term(knst, a, b, c, d, s_lf);
    f.t2 = pos ? pack_tail(a, d, b, c) : pack_tail(b, c, a, d);
    f.s2 = mn - k;
  }
  return f;
}

// log10 of the walk's p, clamped below at 1e-20 (bsc_fisher_batch);
// sets risk where the host may differ
__device__ __forceinline__ double fisher_finish(double p, bool& risk) {
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

// 1-based genotype code of position j (0 = uncovered), from device memory
__device__ __forceinline__ int gt1_at(const int* counts2, const int* max_gt,
                                      long long j) {
  int s = 0;
#pragma unroll
  for (int c = 0; c < 16; ++c) s += counts2[j * 16 + c];
  return s > 0 ? min(max(max_gt[j], 0), kNG - 1) + 1 : 0;
}

constexpr int kSteps = 1024;  // walk factors staged a round
// a tile whose walks take at most this many steps walks in the Fisher
// warps alone (two divisions a thread), beside the light pass; a longer
// one after it, with the divisions spread over all 256 threads
constexpr int kFewSteps = 2 * kT;

template <int kN>
__device__ __forceinline__ void sync_walkers() {
  if (kN == kThreads) __syncthreads();
  else bar_sync(2, kT);
}

// The walks of the tile's queued rows, kSteps factors a round: the kN
// threads (me = 0..kN-1) compute factors of any queued row (the
// divisions, which do not depend on the carry), then each queued row's
// thread (walker, queue place w, its row's first step and step count)
// runs its carry in the reference's order: p = l0, the first tail, then
// p += l2 and the second tail from l = l2. Returns p.
template <int kN>
__device__ double walks(int me, bool walker, int w, const FisherRow& fr,
                        int first, int steps, int total,
                        const int4* s_tails, uint8_t* s_owner,
                        double* s_step) {
  double l = fr.l0, p = fr.l0;
  bool joined = !fr.have2;
  const int split = first + fr.s1;  // the second tail's first step
  for (int lo = 0; lo < total; lo += kSteps) {
    const int hi = min(total, lo + kSteps);
    const int mine = walker ? max(first, lo) : 0;
    const int end = walker ? min(first + steps, hi) : 0;
    for (int f = mine; f < end; ++f) s_owner[f - lo] = (uint8_t)w;
    sync_walkers<kN>();
    for (int f = lo + me; f < hi; f += kN) {
      const int4 t = s_tails[s_owner[f - lo]];
      const int s = f - t.w;
      s_step[f - lo] = s < t.z ? step_factor(t.x, s)
                               : step_factor(t.y, s - t.z);
    }
    sync_walkers<kN>();
    const int mid = min(end, split);
#pragma unroll 4
    for (int f = mine; f < mid; ++f) {
      l = __dmul_rn(l, s_step[f - lo]);
      p = __dadd_rn(p, l);
    }
    if (!joined && split < end) {
      p = __dadd_rn(p, fr.l2);
      l = fr.l2;
      joined = true;
    }
#pragma unroll 4
    for (int f = max(mine, split); f < end; ++f) {
      l = __dmul_rn(l, s_step[f - lo]);
      p = __dadd_rn(p, l);
    }
  }
  if (!joined) p = __dadd_rn(p, fr.l2);
  return p;
}

__global__ void __launch_bounds__(kThreads, 2)
    emit_fields_kernel(const double* __restrict__ gt_prob,
                       const int* __restrict__ max_gt,
                       const double* __restrict__ margin,
                       const double* __restrict__ off,
                       const int* __restrict__ counts2,
                       const float* __restrict__ mapq2_sum,
                       const int* __restrict__ ref, long long n,
                       const int* __restrict__ tab,
                       const double* __restrict__ lf, int quirk,
                       const int* __restrict__ ctx,
                       uint8_t* __restrict__ out) {
  __shared__ __align__(16) int s_tab[kTabN];
  __shared__ __align__(16) double s_lf[kLfactN];
  __shared__ __align__(16) int4 s_c2[4 * kT];
  __shared__ __align__(16) double s_gp[kNG * kT];
  __shared__ __align__(16) float s_gl[5 * kT + 4];  // GL rows, for the stores
  __shared__ int s_gt1[kT + 2];  // the rows' codes, a neighbour each side
  __shared__ int4 s_ftab[kT];    // Fisher tables
  __shared__ double s_fs[kT];
  __shared__ bool s_het[kT];
  __shared__ bool s_frisk[kT];
  __shared__ int s_queue[kT];
  __shared__ int4 s_tails[kT];   // the queue's (t1, t2, s1, first step)
  __shared__ double s_step[kSteps];
  __shared__ uint8_t s_owner[kSteps];  // the queue row of each factor
  __shared__ int s_wsum[kT / 32];
  __shared__ int s_nq, s_total;
  __shared__ __align__(8) uint64_t s_bar;

  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * kT;
  const int rows = (int)min((long long)kT, n - base);
  // the codes just outside the chunk (clamped to a code), -1 unknown; only
  // the first and the last tile read them
  const int ctx_prev = ctx && base == 0 ? min(ctx[0], kNG) : -1;
  const int ctx_next = ctx && base + rows == n ? min(ctx[1], kNG) : -1;
  if (tid == 0) mbar_init(&s_bar);
  __syncthreads();
  stage_tile<4>({{s_tab, tab, 4 * kTabN},
                 {s_lf, lf, 8 * kLfactN},
                 {s_c2, counts2 + base * 16, 64 * rows},
                 {s_gp, gt_prob + base * kNG, 8 * kNG * rows}},
                &s_bar, tid);
  if (tid < 2) {  // the codes of the rows just outside the tile
    const long long j = tid == 0 ? base - 1 : base + rows;
    s_gt1[tid == 0 ? 0 : rows + 1] =
        j >= 0 && j < n ? gt1_at(counts2, max_gt, j)
                        : max(j < 0 ? ctx_prev : ctx_next, 0);
  }
  if (tid == 0) s_nq = 0;
  const int gl_head = (int)((reinterpret_cast<uintptr_t>(
                                 out + 8 * n + 20 * base) >> 2) & 3);

  // packed outputs (emit_cuda.py LAYOUT)
  double* o_fs = reinterpret_cast<double*>(out);
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

  const int r = tid & (kT - 1);  // this thread's row of the tile
  const bool live = r < rows;
  const long long i = base + r;
  // the rows' scalars, coalesced from device memory
  const int mx = live ? min(max(max_gt[i], 0), kNG - 1) : 0;
  const double mg = live ? margin[i] : 0.0;
  const float m2 = live ? mapq2_sum[i] : 0.0f;

  // GQ from the host's winner rewrite gp = -log(1 + off) / ln 10, while
  // the tile's copies are in flight
  bool risk = false;
  int ph = 0;
  double gp_w = 0.0;
  if (tid < kT && live) {
    gp_w = __ddiv_rn(-log(__dadd_rn(1.0, off[i])), kLog10);
    const double x = __dmul_rn(gp_w, kLog10);
    const double z1 = exp(x);
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
  }
  mbar_wait(&s_bar, 0);
  cp_async_wait_all();
  __syncthreads();

  int c2[16];
  int cnt[8];
  int n_all = 0;
  if (live) {
    load_counts2(s_c2, r, c2);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      cnt[c] = c2[c] + c2[8 + c];
      n_all += cnt[c];
    }
  }
  const bool covered = n_all > 0;
  int qd = 0, mq = 0;
  // a queued row's Fisher setup, its steps and its first step in the
  // tile's walk (Fisher warps)
  FisherRow fr = {};
  int q = 0, steps = 0, first_step = 0;

  if (tid < kT) {
    // ---- the light pass, warps 0-3 ----
    if (live) s_gt1[r + 1] = covered ? mx + 1 : 0;
    bar_sync(1, kT);
    if (live) {
      // MQ: (int)(0.5 + sqrt((double)(mapq2 / (float)n))), exact below 2^24
      if (covered) {
        mq = (int)__dadd_rn(
            0.5, sqrt((double)__fdiv_rn(m2, __int2float_rn(n_all))));
        if (m2 >= kMq2Exact) risk = true;
      }
      const int dp1 = cnt[0] + cnt[1] + cnt[2] + cnt[3];
      qd = dp1 > 0 ? ph / dp1 : ph;

      // GL: the model's f64 posteriors, the winner slot rewritten as the
      // host does
      const int rc = min(max(ref[i], 0), 4);
      const int key = mx * 5 + rc;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int idx = s_tab[kGlIdx + key * 5 + k];
        float g;
        if (idx == -2) {
          g = __double2float_rn(-99.999);
        } else {
          const int safe = idx >= 0 ? idx : 0;
          const double v = safe == mx ? gp_w : s_gp[r * kNG + safe];
          g = gl_cast(v);
          if (safe == mx) {
            const double e = fabs(v) * kGlBand;
            if (gl_cast(v - e) != g || gl_cast(v + e) != g) risk = true;
          }
        }
        s_gl[gl_head + 5 * r + k] = g;
      }

      // genotype codes and the CG-status automaton (bsc_emit.cpp:107-126)
      const int a2 = s_gt1[r + 1];
      const int a1 = s_gt1[r];
      const int a3 = s_gt1[r + 2];
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

      // a chunk's edge without its CG context; ll ties go to the oracle
      if ((i == 0 && ctx_prev < 0) || (i == n - 1 && ctx_next < 0))
        risk = true;
      if (mg < kTieMargin) risk = true;

      o_dp1[i] = dp1;
      o_mq[i] = mq;
      o_covered[i] = covered;
      o_gt1[i] = (uint8_t)a2;
      o_max_gt[i] = (uint8_t)mx;
      o_ref5[i] = (uint8_t)rc;
      o_phred[i] = (uint8_t)ph;
      o_qd[i] = (uint8_t)qd;
      o_gl_len[i] = (uint8_t)s_tab[kGlLen + key];
      o_cg_code[i] = (uint8_t)code;
      o_cond_cg[i] = ccg;
    }
  } else {
    // ---- the Fisher test, warps 4-7 ----
    const bool het = covered && s_tab[kHet + mx];
    bool queued = false;
    if (live) {
      int f0 = 0, f1 = 0, f2 = 0, f3 = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int ma = s_tab[kFtabA + mx * 8 + c];
        const int mb = s_tab[kFtabB + mx * 8 + c];
        f0 += c2[c] * ma;
        f1 += c2[c] * mb;
        f2 += c2[8 + c] * ma;
        f3 += c2[8 + c] * mb;
      }
      if (quirk && mx == 8) f2 = c2[8 + 2] + c2[8 + 4] + c2[6];
      // a table of kLfactN or more reads needs lgamma: flagged, as are the
      // rows the light pass flags whatever their FS; an empty table is
      // p = 1, FS 0
      const int total = f0 + f1 + f2 + f3;
      const bool big = total >= kLfactN;
      const bool flagged = big || (i == 0 && ctx_prev < 0) ||
                           (i == n - 1 && ctx_next < 0) ||
                           mg < kTieMargin || m2 >= kMq2Exact;
      queued = het && !flagged && total > 0;
      s_ftab[r] = make_int4(f0, f1, f2, f3);
      s_het[r] = het;
      s_fs[r] = 0.0;
      s_frisk[r] = het && big;
    }
    const int lane = tid & 31, warp = r >> 5;
    unsigned ball = __ballot_sync(0xffffffffu, queued);
    int first = 0;
    if (lane == 0 && ball) first = atomicAdd(&s_nq, __popc(ball));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (queued) s_queue[first + __popc(ball & ((1u << lane) - 1))] = r;
    bar_sync(2, kT);

    // the queue, one thread a row: the setup, and the first step of each
    // row's walk in a scan over the queue
    const int nq = s_nq;
    if (r < nq) {
      q = s_queue[r];
      const int4 t = s_ftab[q];
      fr = fisher_setup(t.x, t.y, t.z, t.w, s_lf);
      steps = fr.s1 + fr.s2;
    }
    int incl = steps;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_wsum[warp] = incl;
    bar_sync(2, kT);
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kT / 32; ++w) {
      const int sw = s_wsum[w];
      before += w < warp ? sw : 0;
      total += sw;
    }
    first_step = before + incl - steps;
    if (r < nq) s_tails[r] = make_int4(fr.t1, fr.t2, fr.s1, first_step);
    if (r == 0) s_total = total;
    if (total <= kFewSteps) {
      const double p = walks<kT>(r, r < nq, r, fr, first_step, steps, total,
                                 s_tails, s_owner, s_step);
      if (r < nq) {
        bool risky = false;
        s_fs[q] = fisher_finish(p, risky);
        if (risky) s_frisk[q] = true;
      }
    }
  }
  __syncthreads();

  if (s_total > kFewSteps) {
    const bool walker = tid >= kT && r < s_nq;
    const double p = walks<kThreads>(tid, walker, r, fr, first_step, steps,
                                     s_total, s_tails, s_owner, s_step);
    if (walker) {
      bool risky = false;
      s_fs[q] = fisher_finish(p, risky);
      if (risky) s_frisk[q] = true;
    }
    __syncthreads();
  }

  if (tid < kT && live) {
    // ---- the finish: FS, the filter bits, mac1 ----
    const bool het = s_het[r];
    const double fs = s_fs[r];
    if (s_frisk[r]) risk = true;
    const double fs_q = __dadd_rn(__dmul_rn(-fs, 10.0), 0.5);
    const int fs_int = (int)(long long)fs_q;
    if (het && near_int(fs_q, kFsBand)) risk = true;

    const int flt = (ph < 20 ? 1 : 0) | (qd < 2 ? 2 : 0) |
                    (fs_int > 60 ? 4 : 0) | (mq < 40 ? 8 : 0);
    bool mac1 = false;
    if (flt == 0 && s_tab[kMacValid + mx]) {
      int sa = 0, sb = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        sa += cnt[c] * s_tab[kMacA + mx * 8 + c];
        sb += cnt[c] * s_tab[kMacB + mx * 8 + c];
      }
      mac1 = sa <= 1 || sb <= 1;
    }
    o_fs[i] = fs;
    o_risk[i] = risk;
    o_fs_int[i] = (uint8_t)fs_int;
    o_flt[i] = (uint8_t)flt;
    o_mac1[i] = mac1;
    o_het[i] = het;
  }

  // ---- GL: the tile's run of 5 x rows floats, 16-byte stores where
  // aligned (s_gl holds it gl_head words into a 16-byte aligned run) ----
  float* a = reinterpret_cast<float*>(out + 8 * n) + 5 * base - gl_head;
  const int end = gl_head + 5 * rows;
  for (int w = 4 * tid; w < end; w += 4 * kThreads) {
    if (w >= gl_head && w + 4 <= end) {
      *reinterpret_cast<float4*>(a + w) =
          *reinterpret_cast<const float4*>(s_gl + w);
    } else {
      for (int j = max(w, gl_head); j < min(w + 4, end); ++j) a[j] = s_gl[j];
    }
  }
}

}  // namespace

// ctx comes after the stream, so that a caller of the entry as it was
// before ctx (tools/kernel_phases.py times older versions of this file
// with one call) passes its arguments where that version reads them.
extern "C" int bsct_emit_fields(const double* gt_prob, const int* max_gt,
                                const double* margin, const double* off,
                                const int* counts2, const float* mapq2_sum,
                                const int* ref, long long n, const int* tab,
                                const double* lfact, int quirk, uint8_t* out,
                                void* stream, const int* ctx) {
  if (n > 0) {
    const unsigned int blocks = (unsigned int)((n + kT - 1) / kT);
    emit_fields_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        gt_prob, max_gt, margin, off, counts2, mapq2_sum, ref, n, tab, lfact,
        quirk, ctx, out);
  }
  return (int)cudaGetLastError();
}
