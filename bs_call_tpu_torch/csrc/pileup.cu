// K1: pileup scatter of a normalised read batch.
//
// Replaces bs_call_tpu/ops/kernels/pileup_device.py `device_pileup` (an
// XLA-fused segment-sum on the TPU), the device half of the reference's
// pileup loop (call_genotypes.c:180-226).
//
// Input (pileup_device.py layout): rd [R,L] u8 with base = rd & 3 and
// q = rd >> 2; starts, ori, strand, mapq [R] i32. starts are
// block-relative and may be negative at partial-range boundaries.
// Per read, bytes outside the first..last live byte (q > 0, q != FLT_QUAL)
// are trimmed; a byte inside counts when q >= min_qual, q != FLT_QUAL and
// 0 <= start + j < n_pos. Its category is BASE_TAB_ST[strand][base].
//
// Design. One block per read row: a block reduction (warp shuffles, then
// shared-memory atomics) finds the row's first and last live byte, then
// the threads stride over that span and scatter with integer atomics into
//   counts2   [n_pos,2,8] i32 at pos*16 + ori*8 + cat
//   qual_sum  [n_pos,8]   i32 at pos*8 + cat      (cast to f32 after)
//   mapq2_sum [n_pos]     u64 += mapq^2           (cast to f32 after)
// Integer sums are exact and independent of the order the atomics land
// in, where float atomicAdd is not. The f32 casts give the JAX version's
// bits (an ordered f32 sum) while a sum stays below 2^24: always for
// qual_sum at realistic depth (2^24 / 43 = 390k reads on one position),
// but mapq2_sum passes 2^24 above ~4.6k reads at mapq 60 and then rounds
// once here where the ordered f32 sum rounds at every add. The exact
// fused tier never reads mapq2_sum (the host aggregate supplies MQ).
//
// Bound. Memory traffic is small (R*L bytes in); the limit is atomic
// throughput on hot positions, where every read covering a position
// updates the same few words. Nothing here is tuned yet: a later version
// can accumulate a position tile in shared memory first.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFltQual = 63;  // FLT_QUAL: trimmed / masked base
constexpr int kBlock = 128;

// BASE_TAB_ST (bs_call_tpu/constants.py): (bs strand, base) -> category
__constant__ int kBaseTab[3][4] = {
    {0, 1, 2, 3},  // non-converted
    {0, 5, 2, 7},  // C2T
    {4, 1, 6, 3},  // G2A
};

__global__ void __launch_bounds__(kBlock)
    pileup_scatter_kernel(const uint8_t* __restrict__ rd,
                          const int* __restrict__ starts,
                          const int* __restrict__ ori,
                          const int* __restrict__ strand,
                          const int* __restrict__ mapq, int L, int n_pos,
                          int min_qual, int* __restrict__ counts2,
                          int* __restrict__ qual_sum,
                          unsigned long long* __restrict__ mapq2_sum) {
  const int r = blockIdx.x;
  const uint8_t* row = rd + (long long)r * L;
  __shared__ int s_lo, s_hi;
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int q = row[j] >> 2;
    if (q > 0 && q != kFltQual) {
      lo = min(lo, j);
      hi = max(hi, j);
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_down_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_down_sync(0xffffffffu, hi, d));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  lo = s_lo;
  hi = s_hi;
  if (hi < 0) return;  // no live byte in this row

  const long long start = starts[r];
  const int o = ori[r] != 0;
  const int st = min(max(strand[r], 0), 2);
  const unsigned long long mq2 =
      (unsigned long long)((long long)mapq[r] * mapq[r]);
  for (int j = lo + threadIdx.x; j <= hi; j += blockDim.x) {
    const int b = row[j];
    const int q = b >> 2;
    if (q < min_qual || q == kFltQual) continue;
    const long long pos = start + j;
    if (pos < 0 || pos >= n_pos) continue;
    const int cat = kBaseTab[st][b & 3];
    atomicAdd(&counts2[pos * 16 + o * 8 + cat], 1);
    atomicAdd(&qual_sum[pos * 8 + cat], q);
    atomicAdd(&mapq2_sum[pos], mq2);
  }
}

}  // namespace

extern "C" int bsct_pileup_scatter(const uint8_t* rd, const int* starts,
                                   const int* ori, const int* strand,
                                   const int* mapq, int R, int L, int n_pos,
                                   int min_qual, int* counts2, int* qual_sum,
                                   unsigned long long* mapq2_sum,
                                   void* stream) {
  if (R > 0 && L > 0) {
    pileup_scatter_kernel<<<R, kBlock, 0, (cudaStream_t)stream>>>(
        rd, starts, ori, strand, mapq, L, n_pos, min_qual, counts2, qual_sum,
        mapq2_sum);
  }
  return (int)cudaGetLastError();
}
