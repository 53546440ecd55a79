// Native float64 genotype model: the host-CPU exact tier.
//
// Scalar transcription of the bisulfite genotype likelihood model
// (reference: genotype_model.c:87-247 calc_gt_prob + get_Z) in IEEE
// float64 with glibc libm — the same libm the reference binary links,
// so this engine sits CLOSER to the C output than the XLA f64 kernel
// it replaces on the default path. The Python twins are
// ops/genotype_np.py (vectorized numpy, the shape this file mirrors
// term by term) and ops/oracle.py (the scalar anchor); randomized
// parity across all three is enforced by tests/test_native_model.py.
//
// All per-qual transcendentals are table gathers (the tables are built
// in Python by ops/tables.py and passed in verbatim, so table VALUES
// are bit-identical across engines); per position only the Z-dependent
// logs (<=8) and the softmax exps (9) remain. Batches are partitioned
// into contiguous ranges across std::threads — deterministic for any
// thread count.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace bsc {  // bsc_pool.cpp
void pool_run(int n, const std::function<void(int)> &fn);
}

namespace {

// Non-informative selector (ops/tables.py NONINF_SEL;
// genotype_model.c:109-164): observed base b x genotype g ->
// 2: n*ln(1+k), 1: n*ln(.5+k), 0: n*ln(k).
const int8_t SEL[4][10] = {
    {2, 1, 1, 1, 0, 0, 0, 0, 0, 0},  // A
    {0, 1, 0, 0, 2, 1, 1, 0, 0, 0},  // C
    {0, 0, 1, 0, 0, 1, 0, 2, 1, 0},  // G
    {0, 0, 0, 1, 0, 0, 1, 0, 1, 2},  // T
};

constexpr double LOG10 = 2.302585092994045684;  // ln(10)

struct GtModel {
    std::vector<double> k, ln_k, ln_kh, ln_k1;  // per qual value
    double prior[5][10];
    double l, t;  // l = 1 - under_conv, t = over_conv
    int nq;
};

// get_Z (genotype_np.py:_get_z; genotype_model.c:23-60): three
// conversion-equilibrium Z values for one strand pairing.
inline void get_z(double x1, double x2, double k1, double k2, double l,
                  double t, double *z) {
    const double lpt = l + t, lmt = l - t;
    double d = (x1 + x2) * lmt;
    if (d == 0.0) d = 1.0;
    const double a1s[3] = {lpt + 2.0 * k2, 2.0 + lpt + 4.0 * k2,
                           lpt + 4.0 * k2};
    const double a2s[3] = {2.0 - lpt + 2.0 * k1, 2.0 - lpt + 4.0 * k1,
                           2.0 - lpt + 4.0 * k1};
    for (int j = 0; j < 3; j++) {
        double sinm = (x1 * a1s[j] - x2 * a2s[j]) / d;
        if (sinm < -1.0) sinm = -1.0;
        if (sinm > 1.0) sinm = 1.0;
        z[j] = 0.5 * (lmt * sinm + 2.0 - lpt);
    }
}

// log clamped at the smallest normal double (np.finfo(f64).tiny), the
// same floor genotype_np._safe_log uses.
inline double lg(double x) { return log(x < DBL_MIN ? DBL_MIN : x); }

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

void call_range(const GtModel *m, int64_t lo, int64_t hi,
                const int32_t *counts, const int32_t *quals,
                const int32_t *ref, double *gt_prob, int32_t *max_gt,
                double *margin, double *off_sum, int cstyle) {
    const int qmax = m->nq - 1;
    for (int64_t i = lo; i < hi; i++) {
        const int32_t *cnt = counts + i * 8;
        const int32_t *qv = quals + i * 8;
        double ll[10];
        memcpy(ll, m->prior[clampi(ref[i], 0, 4)], sizeof(ll));
        for (int b = 0; b < 4; b++) {
            if (cnt[b] <= 0) continue;
            const double nb = (double)cnt[b];
            const int q = clampi(qv[b], 0, qmax);
            const double c0 = m->ln_k[q], c1 = m->ln_kh[q],
                         c2 = m->ln_k1[q];
            for (int g = 0; g < 10; g++) {
                const int s = SEL[b][g];
                ll[g] += nb * (s == 2 ? c2 : s == 1 ? c1 : c0);
            }
        }
        const double n4 = (double)cnt[4], n5 = (double)cnt[5],
                     n6 = (double)cnt[6], n7 = (double)cnt[7];
        const double k4 = m->k[clampi(qv[4], 0, qmax)],
                     k5 = m->k[clampi(qv[5], 0, qmax)],
                     k6 = m->k[clampi(qv[6], 0, qmax)],
                     k7 = m->k[clampi(qv[7], 0, qmax)];
        double z05[3], z35[3];  // Z0,Z1,Z2 and Z3,Z4,Z5
        get_z(n5, n7, k5, k7, m->l, m->t, z05);
        get_z(n6, n4, k6, k4, m->l, m->t, z35);
        const double Z0 = z05[0], Z1 = z05[1], Z2 = z05[2];
        const double Z3 = z35[0], Z4 = z35[1], Z5 = z35[2];
        if (n4 > 0) {  // genotype_np.py n[:,4] column table
            const int q = clampi(qv[4], 0, qmax);
            const double lnk = m->ln_k[q], lnkh = m->ln_kh[q],
                         lnk1 = m->ln_k1[q];
            const double t58 = lg(0.5 * (1.0 - Z5) + k4);
            const double col[10] = {
                lnk1, lnkh, lg(1.0 - 0.5 * Z4 + k4), lnkh, lnk,
                t58,  lnk,  lg(1.0 - Z3 + k4),       t58,  lnk};
            for (int g = 0; g < 10; g++) ll[g] += n4 * col[g];
        }
        if (n5 > 0) {
            const int q = clampi(qv[5], 0, qmax);
            const double lnk = m->ln_k[q];
            const double t15 = lg(0.5 * Z2 + k5);
            const double col[10] = {
                lnk, t15, lnk, lnk, lg(Z0 + k5),
                t15, lg(0.5 * Z1 + k5), lnk, lnk, lnk};
            for (int g = 0; g < 10; g++) ll[g] += n5 * col[g];
        }
        if (n6 > 0) {
            const int q = clampi(qv[6], 0, qmax);
            const double lnk = m->ln_k[q];
            const double t58b = lg(0.5 * Z5 + k6);
            const double col[10] = {
                lnk, lnk, lg(0.5 * Z4 + k6), lnk, lnk,
                t58b, lnk, lg(Z3 + k6), t58b, lnk};
            for (int g = 0; g < 10; g++) ll[g] += n6 * col[g];
        }
        if (n7 > 0) {
            const int q = clampi(qv[7], 0, qmax);
            const double lnk = m->ln_k[q], lnkh = m->ln_kh[q],
                         lnk1 = m->ln_k1[q];
            const double t15b = lg(0.5 * (1.0 - Z2) + k7);
            const double col[10] = {
                lnk, t15b, lnk, lnkh, lg(1.0 - Z0 + k7),
                t15b, lg(1.0 - 0.5 * Z1 + k7), lnk, lnkh, lnk1};
            for (int g = 0; g < 10; g++) ll[g] += n7 * col[g];
        }
        // first-occurrence argmax (np.argmax semantics), runner-up
        // margin, softmax off-sum — genotype_np.py:93-101
        int mx = 0;
        double mval = ll[0];
        for (int g = 1; g < 10; g++)
            if (ll[g] > mval) { mval = ll[g]; mx = g; }
        double second = -HUGE_VAL;
        for (int g = 0; g < 10; g++)
            if (g != mx && ll[g] > second) second = ll[g];
        // off = sum over losers of exp(ll[g]-mval), accumulated in g
        // order exactly as the scalar reference does. Two bit-exact
        // skips: (a) glibc exp returns +0.0 for d <= -746 (below the
        // subnormal floor), so those calls are free to drop; (b) any
        // term smaller than exp(d2)*2^-58 — d2 the runner-up's delta,
        // the largest term — is absorbed: at most 8 such terms sum to
        // < exp(d2)*2^-55, strictly below half an ulp of the
        // accumulator once the d2 term has been added (and each later
        // tiny addition is individually absorbed), so the final f64
        // off is bit-identical with them skipped. Deep losers are the
        // common case at real coverage (GL rows like -0.0002/-3.3 with
        // seven clamped losers), so this drops most of the exp() cost.
        const double cut = (second - mval) - 58.0;
        double off = 0.0;
        double *gp = gt_prob + i * 10;
        for (int g = 0; g < 10; g++) {
            if (g != mx) {
                const double d = ll[g] - mval;
                if (d > -746.0 && d >= cut) off += exp(d);
            }
        }
        const double lo1p = log1p(off);
        for (int g = 0; g < 10; g++)
            gp[g] = (ll[g] - mval - lo1p) / LOG10;
        if (cstyle)
            // engine._finish_exact's C-style max-entry replacement with
            // the reference's 1+off absorption (genotype_model.c:
            // 240-244), hoisted into the parallel range so the caller
            // skips a serial log() per position
            gp[mx] = -log(1.0 + off) / LOG10;
        max_gt[i] = mx;
        margin[i] = mval - second;
        off_sum[i] = off;
    }
}

}  // namespace

extern "C" {

void *bsc_model_new(int64_t nq, const double *k, const double *ln_k,
                    const double *ln_kh, const double *ln_k1,
                    const double *prior, double under_conv,
                    double over_conv) {
    GtModel *m = new GtModel();
    m->nq = (int)nq;
    m->k.assign(k, k + nq);
    m->ln_k.assign(ln_k, ln_k + nq);
    m->ln_kh.assign(ln_kh, ln_kh + nq);
    m->ln_k1.assign(ln_k1, ln_k1 + nq);
    memcpy(m->prior, prior, sizeof(m->prior));
    m->l = 1.0 - under_conv;
    m->t = over_conv;
    return m;
}

void bsc_model_free(void *h) { delete (GtModel *)h; }

void bsc_model_call2(void *h, int64_t n, const int32_t *counts,
                     const int32_t *quals, const int32_t *ref,
                     int32_t n_threads, int32_t cstyle, double *gt_prob,
                     int32_t *max_gt, double *margin, double *off_sum) {
    const GtModel *m = (const GtModel *)h;
    int nt = n_threads < 1 ? 1 : n_threads;
    if ((int64_t)nt * 4096 > n) nt = (int)(n / 4096) + 1;
    if (nt <= 1) {
        call_range(m, 0, n, counts, quals, ref, gt_prob, max_gt, margin,
                   off_sum, cstyle);
        return;
    }
    const int64_t step = (n + nt - 1) / nt;
    bsc::pool_run(nt, [&](int w) {
        const int64_t lo = w * step;
        const int64_t hi = lo + step < n ? lo + step : n;
        if (lo < hi)
            call_range(m, lo, hi, counts, quals, ref, gt_prob, max_gt,
                       margin, off_sum, cstyle);
    });
}

void bsc_model_call(void *h, int64_t n, const int32_t *counts,
                    const int32_t *quals, const int32_t *ref,
                    int32_t n_threads, double *gt_prob, int32_t *max_gt,
                    double *margin, double *off_sum) {
    bsc_model_call2(h, n, counts, quals, ref, n_threads, 0, gt_prob,
                    max_gt, margin, off_sum);
}

}  // extern "C"
