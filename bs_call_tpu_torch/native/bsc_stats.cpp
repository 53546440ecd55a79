// bsc_stats: batched statistics kernels for the emit path.
//
// Fisher 2x2 exact test (two-sided, both-diagonal walk) matching the
// reference algorithm (stats_utils.c:25-91) bit-for-bit: the log-factorial
// memo table is built with the same serial accumulation of log(i), and all
// transcendentals are glibc libm, the same functions the C binary links.
// The Python scalar twin is bs_call_tpu/ops/oracle.py::fisher; randomized
// parity between the two is enforced by tests/test_native.py.

#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kLfactSize = 256;  // bs_call.h:335 analogue
double g_lfact[kLfactSize];
bool g_lfact_ready = false;

void lfact_init() {
    if (g_lfact_ready) return;
    double l = 0.0;
    g_lfact[0] = 0.0;
    if (kLfactSize > 1) g_lfact[1] = 0.0;
    for (int i = 2; i < kLfactSize; i++) {
        l += log((double)i);
        g_lfact[i] = l;
    }
    g_lfact_ready = true;
}

inline double lfact(long long x) {
    if (x < kLfactSize) return g_lfact[x];
    return lgamma((double)x + 1.0);
}

double fisher2x2(long long c0, long long c1, long long c2, long long c3) {
    long long row0 = c0 + c1, row1 = c2 + c3;
    long long col0 = c0 + c2, col1 = c1 + c3;
    long long n = row0 + row1;
    if (n == 0) return 1.0;
    double delta = (double)c0 - (double)(row0 * col0) / (double)n;
    double knst =
        lfact(col0) + lfact(col1) + lfact(row0) + lfact(row1) - lfact(n);
    double l =
        exp(knst - lfact(c0) - lfact(c1) - lfact(c2) - lfact(c3));
    double p = l;
    if (delta > 0.0) {
        long long mn = c1 < c2 ? c1 : c2;
        for (long long i = 0; i < mn; i++) {
            l *= (double)((c1 - i) * (c2 - i)) /
                 (double)((c0 + i + 1) * (c3 + i + 1));
            p += l;
        }
        mn = c0 < c3 ? c0 : c3;
        long long k = (long long)ceil(2.0 * delta);
        if (k <= mn) {
            c0 -= k;
            c3 -= k;
            c1 += k;
            c2 += k;
            l = exp(knst - lfact(c0) - lfact(c1) - lfact(c2) - lfact(c3));
            p += l;
            for (long long i = 0; i < mn - k; i++) {
                l *= (double)((c0 - i) * (c3 - i)) /
                     (double)((c1 + i + 1) * (c2 + i + 1));
                p += l;
            }
        }
    } else {
        long long mn = c0 < c3 ? c0 : c3;
        for (long long i = 0; i < mn; i++) {
            l *= (double)((c0 - i) * (c3 - i)) /
                 (double)((c1 + i + 1) * (c2 + i + 1));
            p += l;
        }
        mn = c1 < c2 ? c1 : c2;
        long long k = (long long)ceil(-2.0 * delta);
        if (!k) k = 1;
        if (k <= mn) {
            c0 += k;
            c3 += k;
            c1 -= k;
            c2 -= k;
            l = exp(knst - lfact(c0) - lfact(c1) - lfact(c2) - lfact(c3));
            p += l;
            for (long long i = 0; i < mn - k; i++) {
                l *= (double)((c1 - i) * (c2 - i)) /
                     (double)((c0 + i + 1) * (c3 + i + 1));
                p += l;
            }
        }
    }
    return p;
}

// ---- emit-side stats accumulator -----------------------------------
//
// One sequential pass per emitted-row batch updating every per-site
// report counter — the native twin of the reference's inline printer-
// thread accumulation (print_vcf.c:382-526) and of the Python scalar
// path (output/site.py). Transcendentals are glibc libm and the meth
// posterior normalization replicates site.py's accumulation order, so
// harvested reports match the Python paths at print precision.

struct CovEntry {
    int64_t all = 0, var = 0;
    int64_t cpg[2] = {0, 0}, cpg_inf[2] = {0, 0};
    int64_t gc[101] = {0};
};

struct CtgCounters {
    // snps, multi, dbsnp_sites, dbsnp_var, cpg_ref, cpg_nonref
    int64_t pairs[6][2] = {};
};

struct StatsAcc {
    uint8_t het[10] = {};
    uint8_t isvar[50] = {}, ismulti[50] = {};
    int32_t mut_tab[50] = {};
    uint8_t plus[10] = {}, minus[10] = {};
    double logp[100] = {};

    std::unordered_map<int64_t, CovEntry> cov;
    std::unordered_map<int64_t, std::array<int64_t, 2>> fs, qd, mq;
    std::unordered_map<int32_t, CtgCounters> ctg;
    int64_t qual[4][256] = {};
    int64_t filter_counts[2][32] = {};
    double meth[2][2][101] = {};  // [nonref?][all/passed][grid]
    int64_t mut[12][2] = {}, dbsnp_mut[12][2] = {};
    // snps, multi, dbsnp_sites, dbsnp_var, cpg_ref, cpg_nonref
    int64_t pairs[6][2] = {};
};

}  // namespace

extern "C" {

void *bsc_stats_acc_new(const uint8_t *het10, const uint8_t *isvar50,
                        const uint8_t *ismulti50, const int32_t *mut50,
                        const uint8_t *plus10, const uint8_t *minus10,
                        const double *logp100) {
    lfact_init();
    StatsAcc *a = new StatsAcc();
    memcpy(a->het, het10, 10);
    memcpy(a->isvar, isvar50, 50);
    memcpy(a->ismulti, ismulti50, 50);
    memcpy(a->mut_tab, mut50, 50 * sizeof(int32_t));
    memcpy(a->plus, plus10, 10);
    memcpy(a->minus, minus10, 10);
    memcpy(a->logp, logp100, 100 * sizeof(double));
    return a;
}

void bsc_stats_acc_free(void *h) { delete (StatsAcc *)h; }

// Coverage hash + GC% for every reached (covered, deduped) row of one
// chunk: counts8_all is the full sz*8 aggregate, reach the row mask —
// the depth sum happens here so Python ships no derived arrays.
// gc_bins may be null (no GC tracking for this contig).
void bsc_stats_acc_cov(void *h, int64_t sz, const int32_t *counts8_all,
                       const uint8_t *reach, const int64_t *pos,
                       const uint8_t *gc_bins, int64_t gc_len,
                       int64_t gc_start) {
    StatsAcc *a = (StatsAcc *)h;
    for (int64_t i = 0; i < sz; i++) {
        if (!reach[i]) continue;
        const int32_t *c = counts8_all + i * 8;
        int64_t dp = (int64_t)c[0] + c[1] + c[2] + c[3] + c[4] + c[5] +
                     c[6] + c[7];
        CovEntry &e = a->cov[dp];
        e.all++;
        if (gc_bins && gc_len > 0) {
            int64_t off = pos[i] - gc_start;
            int64_t bn = off / 100;
            // match the Python floor-divide for positions before
            // gc_start (C++ / truncates toward zero)
            if (off < 0 && off % 100 != 0) bn -= 1;
            if (bn >= 0 && bn < gc_len) {
                uint8_t gc = gc_bins[bn];
                if (gc <= 100) e.gc[gc]++;
            }
        }
    }
}

// Emitted-row accumulation for one chunk (sequential, carrying the
// CpG '+'-row state across calls via io_prev_*). counts8 is n*8
// int32; rf3 is n*3 (rf7 columns 1..3).
void bsc_stats_acc_rows(void *h, int64_t n, int32_t ctg_id,
                        const int64_t *pos, const int32_t *g,
                        const int32_t *r, const int32_t *phred,
                        const int32_t *qd, const int64_t *fs,
                        const int32_t *mq, const int32_t *flt_full,
                        const int32_t *counts8, const uint8_t *cond_cg,
                        const uint8_t *rsp, const int32_t *rf3,
                        int64_t *io_prev_x, uint8_t *io_prev_flt) {
    StatsAcc *a = (StatsAcc *)h;
    CtgCounters &cc = a->ctg[ctg_id];
    int64_t prev_x = *io_prev_x;
    bool prev_flt = *io_prev_flt != 0;
    for (int64_t i = 0; i < n; i++) {
        int gi = g[i], ri = r[i];
        bool het = a->het[gi] != 0;
        int flt = flt_full[i];
        bool passed = flt == 0;
        bool isvar = a->isvar[gi * 5 + ri] != 0;
        bool ismulti = a->ismulti[gi * 5 + ri] != 0 && isvar;
        bool issnp = isvar && !ismulti;
        const int32_t *cnt = counts8 + i * 8;
        int64_t dp1 = cnt[0] + cnt[1] + cnt[2] + cnt[3];
        int64_t d_inf = cnt[4] + cnt[5] + cnt[6] + cnt[7];
        int64_t dp = dp1 + d_inf;
        if (issnp) {
            a->pairs[0][0]++;
            cc.pairs[0][0]++;
            if (passed) {
                a->pairs[0][1]++;
                cc.pairs[0][1]++;
            }
        }
        if (ismulti) {
            a->pairs[1][0]++;
            cc.pairs[1][0]++;
            if (passed) {
                a->pairs[1][1]++;
                cc.pairs[1][1]++;
            }
        }
        int ph = phred[i] & 255;
        if (isvar) {
            a->qual[1][ph]++;
            a->cov[dp].var++;
        }
        a->qd[qd[i]][het ? 1 : 0]++;
        a->fs[fs[i]][het ? 1 : 0]++;
        a->mq[mq[i]][het ? 1 : 0]++;
        a->filter_counts[het ? 1 : 0][flt & 31]++;
        a->qual[0][ph]++;
        if (rsp[i]) {
            a->pairs[2][0]++;
            cc.pairs[2][0]++;
            if (passed) {
                a->pairs[2][1]++;
                cc.pairs[2][1]++;
            }
            if (isvar) {
                a->pairs[3][0]++;
                cc.pairs[3][0]++;
                if (passed) {
                    a->pairs[3][1]++;
                    cc.pairs[3][1]++;
                }
            }
        }
        // CpG pair + methylation posterior (print_vcf.c:466-514)
        bool is_plus = cond_cg[i] && a->plus[gi];
        bool is_minus = cond_cg[i] && a->minus[gi];
        if (is_plus || is_minus) {
            const int32_t *rf = rf3 + i * 3;  // rf7 columns 1,2,3
            bool ref_cpg = is_plus ? (rf[1] == 2 && rf[2] == 3)
                                   : (rf[0] == 2 && rf[1] == 3);
            if (is_minus && pos[i] - prev_x == 1) {
                int k = ref_cpg ? 4 : 5;
                bool pair_ok = !(prev_flt || flt != 0);
                a->pairs[k][0]++;
                cc.pairs[k][0]++;
                if (pair_ok) {
                    a->pairs[k][1]++;
                    cc.pairs[k][1]++;
                }
            }
            if (is_plus) {
                prev_x = pos[i];
                prev_flt = flt != 0;
            }
            a->qual[ref_cpg ? 2 : 3][ph]++;
            a->cov[dp].cpg[ref_cpg ? 0 : 1]++;
            a->cov[d_inf].cpg_inf[ref_cpg ? 0 : 1]++;
            int64_t av = is_plus ? cnt[5] : cnt[6];
            int64_t bv = is_plus ? cnt[7] : cnt[4];
            if (av + bv > 0) {
                double konst =
                    lfact(av + bv + 1) - lfact(av) - lfact(bv);
                double meth[101];
                double s = 0.0;  // site.py's assignment-order quirk
                meth[0] = av ? 0.0 : exp(konst);
                if (!av) s = meth[0];
                meth[100] = bv ? 0.0 : exp(konst);
                if (!bv) s = meth[100];
                double da = (double)av, db = (double)bv;
                for (int j = 1; j < 100; j++) {
                    meth[j] = exp(konst + a->logp[j - 1] * da +
                                  a->logp[99 - j] * db);
                    s += meth[j];
                }
                double(*dst)[101] = a->meth[ref_cpg ? 0 : 1];
                for (int j = 0; j <= 100; j++) {
                    double z = meth[j] / s;
                    dst[0][j] += z;
                    if (passed) dst[1][j] += z;
                }
            }
        }
        int mt = a->mut_tab[gi * 5 + ri];
        if (mt != 12) {
            a->mut[mt][0]++;
            if (passed) a->mut[mt][1]++;
            if (rsp[i]) {
                a->dbsnp_mut[mt][0]++;
                if (passed) a->dbsnp_mut[mt][1]++;
            }
        }
    }
    *io_prev_x = prev_x;
    *io_prev_flt = prev_flt ? 1 : 0;
}

int64_t bsc_stats_acc_cov_size(void *h) {
    return (int64_t)((StatsAcc *)h)->cov.size();
}

void bsc_stats_acc_cov_dump(void *h, int64_t *keys, int64_t *allv,
                            int64_t *var, int64_t *cpg, int64_t *cpg_inf,
                            int64_t *gc) {
    StatsAcc *a = (StatsAcc *)h;
    int64_t i = 0;
    for (auto &kv : a->cov) {
        keys[i] = kv.first;
        allv[i] = kv.second.all;
        var[i] = kv.second.var;
        cpg[i * 2] = kv.second.cpg[0];
        cpg[i * 2 + 1] = kv.second.cpg[1];
        cpg_inf[i * 2] = kv.second.cpg_inf[0];
        cpg_inf[i * 2 + 1] = kv.second.cpg_inf[1];
        memcpy(gc + i * 101, kv.second.gc, 101 * sizeof(int64_t));
        i++;
    }
}

int64_t bsc_stats_acc_map_size(void *h, int32_t which) {
    StatsAcc *a = (StatsAcc *)h;
    auto &m = which == 0 ? a->fs : which == 1 ? a->qd : a->mq;
    return (int64_t)m.size();
}

void bsc_stats_acc_map_dump(void *h, int32_t which, int64_t *keys,
                            int64_t *vals) {
    StatsAcc *a = (StatsAcc *)h;
    auto &m = which == 0 ? a->fs : which == 1 ? a->qd : a->mq;
    int64_t i = 0;
    for (auto &kv : m) {
        keys[i] = kv.first;
        vals[i * 2] = kv.second[0];
        vals[i * 2 + 1] = kv.second[1];
        i++;
    }
}

void bsc_stats_acc_fixed(void *h, int64_t *qual, int64_t *filter_counts,
                         double *meth, int64_t *mut, int64_t *dbsnp_mut,
                         int64_t *pairs) {
    StatsAcc *a = (StatsAcc *)h;
    memcpy(qual, a->qual, sizeof(a->qual));
    memcpy(filter_counts, a->filter_counts, sizeof(a->filter_counts));
    memcpy(meth, a->meth, sizeof(a->meth));
    memcpy(mut, a->mut, sizeof(a->mut));
    memcpy(dbsnp_mut, a->dbsnp_mut, sizeof(a->dbsnp_mut));
    memcpy(pairs, a->pairs, sizeof(a->pairs));
}

int64_t bsc_stats_acc_nctg(void *h) {
    return (int64_t)((StatsAcc *)h)->ctg.size();
}

void bsc_stats_acc_ctg_dump(void *h, int64_t *ids, int64_t *pairs) {
    StatsAcc *a = (StatsAcc *)h;
    int64_t i = 0;
    for (auto &kv : a->ctg) {
        ids[i] = kv.first;
        memcpy(pairs + i * 12, kv.second.pairs, sizeof(kv.second.pairs));
        i++;
    }
}

// ftab: [n,4] int64 2x2 tables; out: [n] f64 phred-ready log10 p-values
// (log(p)/log(10), clamped below at log10(1e-20) like call_genotypes.c).
void bsc_fisher_batch(int64_t n, const int64_t *ftab, double *out) {
    lfact_init();
    const double kLog10 = 2.30258509299404568402;  // bs_call.h:36
    for (int64_t i = 0; i < n; i++) {
        double z = fisher2x2(ftab[i * 4], ftab[i * 4 + 1], ftab[i * 4 + 2],
                             ftab[i * 4 + 3]);
        if (z < 1.0e-20) z = 1.0e-20;
        out[i] = log(z) / kLog10;
    }
}

}  // extern "C"
