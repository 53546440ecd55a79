// bsc_emit: per-row emit-field preparation for the vector emitter.
//
// Computes, natively and with the libm calls the C binary links, every
// per-emitted-row numeric field the VCF formatter consumes: GQ phred
// (print_vcf.c:140-148, no boundary-rescue pass needed since this IS
// scalar libm), QD, FS int, the q20/qd2/fs60/mq40 filter bits
// (print_vcf.c:186-217), the mac1 minor-allele-count rule, the GL value
// compaction to the ref+alt subset (print_vcf.c:318-347, -99.999 clamp,
// float32 for %g formatting), the CG-status automaton codes
// (print_vcf.c:227-266) and the het flag. Lookup tables are passed in
// from Python (output/vector_site.py) so both paths share one source of
// truth; randomized vector-vs-scalar emitter parity tests pin the
// behavior.

#include <cmath>
#include <cstdint>

namespace {

constexpr double kLog10 = 2.30258509299404568402;  // bs_call.h:36

// mac1 category splits per het genotype (print_vcf.c:192-212; the same
// table as output/vector_site.py emit_block)
struct MacSets {
    int g;
    int na;
    int a[3];
    int nb;
    int b[3];
};
constexpr MacSets kMac[6] = {
    {1, 3, {1, 5, 7}, 2, {0, 4, 0}},
    {2, 2, {2, 6, 0}, 1, {0, 0, 0}},
    {3, 2, {3, 7, 0}, 2, {0, 4, 0}},
    {5, 3, {2, 6, 4}, 3, {1, 5, 7}},
    {6, 1, {3, 0, 0}, 2, {1, 5, 0}},
    {8, 2, {3, 7, 0}, 3, {2, 6, 4}},
};

}  // namespace

extern "C" {

void bsc_emit_prep(
    int64_t n, const int32_t *counts, const double *gt_prob,
    const int32_t *g, const int32_t *r, const int32_t *mq,
    const double *fs, const int32_t *g1, const int32_t *g2,
    const int32_t *g3, const int32_t *gl_idx_tab,
    const int32_t *gl_len_tab, const uint8_t *het_tab,
    const uint8_t *cflag_tab, const uint8_t *gflag_tab,
    int64_t *phred, int64_t *dp1, int64_t *qd, int64_t *fs_int,
    int64_t *flt, uint8_t *mac1, float *gl_vals, int32_t *gl_len,
    int64_t *cg_code, uint8_t *cond_cg, uint8_t *het) {
    for (int64_t i = 0; i < n; i++) {
        int gi = g[i];
        int ri = r[i];
        const double *gp = gt_prob + i * 10;
        // GQ phred from the winning posterior
        double z1 = exp(gp[gi] * kLog10);
        long long ph;
        if (z1 >= 1.0) ph = 255;
        else {
            ph = (long long)(-10.0 * log(1.0 - z1) / kLog10);
            if (ph > 255) ph = 255;
        }
        phred[i] = ph;
        const int32_t *c = counts + i * 8;
        long long d = (long long)c[0] + c[1] + c[2] + c[3];
        dp1[i] = d;
        // FS int: trunc(-fs*10 + 0.5)
        fs_int[i] = (int64_t)(-fs[i] * 10.0 + 0.5);
        qd[i] = d > 0 ? ph / d : ph;
        long long f = 0;
        if (ph < 20) f |= 1;
        if (qd[i] < 2) f |= 2;
        if (fs_int[i] > 60) f |= 4;
        if (mq[i] < 40) f |= 8;
        flt[i] = f;
        // mac1 (only when all hard filters pass)
        uint8_t m1 = 0;
        if (f == 0) {
            for (const MacSets &ms : kMac) {
                if (ms.g != gi) continue;
                long long sa = 0, sb = 0;
                for (int k = 0; k < ms.na; k++) sa += c[ms.a[k]];
                for (int k = 0; k < ms.nb; k++) sb += c[ms.b[k]];
                m1 = (sa <= 1 || sb <= 1) ? 1 : 0;
                break;
            }
        }
        mac1[i] = m1;
        // GL compaction
        const int32_t *gidx = gl_idx_tab + (gi * 5 + ri) * 5;
        gl_len[i] = gl_len_tab[gi * 5 + ri];
        float *gv = gl_vals + i * 5;
        for (int k = 0; k < 5; k++) {
            int32_t idx = gidx[k];
            double v;
            if (idx == -2) v = -99.999;
            else {
                int safe = idx >= 0 ? idx : 0;
                v = gp[safe];
                if (v < -99.999) v = -99.999;
            }
            gv[k] = (float)v;
        }
        // CG-status automaton (codes as ASCII; 'G' marks the 2-char
        // "CG"; cond_cg is also returned for the stats path)
        int32_t a1 = g1[i], a2 = g2[i], a3 = g3[i];
        int g1c = a1 > 0 ? a1 - 1 : 0;
        int g3c = a3 > 0 ? a3 - 1 : 0;
        uint8_t ccg =
            ((a2 == 5 && a3 == 8) || (a2 == 8 && a1 == 5)) ? 1 : 0;
        cond_cg[i] = ccg;
        long long code;
        if (ccg) code = 'G';
        else if (a2 == 5)
            code = a3 > 0 ? (gflag_tab[g3c] ? 'H' : 'N') : '?';
        else if (a2 == 8)
            code = a1 > 0 ? (cflag_tab[g1c] ? 'H' : 'N') : '?';
        else if (cflag_tab[gi])
            code = a3 > 0 ? (gflag_tab[g3c] ? 'H' : 'N') : '?';
        else if (gflag_tab[gi])
            code = a1 > 0 ? (cflag_tab[g1c] ? 'H' : 'N') : '.';
        else code = '.';
        cg_code[i] = code;
        het[i] = het_tab[gi];
    }
}

}  // extern "C"
