// bsc_rowengine: the whole-block host fast path.
//
// Chains the native stages — pileup/aggregate (bsc_pipeline), the f64
// genotype model (bsc_model), Fisher strand (bsc_stats), emit-field
// prep (bsc_emit), report accumulation (bsc_stats StatsAcc) and row
// formatting (bsc_format) — into three calls per staged block
// (load / model / emit), eliminating the per-block Python glue and the
// pileup-tensor export the previous pipeline paid between those same
// native pieces. Behavior is a transcription of the Python
// orchestration it replaces (pipeline/engine.py call_block_soa +
// output/vector_site.py emit_block, themselves built against
// call_genotypes.c:43-115 and print_vcf.c:32-594): the Python path
// stays as the behavioral reference and randomized byte-parity tests
// pin the two against each other.
//
// Exactness: the model winner entry is rewritten C-style
// (gp[mx] = -log(1+off)/log(10), genotype_model.c:240-244 absorption)
// with scalar glibc libm — the libm the C binary links. Likelihood
// ties (margin < 1e-9) are NOT resolved here: bsre_model reports them
// and the caller fixes the rows through the Python scalar oracle
// before bsre_emit, so the oracle stays the only tie authority.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "bsc_common.h"

extern "C" {
// siblings in this shared object
void bsp_block_pileup(void *h, int32_t *counts2, float *qual_sum,
                      float *mapq2, int32_t nthreads);
void bsp_block_aggregate(void *h, const int32_t *counts2,
                         const float *qual_sum, const float *mapq2,
                         int32_t *counts8, int32_t *quals8, int32_t *mq,
                         int32_t *aq, int32_t *ntot, int32_t nthreads);
void bsc_model_call2(void *h, int64_t n, const int32_t *counts,
                     const int32_t *quals, const int32_t *ref,
                     int32_t n_threads, int32_t cstyle, double *gt_prob,
                     int32_t *max_gt, double *margin, double *off_sum);
void bsc_model_call(void *h, int64_t n, const int32_t *counts,
                    const int32_t *quals, const int32_t *ref,
                    int32_t n_threads, double *gt_prob, int32_t *max_gt,
                    double *margin, double *off_sum);
void bsc_emit_prep(
    int64_t n, const int32_t *counts, const double *gt_prob,
    const int32_t *g, const int32_t *r, const int32_t *mq,
    const double *fs, const int32_t *g1, const int32_t *g2,
    const int32_t *g3, const int32_t *gl_idx_tab,
    const int32_t *gl_len_tab, const uint8_t *het_tab,
    const uint8_t *cflag_tab, const uint8_t *gflag_tab,
    int64_t *phred, int64_t *dp1, int64_t *qd, int64_t *fs_int,
    int64_t *flt, uint8_t *mac1, float *gl_vals, int32_t *gl_len,
    int64_t *cg_code, uint8_t *cond_cg, uint8_t *het);
void bsc_fisher_batch(int64_t n, const int64_t *ftab, double *out);
void bsc_stats_acc_cov(void *h, int64_t sz, const int32_t *counts8_all,
                       const uint8_t *reach, const int64_t *pos,
                       const uint8_t *gc_bins, int64_t gc_len,
                       int64_t gc_start);
void bsc_stats_acc_rows(void *h, int64_t n, int32_t ctg_id,
                        const int64_t *pos, const int32_t *g,
                        const int32_t *r, const int32_t *phred,
                        const int32_t *qd, const int64_t *fs,
                        const int32_t *mq, const int32_t *flt_full,
                        const int32_t *counts8, const uint8_t *cond_cg,
                        const uint8_t *rsp, const int32_t *rf3,
                        int64_t *io_prev_x, uint8_t *io_prev_flt);
int64_t bsc_format_rows(
    int64_t n, const char *ctg_name,
    const int64_t *pos, const int32_t *g, const int32_t *r,
    const int64_t *flt, const uint8_t *mac1, const int64_t *phred,
    const int64_t *dp1, const int32_t *mq, const int64_t *qd,
    const int64_t *fs_int, const uint8_t *het,
    const float *gl_vals, const int32_t *gl_len,
    const int32_t *counts, const int32_t *quals,
    const uint8_t *is_cg, const int64_t *cg_code,
    const char *prf, const char *ctx,
    const int64_t *rs_off, const char *rs_blob,
    const char *gt_lut, int gt_stride,
    const char *alt_lut, int alt_stride,
    const char *cs_lut, int cs_stride,
    const char *ft_lut, int ft_stride, const int32_t *ft_len,
    const char *pbase,
    char *out, int64_t out_cap, int32_t n_threads);
}

namespace {

constexpr double kLog10 = 2.30258509299404568402;  // bs_call.h:36

// one staged block's state between the load/model/emit phases
struct Slot {
    int64_t x = 0, y = 0, sz = 0;
    std::vector<int32_t> counts2;            // [sz,2,8]
    std::vector<float> qual_sum;             // [sz,8]
    std::vector<float> mapq2;                // [sz]
    std::vector<int32_t> counts8, quals8;    // [sz,8]
    std::vector<int32_t> mqv, aqv, ntot;     // [sz]
    std::vector<uint8_t> refw;               // [sz+2] codes 0..4
    std::vector<int64_t> cov;                // covered row indices
    std::vector<double> gt_prob;             // [sz,10], zero uncovered
    std::vector<int32_t> max_gt;             // [sz], zero uncovered
    std::vector<double> fs;                  // [sz]
    std::vector<int64_t> ties;               // absolute row indices
    // gathered covered-row model inputs/outputs
    std::vector<int32_t> cc, cq, cr;
    std::vector<double> cgp, cmargin, coff;
    std::vector<int32_t> cmg;
    bool fisher_done = false;
    // emit scratch (reused across blocks)
    std::vector<uint8_t> rf7;                // [sz,7]
    std::vector<int32_t> gt1;                // [sz]
    std::vector<int64_t> eidx;               // emitted row indices
    std::vector<uint8_t> reach;              // [sz]
    std::vector<int64_t> pos_all;            // [sz]
    // per-emitted-row arrays
    std::vector<int32_t> eg, er, emq, eg1, eg2, eg3, egll, ecnt, eql;
    std::vector<int64_t> eph, edp1, eqd, efsi, eflt, ecg, epos, ers_off;
    std::vector<uint8_t> emac, eccg, ehet;
    std::vector<float> eglv;
    std::vector<double> egp, efs;
    std::vector<char> eprf, ectx;
    std::vector<int32_t> eph32, eqd32, efltf, erf3;
    std::vector<uint8_t> ersp;
};

struct RowEngine {
    void *model = nullptr;
    void *stats_acc = nullptr;  // may stay null (no report)
    int n_threads = 1;
    int all_positions = 0;
    int quirk = 1;  // reproduce call_genotypes.c:98 (GT table quirk)
    // LUTs, copied from the Python source of truth at creation
    int32_t gl_idx[250];
    int32_t gl_len[50];
    uint8_t het[10], cflag[10], gflag[10];
    uint8_t gt_flag[50];                  // hom-ref skip [10,5]
    uint8_t fmask_a[80], fmask_b[80];     // fisher cats [10,8]
    uint8_t het_mask[10];                 // GT_HET (fisher gate)
    char gt_lut[400], alt_lut[400], cs_lut[40], ft_lut[384];
    int32_t ft_len[16];
    char pbase[6];    // ref code -> char
    char iupac[16];   // gt1 code (0..10) -> context char
    std::vector<Slot> slots;
};

// strncpy-style truncation: zero everything after the first zero
inline void trunc_copy(const uint8_t *src, uint8_t *dst, int w) {
    bool keep = true;
    for (int j = 0; j < w; j++) {
        uint8_t v = keep ? src[j] : 0;
        if (v == 0) keep = false;
        dst[j] = v;
    }
}

}  // namespace

extern "C" {

void *bsre_new(void *model, void *stats_acc, int n_threads,
               int all_positions, int quirk,
               const int32_t *gl_idx, const int32_t *gl_len,
               const uint8_t *het, const uint8_t *cflag,
               const uint8_t *gflag, const uint8_t *gt_flag,
               const uint8_t *fmask_a, const uint8_t *fmask_b,
               const uint8_t *het_mask,
               const char *gt_lut, const char *alt_lut,
               const char *cs_lut, const char *ft_lut,
               const int32_t *ft_len, const char *pbase,
               const char *iupac, int n_slots) {
    RowEngine *e = new RowEngine();
    e->model = model;
    e->stats_acc = stats_acc;
    e->n_threads = n_threads < 1 ? 1 : n_threads;
    e->all_positions = all_positions;
    e->quirk = quirk;
    memcpy(e->gl_idx, gl_idx, sizeof(e->gl_idx));
    memcpy(e->gl_len, gl_len, sizeof(e->gl_len));
    memcpy(e->het, het, 10);
    memcpy(e->cflag, cflag, 10);
    memcpy(e->gflag, gflag, 10);
    memcpy(e->gt_flag, gt_flag, 50);
    memcpy(e->fmask_a, fmask_a, 80);
    memcpy(e->fmask_b, fmask_b, 80);
    memcpy(e->het_mask, het_mask, 10);
    memcpy(e->gt_lut, gt_lut, sizeof(e->gt_lut));
    memcpy(e->alt_lut, alt_lut, sizeof(e->alt_lut));
    memcpy(e->cs_lut, cs_lut, sizeof(e->cs_lut));
    memcpy(e->ft_lut, ft_lut, sizeof(e->ft_lut));
    memcpy(e->ft_len, ft_len, sizeof(e->ft_len));
    memcpy(e->pbase, pbase, 5);
    e->pbase[5] = 0;
    memcpy(e->iupac, iupac, 11);
    e->slots.resize(n_slots < 1 ? 1 : n_slots);
    return e;
}

void bsre_free(void *h) { delete (RowEngine *)h; }

void bsre_set_stats(void *h, void *stats_acc) {
    ((RowEngine *)h)->stats_acc = stats_acc;
}

// Phase 1: pileup + aggregate the pipeline's staged block into the
// slot, and copy the reference window (sz+2 codes starting at x).
// Must run before the pipeline advances past the staged block.
void bsre_load(void *h, int32_t slot, void *pipe, int64_t x, int64_t y,
               const uint8_t *refw, int64_t rw_len) {
    RowEngine *e = (RowEngine *)h;
    Slot &s = e->slots[slot];
    s.x = x;
    s.y = y;
    s.sz = y - x + 1;
    const int64_t sz = s.sz;
    s.counts2.resize(sz * 16);
    s.qual_sum.resize(sz * 8);
    s.mapq2.resize(sz);
    s.counts8.resize(sz * 8);
    s.quals8.resize(sz * 8);
    s.mqv.resize(sz);
    s.aqv.resize(sz);
    s.ntot.resize(sz);
    s.refw.assign(refw, refw + rw_len);
    if (rw_len < sz + 2) s.refw.resize(sz + 2, 0);
    { BSC_PROF_SCOPE("row.pileup");
    bsp_block_pileup(pipe, s.counts2.data(), s.qual_sum.data(),
                     s.mapq2.data(), e->n_threads); }
    { BSC_PROF_SCOPE("row.aggregate");
    bsp_block_aggregate(pipe, s.counts2.data(), s.qual_sum.data(),
                        s.mapq2.data(), s.counts8.data(),
                        s.quals8.data(), s.mqv.data(), s.aqv.data(),
                        s.ntot.data(), e->n_threads); }
    s.cov.clear();
    for (int64_t i = 0; i < sz; i++)
        if (s.ntot[i] > 0) s.cov.push_back(i);
    s.fisher_done = false;
    s.ties.clear();
}

// Phase 2: f64 model over covered rows; C-style winner rewrite with
// scalar glibc libm; tie detection (margin < 1e-9, the engine's
// _finish_exact threshold). Returns the number of ties the caller must
// fix through the scalar oracle before bsre_emit.
int64_t bsre_model(void *h, int32_t slot) {
    RowEngine *e = (RowEngine *)h;
    Slot &s = e->slots[slot];
    const int64_t nc = (int64_t)s.cov.size();
    const int64_t sz = s.sz;
    s.ties.clear();
    if (nc == 0) {
        s.gt_prob.assign(sz * 10, 0.0);
        s.max_gt.assign(sz, 0);
        return 0;
    }
    const bool dense = nc == sz;  // every position covered: no gather
    s.cmargin.resize(nc);
    s.coff.resize(nc);
    if (dense) {
        // model inputs/outputs are the slot arrays themselves — the
        // gather/scatter below would memcpy ~200B per position for an
        // identity mapping (dense WGBS blocks are the common case)
        s.gt_prob.resize(sz * 10);
        s.max_gt.resize(sz);
        s.cr.resize(sz);
        for (int64_t i = 0; i < sz; i++) s.cr[i] = s.refw[i];
        { BSC_PROF_SCOPE("row.model_call");
        // cstyle=1: the C-style max-entry replacement (reference 1+off
        // absorption, genotype_model.c:240-244) runs inside the
        // parallel ranges — the serial log() per position it replaces
        // was ~0.2s of critical-path wall per 5M positions
        bsc_model_call2(e->model, sz, s.counts8.data(), s.quals8.data(),
                        s.cr.data(), e->n_threads, 1, s.gt_prob.data(),
                        s.max_gt.data(), s.cmargin.data(),
                        s.coff.data()); }
        for (int64_t i = 0; i < sz; i++)
            if (s.cmargin[i] < 1e-9) s.ties.push_back(i);
        return (int64_t)s.ties.size();
    }
    s.gt_prob.assign(sz * 10, 0.0);
    s.max_gt.assign(sz, 0);
    s.cc.resize(nc * 8);
    s.cq.resize(nc * 8);
    s.cr.resize(nc);
    for (int64_t j = 0; j < nc; j++) {
        const int64_t i = s.cov[j];
        memcpy(&s.cc[j * 8], &s.counts8[i * 8], 8 * sizeof(int32_t));
        memcpy(&s.cq[j * 8], &s.quals8[i * 8], 8 * sizeof(int32_t));
        s.cr[j] = s.refw[i];
    }
    s.cgp.resize(nc * 10);
    s.cmg.resize(nc);
    { BSC_PROF_SCOPE("row.model_call");
    bsc_model_call2(e->model, nc, s.cc.data(), s.cq.data(), s.cr.data(),
                    e->n_threads, 1, s.cgp.data(), s.cmg.data(),
                    s.cmargin.data(), s.coff.data()); }
    for (int64_t j = 0; j < nc; j++) {
        const int64_t i = s.cov[j];
        memcpy(&s.gt_prob[i * 10], &s.cgp[j * 10], 10 * sizeof(double));
        s.max_gt[i] = s.cmg[j];
        if (s.cmargin[j] < 1e-9) s.ties.push_back(i);
    }
    return (int64_t)s.ties.size();
}

// Export the tie rows' model inputs for the Python scalar oracle.
void bsre_ties(void *h, int32_t slot, int64_t *idx, int32_t *counts8,
               int32_t *quals8, int32_t *ref) {
    RowEngine *e = (RowEngine *)h;
    Slot &s = e->slots[slot];
    for (size_t j = 0; j < s.ties.size(); j++) {
        const int64_t i = s.ties[j];
        idx[j] = i;
        memcpy(counts8 + j * 8, &s.counts8[i * 8], 8 * sizeof(int32_t));
        memcpy(quals8 + j * 8, &s.quals8[i * 8], 8 * sizeof(int32_t));
        ref[j] = s.refw[i];
    }
}

// Overwrite tie rows with the oracle's (already C-style) results.
void bsre_fix(void *h, int32_t slot, int64_t n, const int64_t *idx,
              const double *gp10, const int32_t *mgt) {
    RowEngine *e = (RowEngine *)h;
    Slot &s = e->slots[slot];
    for (int64_t j = 0; j < n; j++) {
        const int64_t i = idx[j];
        memcpy(&s.gt_prob[i * 10], gp10 + j * 10, 10 * sizeof(double));
        s.max_gt[i] = mgt[j];
    }
}

// Phase 3: gate, window, prep, format, accumulate. Returns bytes
// written into out, or -1 when out_cap is insufficient — then NOTHING
// (stats, old_x, CpG carry) has been updated and the caller may retry
// with a bigger buffer. hold_back=2 withholds the last 2 rows of a
// partial (still-open) block range; the next range re-supplies them
// (output/vector_site.py emit_block streaming contract).
int64_t bsre_emit(void *h, int32_t slot, const char *ctg_name,
                  int32_t ctg_id, int64_t ctg_len, int64_t hold_back,
                  int32_t collect_stats, const uint8_t *gc_bins,
                  int64_t gc_len, int64_t gc_start, int64_t *io_old_x,
                  int64_t *io_prev_cpg_x, uint8_t *io_prev_cpg_flt,
                  char *out, int64_t out_cap) {
    RowEngine *e = (RowEngine *)h;
    Slot &s = e->slots[slot];
    const int64_t sz = s.sz;
    // --- Fisher strand (after tie fixes: max_gt is final) ---
    if (!s.fisher_done) {
        BSC_PROF_SCOPE("emit.fisher");
        s.fs.assign(sz, 0.0);
        std::vector<int64_t> hrows;
        for (int64_t j = 0; j < (int64_t)s.cov.size(); j++) {
            const int64_t i = s.cov[j];
            if (e->het_mask[s.max_gt[i]]) hrows.push_back(i);
        }
        if (!hrows.empty()) {
            std::vector<int64_t> ftab(hrows.size() * 4);
            for (size_t j = 0; j < hrows.size(); j++) {
                const int64_t i = hrows[j];
                const int g = s.max_gt[i];
                const int32_t *c0 = &s.counts2[i * 16];
                const int32_t *c1 = c0 + 8;
                int64_t t0 = 0, t1 = 0, t2 = 0, t3 = 0;
                for (int k = 0; k < 8; k++) {
                    t0 += (int64_t)c0[k] * e->fmask_a[g * 8 + k];
                    t1 += (int64_t)c0[k] * e->fmask_b[g * 8 + k];
                    t2 += (int64_t)c1[k] * e->fmask_a[g * 8 + k];
                    t3 += (int64_t)c1[k] * e->fmask_b[g * 8 + k];
                }
                if (e->quirk && g == 8)
                    // call_genotypes.c:98: the reverse-strand row of the
                    // GT table reads counts[0][6]
                    t2 = (int64_t)c1[2] + c1[4] + c0[6];
                ftab[j * 4] = t0;
                ftab[j * 4 + 1] = t1;
                ftab[j * 4 + 2] = t2;
                ftab[j * 4 + 3] = t3;
            }
            std::vector<double> fsout(hrows.size());
            bsc_fisher_batch((int64_t)hrows.size(), ftab.data(),
                             fsout.data());
            for (size_t j = 0; j < hrows.size(); j++)
                s.fs[hrows[j]] = fsout[j];
        }
        s.fisher_done = true;
    }
    // --- genotype 5-windows + reference 7-windows ---
    BSC_PROF_SCOPE("emit.rest");
    s.gt1.resize(sz);
    for (int64_t i = 0; i < sz; i++)
        s.gt1[i] = s.ntot[i] > 0 ? s.max_gt[i] + 1 : 0;
    // g5(i,k) = gt1[i+k-2], zero-padded head, stale tail (emit_block)
    auto g5 = [&](int64_t i, int k) -> int32_t {
        const int64_t j = i + k - 2;
        if (j < 0) return 0;
        if (j >= sz) return s.gt1[sz - 1];
        return s.gt1[j];
    };
    s.rf7.resize(sz * 7);
    const uint8_t *rw = s.refw.data();
    {
        const int nt7 = sz > 65536 ? 4 : 1;
        const int64_t step7 = (sz + nt7 - 1) / nt7;
        bsc::pool_run(nt7, [&](int w) {
            int64_t lo = w * step7 < 2 ? 2 : w * step7;
            int64_t hi = (w + 1) * step7;
            if (hi > sz - 2) hi = sz - 2;
            for (int64_t i = lo; i < hi; i++)
                trunc_copy(rw + i - 2, &s.rf7[i * 7], 7);
        });
    }
    {   // edge fixups (print_vcf.c:576-580 push offsets / flush rows)
        uint8_t t[7];
        memset(&s.rf7[0], 0, 7);
        trunc_copy(rw, t, 5);
        memcpy(&s.rf7[2], t, 5);
        memset(&s.rf7[7], 0, 7);
        trunc_copy(rw, t, 6);
        memcpy(&s.rf7[8], t, 6);
        uint8_t o[7];
        trunc_copy(rw + sz - 5, o, 7);
        uint8_t *ra = &s.rf7[(sz - 2) * 7];
        for (int k = 0; k < 6; k++) ra[k] = o[k + 1];
        ra[6] = o[6];
        uint8_t *rb = &s.rf7[(sz - 1) * 7];
        for (int k = 0; k < 5; k++) rb[k] = o[k + 2];
        rb[5] = o[6];
        rb[6] = o[6];
    }
    // --- gating ---
    const int64_t old_x = *io_old_x;
    const int64_t ymax = s.y - hold_back;
    s.reach.assign(sz, 0);
    s.pos_all.resize(sz);
    s.eidx.clear();
    int64_t new_old_x = old_x;
    bool any_reach = false;
    for (int64_t i = 0; i < sz; i++) {
        const int64_t p = s.x + i;
        s.pos_all[i] = p;
        if (s.ntot[i] <= 0 || p <= old_x || p > ymax) continue;
        s.reach[i] = 1;
        any_reach = true;
        if (p > new_old_x) new_old_x = p;
        const int g = s.max_gt[i];
        const int r = s.rf7[i * 7 + 2];
        if (e->gt_flag[g * 5 + r] && !e->all_positions) continue;
        if (p > ctg_len) continue;
        s.eidx.push_back(i);
    }
    const int64_t n = (int64_t)s.eidx.size();
    if (n == 0 && !(collect_stats && e->stats_acc && any_reach)) {
        *io_old_x = new_old_x;
        return 0;
    }
    // --- gather per-emitted-row arrays ---
    s.eg.resize(n); s.er.resize(n); s.emq.resize(n);
    s.eg1.resize(n); s.eg2.resize(n); s.eg3.resize(n);
    s.ecnt.resize(n * 8); s.eql.resize(n * 8);
    s.egp.resize(n * 10); s.efs.resize(n);
    s.epos.resize(n);
    s.eprf.resize(n * 5); s.ectx.resize(n * 5);
    { BSC_PROF_SCOPE("emit.gather");
    const int ntg = n > 32768 ? 4 : 1;
    const int64_t stepg = (n + ntg - 1) / ntg;
    bsc::pool_run(ntg, [&](int w) {
    const int64_t glo = w * stepg;
    const int64_t ghi = glo + stepg < n ? glo + stepg : n;
    for (int64_t j = glo; j < ghi; j++) {
        const int64_t i = s.eidx[j];
        s.eg[j] = s.max_gt[i];
        s.er[j] = s.rf7[i * 7 + 2];
        s.emq[j] = s.mqv[i];
        s.eg1[j] = g5(i, 1);
        s.eg2[j] = g5(i, 2);
        s.eg3[j] = g5(i, 3);
        memcpy(&s.ecnt[j * 8], &s.counts8[i * 8], 8 * sizeof(int32_t));
        memcpy(&s.eql[j * 8], &s.quals8[i * 8], 8 * sizeof(int32_t));
        memcpy(&s.egp[j * 10], &s.gt_prob[i * 10], 10 * sizeof(double));
        s.efs[j] = s.fs[i];
        s.epos[j] = s.pos_all[i];
        for (int k = 0; k < 5; k++) {
            s.eprf[j * 5 + k] = e->pbase[s.rf7[i * 7 + k]];
            s.ectx[j * 5 + k] = e->iupac[g5(i, k)];
        }
    }
    }); }
    // --- per-row field prep (bsc_emit.cpp) ---
    s.eph.resize(n); s.edp1.resize(n); s.eqd.resize(n);
    s.efsi.resize(n); s.eflt.resize(n); s.ecg.resize(n);
    s.emac.resize(n); s.eccg.resize(n); s.ehet.resize(n);
    s.eglv.resize(n * 5); s.egll.resize(n);
    if (n) {
        BSC_PROF_SCOPE("emit.prep");
        // per-row independent: split into contiguous ranges on the pool
        const int ntp = n > 32768 ? 4 : 1;
        const int64_t stepp = (n + ntp - 1) / ntp;
        bsc::pool_run(ntp, [&](int w) {
            const int64_t lo = w * stepp;
            const int64_t hi = lo + stepp < n ? lo + stepp : n;
            if (lo >= hi) return;
            const int64_t m = hi - lo;
            bsc_emit_prep(m, s.ecnt.data() + lo * 8,
                          s.egp.data() + lo * 10, s.eg.data() + lo,
                          s.er.data() + lo, s.emq.data() + lo,
                          s.efs.data() + lo, s.eg1.data() + lo,
                          s.eg2.data() + lo, s.eg3.data() + lo,
                          e->gl_idx, e->gl_len, e->het, e->cflag,
                          e->gflag, s.eph.data() + lo,
                          s.edp1.data() + lo, s.eqd.data() + lo,
                          s.efsi.data() + lo, s.eflt.data() + lo,
                          s.emac.data() + lo, s.eglv.data() + lo * 5,
                          s.egll.data() + lo, s.ecg.data() + lo,
                          s.eccg.data() + lo, s.ehet.data() + lo);
        });
    }
    // --- format FIRST (so a too-small buffer retries with no state
    // or stats side effects) ---
    int64_t written = 0;
    if (n) {
        BSC_PROF_SCOPE("emit.format");
        s.ers_off.assign(n + 1, 0);
        written = bsc_format_rows(
            n, ctg_name, s.epos.data(), s.eg.data(), s.er.data(),
            s.eflt.data(), s.emac.data(), s.eph.data(), s.edp1.data(),
            s.emq.data(), s.eqd.data(), s.efsi.data(), s.ehet.data(),
            s.eglv.data(), s.egll.data(), s.ecnt.data(), s.eql.data(),
            s.eccg.data(), s.ecg.data(), s.eprf.data(), s.ectx.data(),
            s.ers_off.data(), "", e->gt_lut, 8, e->alt_lut, 8,
            e->cs_lut, 4, e->ft_lut, 24, e->ft_len, e->pbase, out,
            out_cap, e->n_threads);
        if (written < 0) return -1;
    }
    // --- stats accumulation (print_vcf.c:382-526 twin) ---
    if (collect_stats && e->stats_acc) {
        bsc_stats_acc_cov(e->stats_acc, sz, s.counts8.data(),
                          s.reach.data(), s.pos_all.data(), gc_bins,
                          gc_len, gc_start);
        if (n) {
            s.eph32.resize(n); s.eqd32.resize(n);
            s.efltf.resize(n); s.erf3.resize(n * 3);
            s.ersp.assign(n, 0);
            for (int64_t j = 0; j < n; j++) {
                s.eph32[j] = (int32_t)s.eph[j];
                s.eqd32[j] = (int32_t)s.eqd[j];
                s.efltf[j] =
                    (int32_t)s.eflt[j] | (s.emac[j] ? 128 : 0);
                const int64_t i = s.eidx[j];
                s.erf3[j * 3] = s.rf7[i * 7 + 1];
                s.erf3[j * 3 + 1] = s.rf7[i * 7 + 2];
                s.erf3[j * 3 + 2] = s.rf7[i * 7 + 3];
            }
            bsc_stats_acc_rows(
                e->stats_acc, n, ctg_id, s.epos.data(), s.eg.data(),
                s.er.data(), s.eph32.data(), s.eqd32.data(),
                s.efsi.data(), s.emq.data(), s.efltf.data(),
                s.ecnt.data(), s.eccg.data(), s.ersp.data(),
                s.erf3.data(), io_prev_cpg_x, io_prev_cpg_flt);
        }
    }
    *io_old_x = new_old_x;
    return written;
}

}  // extern "C"
