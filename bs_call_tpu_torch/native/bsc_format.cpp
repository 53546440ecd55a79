// bsc_format: native VCF text row assembly.
//
// The block-vectorized emitter computes all output fields as arrays
// (output/vector_site.py); this function turns them into VCF text rows in
// one pass, replacing the per-row Python formatting loop (the analogue of
// print_vcf.c's record encoding, but for text output). String-valued
// lookup tables are passed in from Python so the two paths share one
// source of truth.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace bsc {  // bsc_pool.cpp
void pool_run(int n, const std::function<void(int)> &fn);
}

namespace {

inline char *put_str(char *p, const char *s) {
    while (*s) *p++ = *s++;
    return p;
}

inline char *put_int(char *p, long long v) {
    if (v < 0) {
        *p++ = '-';
        v = -v;
    }
    char tmp[20];
    int n = 0;
    do {
        tmp[n++] = '0' + (v % 10);
        v /= 10;
    } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

// ---- fast "%g" (default precision 6) ----
//
// printf("%g") is the single hottest call in row formatting (up to 5 GL
// values per row). This writer produces byte-identical output to glibc's
// "%g" for every finite double: scale to 6 significant digits with
// 80-bit long-double arithmetic (relative error ~2e-19, i.e. ~2e-13
// absolute on the 6-digit integer), round, and fall back to snprintf
// whenever the rounding fraction lands inside a 1e-9 guard band around
// a decimal tie — exactly the cases where the cheap path could disagree
// with glibc's correctly-rounded conversion.

// long-double powers of ten: PW10[k] = 10^(k - 80), k in [0, 160]
struct Pw10 {
    long double v[161];
    Pw10() {
        for (int k = 0; k <= 160; k++) v[k] = powl(10.0L, k - 80);
    }
};
const Pw10 PW10;

inline char *g6_fallback(char *p, double x) {
    return p + snprintf(p, 32, "%g", x);
}

inline char *put_g6(char *p, double x) {
    if (!std::isfinite(x)) return g6_fallback(p, x);
    if (x == 0.0) {
        if (std::signbit(x)) *p++ = '-';
        *p++ = '0';
        return p;
    }
    char *const p0 = p;  // fallback rewrites the whole value, sign incl.
    double a = x;
    if (x < 0) {
        *p++ = '-';
        a = -x;
    }
    // decimal exponent estimate, corrected by the scaling loop below:
    // floor(e2 * log10(2)) from the raw binary exponent is within 1 of
    // the true decimal exponent for every normal double, and the loop
    // fixes any off-by-one — so no log10() call is needed
    uint64_t bits;
    memcpy(&bits, &a, 8);
    int e2 = (int)((bits >> 52) & 0x7FF);
    int e;
    if (e2 == 0) {  // subnormal: scale into the normal range first
        e = (int)floor(log10(a));
    } else {
        e = (int)(((int64_t)(e2 - 1023) * 315653) >> 20);  // *log10(2)
    }
    uint64_t d;
    for (int iter = 0;; iter++) {
        int idx = 5 - e + 80;
        if (idx < 0 || idx > 160 || iter > 4) return g6_fallback(p0, x);
        const long double D = (long double)a * PW10.v[idx];
        if (D >= 1e6L) {
            e++;
            continue;
        }
        if (D < 1e5L) {
            e--;
            continue;
        }
        d = (uint64_t)D;
        const long double frac = D - (long double)d;
        long double tie = frac - 0.5L;
        if (tie < 0) tie = -tie;
        if (tie < 1e-9L) return g6_fallback(p0, x);
        if (frac > 0.5L) d++;
        if (d == 1000000) {  // rounding carried into a new decade
            d = 100000;
            e++;
        }
        break;
    }
    char dig[6];
    for (int k = 5; k >= 0; k--) {
        dig[k] = (char)('0' + d % 10);
        d /= 10;
    }
    int last = 5;  // trim trailing zeros of the significand
    while (last > 0 && dig[last] == '0') last--;
    if (e >= -4 && e < 6) {  // f-style
        if (e >= 0) {
            int i = 0;
            for (; i <= e; i++) *p++ = i <= last ? dig[i] : '0';
            if (last > e) {
                *p++ = '.';
                for (; i <= last; i++) *p++ = dig[i];
            }
        } else {
            *p++ = '0';
            *p++ = '.';
            for (int z = 0; z < -e - 1; z++) *p++ = '0';
            for (int i = 0; i <= last; i++) *p++ = dig[i];
        }
    } else {  // e-style
        *p++ = dig[0];
        if (last > 0) {
            *p++ = '.';
            for (int i = 1; i <= last; i++) *p++ = dig[i];
        }
        *p++ = 'e';
        int ae = e;
        if (e < 0) {
            *p++ = '-';
            ae = -e;
        } else {
            *p++ = '+';
        }
        if (ae < 10) {
            *p++ = '0';
            *p++ = (char)('0' + ae);
        } else {
            p = put_int(p, ae);
        }
    }
    return p;
}

}  // namespace

extern "C" {
// exposed for the byte-parity test (tests/test_format_g6.py)
int64_t bsc_format_g6(double x, char *out) {
    return put_g6(out, x) - out;
}
}

namespace {

// every array the row writer touches, bundled so the same loop serves
// the single-threaded and the range-parallel paths
struct RowArgs {
    const char *ctg_name;
    const int64_t *pos;
    const int32_t *g, *r;
    const int64_t *flt;
    const uint8_t *mac1;
    const int64_t *phred, *dp1;
    const int32_t *mq;
    const int64_t *qd, *fs_int;
    const uint8_t *het;
    const float *gl_vals;
    const int32_t *gl_len, *counts, *quals;
    const uint8_t *is_cg;
    const int64_t *cg_code;
    const char *prf, *ctx;
    const int64_t *rs_off;
    const char *rs_blob;
    const char *gt_lut;
    int gt_stride;
    const char *alt_lut;
    int alt_stride;
    const char *cs_lut;
    int cs_stride;
    const char *ft_lut;
    int ft_stride;
    const int32_t *ft_len;
    const char *pbase;
};

// Returns bytes written, or -1 if the buffer is insufficient.
int64_t format_range(const RowArgs &a, int64_t lo, int64_t hi,
                     char *out, int64_t out_cap) {
    const char *ctg_name = a.ctg_name;
    const int64_t *pos = a.pos, *flt = a.flt, *phred = a.phred,
                  *dp1 = a.dp1, *qd = a.qd, *fs_int = a.fs_int,
                  *cg_code = a.cg_code, *rs_off = a.rs_off;
    const int32_t *g = a.g, *r = a.r, *mq = a.mq, *gl_len = a.gl_len,
                  *counts = a.counts, *quals = a.quals,
                  *ft_len = a.ft_len;
    const uint8_t *mac1 = a.mac1, *het = a.het, *is_cg = a.is_cg;
    const float *gl_vals = a.gl_vals;
    const char *prf = a.prf, *ctx = a.ctx, *rs_blob = a.rs_blob,
               *gt_lut = a.gt_lut, *alt_lut = a.alt_lut,
               *cs_lut = a.cs_lut, *ft_lut = a.ft_lut, *pbase = a.pbase;
    const int gt_stride = a.gt_stride, alt_stride = a.alt_stride,
              cs_stride = a.cs_stride, ft_stride = a.ft_stride;
    char *p = out;
    char *end = out + out_cap - 512;  // per-row safety margin
    for (int64_t i = lo; i < hi; i++) {
        if (p >= end) return -1;
        int gi = g[i];
        int ri = r[i];
        const char *filt;
        // FT entries may carry embedded NULs (the reference copies each
        // filter name's terminator into the typed vector,
        // print_vcf.c:283-296) — always write by explicit length
        int ft_ix;
        if (flt[i]) {
            filt = "fail";
            ft_ix = (int)(flt[i] & 15);
        } else if (mac1[i]) {
            filt = "mac1";
            ft_ix = 0;  // "PASS"
        } else {
            filt = "PASS";
            ft_ix = 0;
        }
        const char *ft = ft_lut + ft_ix * ft_stride;
        int ft_n = ft_len[ft_ix];
        p = put_str(p, ctg_name);
        *p++ = '\t';
        p = put_int(p, pos[i]);
        *p++ = '\t';
        if (rs_off && rs_off[i + 1] > rs_off[i]) {
            memcpy(p, rs_blob + rs_off[i], rs_off[i + 1] - rs_off[i]);
            p += rs_off[i + 1] - rs_off[i];
        } else *p++ = '.';
        *p++ = '\t';
        *p++ = pbase[ri];
        *p++ = '\t';
        p = put_str(p, alt_lut + (gi * 5 + ri) * alt_stride);
        *p++ = '\t';
        p = put_int(p, phred[i]);
        *p++ = '\t';
        p = put_str(p, filt);
        p = put_str(p, "\tCX=");
        memcpy(p, prf + i * 5, 5);
        p += 5;
        p = put_str(p, het[i]
                        ? "\tGT:FT:DP:MQ:GQ:QD:GL:MC8:AMQ:CS:CG:CX:FS\t"
                        : "\tGT:FT:DP:MQ:GQ:QD:GL:MC8:AMQ:CS:CG:CX\t");
        p = put_str(p, gt_lut + (gi * 5 + ri) * gt_stride);
        *p++ = ':';
        memcpy(p, ft, ft_n);
        p += ft_n;
        *p++ = ':';
        p = put_int(p, dp1[i]);
        *p++ = ':';
        p = put_int(p, mq[i]);
        *p++ = ':';
        p = put_int(p, phred[i]);
        *p++ = ':';
        p = put_int(p, qd[i]);
        *p++ = ':';
        for (int k = 0; k < gl_len[i]; k++) {
            if (k) *p++ = ',';
            p = put_g6(p, (double)gl_vals[i * 5 + k]);
        }
        *p++ = ':';
        for (int k = 0; k < 8; k++) {
            if (k) *p++ = ',';
            p = put_int(p, counts[i * 8 + k]);
        }
        *p++ = ':';
        bool first = true;
        for (int k = 0; k < 8; k++) {
            if (counts[i * 8 + k] > 0) {
                if (!first) *p++ = ',';
                p = put_int(p, quals[i * 8 + k]);
                first = false;
            }
        }
        *p++ = ':';
        p = put_str(p, cs_lut + gi * cs_stride);
        *p++ = ':';
        // one char only, like the reference (print_vcf.c:366-368)
        *p++ = is_cg[i] ? 'C' : (char)cg_code[i];
        *p++ = ':';
        memcpy(p, ctx + i * 5, 5);
        p += 5;
        if (het[i]) {
            *p++ = ':';
            p = put_int(p, fs_int[i]);
        }
        *p++ = '\n';
    }
    return p - out;
}

}  // namespace

extern "C" {

// Text VCF rows [0, n) into out. Row ranges are formatted on n_threads
// std::threads into per-thread scratch, then stitched in order — output
// bytes are identical for any thread count. Returns bytes written, or
// -1 if out_cap is insufficient.
// LUT blobs: fixed-stride char arrays, NUL-terminated entries.
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
    char *out, int64_t out_cap, int32_t n_threads) {
    RowArgs a{ctg_name, pos,    g,        r,        flt,      mac1,
              phred,    dp1,    mq,       qd,       fs_int,   het,
              gl_vals,  gl_len, counts,   quals,    is_cg,    cg_code,
              prf,      ctx,    rs_off,   rs_blob,  gt_lut,   gt_stride,
              alt_lut,  alt_stride, cs_lut, cs_stride, ft_lut,
              ft_stride, ft_len, pbase};
    int nt = n_threads < 1 ? 1 : n_threads;
    if ((int64_t)nt * 4096 > n) nt = (int)(n / 4096) + 1;
    if (nt <= 1) return format_range(a, 0, n, out, out_cap);
    const int64_t step = (n + nt - 1) / nt;
    std::vector<std::vector<char>> bufs(nt);
    std::vector<int64_t> lens(nt, 0);
    bsc::pool_run(nt, [&](int w) {
        const int64_t lo = w * step;
        const int64_t hi = lo + step < n ? lo + step : n;
        if (lo >= hi) return;
        // 192 B/row typical; grow by retry if a range overflows
        int64_t cap = (hi - lo) * 224 + 1024;
        for (;;) {
            bufs[w].resize(cap);
            int64_t r2 = format_range(a, lo, hi, bufs[w].data(), cap);
            if (r2 >= 0) {
                lens[w] = r2;
                return;
            }
            cap *= 2;
        }
    });
    int64_t total = 0;
    for (int w = 0; w < nt; w++) total += lens[w];
    if (total > out_cap) return -1;
    char *p = out;
    for (int w = 0; w < nt; w++) {
        memcpy(p, bufs[w].data(), (size_t)lens[w]);
        p += lens[w];
    }
    return total;
}

}  // extern "C"

// ---- BCF2.2 record encoding (mirrors io/bcf.py) ----

namespace {

inline char *enc_size(char *p, int size, int btype) {
    if (size < 15) {
        *p++ = (char)((size << 4) | btype);
        return p;
    }
    *p++ = (char)(0xF0 | btype);
    // itf-style int1 for the length
    if (size <= 127) {
        *p++ = 0x11;
        *p++ = (char)size;
    } else if (size <= 32767) {
        *p++ = 0x12;
        memcpy(p, &size, 2);
        p += 2;
    } else {
        *p++ = 0x13;
        memcpy(p, &size, 4);
        p += 4;
    }
    return p;
}

inline char *enc_int1(char *p, long long v) {
    if (v >= -120 && v <= 127) {
        *p++ = 0x11;
        *p++ = (char)(int8_t)v;
    } else if (v >= -32760 && v <= 32767) {
        *p++ = 0x12;
        int16_t x = (int16_t)v;
        memcpy(p, &x, 2);
        p += 2;
    } else {
        *p++ = 0x13;
        int32_t x = (int32_t)v;
        memcpy(p, &x, 4);
        p += 4;
    }
    return p;
}

inline char *enc_vint(char *p, const long long *vals, int n) {
    long long lo = 0, hi = 0;
    for (int i = 0; i < n; i++) {
        if (vals[i] < lo) lo = vals[i];
        if (vals[i] > hi) hi = vals[i];
    }
    if (lo >= -120 && hi <= 127) {
        p = enc_size(p, n, 1);
        for (int i = 0; i < n; i++) *p++ = (char)(int8_t)vals[i];
    } else if (lo >= -32760 && hi <= 32767) {
        p = enc_size(p, n, 2);
        for (int i = 0; i < n; i++) {
            int16_t x = (int16_t)vals[i];
            memcpy(p, &x, 2);
            p += 2;
        }
    } else {
        p = enc_size(p, n, 3);
        for (int i = 0; i < n; i++) {
            int32_t x = (int32_t)vals[i];
            memcpy(p, &x, 4);
            p += 4;
        }
    }
    return p;
}

inline char *enc_str(char *p, const char *s, int n) {
    p = enc_size(p, n, 7);
    memcpy(p, s, n);
    return p + n;
}

}  // namespace

extern "C" {

// ids[]: PASS,fail,mac1,CX,GT,FT,GL,GQ,DP,MQ,QD,MC8,AMQ,CS,CG,FS dictionary
// ids (same order as the reference's vcf_ids, print_vcf.c:755).
// Returns bytes written or -1.
int64_t bsc_format_bcf(
    int64_t n, int32_t rid, const int32_t *ids,
    const int64_t *pos, const int32_t *g, const int32_t *r,
    const int64_t *flt, const uint8_t *mac1, const int64_t *phred,
    const int64_t *dp1, const int32_t *mq, const int64_t *qd,
    const int64_t *fs_int, const uint8_t *het,
    const float *gl_vals, const int32_t *gl_len,
    const int32_t *counts, const int32_t *quals,
    const uint8_t *is_cg, const int64_t *cg_code,
    const char *prf, const char *ctx,
    const int64_t *rs_off, const char *rs_blob,
    const char *alt_lut, int alt_stride,
    const char *cs_lut, int cs_stride,
    const char *ft_lut, int ft_stride, const int32_t *ft_len,
    const char *pbase, const uint8_t *gt_int_lut,
    char *out, int64_t out_cap) {
    char *p = out;
    char *end = out + out_cap - 1024;
    for (int64_t i = 0; i < n; i++) {
        if (p >= end) return -1;
        int gi = g[i];
        int ri = r[i];
        char *rec_start = p;
        p += 8;  // l_shared/l_indiv backpatch
        char *shared_start = p;
        // core
        memcpy(p, &rid, 4);
        p += 4;
        int32_t pos0 = (int32_t)(pos[i] - 1);
        memcpy(p, &pos0, 4);
        p += 4;
        int32_t rlen = 1;
        memcpy(p, &rlen, 4);
        p += 4;
        float qual = (float)phred[i];
        memcpy(p, &qual, 4);
        p += 4;
        uint16_t n_info = 1;
        const char *alt = alt_lut + (gi * 5 + ri) * alt_stride;
        int n_alt = 0;
        for (const char *a = alt; *a; a++)
            if (*a != ',' && *a != '.') n_alt++;
        uint16_t n_allele = 1 + n_alt;
        memcpy(p, &n_info, 2);
        p += 2;
        memcpy(p, &n_allele, 2);
        p += 2;
        char *nfmt_pos = p;  // n_sample | n_fmt<<24
        p += 4;
        // ID
        if (rs_off && rs_off[i + 1] > rs_off[i]) {
            int ln = (int)(rs_off[i + 1] - rs_off[i]);
            p = enc_str(p, rs_blob + rs_off[i], ln);
        } else p = enc_size(p, 0, 7);
        // alleles
        p = enc_str(p, pbase + ri, 1);
        for (const char *a = alt; *a; a++)
            if (*a != ',' && *a != '.') p = enc_str(p, a, 1);
        // FILTER
        long long fid = flt[i] ? ids[1] : (mac1[i] ? ids[2] : ids[0]);
        p = enc_vint(p, &fid, 1);
        // INFO CX
        p = enc_int1(p, ids[3]);
        p = enc_str(p, prf + i * 5, 5);
        int64_t l_shared = p - shared_start;
        char *indiv_start = p;
        int n_fmt = 0;
        // GT
        uint8_t gg = gt_int_lut[gi * 5 + ri];
        long long gt2[2] = {gg >> 4, gg & 0xF};
        p = enc_int1(p, ids[4]);
        p = enc_vint(p, gt2, 2);
        n_fmt++;
        // FT (embedded NULs possible — explicit length)
        int ft_ix = flt[i] ? (int)(flt[i] & 15) : 0;
        p = enc_int1(p, ids[5]);
        p = enc_str(p, ft_lut + ft_ix * ft_stride, ft_len[ft_ix]);
        n_fmt++;
        // DP, MQ, GQ, QD
        p = enc_int1(p, ids[8]);
        p = enc_int1(p, dp1[i]);
        n_fmt++;
        p = enc_int1(p, ids[9]);
        p = enc_int1(p, mq[i]);
        n_fmt++;
        p = enc_int1(p, ids[7]);
        p = enc_int1(p, phred[i]);
        n_fmt++;
        p = enc_int1(p, ids[10]);
        p = enc_int1(p, qd[i]);
        n_fmt++;
        // GL (float vector)
        p = enc_int1(p, ids[6]);
        p = enc_size(p, gl_len[i], 5);
        memcpy(p, gl_vals + i * 5, gl_len[i] * 4);
        p += gl_len[i] * 4;
        n_fmt++;
        // MC8
        long long mc8[8];
        for (int k = 0; k < 8; k++) mc8[k] = counts[i * 8 + k];
        p = enc_int1(p, ids[11]);
        p = enc_vint(p, mc8, 8);
        n_fmt++;
        // AMQ (nonzero-count categories)
        long long amq[8];
        int na = 0;
        for (int k = 0; k < 8; k++)
            if (counts[i * 8 + k] > 0) amq[na++] = quals[i * 8 + k];
        if (na > 0) {
            p = enc_int1(p, ids[12]);
            p = enc_vint(p, amq, na);
            n_fmt++;
        }
        // CS, CG, CX
        const char *cs = cs_lut + gi * cs_stride;
        p = enc_int1(p, ids[13]);
        p = enc_str(p, cs, (int)strlen(cs));
        n_fmt++;
        p = enc_int1(p, ids[14]);
        {
            // one char only, like the reference (print_vcf.c:366-368)
            char cgc = is_cg[i] ? 'C' : (char)cg_code[i];
            p = enc_str(p, &cgc, 1);
        }
        n_fmt++;
        p = enc_int1(p, ids[3]);
        p = enc_str(p, ctx + i * 5, 5);
        n_fmt++;
        if (het[i]) {
            p = enc_int1(p, ids[15]);
            p = enc_int1(p, fs_int[i]);
            n_fmt++;
        }
        int64_t l_indiv = p - indiv_start;
        uint32_t ns_nf = ((uint32_t)n_fmt << 24) | 1;
        memcpy(nfmt_pos, &ns_nf, 4);
        uint32_t ls = (uint32_t)l_shared, li = (uint32_t)l_indiv;
        memcpy(rec_start, &ls, 4);
        memcpy(rec_start + 4, &li, 4);
    }
    return p - out;
}

}  // extern "C"
