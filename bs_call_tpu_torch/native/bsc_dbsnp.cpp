// bsc_dbsnp: one contig of bs_call's dbSNP index decoded into flat arrays,
// and the rs names of a set of entries written into one blob.
//
// The contig is the chain of { u64 comp_size, zlib block } that starts at
// the contig's file offset and ends at a zero size (io/dbsnp.py states the
// format). Each block holds bins of 64 positions: a varint bin gap, then
// entries of (prefix|offset byte, optional 2-byte explicit prefix id read
// big-endian, packed BCD digits mapped through db_tab, terminator <= 3
// with the maf bit 2 and the end-of-bin bit 1). The decode follows
// DbSnpContig._py_arrays (io/dbsnp.py) step for step, errors included:
// an entry's bin is the bin current at its end-of-bin mark, a bin that
// comes again replaces the earlier one, a bin past max_bin ends the
// block, and entries of an unfinished bin at the chain's end are dropped.
//
// Output per entry, in position order: pos (bin * 64 + offset, 1-based),
// sel (1 present, 3 present and maf-selected), pfx (prefix id), and the
// entry's packed digit bytes at names[name_off[i] .. name_off[i + 1]).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Contig {
    std::vector<int64_t> pos;
    std::vector<uint8_t> sel;
    std::vector<uint16_t> pfx;
    std::vector<int64_t> name_off{0};
    std::vector<uint8_t> names;
};

// stored file byte -> packed BCD (db_tab, dbSNP.c:160-177)
struct DbTab {
    uint8_t t[256];
    DbTab() {
        memset(t, 0xff, sizeof t);
        for (int b = 0x21; b < 0x85; b++)
            t[b] = (uint8_t)((((b - 0x21) / 10) << 4) | ((b - 0x21) % 10));
        for (int b = 0x85; b < 0x8f; b++)
            t[b] = (uint8_t)(((b - 0x85) << 4) | 0xf);
    }
};
const DbTab kDbTab;

enum Err { kOk = 0, kOffsets = 1, kName = 2, kBlock = 3, kOpen = 4 };

// One whole zlib stream of `in` into `out`; bytes after its end are
// ignored, as zlib.decompress ignores them.
bool inflate_all(const std::vector<uint8_t> &in, std::vector<uint8_t> &out) {
    z_stream zs;
    memset(&zs, 0, sizeof zs);
    if (inflateInit(&zs) != Z_OK) return false;
    out.resize(in.size() * 4 + 4096);
    zs.next_in = const_cast<Bytef *>(in.data());
    zs.avail_in = (uInt)in.size();
    size_t done = 0;
    int rc;
    for (;;) {
        zs.next_out = out.data() + done;
        zs.avail_out = (uInt)(out.size() - done);
        rc = inflate(&zs, Z_NO_FLUSH);
        done = out.size() - zs.avail_out;
        if (rc == Z_STREAM_END) break;
        if (rc != Z_OK && rc != Z_BUF_ERROR) break;
        if (zs.avail_out == 0) {
            out.resize(out.size() * 2);
        } else if (zs.avail_in == 0 || rc == Z_BUF_ERROR) {
            break;  // the stream ends early
        }
    }
    inflateEnd(&zs);
    out.resize(done);
    return rc == Z_STREAM_END;
}

struct Pending {
    int off;
    uint8_t sel;
    uint16_t pfx;
    int64_t nlen;
};

int decode(FILE *f, int64_t min_bin, int64_t max_bin, Contig &c) {
    std::vector<uint8_t> comp, data;
    std::vector<Pending> pend;
    std::vector<uint8_t> pend_names;
    int64_t curr_bin = min_bin, last_bin = -1, last_start = 0;
    int prev_ix = -1;
    for (;;) {
        uint8_t raw[8];
        if (fread(raw, 1, 8, f) < 8) break;
        uint64_t sz = 0;
        for (int k = 7; k >= 0; k--) sz = (sz << 8) | raw[k];
        if (sz == 0) break;
        comp.resize(sz);
        comp.resize(fread(comp.data(), 1, sz, f));
        if (!inflate_all(comp, data)) return kBlock;
        const uint8_t *d = data.data();
        const size_t n = data.size();
        size_t bp = 0;
        int n_entries = 0;
        while (bp < n) {
            if (!n_entries) {
                uint8_t x = d[bp++];
                int64_t inc;
                switch (x & 3) {
                case 0:
                    inc = x >> 2;
                    break;
                case 1:
                    if (bp + 1 > n) return kBlock;
                    inc = d[bp];
                    bp += 1;
                    break;
                case 2:
                    if (bp + 2 > n) return kBlock;
                    inc = d[bp] | (d[bp + 1] << 8);
                    bp += 2;
                    break;
                default:
                    if (bp + 4 > n) return kBlock;
                    inc = (int64_t)d[bp] | ((int64_t)d[bp + 1] << 8) |
                          ((int64_t)d[bp + 2] << 16) |
                          ((int64_t)d[bp + 3] << 24);
                    bp += 4;
                }
                curr_bin += inc;
                if (curr_bin > max_bin || bp >= n) break;
            }
            uint8_t x = d[bp++];
            uint16_t pfx;
            if ((x >> 6) == 0) {
                if (bp + 2 > n) return kName;
                pfx = (uint16_t)((d[bp] << 8) | d[bp + 1]);
                bp += 2;
            } else {
                pfx = (uint16_t)((x >> 6) - 1);
            }
            if ((x & 63) <= prev_ix) return kOffsets;
            prev_ix = x & 63;
            size_t k0 = bp;
            while (bp < n && d[bp] > 3) pend_names.push_back(kDbTab.t[d[bp++]]);
            if (bp >= n) return kName;
            uint8_t tm = d[bp++];
            pend.push_back({prev_ix, (uint8_t)(tm & 2 ? 3 : 1), pfx,
                            (int64_t)(bp - 1 - k0)});
            n_entries++;
            if (tm & 1) {  // end of bin
                if (last_bin == curr_bin) {  // the bin again: replace it
                    c.pos.resize(last_start);
                    c.sel.resize(last_start);
                    c.pfx.resize(last_start);
                    c.name_off.resize(last_start + 1);
                    c.names.resize(c.name_off.back());
                }
                last_bin = curr_bin;
                last_start = (int64_t)c.pos.size();
                c.names.insert(c.names.end(), pend_names.begin(),
                               pend_names.end());
                for (const Pending &e : pend) {
                    c.pos.push_back((curr_bin << 6) + e.off);
                    c.sel.push_back(e.sel);
                    c.pfx.push_back(e.pfx);
                    c.name_off.push_back(c.name_off.back() + e.nlen);
                }
                pend.clear();
                pend_names.clear();
                prev_ix = -1;
                n_entries = 0;
            }
        }
    }
    return kOk;
}

}  // namespace

extern "C" {

// Decodes the contig whose block chain starts at `offset` of the index at
// `path`. Returns a handle holding the arrays, their sizes in *n_ent and
// *n_name; NULL with *err set (1 bin offsets, 2 name, 3 block, 4 open).
void *bsc_dbsnp_load(const char *path, int64_t offset, int64_t min_bin,
                     int64_t max_bin, int64_t *n_ent, int64_t *n_name,
                     int32_t *err) {
    FILE *f = fopen(path, "rb");
    if (!f || fseeko(f, (off_t)offset, SEEK_SET) != 0) {
        if (f) fclose(f);
        *err = kOpen;
        return nullptr;
    }
    Contig *c = new Contig();
    int rc = decode(f, min_bin, max_bin, *c);
    fclose(f);
    if (rc != kOk) {
        delete c;
        *err = rc;
        return nullptr;
    }
    *err = kOk;
    *n_ent = (int64_t)c->pos.size();
    *n_name = (int64_t)c->names.size();
    return c;
}

// Copies the handle's arrays out (name_off has n_ent + 1 entries).
void bsc_dbsnp_take(void *h, int64_t *pos, uint8_t *sel, uint16_t *pfx,
                    int64_t *name_off, uint8_t *names) {
    const Contig *c = static_cast<const Contig *>(h);
    const size_t n = c->pos.size();
    memcpy(pos, c->pos.data(), n * sizeof(int64_t));
    memcpy(sel, c->sel.data(), n);
    memcpy(pfx, c->pfx.data(), n * sizeof(uint16_t));
    memcpy(name_off, c->name_off.data(), (n + 1) * sizeof(int64_t));
    memcpy(names, c->names.data(), c->names.size());
}

void bsc_dbsnp_free(void *h) { delete static_cast<Contig *>(h); }

// The rs names of entries ent[0..m) into out at out_off[rows[j]]: the
// prefix's bytes, then two characters a packed byte, a nibble >= 10 as a
// NUL (dbSNP.c:341-342 decodes the padding nibble of an odd-digit name
// too). The caller sized out_off from the same lengths.
void bsc_dbsnp_names(int64_t m, const int64_t *rows, const int64_t *ent,
                     const uint16_t *pfx, const int64_t *name_off,
                     const uint8_t *names, const int64_t *pfx_off,
                     const uint8_t *pfx_blob, const int64_t *out_off,
                     uint8_t *out) {
    for (int64_t j = 0; j < m; j++) {
        const int64_t e = ent[j];
        uint8_t *p = out + out_off[rows[j]];
        const int64_t p0 = pfx_off[pfx[e]], p1 = pfx_off[pfx[e] + 1];
        memcpy(p, pfx_blob + p0, p1 - p0);
        p += p1 - p0;
        for (int64_t k = name_off[e]; k < name_off[e + 1]; k++) {
            const uint8_t z = names[k], hi = z >> 4, lo = z & 15;
            *p++ = hi < 10 ? (uint8_t)('0' + hi) : 0;
            *p++ = lo < 10 ? (uint8_t)('0' + lo) : 0;
        }
    }
}

}  // extern "C"
