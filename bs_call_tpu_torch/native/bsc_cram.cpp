// bsc_cram: native CRAM 3.0 slice decoder (record hot loop).
//
// The reference delegates CRAM to htslib; this is a from-scratch decoder
// of the CRAM 3.0 record layer (spec sections 8-10), the C++ twin of
// bs_call_tpu/io/cram.py. Python keeps the container/block orchestration
// (headers, block decompression via zlib/bz2/lzma/rANS) and hands each
// slice's decompressed core+external blocks here; the per-record codec
// reads, feature reconstruction against the reference sequence, and raw
// BAM serialization all run natively. Output feeds the push-mode block
// builder (bsc_pipeline.cpp) with the same byte layout as
// io/bam.py::encode_bam_record, so downstream parity is structural.
// Randomized equality with the Python decoder is enforced by
// tests/test_cram_native.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Buf {
    const uint8_t *d = nullptr;
    int64_t len = 0;
    int64_t off = 0;
};

int32_t itf8(Buf &b) {
    if (b.off >= b.len) throw std::runtime_error("itf8 eof");
    uint32_t b0 = b.d[b.off];
    if (b0 < 0x80) {
        b.off += 1;
        return (int32_t)b0;
    }
    if (b0 < 0xC0) {
        if (b.off + 2 > b.len) throw std::runtime_error("itf8 eof");
        uint32_t v = ((b0 & 0x7F) << 8) | b.d[b.off + 1];
        b.off += 2;
        return (int32_t)v;
    }
    if (b0 < 0xE0) {
        if (b.off + 3 > b.len) throw std::runtime_error("itf8 eof");
        uint32_t v =
            ((b0 & 0x3F) << 16) | (b.d[b.off + 1] << 8) | b.d[b.off + 2];
        b.off += 3;
        return (int32_t)v;
    }
    if (b0 < 0xF0) {
        if (b.off + 4 > b.len) throw std::runtime_error("itf8 eof");
        uint32_t v = ((b0 & 0x1F) << 24) | (b.d[b.off + 1] << 16) |
                     (b.d[b.off + 2] << 8) | b.d[b.off + 3];
        b.off += 4;
        return (int32_t)v;
    }
    if (b.off + 5 > b.len) throw std::runtime_error("itf8 eof");
    uint32_t v = ((b0 & 0x0F) << 28) | (b.d[b.off + 1] << 20) |
                 (b.d[b.off + 2] << 12) | (b.d[b.off + 3] << 4) |
                 (b.d[b.off + 4] & 0x0F);
    b.off += 5;
    return (int32_t)v;
}

int64_t ltf8(Buf &b) {
    if (b.off >= b.len) throw std::runtime_error("ltf8 eof");
    uint32_t b0 = b.d[b.off];
    int n = 8;
    for (int i = 0; i < 8; i++) {
        if (!(b0 & (0x80 >> i))) {
            n = i;
            break;
        }
    }
    if (n == 0) {
        b.off += 1;
        return (int64_t)b0;
    }
    if (b.off + 1 + n > b.len) throw std::runtime_error("ltf8 eof");
    uint64_t v;
    if (n == 8) {
        v = 0;
        for (int i = 0; i < 8; i++) v = (v << 8) | b.d[b.off + 1 + i];
    } else {
        v = b0 & (0xFF >> (n + 1));
        for (int i = 0; i < n; i++) v = (v << 8) | b.d[b.off + 1 + i];
    }
    b.off += 1 + n;
    return (int64_t)v;
}

struct Bits {
    const uint8_t *d;
    int64_t len;
    int64_t pos = 0;
    int bit = 0;

    int read_bit() {
        if (pos >= len) throw std::runtime_error("core eof");
        int v = (d[pos] >> (7 - bit)) & 1;
        if (++bit == 8) {
            bit = 0;
            pos++;
        }
        return v;
    }
    uint32_t read_bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) v = (v << 1) | (uint32_t)read_bit();
        return v;
    }
};

struct Codec {
    int kind = 0;  // 0 none, 1 external, 3 huffman, 4 balen, 5 bastop,
                   // 6 beta, 9 gamma
    int32_t cid = 0;
    // huffman
    bool hsingle = false;
    int32_t hval = 0;
    std::unordered_map<uint64_t, int32_t> htab;  // (len<<32)|code -> sym
    // beta / gamma
    int32_t offset = 0;
    int nbits = 0;
    // byte_array_len
    std::unique_ptr<Codec> len_c, val_c;
    // byte_array_stop
    uint8_t stop = 0;
};

using ExtMap = std::unordered_map<int32_t, Buf>;

Buf &ext_of(ExtMap &ext, int32_t cid) {
    auto it = ext.find(cid);
    if (it == ext.end()) throw std::runtime_error("missing ext block");
    return it->second;
}

int32_t read_int(const Codec &c, Bits &core, ExtMap &ext);

uint8_t read_byte(const Codec &c, Bits &core, ExtMap &ext) {
    if (c.kind == 1) {
        Buf &b = ext_of(ext, c.cid);
        if (b.off >= b.len) throw std::runtime_error("ext eof");
        return b.d[b.off++];
    }
    return (uint8_t)read_int(c, core, ext);
}

int32_t read_int(const Codec &c, Bits &core, ExtMap &ext) {
    switch (c.kind) {
        case 1: {
            Buf &b = ext_of(ext, c.cid);
            return itf8(b);
        }
        case 3: {
            if (c.hsingle) return c.hval;
            uint64_t code = 0;
            int ln = 0;
            for (;;) {
                code = (code << 1) | (uint64_t)core.read_bit();
                ln++;
                auto it = c.htab.find(((uint64_t)ln << 32) | code);
                if (it != c.htab.end()) return it->second;
                if (ln > 31) throw std::runtime_error("bad huffman");
            }
        }
        case 6:
            return (int32_t)core.read_bits(c.nbits) - c.offset;
        case 9: {
            int n = 0;
            while (core.read_bit() == 0) n++;
            int32_t v = 1;
            for (int i = 0; i < n; i++)
                v = (v << 1) | (int32_t)core.read_bit();
            return v - 1 - c.offset;
        }
        default:
            throw std::runtime_error("read_int on codec kind");
    }
}

std::vector<uint8_t> read_array(const Codec &c, Bits &core, ExtMap &ext) {
    if (c.kind == 5) {
        Buf &b = ext_of(ext, c.cid);
        int64_t end = b.off;
        while (end < b.len && b.d[end] != c.stop) end++;
        std::vector<uint8_t> out(b.d + b.off, b.d + end);
        b.off = end + 1;
        return out;
    }
    if (c.kind == 4) {
        int32_t n = read_int(*c.len_c, core, ext);
        if (n < 0) throw std::runtime_error("negative array len");
        std::vector<uint8_t> out;
        out.reserve(n);
        if (c.val_c->kind == 1) {
            Buf &b = ext_of(ext, c.val_c->cid);
            if (b.off + n > b.len) throw std::runtime_error("ext eof");
            out.assign(b.d + b.off, b.d + b.off + n);
            b.off += n;
        } else {
            for (int32_t i = 0; i < n; i++)
                out.push_back(read_byte(*c.val_c, core, ext));
        }
        return out;
    }
    throw std::runtime_error("read_array on codec kind");
}

void bulk_bytes(const Codec &c, Bits &core, ExtMap &ext, int32_t n,
                std::vector<uint8_t> &out) {
    if (n < 0) throw std::runtime_error("negative bulk length");
    out.resize(n);
    if (c.kind == 1) {
        Buf &b = ext_of(ext, c.cid);
        if (b.off + n > b.len) throw std::runtime_error("ext eof");
        memcpy(out.data(), b.d + b.off, n);
        b.off += n;
        return;
    }
    for (int32_t i = 0; i < n; i++) out[i] = read_byte(c, core, ext);
}

Codec parse_codec(Buf &b) {
    Codec c;
    int32_t codec_id = itf8(b);
    int32_t nparam = itf8(b);
    // the parameter-block length moves the cursor unconditionally at the
    // end — a corrupt negative/oversized value would park b.off out of
    // bounds for every later read
    if (nparam < 0 || b.off + nparam > b.len)
        throw std::runtime_error("bad codec param length");
    int64_t end = b.off + nparam;
    c.kind = codec_id;
    switch (codec_id) {
        case 0:
            b.off = end;
            break;
        case 1:
            c.cid = itf8(b);
            break;
        case 3: {
            int32_t nal = itf8(b);
            std::vector<int32_t> syms(nal);
            for (int32_t i = 0; i < nal; i++) syms[i] = itf8(b);
            int32_t nln = itf8(b);
            std::vector<int32_t> lens(nln);
            for (int32_t i = 0; i < nln; i++) lens[i] = itf8(b);
            if (nal == 1) {
                c.hsingle = true;
                c.hval = syms[0];
            } else {
                // canonical: sort by (length, symbol)
                std::vector<int> order(nal);
                for (int i = 0; i < nal; i++) order[i] = i;
                std::sort(order.begin(), order.end(), [&](int a, int bb) {
                    if (lens[a] != lens[bb]) return lens[a] < lens[bb];
                    return syms[a] < syms[bb];
                });
                uint64_t code = 0;
                int prev_len = 0;
                for (int i : order) {
                    int ln = lens[i];
                    code <<= (ln - prev_len);
                    prev_len = ln;
                    c.htab[((uint64_t)ln << 32) | code] = syms[i];
                    code++;
                }
            }
            break;
        }
        case 4: {
            c.len_c = std::make_unique<Codec>(parse_codec(b));
            c.val_c = std::make_unique<Codec>(parse_codec(b));
            break;
        }
        case 5: {
            if (b.off >= b.len) throw std::runtime_error("eof");
            c.stop = b.d[b.off++];
            c.cid = itf8(b);
            break;
        }
        case 6:
            c.offset = itf8(b);
            c.nbits = itf8(b);
            break;
        case 9:
            c.offset = itf8(b);
            break;
        default:
            throw std::runtime_error("unsupported codec id");
    }
    b.off = end;
    return c;
}

struct CompHeader {
    bool rn_preserved = true;
    bool ap_delta = true;
    uint8_t sub_matrix[5] = {0, 0, 0, 0, 0};
    std::vector<std::vector<std::pair<std::string, char>>> tag_lines;
    std::unordered_map<uint16_t, Codec> series;
    std::unordered_map<int32_t, Codec> tags;

    const Codec &S(const char *k) const {
        uint16_t key = ((uint16_t)(uint8_t)k[0] << 8) | (uint8_t)k[1];
        auto it = series.find(key);
        if (it == series.end())
            throw std::runtime_error(std::string("missing series ") + k);
        return it->second;
    }
};

CompHeader parse_comp_header(const uint8_t *raw, int64_t len) {
    CompHeader ch;
    Buf b{raw, len, 0};
    itf8(b);  // size
    int32_t nkeys = itf8(b);
    auto need = [&](int64_t nbytes) {
        if (nbytes < 0 || b.off + nbytes > b.len)
            throw std::runtime_error("comp header eof");
    };
    for (int32_t i = 0; i < nkeys; i++) {
        need(2);
        char k0 = (char)b.d[b.off], k1 = (char)b.d[b.off + 1];
        b.off += 2;
        if (k0 == 'R' && k1 == 'N') {
            need(1);
            ch.rn_preserved = b.d[b.off++] != 0;
        } else if (k0 == 'A' && k1 == 'P') {
            need(1);
            ch.ap_delta = b.d[b.off++] != 0;
        } else if (k0 == 'R' && k1 == 'R') {
            need(1);
            b.off++;  // reference-required flag: unused here
        } else if (k0 == 'S' && k1 == 'M') {
            need(5);
            memcpy(ch.sub_matrix, b.d + b.off, 5);
            b.off += 5;
        } else if (k0 == 'T' && k1 == 'D') {
            int32_t ln = itf8(b);
            need(ln);
            const uint8_t *blob = b.d + b.off;
            int64_t start = 0;
            for (int64_t p = 0; p <= ln; p++) {
                if (p == ln || blob[p] == 0) {
                    std::vector<std::pair<std::string, char>> line;
                    for (int64_t q = start; q + 2 < p; q += 3)
                        line.emplace_back(
                            std::string((const char *)blob + q, 2),
                            (char)blob[q + 2]);
                    if (p < ln || start < p) ch.tag_lines.push_back(line);
                    start = p + 1;
                }
            }
            b.off += ln;
        } else {
            throw std::runtime_error("unsupported preservation key");
        }
    }
    itf8(b);  // size
    int32_t n = itf8(b);
    for (int32_t i = 0; i < n; i++) {
        need(2);
        uint16_t key =
            ((uint16_t)b.d[b.off] << 8) | (uint16_t)b.d[b.off + 1];
        b.off += 2;
        ch.series.emplace(key, parse_codec(b));
    }
    itf8(b);  // size
    n = itf8(b);
    for (int32_t i = 0; i < n; i++) {
        int32_t key = itf8(b);
        ch.tags.emplace(key, parse_codec(b));
    }
    return ch;
}

struct CRec {
    std::string name;
    int32_t flag = 0, tid = -1, pos = 0, mapq = 0;
    int32_t mtid = -1, mpos = -1, isize = 0, rl = 0;
    std::vector<uint32_t> cigar;
    std::vector<uint8_t> seq;  // codes 0..4
    std::vector<uint8_t> qual;
    std::vector<uint8_t> aux;
};

void push_cig(std::vector<uint32_t> &cig, int64_t n, int op) {
    if (n <= 0) return;
    if (!cig.empty() && (int)(cig.back() & 0xF) == op)
        cig.back() += (uint32_t)(n << 4);
    else
        cig.push_back((uint32_t)((n << 4) | op));
}

inline uint8_t b2c(uint8_t ch) {
    switch (ch) {
        case 'A': return 1;
        case 'C': return 2;
        case 'G': return 3;
        case 'T': return 4;
        default: return 0;
    }
}

uint8_t sub_base(const uint8_t *sm, int ref_code, int code) {
    static const char SUB_ORDER[] = "ACGTN";
    static const char CODE2B[] = "NACGT";
    char r = CODE2B[ref_code];
    int ri = 4;
    for (int i = 0; i < 5; i++)
        if (SUB_ORDER[i] == r) { ri = i; break; }
    uint8_t byte = sm[ri];
    int k = 0;
    for (int i = 0; i < 5; i++) {
        char bch = SUB_ORDER[i];
        if (bch == r) continue;
        int rank = (byte >> (6 - 2 * k)) & 3;
        if (rank == code) return b2c((uint8_t)bch);
        k++;
    }
    return 0;
}

int64_t ref_span_of(const std::vector<uint32_t> &cig) {
    int64_t s = 0;
    for (uint32_t c : cig) {
        int op = c & 0xF;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
            s += c >> 4;
    }
    return s;
}

// serialized size of one record body
int64_t rec_size(const CRec &r) {
    int64_t l_seq = r.seq.size();
    return 32 + (int64_t)r.name.size() + 1 + 4 * (int64_t)r.cigar.size() +
           (l_seq + 1) / 2 + l_seq + (int64_t)r.aux.size();
}

uint8_t *emit_rec(const CRec &r, uint8_t *p) {
    static const uint8_t CODE2NIB[5] = {15, 1, 2, 4, 8};
    int64_t body = rec_size(r);
    int32_t v32 = (int32_t)body;
    memcpy(p, &v32, 4);
    p += 4;
    memcpy(p, &r.tid, 4);
    p += 4;
    memcpy(p, &r.pos, 4);
    p += 4;
    *p++ = (uint8_t)(r.name.size() + 1);
    *p++ = (uint8_t)r.mapq;
    uint16_t v16 = 0;  // bin
    memcpy(p, &v16, 2);
    p += 2;
    v16 = (uint16_t)r.cigar.size();
    memcpy(p, &v16, 2);
    p += 2;
    v16 = (uint16_t)r.flag;
    memcpy(p, &v16, 2);
    p += 2;
    v32 = (int32_t)r.seq.size();
    memcpy(p, &v32, 4);
    p += 4;
    memcpy(p, &r.mtid, 4);
    p += 4;
    memcpy(p, &r.mpos, 4);
    p += 4;
    memcpy(p, &r.isize, 4);
    p += 4;
    memcpy(p, r.name.data(), r.name.size());
    p += r.name.size();
    *p++ = 0;
    if (!r.cigar.empty()) {
        memcpy(p, r.cigar.data(), 4 * r.cigar.size());
        p += 4 * r.cigar.size();
    }
    int64_t l_seq = r.seq.size();
    for (int64_t i = 0; i < l_seq; i += 2) {
        uint8_t hi = CODE2NIB[r.seq[i]];
        uint8_t lo = (i + 1 < l_seq) ? CODE2NIB[r.seq[i + 1]] : 0;
        *p++ = (uint8_t)((hi << 4) | lo);
    }
    memcpy(p, r.qual.data(), l_seq);
    p += l_seq;
    if (!r.aux.empty()) {
        memcpy(p, r.aux.data(), r.aux.size());
        p += r.aux.size();
    }
    return p;
}

}  // namespace

namespace {

// Decode one slice. ext blocks are passed as a concatenated blob with
// n_ext (id, offset) pairs; offsets has n_ext+1 entries delimiting each
// block. References come as a per-tid table (multi-ref slices switch
// contigs per record via the RI series, CRAM 3.0 §8.5): n_refs
// (tid, offset) pairs into ref_blob, offsets n_refs+1 entries. Returns
// bytes written to out, -1 if out_cap too small (caller grows and
// retries), -2 on decode error.
int64_t decode_slice_impl(
    const uint8_t *ch_raw, int64_t ch_len, const uint8_t *core_d,
    int64_t core_len, int32_t n_ext, const int32_t *ext_ids,
    const int64_t *ext_offs, const uint8_t *ext_blob, int32_t s_ref,
    int32_t s_start, int32_t n_rec, int32_t n_refs,
    const int32_t *ref_tids, const int64_t *ref_offs,
    const uint8_t *ref_blob, uint8_t *out, int64_t out_cap) {
    try {
        CompHeader ch = parse_comp_header(ch_raw, ch_len);
        Bits core{core_d, core_len};
        ExtMap ext;
        for (int32_t i = 0; i < n_ext; i++)
            ext[ext_ids[i]] = Buf{ext_blob + ext_offs[i],
                                  ext_offs[i + 1] - ext_offs[i], 0};
        std::vector<CRec> recs(n_rec);
        std::vector<std::pair<int32_t, int32_t>> mate_links;
        int32_t prev_pos = s_start;
        std::vector<uint8_t> tmp;
        for (int32_t ridx = 0; ridx < n_rec; ridx++) {
            CRec &r = recs[ridx];
            int32_t bf = read_int(ch.S("BF"), core, ext);
            int32_t cf = read_int(ch.S("CF"), core, ext);
            r.tid = s_ref;
            if (s_ref == -2) r.tid = read_int(ch.S("RI"), core, ext);
            const uint8_t *ref_codes = nullptr;
            int64_t ref_len = 0;
            for (int32_t q = 0; q < n_refs; q++) {
                if (ref_tids[q] == r.tid) {
                    ref_codes = ref_blob + ref_offs[q];
                    ref_len = ref_offs[q + 1] - ref_offs[q];
                    break;
                }
            }
            r.rl = read_int(ch.S("RL"), core, ext);
            if (r.rl < 0 || r.rl > (1 << 27))
                throw std::runtime_error("bad read length");
            int32_t ap = read_int(ch.S("AP"), core, ext);
            int32_t pos1;
            if (ch.ap_delta) {
                pos1 = prev_pos + ap;
                prev_pos = pos1;
            } else pos1 = ap;
            read_int(ch.S("RG"), core, ext);
            if (ch.rn_preserved) {
                auto nm = read_array(ch.S("RN"), core, ext);
                r.name.assign(nm.begin(), nm.end());
            } else {
                r.name = "r" + std::to_string(ridx);
            }
            int32_t flag_extra = 0;
            if (cf & 0x2) {  // detached
                int32_t mf = read_int(ch.S("MF"), core, ext);
                if (!ch.rn_preserved) {
                    auto nm = read_array(ch.S("RN"), core, ext);
                    r.name.assign(nm.begin(), nm.end());
                }
                if (mf & 1) flag_extra |= 0x20;
                if (mf & 2) flag_extra |= 0x8;
                r.mtid = read_int(ch.S("NS"), core, ext);
                int32_t np = read_int(ch.S("NP"), core, ext);
                r.mpos = np > 0 ? np - 1 : -1;
                r.isize = read_int(ch.S("TS"), core, ext);
            } else if (cf & 0x4) {  // mate downstream
                int32_t nf = read_int(ch.S("NF"), core, ext);
                mate_links.emplace_back(ridx, ridx + nf + 1);
            }
            int32_t tl = read_int(ch.S("TL"), core, ext);
            if (tl >= 0 && tl < (int32_t)ch.tag_lines.size()) {
                for (auto &tt : ch.tag_lines[tl]) {
                    int32_t key = ((int32_t)(uint8_t)tt.first[0] << 16) |
                                  ((int32_t)(uint8_t)tt.first[1] << 8) |
                                  (int32_t)(uint8_t)tt.second;
                    auto it = ch.tags.find(key);
                    if (it == ch.tags.end())
                        throw std::runtime_error("missing tag codec");
                    auto val = read_array(it->second, core, ext);
                    r.aux.push_back((uint8_t)tt.first[0]);
                    r.aux.push_back((uint8_t)tt.first[1]);
                    r.aux.push_back((uint8_t)tt.second);
                    r.aux.insert(r.aux.end(), val.begin(), val.end());
                }
            }
            r.seq.assign(r.rl, 0);
            r.qual.assign(r.rl, 0);
            if (!(bf & 4)) {
                int32_t fn = read_int(ch.S("FN"), core, ext);
                // features
                int64_t out_i = 0, ref_i = pos1 - 1;
                int32_t fpos = 0;
                auto fill_match = [&](int64_t nmatch) {
                    if (nmatch <= 0) return;
                    if (out_i + nmatch > (int64_t)r.rl)
                        throw std::runtime_error("feature overflow");
                    if (ref_codes) {
                        // clamp both ends: corrupt positions/AP deltas
                        // can drive ref_i negative or past the contig
                        int64_t k0 = ref_i < 0 ? 0 : ref_i;
                        int64_t end = ref_i + nmatch;
                        if (end > ref_len) end = ref_len;
                        for (int64_t k = k0; k < end; k++)
                            r.seq[out_i + (k - ref_i)] = ref_codes[k];
                    }
                    push_cig(r.cigar, nmatch, 0);
                    out_i += nmatch;
                    ref_i += nmatch;
                };
                auto need = [&](int64_t nbytes) {
                    if (nbytes < 0 || out_i + nbytes > (int64_t)r.rl)
                        throw std::runtime_error("feature overflow");
                };
                for (int32_t f = 0; f < fn; f++) {
                    uint8_t fc = read_byte(ch.S("FC"), core, ext);
                    fpos += read_int(ch.S("FP"), core, ext);
                    fill_match((int64_t)fpos - 1 - out_i);
                    switch (fc) {
                        case 'B': {
                            uint8_t bb = read_byte(ch.S("BA"), core, ext);
                            uint8_t q = read_byte(ch.S("QS"), core, ext);
                            need(1);
                            r.seq[out_i] = b2c(bb);
                            r.qual[out_i] = q;
                            push_cig(r.cigar, 1, 0);
                            out_i++;
                            ref_i++;
                            break;
                        }
                        case 'X': {
                            int32_t code =
                                read_int(ch.S("BS"), core, ext);
                            int rb = (ref_codes && ref_i < ref_len &&
                                      ref_i >= 0)
                                         ? ref_codes[ref_i]
                                         : 0;
                            need(1);
                            r.seq[out_i] =
                                sub_base(ch.sub_matrix, rb, code);
                            push_cig(r.cigar, 1, 0);
                            out_i++;
                            ref_i++;
                            break;
                        }
                        case 'S': {
                            auto sc = read_array(ch.S("SC"), core, ext);
                            need((int64_t)sc.size());
                            for (size_t k = 0; k < sc.size(); k++)
                                r.seq[out_i + k] = b2c(sc[k]);
                            push_cig(r.cigar, sc.size(), 4);
                            out_i += sc.size();
                            break;
                        }
                        case 'I': {
                            auto in = read_array(ch.S("IN"), core, ext);
                            need((int64_t)in.size());
                            for (size_t k = 0; k < in.size(); k++)
                                r.seq[out_i + k] = b2c(in[k]);
                            push_cig(r.cigar, in.size(), 1);
                            out_i += in.size();
                            break;
                        }
                        case 'i': {
                            uint8_t bb = read_byte(ch.S("BA"), core, ext);
                            need(1);
                            r.seq[out_i] = b2c(bb);
                            push_cig(r.cigar, 1, 1);
                            out_i++;
                            break;
                        }
                        case 'D': {
                            int32_t dl = read_int(ch.S("DL"), core, ext);
                            push_cig(r.cigar, dl, 2);
                            ref_i += dl;
                            break;
                        }
                        case 'N': {
                            int32_t v = read_int(ch.S("RS"), core, ext);
                            push_cig(r.cigar, v, 3);
                            ref_i += v;
                            break;
                        }
                        case 'H': {
                            int32_t v = read_int(ch.S("HC"), core, ext);
                            push_cig(r.cigar, v, 5);
                            break;
                        }
                        case 'P': {
                            int32_t v = read_int(ch.S("PD"), core, ext);
                            push_cig(r.cigar, v, 6);
                            break;
                        }
                        case 'Q': {
                            uint8_t q = read_byte(ch.S("QS"), core, ext);
                            r.qual[out_i ? out_i - 1 : 0] = q;
                            break;
                        }
                        case 'q': {
                            auto qq = read_array(ch.S("QQ"), core, ext);
                            (void)qq;  // scores applied via QS bulk below
                            break;
                        }
                        case 'b': {
                            auto bb2 = read_array(ch.S("BB"), core, ext);
                            need((int64_t)bb2.size());
                            for (size_t k = 0; k < bb2.size(); k++)
                                r.seq[out_i + k] = b2c(bb2[k]);
                            push_cig(r.cigar, bb2.size(), 0);
                            out_i += bb2.size();
                            ref_i += bb2.size();
                            break;
                        }
                        default:
                            throw std::runtime_error("CRAM feature");
                    }
                }
                fill_match((int64_t)r.rl - out_i);
                r.mapq = read_int(ch.S("MQ"), core, ext);
                if (cf & 0x1) {
                    bulk_bytes(ch.S("QS"), core, ext, r.rl, tmp);
                    r.qual = tmp;
                }
            } else {
                if (!(cf & 0x8)) {
                    bulk_bytes(ch.S("BA"), core, ext, r.rl, tmp);
                    for (int32_t k = 0; k < r.rl; k++)
                        r.seq[k] = b2c(tmp[k]);
                }
                if (cf & 0x1) {
                    bulk_bytes(ch.S("QS"), core, ext, r.rl, tmp);
                    r.qual = tmp;
                }
            }
            r.flag = (bf & 0xFFF) | flag_extra;
            r.pos = pos1 - 1;
        }
        for (auto &ml : mate_links) {
            if (ml.second < n_rec) {
                CRec &a = recs[ml.first];
                CRec &b = recs[ml.second];
                a.mtid = b.tid;
                a.mpos = b.pos;
                b.mtid = a.tid;
                b.mpos = a.pos;
                int64_t left = a.pos < b.pos ? a.pos : b.pos;
                int64_t ra = a.pos + ref_span_of(a.cigar);
                int64_t rb = b.pos + ref_span_of(b.cigar);
                int64_t right = ra > rb ? ra : rb;
                a.isize = (a.pos <= b.pos) ? (int32_t)(right - left)
                                           : (int32_t)(left - right);
                b.isize = -a.isize;
            }
        }
        int64_t total = 0;
        for (auto &r : recs) total += 4 + rec_size(r);
        if (total > out_cap) return -1;
        uint8_t *p = out;
        for (auto &r : recs) p = emit_rec(r, p);
        return p - out;
    } catch (...) {
        return -2;
    }
}

}  // namespace

extern "C" {

// Single-ref entry (historic ABI): the slice's one contig, or NULL for
// no-reference decoding.
int64_t bsc_cram_decode_slice(
    const uint8_t *ch_raw, int64_t ch_len, const uint8_t *core_d,
    int64_t core_len, int32_t n_ext, const int32_t *ext_ids,
    const int64_t *ext_offs, const uint8_t *ext_blob, int32_t s_ref,
    int32_t s_start, int32_t n_rec, const uint8_t *ref_codes,
    int64_t ref_len, uint8_t *out, int64_t out_cap) {
    int64_t offs[2] = {0, ref_len};
    return decode_slice_impl(
        ch_raw, ch_len, core_d, core_len, n_ext, ext_ids, ext_offs,
        ext_blob, s_ref, s_start, n_rec, ref_codes ? 1 : 0, &s_ref,
        offs, ref_codes, out, out_cap);
}

// Multi-ref entry: per-tid reference table for s_ref == -2 slices
// (and any slice whose records span several contigs).
int64_t bsc_cram_decode_slice_mref(
    const uint8_t *ch_raw, int64_t ch_len, const uint8_t *core_d,
    int64_t core_len, int32_t n_ext, const int32_t *ext_ids,
    const int64_t *ext_offs, const uint8_t *ext_blob, int32_t s_ref,
    int32_t s_start, int32_t n_rec, int32_t n_refs,
    const int32_t *ref_tids, const int64_t *ref_offs,
    const uint8_t *ref_blob, uint8_t *out, int64_t out_cap) {
    return decode_slice_impl(
        ch_raw, ch_len, core_d, core_len, n_ext, ext_ids, ext_offs,
        ext_blob, s_ref, s_start, n_rec, n_refs, ref_tids, ref_offs,
        ref_blob, out, out_cap);
}

}  // extern "C"
