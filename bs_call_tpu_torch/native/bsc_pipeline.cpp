// bsc_pipeline: native ingest-to-pileup pipeline.
//
// Full C++ port of the host-side calling pipeline, replacing the
// per-record Python path for throughput: record classification
// (pipeline/reads.py <- input_sam.c:222-312), mate pairing / duplicate
// selection / block building (pipeline/blocks.py <-
// get_template_vector.c:49-389), template normalization
// (pipeline/template.py <- read_utils.c, al_utils.c, process_template.c)
// and pileup + methylation-profile accumulation (ops/pileup.py,
// stats/meth_profile.py <- call_genotypes.c:180-226, meth_profile.c).
// The Python implementations remain the behavioral reference; tests assert
// bit-identical pileup tensors and stats from both paths.

#include "bsc_common.h"

#include <cctype>
#include <cmath>
#include <cstdlib>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using namespace bsc;

constexpr uint16_t FPAIRED = 1, FPROPER = 2, FUNMAP = 4, FMUNMAP = 8,
                   FREVERSE = 16, FREAD2 = 128, FSECONDARY = 256,
                   FQCFAIL = 512, FDUP = 1024, FSUPPL = 2048;

// gt_filter_reason indices (constants.py / bs_call.h:50)
enum {
    R_NONE = 0, R_UNMAPPED, R_QC, R_SECONDARY, R_MATE_UNMAPPED, R_DUPLICATE,
    R_NOPOS, R_NOMATEPOS, R_MISMATCH_CHR, R_ORIENTATION, R_INSERT_SIZE,
    R_NOSEQ, R_MAPQ, R_NOT_CORRECTLY_ALIGNED, R_PAIR_NOT_FOUND
};

enum MismsType : uint8_t { M_MISMS = 0, M_INS = 1, M_DEL = 2, M_SOFT = 3 };

struct Misms {
    uint8_t type;
    int64_t position;
    int64_t size;
};

struct Align {
    uint32_t fwd_pos = 0, rev_pos = 0;
    uint32_t ref_span[2] = {0, 0};
    bool has_read[2] = {false, false};
    std::vector<uint8_t> read[2];
    std::vector<Misms> misms[2];
    uint8_t mapq[2] = {0, 0};
    uint8_t orientation = 0, bs_strand = 0;
    std::vector<int32_t> orig_pos[2];
    // partial-block staging state (settled-prefix handover)
    bool processed = false;   // trims/overlap/normalize applied
    bool meth_done = false;   // meth profile contribution recorded
    int64_t norm_mp = 0;      // normalize() result (profile row bound)
    int64_t end_pos = 0;      // max ref position covered (post-normalize)

    void clear() {
        fwd_pos = rev_pos = 0;
        ref_span[0] = ref_span[1] = 0;
        has_read[0] = has_read[1] = false;
        read[0].clear();
        read[1].clear();
        misms[0].clear();
        misms[1].clear();
        orig_pos[0].clear();
        orig_pos[1].clear();
        mapq[0] = mapq[1] = 0;
        orientation = bs_strand = 0;
        processed = meth_done = false;
        norm_mp = 0;
        end_pos = 0;
    }

    int64_t start_min() const {
        if (fwd_pos && rev_pos)
            return fwd_pos < rev_pos ? fwd_pos : rev_pos;
        return fwd_pos ? fwd_pos : rev_pos;
    }
};

struct Config {
    int mapq_thresh = 20;
    int64_t max_template_len = 1000;
    int min_qual = 20;
    bool keep_unmatched = false;
    bool ignore_dup = false;
    bool keep_dup = false;
    bool quirks = true;
    int left_trim[2] = {0, 0};
    int right_trim[2] = {0, 0};
};

struct Stats {
    int64_t filter_cts[15] = {0};
    int64_t filter_bases[15] = {0};
    int64_t base_filter[5] = {0};
};

struct HashEntry {
    Align *al;
    uint16_t flag;
    size_t ix;
    std::string tag;
};

struct ClassifyResult {
    bool skip;
    int filtered;
    bool reverse;
    uint32_t align_length;
    uint16_t flag;
};

// ---- per-record classification (pipeline/reads.py) ----

ClassifyResult classify(const RawRec &rec, Align &al, const Config &cfg) {
    ClassifyResult res{false, R_NONE, false, 0, rec.flag};
    int filtered = R_NONE;
    uint16_t flag = rec.flag;
    if ((flag & FPAIRED) && !cfg.keep_unmatched) {
        uint16_t bad = flag & (FPROPER | FUNMAP | FMUNMAP | FQCFAIL |
                               FSECONDARY | FSUPPL | FDUP);
        if (bad != FPROPER) {
            if (flag & (FSECONDARY | FSUPPL)) filtered = R_SECONDARY;
            else if (flag & FUNMAP) filtered = R_UNMAPPED;
            else if (flag & FMUNMAP) filtered = R_MATE_UNMAPPED;
            else if (flag & FQCFAIL) filtered = R_QC;
            else if (flag & FDUP) {
                if (!cfg.ignore_dup) filtered = R_DUPLICATE;
            } else filtered = R_NOT_CORRECTLY_ALIGNED;
        }
    } else {
        if (flag & (FUNMAP | FQCFAIL | FSECONDARY | FSUPPL | FDUP)) {
            if (flag & (FSECONDARY | FSUPPL)) filtered = R_SECONDARY;
            else if (flag & FUNMAP) filtered = R_UNMAPPED;
            else if (flag & FQCFAIL) filtered = R_QC;
            else if (flag & FDUP) filtered = R_DUPLICATE;
        }
    }
    // corrupt/garbage coordinates (< -1) would wrap to huge unsigned
    // positions and hold blocks open across the whole coordinate space
    if (!filtered && rec.pos < -1) filtered = R_NOPOS;
    if (!filtered && (flag & FPAIRED) && rec.mpos < -1)
        filtered = R_NOMATEPOS;
    bool mis_matched = (flag & (FMUNMAP | FPROPER)) != FPROPER;
    bool reverse = flag & FREVERSE;
    bool second = flag & FREAD2;
    al.orientation = ((second && reverse) || !(second || reverse)) ? 0 : 1;
    bool mult_seg = (flag & (FPAIRED | FMUNMAP)) == FPAIRED;
    if (reverse) {
        al.fwd_pos = rec.mpos + 1;
        al.rev_pos = rec.pos + 1;
        al.mapq[1] = rec.mapq;
    } else {
        al.fwd_pos = rec.pos + 1;
        al.rev_pos = rec.mpos + 1;
        al.mapq[0] = rec.mapq;
    }
    if (rec.mapq < cfg.mapq_thresh && !filtered) filtered = R_MAPQ;
    uint16_t aflag = flag;
    if (mult_seg) {
        if (rec.tid != rec.mtid) {
            if (!filtered) filtered = R_MISMATCH_CHR;
            if (cfg.keep_unmatched) mis_matched = true;
        }
        if (!filtered) {
            if (llabs((long long)rec.isize) > cfg.max_template_len) {
                filtered = R_INSERT_SIZE;
                if (cfg.keep_unmatched) mis_matched = true;
            }
        }
        if (!filtered && !reverse &&
            (long long)rec.mpos - (long long)rec.pos >
                cfg.max_template_len) {
            // field-consistency bound: a legal pair with |isize| <=
            // max_template_len cannot have its mate further than that
            // downstream; corrupt mpos values would otherwise hold the
            // block open across the gap and grow it without limit
            filtered = R_INSERT_SIZE;
            if (cfg.keep_unmatched) mis_matched = true;
        }
        if (reverse) {
            if (rec.pos < rec.mpos) {
                if (!filtered) filtered = R_ORIENTATION;
                if (cfg.keep_unmatched) mis_matched = true;
            }
            if (mis_matched) al.fwd_pos = 0;
        } else {
            if (rec.pos > rec.mpos) {
                if (!filtered) filtered = R_ORIENTATION;
                if (cfg.keep_unmatched) mis_matched = true;
            }
            if (mis_matched) al.rev_pos = 0;
        }
    }
    if (!mult_seg || mis_matched) aflag &= ~FPAIRED;
    bool skip = false;
    if (filtered) {
        if (!(cfg.keep_unmatched &&
              (filtered == R_INSERT_SIZE || filtered == R_MISMATCH_CHR ||
               filtered == R_ORIENTATION)))
            skip = true;
    }
    uint32_t align_length = 0;
    if (!skip) {
        int ix = reverse ? 1 : 0;
        // CIGAR decode (pipeline/reads.py cigar_to_misms)
        uint32_t position = 0, span = 0;
        al.misms[ix].clear();
        for (int i = 0; i < rec.n_cigar; i++) {
            uint32_t w = rec.cigar[i];
            uint32_t len = w >> 4;
            switch (w & 0xF) {
            case 0: case 7: case 8:  // M, =, X
                position += len;
                span += len;
                break;
            case 4: case 6:  // S, P (quirk: P treated like S)
                al.misms[ix].push_back({M_SOFT, position, len});
                position += len;
                break;
            case 1:  // I -> stored DEL
                al.misms[ix].push_back({M_DEL, position, len});
                position += len;
                break;
            case 2:  // D -> stored INS
                al.misms[ix].push_back({M_INS, position, len});
                span += len;
                break;
            default:
                break;  // N, H ignored
            }
        }
        al.ref_span[ix] = span;
        align_length = position;
        if (position != (uint32_t)rec.l_seq) {
            // read-consuming CIGAR ops must cover the sequence exactly
            // (the htslib invariant); corrupt CIGARs would otherwise
            // drive out-of-range erases in trim/normalize. The P-as-S
            // quirk counts P here, matching the downstream arithmetic.
            skip = true;
            if (!filtered) filtered = R_NOT_CORRECTLY_ALIGNED;
            res.skip = true;
            res.filtered = filtered;
            res.reverse = reverse;
            res.align_length = 0;
            res.flag = aflag;
            return res;
        }
        // pack_read's LUT expansion writes whole byte pairs: reserve
        // the rounded-up capacity, then shrink to the true length
        al.read[ix].resize(pack_read_cap(rec.l_seq));
        pack_read(rec, al.read[ix].data());
        al.read[ix].resize(rec.l_seq);
        al.has_read[ix] = true;
        al.bs_strand = scan_bs_strand(rec.aux, rec.aux_end);
    }
    res.skip = skip;
    res.filtered = filtered;
    res.reverse = reverse;
    res.align_length = align_length;
    res.flag = aflag;
    return res;
}

// ---- duplicate tie-break (pipeline/alignments.py get_al_qual) ----

int64_t get_al_qual(const Align &al, bool quirks) {
    int64_t qual = 0, n = 0;
    for (int k = 0; k < 2; k++) {
        if (!al.has_read[k] || al.read[k].empty()) continue;
        int64_t rl = al.read[k].size();
        if (quirks) {
            if (k < rl) {
                int q = al.read[k][k] >> 2;
                if (q != FLT_QUAL) {
                    qual += (int64_t)q * rl;
                    n += rl;
                }
            }
        } else {
            for (uint8_t b : al.read[k]) {
                int q = b >> 2;
                if (q != FLT_QUAL) {
                    qual += q;
                    n++;
                }
            }
        }
    }
    return n > 0 ? qual / n : 0;
}

// ---- template normalization (pipeline/template.py) ----

void trim_read_mask(std::vector<uint8_t> &rd, int left, int right) {
    int64_t rl = rd.size();
    for (int64_t k = 0; k < left && k < rl; k++)
        rd[k] = (rd[k] & 3) | (FLT_QUAL << 2);
    for (int64_t k = 0; k < right && k < rl; k++)
        rd[rl - k - 1] = (rd[rl - k - 1] & 3) | (FLT_QUAL << 2);
}

void trim_soft_clips(Align &al, Stats *st, int64_t tl[2], int64_t tr[2]) {
    for (int k = 0; k < 2; k++) {
        if (!al.has_read[k] || al.read[k].empty()) continue;
        int64_t rl = al.read[k].size();
        auto &misms = al.misms[k];
        int nclip = 0;
        int64_t adj = 0;
        std::vector<Misms> kept;
        for (size_t z = 0; z < misms.size(); z++) {
            Misms m = misms[z];
            if (m.type == M_SOFT) {
                nclip++;
                if (m.position == 0) {
                    adj = m.size;
                    if (st) st->base_filter[2] += adj;
                    al.read[k].erase(al.read[k].begin(),
                                     al.read[k].begin() + adj);
                    tl[k] = adj;
                } else {
                    al.read[k].resize(al.read[k].size() - m.size);
                    tr[k] = m.size;
                    if (st) st->base_filter[2] += m.size;
                }
            } else {
                if (nclip) m.position -= adj;
                kept.push_back(m);
            }
        }
        misms = kept;
        (void)rl;
    }
}

int64_t mean_qual(const std::vector<uint8_t> &rd) {
    int64_t s = 0, n = 0;
    for (uint8_t b : rd) {
        int q = b >> 2;
        if (q != FLT_QUAL) {
            s += q;
            n++;
        }
    }
    return n ? s / n : 0;
}

void handle_overlap(Align &al, Stats *st, int64_t tl[2], int64_t tr[2]) {
    int64_t rdl[2] = {
        al.has_read[0] ? (int64_t)al.read[0].size() : 0,
        al.has_read[1] ? (int64_t)al.read[1].size() : 0,
    };
    if (!(rdl[0] > 0 && rdl[1] > 0)) return;
    int64_t overlap;
    bool rev;
    if (al.fwd_pos <= al.rev_pos) {
        overlap = (int64_t)al.ref_span[0] - al.rev_pos + al.fwd_pos;
        rev = false;
    } else {
        overlap = (int64_t)al.ref_span[1] + al.rev_pos - al.fwd_pos;
        rev = true;
    }
    if (al.fwd_pos + al.ref_span[0] < al.rev_pos) return;

    int tr_ix;
    if (al.ref_span[0] > al.ref_span[1]) tr_ix = 1;
    else if (al.ref_span[0] < al.ref_span[1]) tr_ix = 0;
    else tr_ix = mean_qual(al.read[0]) <= mean_qual(al.read[1]) ? 0 : 1;

    if (rev != (tr_ix == 1)) {
        if (tr_ix) al.rev_pos += overlap;
        else al.fwd_pos += overlap;
    }
    auto &misms = al.misms[tr_ix];
    auto &rd = al.read[tr_ix];
    bool right_case = (rev && tr_ix == 1) || !(rev || tr_ix == 1);
    auto right_trim = [&](int64_t n) {
        if (n > 0) {
            if (n >= (int64_t)rd.size()) rd.clear();
            else rd.resize(rd.size() - n);
        }
    };
    auto left_trim = [&](int64_t n) {
        if (n > 0) {
            if (n >= (int64_t)rd.size()) rd.clear();
            else rd.erase(rd.begin(), rd.begin() + n);
        }
    };
    if (misms.empty()) {
        if (right_case) right_trim(overlap);
        else left_trim(overlap);
    } else if (right_case) {
        int64_t xx = (int64_t)al.ref_span[tr_ix] - overlap;
        int64_t adj = 0;
        bool trimmed = false;
        for (size_t z = 0; z < misms.size(); z++) {
            Misms &m = misms[z];
            if (m.position + adj >= xx) {
                right_trim(rdl[tr_ix] - xx + adj);
                misms.resize(z);
                trimmed = true;
                break;
            }
            if (m.type == M_INS) {
                if (m.position + adj + m.size >= xx) {
                    int64_t trim = rdl[tr_ix] - m.position;
                    m.size = xx - (m.position + adj);
                    right_trim(trim);
                    misms.resize(z + 1);
                    trimmed = true;
                    break;
                }
                adj += m.size;
            } else if (m.type == M_DEL) adj -= m.size;
        }
        if (!trimmed) right_trim(overlap);
    } else {
        int64_t xx = overlap;
        int64_t adj = 0;
        bool trimmed = false;
        for (size_t z = 0; z < misms.size(); z++) {
            Misms &m = misms[z];
            if (m.position + adj >= xx) {
                int64_t trim = xx - adj;
                left_trim(trim);
                trimmed = true;
                for (size_t z1 = z; z1 < misms.size(); z1++)
                    misms[z1].position -= trim;
                misms.erase(misms.begin(), misms.begin() + z);
                break;
            }
            if (m.type == M_INS) {
                if (m.position + adj + m.size >= xx) {
                    m.size = m.position + m.size + adj - xx;
                    int64_t trim = m.position;
                    left_trim(trim);
                    trimmed = true;
                    size_t z2 = m.size ? z : z + 1;
                    for (size_t z1 = z2; z1 < misms.size(); z1++)
                        misms[z1].position -= trim;
                    misms.erase(misms.begin(), misms.begin() + z2);
                    break;
                }
                adj += m.size;
            } else if (m.type == M_DEL) adj -= m.size;
        }
        if (!trimmed) {
            left_trim(overlap - adj);
            misms.clear();
        }
    }
    int64_t rdl1[2] = {
        al.has_read[0] ? (int64_t)al.read[0].size() : 0,
        al.has_read[1] ? (int64_t)al.read[1].size() : 0,
    };
    if (st) st->base_filter[3] += (rdl[0] - rdl1[0]) + (rdl[1] - rdl1[1]);
    if (right_case) tr[tr_ix] += rdl[tr_ix] - rdl1[tr_ix];
    else tl[tr_ix] += rdl[tr_ix] - rdl1[tr_ix];
}

// indel normalization (process_template.c:66-111); returns max_pos
int64_t normalize(Align &al, const int64_t tl[2], const int64_t tr[2]) {
    int64_t max_pos = 0;
    for (int k = 0; k < 2; k++) {
        if (!al.has_read[k]) continue;
        auto &rd = al.read[k];
        int64_t rl = rd.size();
        auto &orig = al.orig_pos[k];
        orig.resize(rl);
        int64_t mpos;
        if (k) {
            int64_t posx = rl + tr[k] - 1;
            for (int64_t i = 0; i < rl; i++) orig[i] = posx - i;
            mpos = posx;
        } else {
            int64_t posx = tl[k];
            for (int64_t i = 0; i < rl; i++) orig[i] = posx + i;
            mpos = posx + rl;
        }
        if (mpos > max_pos) max_pos = mpos;
        int64_t adj = 0;
        for (auto &m : al.misms[k]) {
            int64_t ix1 = m.position + adj;
            if (m.type == M_INS) {
                rd.insert(rd.begin() + ix1, m.size, 0);
                orig.insert(orig.begin() + ix1, m.size, -1);
                adj += m.size;
            } else if (m.type == M_DEL) {
                rd.erase(rd.begin() + ix1, rd.begin() + ix1 + m.size);
                orig.erase(orig.begin() + ix1, orig.begin() + ix1 + m.size);
                adj -= m.size;
            }
        }
    }
    return max_pos;
}

// ---- the pipeline object ----

struct Pipeline {
    Reader *r = nullptr;
    Config cfg;
    Stats stats;
    bool collect_stats = false;
    int n_threads = 1;  // worker budget for stage-time parallel loops
    std::vector<int8_t> tid_keep;

    // block builder state
    std::vector<Align *> align_list;
    std::vector<HashEntry *> al_hash_list;
    std::unordered_map<std::string, HashEntry *> hash;
    std::vector<Align *> free_pool;
    std::vector<HashEntry *> hash_pool;
    int curr_tid = -1, old_tid = -1;
    bool chr_skip = false;
    uint32_t max_pos = 0, start_pos = 0, curr_pos = 0;
    uint32_t last_start = 0;  // sortedness enforcement (per contig)
    size_t start_idx = 0;
    Align *pending = nullptr;
    bool eof = false;

    // staged block
    std::vector<Align *> blk_list;
    int blk_tid = -1;
    uint32_t blk_x = 0, blk_y = 0;
    int64_t blk_max_pos = 0;
    int64_t blk_n_templates = 0;

    // partial staging (settled-prefix handover, docs/PERF.md): once the
    // open block spans > partial_limit settled positions, the prefix
    // below every pending pair and below the current dup window is
    // staged as a chunk (ranges overlap by 4 positions to match the
    // emitter's hold_back=2 streaming contract), and fully-consumed
    // aligns are recycled — bounding ingest memory on gap-free contigs
    int64_t partial_limit = 0;   // positions; 0 = off
    bool blk_partial = false;    // staged range is non-final
    bool blk_from_list = false;  // pileup/meth read align_list, not blk_list
    uint32_t part_x = 0;         // next range start (0 = fresh block)
    int64_t blk_meth_x = 0;      // ref anchor for this stage's meth profile
    int64_t partial_trigger = 0; // next record start worth attempting at

    // push mode: records arrive pre-decoded (raw BAM record layout) from
    // the host instead of through Reader — serves CRAM/SAM inputs
    bool push_mode = false;
    std::vector<uint8_t> pbuf;
    size_t ppos = 0;
    bool push_done = false;
    bool push_error = false;  // dropped bytes (OOM): stream is broken

    // SAM text mode: pushed bytes are SAM lines; each line is converted
    // to the raw BAM body layout in sam_buf (the reference's text parse
    // lives in htslib; this is the from-scratch equivalent)
    bool sam_mode = false;
    std::unordered_map<std::string, int32_t> ref_ids;
    std::vector<uint8_t> sam_buf;
    std::string sam_line;              // NUL-terminated line scratch
    std::vector<const char *> sam_fields;
    std::vector<int64_t> ref_lens;  // per-tid contig lengths (sanity cap)

    // indexed region mode (file input only): replay of the Python
    // _indexed_region_records generator (pipeline/runner.py) — per
    // region, seek to its BAI/CSI chunks and stream records overlapping
    // it, skipping records that start inside an earlier region of the
    // same contig (already yielded there). Mirrors the reference's
    // sam_itr_queryi loop (get_template_vector.c:69-101).
    struct RegSeg {
        int32_t tid;
        int64_t beg, end;  // 0-based half-open query window
        std::vector<std::pair<uint64_t, uint64_t>> chunks;  // voffsets
        std::vector<std::pair<int64_t, int64_t>> prev;  // 1-based incl.
    };
    std::vector<RegSeg> regions;
    bool region_mode = false;
    size_t reg_i = 0, chunk_i = 0;
    bool chunk_open = false;
    int32_t last_region_id = -1;  // sortedness tracking (blocks.py:196)
    int32_t rec_region_id = -1;   // region of the current record

    // stream region mode (any input kind, incl. push-mode CRAM/SAM and
    // non-seekable/non-indexed BAM): the sequential twin of the indexed
    // replay — the C++ port of blocks.region_filtered_records: each
    // record is kept iff it overlaps a region of its contig (first
    // match; a record spanning two regions passes once). The stream
    // stays coordinate-sorted after filtering, so no monotonicity
    // resets are needed (unlike the indexed per-region jumps).
    struct StreamReg {
        int64_t start, stop;  // 1-based inclusive (-C semantics)
    };
    std::unordered_map<int32_t, std::vector<StreamReg>> stream_regions;
    bool stream_region_mode = false;

    bool stream_region_pass(const RawRec &rec) const {
        auto it = stream_regions.find(rec.tid);
        if (it == stream_regions.end()) return false;
        int64_t start = (int64_t)rec.pos + 1;
        int64_t span = 0;
        for (int i = 0; i < rec.n_cigar; i++) {
            uint32_t v = rec.cigar[i];
            uint32_t op = v & 0xF;
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                span += v >> 4;
        }
        int64_t end = rec.n_cigar ? (int64_t)rec.pos + span : start;
        for (const StreamReg &rg : it->second)
            if (start <= rg.stop && end >= rg.start) return true;
        return false;
    }

    // 1 = record (rec_region_id set), 0 = end of regions, -2 = corrupt
    int next_region_record(RawRec &rec) {
        for (;;) {
            if (reg_i >= regions.size()) return 0;
            RegSeg &rg = regions[reg_i];
            if (chunk_i >= rg.chunks.size()) {
                reg_i++;
                chunk_i = 0;
                chunk_open = false;
                continue;
            }
            if (!chunk_open) {
                if (!r->open_chunk(rg.chunks[chunk_i].first,
                                   rg.chunks[chunk_i].second))
                    return -2;
                chunk_open = true;
            }
            if (!next_record(*r, rec)) {
                if (r->corrupt) return -2;
                chunk_i++;  // chunk exhausted
                chunk_open = false;
                continue;
            }
            // the query ends at the first record past the window
            // (coordinate-sorted input), like io/bai.py query()
            if (rec.tid != rg.tid || (int64_t)rec.pos >= rg.end) {
                reg_i++;
                chunk_i = 0;
                chunk_open = false;
                continue;
            }
            int64_t span = 0;
            for (int i = 0; i < rec.n_cigar; i++) {
                uint32_t v = rec.cigar[i];
                uint32_t op = v & 0xF;
                if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                    span += v >> 4;
            }
            if (span < 1) span = 1;
            if ((int64_t)rec.pos + span <= rg.beg) continue;  // no overlap
            int64_t p1 = (int64_t)rec.pos + 1;
            bool in_prev = false;
            for (auto &pv : rg.prev)
                if (pv.first <= p1 && p1 <= pv.second) {
                    in_prev = true;
                    break;
                }
            if (in_prev) continue;
            rec_region_id = (int32_t)reg_i;
            return 1;
        }
    }

    void push_bytes(const uint8_t *data, size_t len) {
        if (ppos) {  // compact consumed prefix
            pbuf.erase(pbuf.begin(), pbuf.begin() + ppos);
            ppos = 0;
        }
        pbuf.insert(pbuf.end(), data, data + len);
    }

    // 1 = record, 0 = starved (push more / push_eof), -1 = end of
    // input, -2 = corrupt stream (fatal, "SAM input truncated" analogue)
    int next_push_record(RawRec &rec) {
        if (push_error) return -2;
        if (sam_mode) return next_push_record_sam(rec);
        size_t avail = pbuf.size() - ppos;
        if (avail < 4) return push_done ? -1 : 0;
        uint32_t block_size;
        memcpy(&block_size, pbuf.data() + ppos, 4);
        if (block_size > (1u << 28)) return -2;
        if (avail < 4 + (size_t)block_size) return push_done ? -1 : 0;
        if (!validate_raw(pbuf.data() + ppos + 4, block_size)) return -2;
        parse_raw(pbuf.data() + ppos + 4, block_size, rec);
        ppos += 4 + block_size;
        return 1;
    }

    int next_push_record_sam(RawRec &rec) {
        for (;;) {
            size_t avail = pbuf.size() - ppos;
            if (avail == 0) return push_done ? -1 : 0;
            const uint8_t *base = pbuf.data() + ppos;
            const void *nl = memchr(base, '\n', avail);
            size_t linelen;
            if (!nl) {
                if (!push_done) return 0;
                linelen = avail;  // final line without newline
            } else {
                linelen = (const uint8_t *)nl - base;
            }
            ppos += linelen + (nl ? 1 : 0);
            const char *s = (const char *)base;
            size_t ll = linelen;
            if (ll && s[ll - 1] == '\r') ll--;
            if (ll == 0 || s[0] == '@') continue;
            if (sam_line_to_bam(s, s + ll)) {
                parse_raw(sam_buf.data(), (uint32_t)sam_buf.size(), rec);
                return 1;
            }
            // malformed mandatory field: fatal, like the BAM corrupt
            // path (the reference's htslib parser aborts on bad SAM) —
            // silently dropping a record would silently change outputs
            return -2;
        }
    }

    // Convert one SAM text line to the raw BAM body layout in sam_buf.
    bool sam_line_to_bam(const char *s_in, const char *end_in) {
        // NUL-terminated private copy: strtoll/strtof on raw buffer
        // slices could scan past the push buffer's end for a final line
        // without a newline
        sam_line.assign(s_in, end_in - s_in);
        const char *s = sam_line.c_str();
        const char *end = s + sam_line.size();
        // split ALL fields (a SAM record may carry many optional tags;
        // the bisulfite strand tag is frequently not the first one)
        sam_fields.clear();
        sam_fields.push_back(s);
        for (const char *p = s; p < end; p++)
            if (*p == '\t') sam_fields.push_back(p + 1);
        const char **f = sam_fields.data();
        int nf = (int)sam_fields.size();
        if (nf < 11) return false;
        auto fend = [&](int i) {
            return i + 1 < nf ? f[i + 1] - 1 : end;
        };
        auto to_int = [&](int i, long long &out) {
            char *e = nullptr;
            out = strtoll(f[i], &e, 10);
            return e == fend(i);
        };
        long long flag, pos, mapq, pnext, tlen;
        if (!to_int(1, flag) || !to_int(3, pos) || !to_int(4, mapq) ||
            !to_int(7, pnext) || !to_int(8, tlen))
            return false;
        // tid lookups
        auto lookup = [&](const char *b, const char *e2) -> int32_t {
            if (e2 - b == 1 && *b == '*') return -1;
            auto it = ref_ids.find(std::string(b, e2));
            return it == ref_ids.end() ? -1 : it->second;
        };
        int32_t tid = lookup(f[2], fend(2));
        int32_t mtid;
        if (fend(6) - f[6] == 1 && *f[6] == '=') mtid = tid;
        else mtid = lookup(f[6], fend(6));
        // cigar
        std::vector<uint32_t> cig;
        {
            const char *p = f[5], *e2 = fend(5);
            if (!(e2 - p == 1 && *p == '*')) {
                uint32_t n = 0;
                for (; p < e2; p++) {
                    char c = *p;
                    if (c >= '0' && c <= '9') {
                        n = n * 10 + (uint32_t)(c - '0');
                    } else {
                        static const char OPS[] = "MIDNSHP=X";
                        const char *q = strchr(OPS, c);
                        if (!q || n == 0) return false;
                        cig.push_back((n << 4) | (uint32_t)(q - OPS));
                        n = 0;
                    }
                }
                if (n) return false;
            }
        }
        // BAM framing limits: n_cigar is a u16 and mapq a u8 — values
        // beyond them would silently wrap and mis-frame seq/qual offsets
        if (cig.size() > 0xFFFF || mapq < 0 || mapq > 255 ||
            flag < 0 || flag > 0xFFFF)
            return false;
        const char *seq = f[9], *seq_e = fend(9);
        int32_t l_seq =
            (seq_e - seq == 1 && *seq == '*') ? 0 : (int32_t)(seq_e - seq);
        const char *qual = f[10], *qual_e = fend(10);
        bool no_qual = (qual_e - qual == 1 && *qual == '*');
        if (!no_qual && (int32_t)(qual_e - qual) != l_seq) return false;
        size_t name_len = (size_t)(fend(0) - f[0]);
        if (name_len == 0 || name_len > 254) return false;

        sam_buf.clear();
        sam_buf.reserve(64 + name_len + 4 * cig.size() + l_seq * 2);
        auto put32 = [&](int32_t v) {
            const uint8_t *b = (const uint8_t *)&v;
            sam_buf.insert(sam_buf.end(), b, b + 4);
        };
        auto put16 = [&](uint16_t v) {
            const uint8_t *b = (const uint8_t *)&v;
            sam_buf.insert(sam_buf.end(), b, b + 2);
        };
        put32(tid);
        put32((int32_t)pos - 1);
        sam_buf.push_back((uint8_t)(name_len + 1));
        sam_buf.push_back((uint8_t)mapq);
        put16(0);  // bin
        put16((uint16_t)cig.size());
        put16((uint16_t)flag);
        put32(l_seq);
        put32(mtid);
        put32((int32_t)pnext - 1);
        put32((int32_t)tlen);
        sam_buf.insert(sam_buf.end(), (const uint8_t *)f[0],
                       (const uint8_t *)f[0] + name_len);
        sam_buf.push_back(0);
        if (!cig.empty())
            sam_buf.insert(sam_buf.end(), (const uint8_t *)cig.data(),
                           (const uint8_t *)(cig.data() + cig.size()));
        // seq: 4-bit nibbles, =ACMGRSVTWYHKDBN
        static int8_t c2n[256];
        static bool c2n_init = false;
        if (!c2n_init) {
            memset(c2n, 15, sizeof(c2n));
            const char *SN = "=ACMGRSVTWYHKDBN";
            for (int i = 0; i < 16; i++) {
                c2n[(uint8_t)SN[i]] = (int8_t)i;
                c2n[(uint8_t)tolower(SN[i])] = (int8_t)i;
            }
            c2n_init = true;
        }
        for (int32_t k = 0; k < l_seq; k += 2) {
            uint8_t hi = (uint8_t)c2n[(uint8_t)seq[k]];
            uint8_t lo =
                (k + 1 < l_seq) ? (uint8_t)c2n[(uint8_t)seq[k + 1]] : 0;
            sam_buf.push_back((uint8_t)((hi << 4) | lo));
        }
        if (no_qual) {
            sam_buf.insert(sam_buf.end(), (size_t)l_seq, 0xFF);
        } else {
            for (int32_t k = 0; k < l_seq; k++)
                sam_buf.push_back((uint8_t)(qual[k] - 33));
        }
        // optional fields
        for (int i = 11; i < nf; i++) {
            const char *p = f[i], *e2 = fend(i);
            if (e2 - p < 5 || p[2] != ':' || p[4] != ':') continue;
            char typ = p[3];
            const char *v = p + 5;
            sam_buf.push_back((uint8_t)p[0]);
            sam_buf.push_back((uint8_t)p[1]);
            if (typ == 'A') {
                sam_buf.push_back('A');
                sam_buf.push_back((uint8_t)(v < e2 ? *v : 0));
            } else if (typ == 'i') {
                sam_buf.push_back('i');
                put32((int32_t)strtoll(v, nullptr, 10));
            } else if (typ == 'f') {
                sam_buf.push_back('f');
                float fv = strtof(v, nullptr);
                const uint8_t *b = (const uint8_t *)&fv;
                sam_buf.insert(sam_buf.end(), b, b + 4);
            } else if (typ == 'Z' || typ == 'H') {
                sam_buf.push_back((uint8_t)typ);
                sam_buf.insert(sam_buf.end(), (const uint8_t *)v,
                               (const uint8_t *)e2);
                sam_buf.push_back(0);
            } else if (typ == 'B' && v < e2) {
                sam_buf.push_back('B');
                char sub = *v;
                sam_buf.push_back((uint8_t)sub);
                std::vector<uint8_t> vals;
                uint32_t cnt = 0;
                const char *q = v + 1;
                while (q < e2 && *q == ',') {
                    q++;
                    char *qe = nullptr;
                    if (sub == 'f') {
                        float fv = strtof(q, &qe);
                        const uint8_t *b = (const uint8_t *)&fv;
                        vals.insert(vals.end(), b, b + 4);
                    } else {
                        long long iv = strtoll(q, &qe, 10);
                        int w = (sub == 'c' || sub == 'C') ? 1
                                : (sub == 's' || sub == 'S') ? 2 : 4;
                        const uint8_t *b = (const uint8_t *)&iv;
                        vals.insert(vals.end(), b, b + w);
                    }
                    q = qe;
                    cnt++;
                }
                const uint8_t *b = (const uint8_t *)&cnt;
                sam_buf.insert(sam_buf.end(), b, b + 4);
                sam_buf.insert(sam_buf.end(), vals.begin(), vals.end());
            } else {
                // unknown type: drop the two tag bytes we pushed
                sam_buf.resize(sam_buf.size() - 2);
            }
        }
        return true;
    }

    ~Pipeline() {
        release_block();
        for (Align *a : align_list) delete a;
        for (Align *a : free_pool) delete a;
        if (pending) delete pending;
        for (auto &kv : hash) delete kv.second;
        for (HashEntry *e : hash_pool) delete e;
        delete r;
    }

    Align *new_align() {
        if (!free_pool.empty()) {
            Align *a = free_pool.back();
            free_pool.pop_back();
            a->clear();
            return a;
        }
        return new Align();
    }

    HashEntry *new_hash(Align *al, uint16_t flag, size_t ix,
                        const std::string &tag) {
        HashEntry *e;
        if (!hash_pool.empty()) {
            e = hash_pool.back();
            hash_pool.pop_back();
        } else e = new HashEntry();
        e->al = al;
        e->flag = flag;
        e->ix = ix;
        e->tag = tag;
        return e;
    }

    void clear_hash() {
        for (auto &kv : hash) hash_pool.push_back(kv.second);
        hash.clear();
    }

    void release_block() {
        for (Align *a : blk_list) free_pool.push_back(a);
        blk_list.clear();
    }

    // --- block production (pipeline/blocks.py read_blocks) ---

    bool flush_to_block(int tid) {
        clear_hash();
        if (align_list.empty()) return false;
        blk_list = std::move(align_list);
        align_list.clear();
        al_hash_list.clear();
        blk_tid = tid;
        blk_y = max_pos;
        return true;
    }

    // 1 = block staged, 0 = end of input, 2 = starved (push mode only:
    // push more records or push_eof, then call again — builder state is
    // fully resident in members, so re-entry resumes mid-block)
    int next_block() {
        release_block();
        if (blk_from_list) {
            // the consumer is done with the partial range: recycle
            // aligns that no staged-range overlap can reach anymore
            blk_from_list = false;
            compact_align_list();
        }
        if (eof) return 0;
        Stats *st = collect_stats ? &stats : nullptr;
        for (;;) {
            RawRec rec;
            bool have_rec;
            if (push_mode) {
                int got = next_push_record(rec);
                if (got == 0) return 2;
                if (got == -2) return -1;  // corrupt stream
                have_rec = got > 0;
            } else if (region_mode) {
                int got = next_region_record(rec);
                if (got == -2) return -1;  // corrupt stream/seek
                have_rec = got > 0;
            } else {
                have_rec = next_record(*r, rec);
                if (!have_rec && r->corrupt) return -1;
            }
            if (!have_rec) {
                eof = true;
                return flush_to_block(curr_tid) ? (stage() ? 1 : 0) : 0;
            }
            // stream -C filter BEFORE classify: records outside every
            // region never touch filter stats, exactly like the Python
            // region_filtered_records wrapper (blocks.py:41-68)
            if (stream_region_mode && !stream_region_pass(rec)) continue;
            Align *al = pending ? pending : new_align();
            pending = nullptr;
            al->clear();
            ClassifyResult res;
            {
                BSC_PROF_SCOPE("ingest.classify");
                res = classify(rec, *al, cfg);
            }
            if (res.skip) {
                if (st) {
                    st->filter_cts[res.filtered]++;
                    st->filter_bases[res.filtered] += rec.l_seq;
                }
                pending = al;
                continue;
            }
            std::string tag(rec.name, rec.name_len);
            bool reverse = res.reverse;
            uint16_t aflag = res.flag;

            bool new_block = false, new_contig = false;
            if (curr_tid < 0 || curr_tid != rec.tid) {
                new_contig = new_block = true;
                chr_skip = false;
                old_tid = curr_tid;
                curr_tid = rec.tid;
                chr_skip = !(curr_tid >= 0 &&
                             curr_tid < (int)tid_keep.size() &&
                             tid_keep[curr_tid]);
            }
            bool insert = true;
            if (!(chr_skip || new_contig)) {
                if ((aflag & FPAIRED) && al->fwd_pos > 0 && al->rev_pos > 0) {
                    if (al->fwd_pos == al->rev_pos)
                        insert = hash.find(tag) == hash.end();
                    else if (reverse) insert = al->fwd_pos > al->rev_pos;
                    else insert = al->fwd_pos < al->rev_pos;
                }
                if (insert && start_pos > 0) {
                    if (al->fwd_pos > 0) {
                        if (al->fwd_pos > max_pos &&
                            (al->rev_pos > max_pos || al->rev_pos == 0)) {
                            if (al->fwd_pos - max_pos > 1) new_block = true;
                        }
                    } else if (al->rev_pos > max_pos &&
                               al->rev_pos - max_pos > 1)
                        new_block = true;
                }
            }
            bool have_block = false;
            int flush_tid = -1;
            if (new_block) {
                flush_tid = new_contig ? old_tid : curr_tid;
                have_block =
                    !align_list.empty() && flush_to_block(flush_tid);
                clear_hash();
                curr_pos = 0;
                start_idx = 0;
                if (new_contig && old_tid >= 0) old_tid = -1;
                max_pos = start_pos = 0;
            }
            if (chr_skip) {
                pending = al;
                if (have_block) return stage() ? 1 : 0;
                continue;
            }
            if (align_list.empty()) {
                // region tracking handled Python-side (native path is used
                // for whole-file runs)
            }
            uint32_t ml, stp;
            if (reverse) {
                ml = al->rev_pos + al->ref_span[1];
                stp = al->rev_pos;
            } else {
                ml = al->fwd_pos + al->ref_span[0];
                stp = al->fwd_pos;
            }
            if (curr_tid >= 0 && curr_tid < (int)ref_lens.size() &&
                ref_lens[curr_tid] > 0 &&
                (int64_t)ml > ref_lens[curr_tid] + (1 << 20)) {
                // a record "ending" >1Mb past its contig is corruption
                // (e.g. a flipped CIGAR byte making a 200Mb deletion);
                // accepting it would stage a block across the overshoot
                pending = al;
                return -1;
            }
            if (new_contig || (region_mode && rec_region_id !=
                               last_region_id)) {
                // region change: per-region streams restart the
                // monotonicity window (blocks.py:196-199 — a later
                // region's first record may start before the previous
                // region's last yielded start)
                last_start = 0;
                last_region_id = rec_region_id;
            }
            if (last_start && stp < last_start) {
                // input is contractually coordinate-sorted; a backwards
                // jump is corruption (and would grow the open block
                // without bound), so fail like the reference's
                // "SAM input truncated" fatal
                pending = al;
                return -1;
            }
            last_start = stp;
            if (ml > max_pos) max_pos = ml;
            if (start_pos == 0 || start_pos > stp) start_pos = stp;

            if (aflag & FPAIRED) {
                if (!insert) {
                    auto it = hash.find(tag);
                    if (it != hash.end()) {
                        HashEntry *th = it->second;
                        hash.erase(it);
                        int ix = reverse ? 1 : 0;
                        Align *tal = th->al;
                        std::swap(tal->read[ix], al->read[ix]);
                        std::swap(tal->has_read[ix], al->has_read[ix]);
                        tal->mapq[ix] = al->mapq[ix];
                        tal->ref_span[ix] = al->ref_span[ix];
                        std::swap(tal->misms[ix], al->misms[ix]);
                        al_hash_list[th->ix] = nullptr;
                        hash_pool.push_back(th);
                        pending = al;
                    } else {
                        if (st) {
                            st->filter_cts[R_PAIR_NOT_FOUND]++;
                            int ix = reverse ? 1 : 0;
                            st->filter_bases[R_PAIR_NOT_FOUND] +=
                                al->has_read[ix] ? al->read[ix].size() : 0;
                        }
                        bool al_skip = false;
                        if (!cfg.keep_dup) {
                            uint32_t x =
                                reverse ? al->rev_pos : al->fwd_pos;
                            if (x >= start_pos) al_skip = true;
                        }
                        if (!al_skip && cfg.keep_unmatched) {
                            uint32_t x = al->fwd_pos > 0
                                             ? al->fwd_pos + res.align_length
                                             : al->rev_pos + res.align_length;
                            if (x > max_pos) max_pos = x;
                            align_list.push_back(al);
                            al_hash_list.push_back(nullptr);
                        } else {
                            pending = al;
                        }
                    }
                } else {
                    bool al_skip = false;
                    if (!cfg.keep_dup) {
                        uint32_t pos =
                            al->fwd_pos > 0 ? al->fwd_pos : al->rev_pos;
                        if (pos == curr_pos) {
                            for (size_t ix = start_idx;
                                 ix < align_list.size(); ix++) {
                                Align *al1 = align_list[ix];
                                if (al->fwd_pos == al1->fwd_pos &&
                                    al->rev_pos == al1->rev_pos &&
                                    al->bs_strand == al1->bs_strand) {
                                    int64_t maxq = 0, kn = 0, maxq1 = 0,
                                            kn1 = 0;
                                    for (int s = 0; s < 2; s++) {
                                        if (al->has_read[s] &&
                                            !al->read[s].empty()) {
                                            maxq += al->mapq[s];
                                            kn++;
                                        }
                                        if (al1->has_read[s] &&
                                            !al1->read[s].empty()) {
                                            maxq1 += al1->mapq[s];
                                            kn1++;
                                        }
                                    }
                                    maxq /= kn ? kn : 1;
                                    maxq1 /= kn1 ? kn1 : 1;
                                    if (maxq1 < maxq ||
                                        (maxq == maxq1 &&
                                         get_al_qual(*al1, cfg.quirks) <
                                             get_al_qual(*al, cfg.quirks))) {
                                        auto it2 = hash.find(tag);
                                        HashEntry *th =
                                            it2 != hash.end() ? it2->second
                                                              : al_hash_list[ix];
                                        align_list[ix] = al;
                                        if (th) {
                                            hash.erase(th->tag);
                                            th->al = al;
                                            th->flag = aflag;
                                            th->ix = ix;
                                        } else
                                            th = new_hash(al, aflag, ix, tag);
                                        th->tag = tag;
                                        hash[tag] = th;
                                        al_hash_list[ix] = th;
                                        al = al1;
                                    }
                                    if (st) {
                                        int64_t l1 = al->has_read[0]
                                                         ? al->read[0].size()
                                                         : 0;
                                        int64_t l2 = al->has_read[1]
                                                         ? al->read[1].size()
                                                         : 0;
                                        bool paired = l1 && l2;
                                        st->filter_cts[R_DUPLICATE] +=
                                            paired ? 2 : 1;
                                        st->filter_bases[R_DUPLICATE] +=
                                            l1 + l2;
                                    }
                                    al_skip = true;
                                }
                            }
                        } else {
                            curr_pos = pos;
                            start_idx = align_list.size();
                        }
                    }
                    if (!al_skip) {
                        HashEntry *th =
                            new_hash(al, aflag, align_list.size(), tag);
                        hash[tag] = th;
                        align_list.push_back(al);
                        al_hash_list.push_back(th);
                    } else {
                        pending = al;
                    }
                }
            } else {
                bool al_skip = false;
                if (!cfg.keep_dup) {
                    uint32_t pos = al->fwd_pos > 0 ? al->fwd_pos : al->rev_pos;
                    if (pos == curr_pos) {
                        for (size_t ix = start_idx; ix < align_list.size();
                             ix++) {
                            Align *al1 = align_list[ix];
                            HashEntry *th = al_hash_list[ix];
                            if (al->fwd_pos == al1->fwd_pos &&
                                al->rev_pos == al1->rev_pos &&
                                al->bs_strand == al1->bs_strand &&
                                (th == nullptr || ((th->flag & 9) == 9 ||
                                                   (th->flag & 9) == 0))) {
                                if (al1->mapq[0] < al->mapq[0] ||
                                    (al1->mapq[0] == al->mapq[0] &&
                                     get_al_qual(*al1, cfg.quirks) <
                                         get_al_qual(*al, cfg.quirks))) {
                                    align_list[ix] = al;
                                    al = al1;
                                }
                                if (st) {
                                    st->filter_cts[R_DUPLICATE]++;
                                    int ix2 = reverse ? 1 : 0;
                                    st->filter_bases[R_NONE] +=
                                        al->has_read[ix2]
                                            ? al->read[ix2].size()
                                            : 0;
                                }
                                al_skip = true;
                            }
                        }
                    } else {
                        curr_pos = pos;
                        start_idx = align_list.size();
                    }
                }
                if (!al_skip) {
                    align_list.push_back(al);
                    al_hash_list.push_back(nullptr);
                } else {
                    pending = al;
                }
            }
            if (have_block) return stage() ? 1 : 0;
            if (try_stage_partial(stp)) return 1;
        }
    }

    // --- template normalization + block staging ---

    void process_align(Align *al, Stats *st) {
        int msk = al->orientation == 0 ? 0 : 1;
        if (cfg.left_trim[0] || cfg.right_trim[0])
            if (al->has_read[0 ^ msk])
                trim_read_mask(al->read[0 ^ msk], cfg.left_trim[0],
                               cfg.right_trim[0]);
        if (cfg.left_trim[1] || cfg.right_trim[1])
            if (al->has_read[1 ^ msk])
                trim_read_mask(al->read[1 ^ msk], cfg.left_trim[1],
                               cfg.right_trim[1]);
        int64_t tl[2] = {0, 0}, tr[2] = {0, 0};
        trim_soft_clips(*al, st, tl, tr);
        handle_overlap(*al, st, tl, tr);
        if (st) {
            for (int k = 0; k < 2; k++) {
                if (!al->has_read[k]) continue;
                for (uint8_t b : al->read[k]) {
                    int q = b >> 2;
                    if (q == FLT_QUAL) st->base_filter[1]++;
                    else if (q < cfg.min_qual) st->base_filter[4]++;
                    else st->base_filter[0]++;
                }
                st->filter_cts[R_NONE]++;
                st->filter_bases[R_NONE] += al->read[k].size();
            }
        }
        al->norm_mp = normalize(*al, tl, tr);
        al->end_pos = 0;
        for (int k = 0; k < 2; k++) {
            if (!al->has_read[k] || al->read[k].empty()) continue;
            int64_t s = k ? al->rev_pos : al->fwd_pos;
            int64_t e = s + (int64_t)al->read[k].size() - 1;
            if (e > al->end_pos) al->end_pos = e;
        }
        al->processed = true;
    }

    // process_align over a batch, split across n_threads workers. Each
    // align is independent; stats counters accumulate into per-thread
    // partials merged afterwards (integer sums — order-free), so the
    // result is identical to the sequential loop for any thread count.
    void process_aligns_mt(std::vector<Align *> &todo, Stats *st) {
        BSC_PROF_SCOPE("ingest.process_aligns");
        const size_t n = todo.size();
        int nt = n_threads < 1 ? 1 : n_threads;
        if ((size_t)nt * 512 > n) nt = (int)(n / 512) + 1;
        if (nt <= 1) {
            for (Align *al : todo) process_align(al, st);
            return;
        }
        std::vector<Stats> parts(st ? nt : 0);
        const size_t step = (n + nt - 1) / nt;
        bsc::pool_run(nt, [&](int w) {
            const size_t lo = w * step;
            const size_t hi = lo + step < n ? lo + step : n;
            Stats *pst = st ? &parts[w] : nullptr;
            for (size_t i = lo; i < hi; i++)
                process_align(todo[i], pst);
        });
        if (st) {
            for (const Stats &ps : parts) {
                for (int i = 0; i < 15; i++) {
                    st->filter_cts[i] += ps.filter_cts[i];
                    st->filter_bases[i] += ps.filter_bases[i];
                }
                for (int i = 0; i < 5; i++)
                    st->base_filter[i] += ps.base_filter[i];
            }
        }
    }

    // update this stage's meth-profile bookkeeping for one align about
    // to be profiled: row bound + leftmost ref position its FSM reads
    void meth_account(Align *al) {
        if (al->norm_mp > blk_max_pos) blk_max_pos = al->norm_mp;
        int64_t s0 = al->start_min();
        if (s0 > 1) s0 -= 1;  // FSM reads ref[pos-1]
        if (s0 < blk_meth_x) blk_meth_x = s0 > 0 ? s0 : 1;
    }

    bool stage() {
        // compute x (process_template.c:24-27 via runner); a partially
        // staged block continues at the overlap row
        Align *first = blk_list[0];
        uint32_t x = first->fwd_pos ? first->fwd_pos : first->rev_pos;
        blk_x = part_x ? part_x : (x > 2 ? x - 2 : 1);
        part_x = 0;
        partial_trigger = 0;
        blk_partial = false;
        blk_from_list = false;
        Stats *st = collect_stats ? &stats : nullptr;
        blk_max_pos = 0;
        blk_meth_x = blk_x;
        blk_n_templates = 0;
        std::vector<Align *> todo;
        todo.reserve(blk_list.size());
        for (Align *al : blk_list)
            if (!al->processed) todo.push_back(al);
        blk_n_templates = (int64_t)todo.size();
        process_aligns_mt(todo, st);
        for (Align *al : blk_list)
            if (!al->meth_done) meth_account(al);
        return true;
    }

    // Stage the settled prefix [part_x|block start, settle_y] of the open
    // block. Every align whose data can still change (pending mate, or
    // inside the current duplicate window) starts above settle_y, so the
    // staged pileup columns are final.
    void stage_partial(uint32_t settle_y, uint32_t stp_now) {
        Stats *st = collect_stats ? &stats : nullptr;
        blk_tid = curr_tid;
        blk_x = part_x ? part_x : (start_pos > 2 ? start_pos - 2 : 1);
        blk_y = settle_y;
        blk_partial = true;
        blk_from_list = true;
        blk_max_pos = 0;
        blk_meth_x = blk_x;
        blk_n_templates = 0;
        std::vector<Align *> todo;
        todo.reserve(align_list.size());
        for (size_t i = 0; i < align_list.size(); i++) {
            Align *al = align_list[i];
            if (!al->processed && al_hash_list[i] == nullptr &&
                (uint32_t)al->start_min() < stp_now)
                // resolved and below every record still to come: no
                // future record can dup-replace it (replacement needs
                // pos == align start, and future pos >= stp_now), so
                // its raw-byte dup comparisons are over and trimming/
                // normalization is final
                todo.push_back(al);
        }
        blk_n_templates = (int64_t)todo.size();
        process_aligns_mt(todo, st);
        for (Align *al : align_list) {
            if (al->processed && !al->meth_done &&
                al->end_pos <= (int64_t)blk_y)
                meth_account(al);
        }
        // next range re-supplies 2 context rows + the 2 held-back rows
        part_x = settle_y > 4 ? settle_y - 3 : 1;
    }

    // attempt a partial stage once the settled span is large enough;
    // returns true if a range was staged
    bool try_stage_partial(uint32_t stp_now) {
        if (partial_limit <= 0 || chr_skip || start_pos == 0) return false;
        if ((int64_t)stp_now < partial_trigger) return false;
        int64_t floor_x =
            part_x ? (int64_t)part_x
                   : (start_pos > 2 ? (int64_t)start_pos - 2 : 1);
        if ((int64_t)stp_now < floor_x + partial_limit + 8) {
            partial_trigger = floor_x + partial_limit + 8;
            return false;
        }
        // settle below every pending pair (their resolution may mutate or
        // extend the resident align)
        uint32_t cap = stp_now;
        for (size_t i = 0; i < align_list.size(); i++) {
            if (al_hash_list[i] == nullptr) continue;
            int64_t ps = align_list[i]->start_min();
            if (ps > 0 && (uint32_t)ps < cap) cap = (uint32_t)ps;
        }
        if ((int64_t)cap < floor_x + partial_limit + 8) {
            // pending pairs pin the prefix; retry a little later
            partial_trigger = (int64_t)stp_now + (partial_limit >> 2);
            return false;
        }
        stage_partial(cap - 2, stp_now);
        return true;
    }

    // recycle aligns fully consumed by staged ranges (called when the
    // consumer is done with the partial range)
    void compact_align_list() {
        size_t w = 0, removed_before = 0;
        for (size_t i = 0; i < align_list.size(); i++) {
            Align *al = align_list[i];
            HashEntry *th = al_hash_list[i];
            if (th == nullptr && al->processed &&
                al->end_pos < (int64_t)part_x) {
                free_pool.push_back(al);
                if (i < start_idx) removed_before++;
                continue;
            }
            align_list[w] = al;
            al_hash_list[w] = th;
            if (th) th->ix = w;
            w++;
        }
        align_list.resize(w);
        al_hash_list.resize(w);
        start_idx -= removed_before;
    }

    // --- pileup (ops/pileup.py <- call_genotypes.c:180-226) ---
    //
    // Threaded by POSITION range: each worker walks every align but
    // contributes only bases inside its own [plo, phi] columns, so the
    // per-position accumulation order (and therefore every float32
    // qual_sum rounding) is identical to the sequential loop for any
    // thread count.

    void pileup_range(int32_t *counts2, float *qual_sum, float *mapq2,
                      int64_t plo, int64_t phi) const {
        static const int8_t base_tab_st[3][4] = {
            {0, 1, 2, 3}, {0, 5, 2, 7}, {4, 1, 6, 3}};
        const std::vector<Align *> &src =
            blk_from_list ? align_list : blk_list;
        for (const Align *al : src) {
            // partial ranges: only processed aligns contribute (pending
            // ones start above blk_y anyway; unprocessed reads are not
            // yet in reference coordinates)
            if (!al->processed) continue;
            int ori = al->orientation;
            int stx = al->bs_strand;
            for (int k = 0; k < 2; k++, ori ^= 1) {
                if (!al->has_read[k] || al->read[k].empty()) continue;
                const auto &rd = al->read[k];
                int64_t rl = rd.size();
                int64_t rstart = (k ? al->rev_pos : al->fwd_pos);
                if (rstart > phi || rstart + rl <= plo) continue;
                int64_t rs = -1, re = -1;
                for (int64_t j = 0; j < rl; j++) {
                    int q = rd[j] >> 2;
                    if (q > 0 && q != FLT_QUAL) { rs = j; break; }
                }
                if (rs < 0) continue;
                for (int64_t j = rl; j > 0; j--) {
                    int q = rd[j - 1] >> 2;
                    if (q > 0 && q != FLT_QUAL) { re = j - 1; break; }
                }
                // clip below the range (prior partial ranges own those
                // columns; [plo, phi] is this worker's column span)
                if (rstart + rs < plo) rs = plo - rstart;
                if (rs > re) continue;
                int64_t pos = rstart + rs;
                float mq2 = (float)(al->mapq[k] * al->mapq[k]);
                for (int64_t j = rs; j <= re && pos <= phi;
                     j++, pos++) {
                    int q = rd[j] >> 2;
                    if (q >= cfg.min_qual && q != FLT_QUAL) {
                        int c = base_tab_st[stx][rd[j] & 3];
                        int64_t o = pos - blk_x;
                        counts2[o * 16 + ori * 8 + c]++;
                        qual_sum[o * 8 + c] += (float)q;
                        mapq2[o] += mq2;
                    }
                }
            }
        }
    }

    void pileup(int32_t *counts2, float *qual_sum, float *mapq2,
                int nthreads = 1) const {
        int64_t sz = (int64_t)blk_y - blk_x + 1;
        memset(counts2, 0, sizeof(int32_t) * sz * 16);
        memset(qual_sum, 0, sizeof(float) * sz * 8);
        memset(mapq2, 0, sizeof(float) * sz);
        int nt = nthreads < 1 ? 1 : nthreads;
        if ((int64_t)nt * 16384 > sz) nt = (int)(sz / 16384) + 1;
        if (nt <= 1) {
            pileup_range(counts2, qual_sum, mapq2, blk_x, blk_y);
            return;
        }
        const int64_t step = (sz + nt - 1) / nt;
        bsc::pool_run(nt, [&](int w) {
            int64_t plo = (int64_t)blk_x + w * step;
            int64_t phi = plo + step - 1;
            if (phi > (int64_t)blk_y) phi = blk_y;
            if (plo <= phi)
                pileup_range(counts2, qual_sum, mapq2, plo, phi);
        });
    }

    // --- normalized read-batch export (fused device pileup+call) ---
    // Rows are the exact (align, read-end) segments the pileup loop
    // above iterates, in the same order; starts are block-relative
    // (may be negative for reads straddling a partial-range boundary —
    // the device kernel's pos>=0 clip reproduces the blk_x clip).
    void block_reads_size(int64_t *n_reads, int64_t *max_len) const {
        const std::vector<Align *> &src =
            blk_from_list ? align_list : blk_list;
        int64_t n = 0, ml = 0;
        for (const Align *al : src) {
            if (!al->processed) continue;
            for (int k = 0; k < 2; k++) {
                if (!al->has_read[k] || al->read[k].empty()) continue;
                n++;
                if ((int64_t)al->read[k].size() > ml)
                    ml = (int64_t)al->read[k].size();
            }
        }
        *n_reads = n;
        *max_len = ml;
    }

    void block_reads(uint8_t *rd, int64_t R, int64_t L, int32_t *starts,
                     int32_t *ori_out, int32_t *strand_out,
                     int32_t *mapq_out, int32_t *lens) const {
        const std::vector<Align *> &src =
            blk_from_list ? align_list : blk_list;
        int64_t i = 0;
        for (const Align *al : src) {
            if (!al->processed) continue;
            int ori = al->orientation;
            for (int k = 0; k < 2; k++, ori ^= 1) {
                if (!al->has_read[k] || al->read[k].empty()) continue;
                if (i >= R) return;  // caller sized via block_reads_size
                const auto &r = al->read[k];
                int64_t rl = (int64_t)r.size();
                if (rl > L) rl = L;
                memcpy(rd + i * L, r.data(), rl);
                if (rl < L) memset(rd + i * L + rl, 0, L - rl);
                int64_t rstart = (k ? al->rev_pos : al->fwd_pos);
                starts[i] = (int32_t)(rstart - (int64_t)blk_x);
                ori_out[i] = ori;
                strand_out[i] = al->bs_strand;
                mapq_out[i] = al->mapq[k];
                lens[i] = (int32_t)r.size();
                i++;
            }
        }
    }

    // per-position aggregation (call_genotypes.c:45-59 float32 semantics)
    void aggregate(const int32_t *counts2, const float *qual_sum,
                   const float *mapq2, int32_t *counts8, int32_t *quals8,
                   int32_t *mq, int32_t *aq, int32_t *ntot,
                   int nthreads = 1) const {
        int64_t sz = (int64_t)blk_y - blk_x + 1;
        int nt = nthreads < 1 ? 1 : nthreads;
        if ((int64_t)nt * 32768 > sz) nt = (int)(sz / 32768) + 1;
        if (nt > 1) {  // row-parallel: each position is independent
            const int64_t step = (sz + nt - 1) / nt;
            bsc::pool_run(nt, [&](int w) {
                int64_t lo = w * step;
                int64_t hi = lo + step < sz ? lo + step : sz;
                if (lo < hi)
                    aggregate_range(counts2, qual_sum, mapq2, counts8,
                                    quals8, mq, aq, ntot, lo, hi);
            });
            return;
        }
        aggregate_range(counts2, qual_sum, mapq2, counts8, quals8, mq,
                        aq, ntot, 0, sz);
    }

    void aggregate_range(const int32_t *counts2, const float *qual_sum,
                         const float *mapq2, int32_t *counts8,
                         int32_t *quals8, int32_t *mq, int32_t *aq,
                         int32_t *ntot, int64_t lo, int64_t sz) const {
        for (int64_t i = lo; i < sz; i++) {
            int64_t n = 0;
            float tot_qual = 0.0f;
            for (int j = 0; j < 8; j++) {
                int32_t c =
                    counts2[i * 16 + j] + counts2[i * 16 + 8 + j];
                counts8[i * 8 + j] = c;
                if (c > 0) {
                    float q = qual_sum[i * 8 + j];
                    tot_qual += q;
                    quals8[i * 8 + j] =
                        (int32_t)floorf(0.5f + q / (float)c);
                } else quals8[i * 8 + j] = 0;
                n += c;
            }
            ntot[i] = (int32_t)n;
            if (n > 0) {
                aq[i] = (int32_t)floorf(0.5f + tot_qual / (float)n);
                mq[i] = (int32_t)(0.5 + sqrt((double)(mapq2[i] / (float)n)));
            } else {
                aq[i] = 0;
                mq[i] = 0;
            }
        }
    }

    // --- methylation read profile (stats/meth_profile.py) ---

    void meth_profile(const uint8_t *ref, int64_t ref_len, int64_t *mprof,
                      int64_t rows) const {
        static uint8_t rtab[64];
        static uint8_t flt_tab[3 * 256];
        static int flt_tab_minq = -1;
        if (flt_tab_minq != cfg.min_qual) {
            memset(rtab, 0, sizeof(rtab));
            for (int prev = 0; prev < 5; prev++)
                for (int cur = 0; cur < 5; cur++) {
                    int s = (prev << 3) | cur;
                    if (prev == 2 && (cur == 1 || cur == 2 || cur == 4))
                        rtab[s] = 4;
                    else if (cur == 3 &&
                             (prev == 1 || prev == 3 || prev == 4))
                        rtab[s] = 8;
                }
            memset(flt_tab, 0, sizeof(flt_tab));
            for (int q = cfg.min_qual; q < FLT_QUAL; q++) {
                int x = q << 2;
                const uint8_t v0[4] = {11, 6, 10, 7};
                const uint8_t v1[4] = {11, 4, 10, 5};
                const uint8_t v2[4] = {9, 6, 8, 7};
                for (int i = 0; i < 4; i++) {
                    flt_tab[x + i] = v0[i];
                    flt_tab[256 + x + i] = v1[i];
                    flt_tab[512 + x + i] = v2[i];
                }
            }
            flt_tab_minq = cfg.min_qual;
        }
        const std::vector<Align *> &src =
            blk_from_list ? align_list : blk_list;
        for (Align *al : src) {
            // each align is profiled exactly once, in the first staged
            // range that fully contains it (ref window anchored at
            // blk_meth_x covers [start-1, blk_y+2])
            if (!al->processed || al->meth_done ||
                al->end_pos > (int64_t)blk_y)
                continue;
            al->meth_done = true;
            const uint8_t *btab = flt_tab + 256 * al->bs_strand;
            for (int k = 0; k < 2; k++) {
                if (!al->has_read[k] || al->read[k].empty()) continue;
                const auto &rd = al->read[k];
                const auto &op = al->orig_pos[k];
                int64_t pos = k ? al->rev_pos : al->fwd_pos;
                int64_t ri = pos - blk_meth_x;
                uint8_t state = 0;
                if (pos > (int64_t)blk_meth_x) {
                    state = (uint8_t)(((ref[ri - 1] << 3) | ref[ri]) & 63);
                    ri++;
                }
                uint8_t mask = rtab[state];
                for (size_t j = 0; j < rd.size(); j++) {
                    uint8_t xx = btab[rd[j]];
                    uint8_t mask1 = (xx & mask) >> 1;
                    if (pos >= (int64_t)blk_meth_x) {
                        uint8_t nxt = ri < ref_len ? ref[ri] : 0;
                        state = (uint8_t)(((state << 3) | nxt) & 63);
                        ri++;
                    } else state = 0;
                    mask = rtab[state];
                    int inc = ((xx & mask) | mask1) >> 2 & 1;
                    int64_t row = (int64_t)op[j] + 1;
                    if (inc && row >= 0 && row < rows)
                        mprof[row * 4 + (xx & 3)]++;
                }
            }
        }
    }
};

}  // namespace

extern "C" {

void *bsp_open(const char *path, int nthreads, int mapq_thresh,
               long long max_template_len, int min_qual, int keep_unmatched,
               int ignore_dup, int keep_dup, int quirks, int lt0, int lt1,
               int rt0, int rt1, int collect_stats, const int8_t *tid_keep,
               int n_tids) {
    Reader *r = bsc::open_reader(path, nthreads);
    if (!r) return nullptr;
    Pipeline *p = new Pipeline();
    p->r = r;
    p->n_threads = nthreads;
    p->cfg.mapq_thresh = mapq_thresh;
    p->cfg.max_template_len = max_template_len;
    p->cfg.min_qual = min_qual;
    p->cfg.keep_unmatched = keep_unmatched;
    p->cfg.ignore_dup = ignore_dup;
    p->cfg.keep_dup = keep_dup;
    p->cfg.quirks = quirks;
    p->cfg.left_trim[0] = lt0;
    p->cfg.left_trim[1] = lt1;
    p->cfg.right_trim[0] = rt0;
    p->cfg.right_trim[1] = rt1;
    p->collect_stats = collect_stats;
    p->tid_keep.assign(tid_keep, tid_keep + n_tids);
    p->ref_lens.assign(r->ref_lens.begin(), r->ref_lens.end());
    return p;
}

void bsp_close(void *h) { delete (Pipeline *)h; }

// stage-time parallel worker budget (push pipelines have no reader
// thread count to inherit)
void bsp_set_threads(void *h, int32_t n) {
    ((Pipeline *)h)->n_threads = n < 1 ? 1 : n;
}

int bsp_n_refs(void *h) {
    return (int)((Pipeline *)h)->r->ref_names.size();
}
const char *bsp_ref_name(void *h, int i) {
    return ((Pipeline *)h)->r->ref_names[i].c_str();
}
int bsp_ref_len(void *h, int i) { return ((Pipeline *)h)->r->ref_lens[i]; }
const char *bsp_header_text(void *h) {
    return ((Pipeline *)h)->r->header_text.c_str();
}

// meta[7]: tid, x, y, max_pos, n_templates, partial, meth_x.
// Returns 1 (block staged, meta filled), 0 (end of input), or 2
// (push mode starved: bsp_push more records or bsp_push_eof, call again)
int bsp_next_block(void *h, int64_t *meta) {
    Pipeline *p = (Pipeline *)h;
    int rc;
    try {
        rc = p->next_block();
    } catch (...) {
        // allocation failure or internal error must not unwind through
        // the C ABI into ctypes (undefined behaviour -> crashes later)
        return -1;
    }
    if (rc != 1) return rc;
    meta[0] = p->blk_tid;
    meta[1] = p->blk_x;
    meta[2] = p->blk_y;
    meta[3] = p->blk_max_pos;
    meta[4] = p->blk_n_templates;
    meta[5] = p->blk_partial ? 1 : 0;
    meta[6] = p->blk_meth_x;
    return 1;
}

// Enable settled-prefix partial staging of open blocks (0 disables).
// data = [n, (tid, start, stop) * n] with start/stop 1-based inclusive
// (the -C BED rows after +1 start conversion). Works for every input
// kind including push mode. Returns 1 on success, 0 on malformed data.
int bsp_set_stream_regions(void *h, const int64_t *data, int64_t len) {
    Pipeline *p = (Pipeline *)h;
    if (len < 1) return 0;
    int64_t n = data[0];
    if (n < 0 || 1 + 3 * n != len) return 0;
    p->stream_regions.clear();
    const int64_t *q = data + 1;
    for (int64_t i = 0; i < n; i++, q += 3) {
        Pipeline::StreamReg rg;
        rg.start = q[1];
        rg.stop = q[2];
        p->stream_regions[(int32_t)q[0]].push_back(rg);
    }
    for (auto &kv : p->stream_regions)
        std::sort(kv.second.begin(), kv.second.end(),
                  [](const Pipeline::StreamReg &a,
                     const Pipeline::StreamReg &b) {
                      return a.start < b.start;
                  });
    p->stream_region_mode = true;
    return 1;
}

void bsp_set_partial(void *h, int64_t limit) {
    ((Pipeline *)h)->partial_limit = limit;
}

// Indexed region mode (file input only): data is a packed int64 table —
// [n_regions] then per region [tid, beg, end, n_chunks, n_prev] followed
// by n_chunks (cb, ce) virtual-offset pairs and n_prev (lo, hi) 1-based
// inclusive skip intervals. Voffsets fit in int64 (file offsets < 2^47).
// Returns 1 on success, 0 on malformed payload or non-file pipeline.
int bsp_set_regions(void *h, const int64_t *data, int64_t len) {
    Pipeline *p = (Pipeline *)h;
    if (!p->r || p->push_mode) return 0;
    const int64_t *q = data, *end = data + len;
    if (q >= end) return 0;
    int64_t n = *q++;
    if (n < 0) return 0;
    std::vector<Pipeline::RegSeg> regs;
    try {
        for (int64_t i = 0; i < n; i++) {
            if (end - q < 5) return 0;
            Pipeline::RegSeg rg;
            rg.tid = (int32_t)q[0];
            rg.beg = q[1];
            rg.end = q[2];
            int64_t nc = q[3], np = q[4];
            q += 5;
            if (nc < 0 || np < 0 || end - q < 2 * (nc + np)) return 0;
            for (int64_t c = 0; c < nc; c++) {
                rg.chunks.emplace_back((uint64_t)q[0], (uint64_t)q[1]);
                q += 2;
            }
            for (int64_t c = 0; c < np; c++) {
                rg.prev.emplace_back(q[0], q[1]);
                q += 2;
            }
            regs.push_back(std::move(rg));
        }
    } catch (...) {
        return 0;
    }
    p->regions = std::move(regs);
    p->region_mode = true;
    return 1;
}

// Push-mode pipeline: records arrive as raw BAM record blobs
// ([u32 size][body]...) via bsp_push; serves CRAM/SAM decoded host-side.
void *bsp_open_push(int mapq_thresh, long long max_template_len,
                    int min_qual, int keep_unmatched, int ignore_dup,
                    int keep_dup, int quirks, int lt0, int lt1, int rt0,
                    int rt1, int collect_stats, const int8_t *tid_keep,
                    int n_tids) {
    Pipeline *p = new Pipeline();
    p->push_mode = true;
    p->cfg.mapq_thresh = mapq_thresh;
    p->cfg.max_template_len = max_template_len;
    p->cfg.min_qual = min_qual;
    p->cfg.keep_unmatched = keep_unmatched;
    p->cfg.ignore_dup = ignore_dup;
    p->cfg.keep_dup = keep_dup;
    p->cfg.quirks = quirks;
    p->cfg.left_trim[0] = lt0;
    p->cfg.left_trim[1] = lt1;
    p->cfg.right_trim[0] = rt0;
    p->cfg.right_trim[1] = rt1;
    p->collect_stats = collect_stats;
    p->tid_keep.assign(tid_keep, tid_keep + n_tids);
    return p;
}

void bsp_push(void *h, const uint8_t *data, int64_t len) {
    try {
        ((Pipeline *)h)->push_bytes(data, (size_t)len);
    } catch (...) {
        // out of memory: bytes were dropped, so the stream is broken —
        // flag it so next_block reports a hard error instead of a
        // silently truncated (but clean-looking) end of input
        ((Pipeline *)h)->push_error = true;
        ((Pipeline *)h)->push_done = true;
    }
}

// Contig lengths for the end-overshoot corruption cap (push mode; file
// mode fills them from the BAM header itself).
void bsp_set_ref_lens(void *h, const int64_t *lens, int32_t n) {
    ((Pipeline *)h)->ref_lens.assign(lens, lens + n);
}

// SAM text mode for the push pipeline: pushed bytes are SAM lines.
// names = "name1\0name2\0..." in tid order.
void bsp_set_sam_mode(void *h, const char *names, int64_t len) {
    Pipeline *p = (Pipeline *)h;
    p->sam_mode = true;
    int32_t tid = 0;
    const char *q = names, *end = names + len;
    while (q < end) {
        size_t n = strlen(q);
        p->ref_ids.emplace(std::string(q, n), tid++);
        q += n + 1;
    }
}

void bsp_push_eof(void *h) { ((Pipeline *)h)->push_done = true; }

void bsp_block_pileup(void *h, int32_t *counts2, float *qual_sum,
                      float *mapq2, int32_t nthreads) {
    ((Pipeline *)h)->pileup(counts2, qual_sum, mapq2, nthreads);
}

void bsp_block_reads_size(void *h, int64_t *n_reads, int64_t *max_len) {
    ((Pipeline *)h)->block_reads_size(n_reads, max_len);
}

void bsp_block_reads(void *h, uint8_t *rd, int64_t R, int64_t L,
                     int32_t *starts, int32_t *ori, int32_t *strand,
                     int32_t *mapq, int32_t *lens) {
    ((Pipeline *)h)->block_reads(rd, R, L, starts, ori, strand, mapq, lens);
}

void bsp_block_meth_profile(void *h, const uint8_t *ref, int64_t ref_len,
                            int64_t *mprof, int64_t rows) {
    ((Pipeline *)h)->meth_profile(ref, ref_len, mprof, rows);
}

void bsp_block_aggregate(void *h, const int32_t *counts2,
                         const float *qual_sum, const float *mapq2,
                         int32_t *counts8, int32_t *quals8, int32_t *mq,
                         int32_t *aq, int32_t *ntot, int32_t nthreads) {
    ((Pipeline *)h)->aggregate(counts2, qual_sum, mapq2, counts8, quals8,
                               mq, aq, ntot, nthreads);
}

void bsp_get_stats(void *h, int64_t *filter_cts, int64_t *filter_bases,
                   int64_t *base_filter) {
    Pipeline *p = (Pipeline *)h;
    memcpy(filter_cts, p->stats.filter_cts, sizeof(p->stats.filter_cts));
    memcpy(filter_bases, p->stats.filter_bases,
           sizeof(p->stats.filter_bases));
    memcpy(base_filter, p->stats.base_filter, sizeof(p->stats.base_filter));
}

}  // extern "C"
