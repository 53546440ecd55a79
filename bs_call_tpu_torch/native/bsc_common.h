// Shared native ingest internals: multithreaded BGZF stream, BAM record
// parsing, packed-read encoding, bisulfite-strand aux classification.
// See bsc_ingest.cpp for the role description.
#pragma once

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <functional>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

namespace bsc {

// Persistent shared worker pool (bsc_pool.cpp): run fn(0..n-1), caller
// participates, returns when all complete. Replaces per-call
// std::thread spawning everywhere — thread stack mmap/munmap churn was
// the dominant kernel-time cost on shared VMs.
void pool_run(int n, const std::function<void(int)> &fn);
int pool_size();

// Opt-in phase profiling (BSC_PROF=1; bsc_pool.cpp): cumulative WALL
// seconds per labeled call site, reported at exit. Builder tooling.
bool prof_on();
void prof_add(int *slot, const char *name, int64_t ns);

struct ProfScope {
    int *slot;
    const char *name;
    std::chrono::steady_clock::time_point t0;
    bool on;
    ProfScope(int *s, const char *n)
        : slot(s), name(n), on(prof_on()) {
        if (on) t0 = std::chrono::steady_clock::now();
    }
    ~ProfScope() {
        if (on)
            prof_add(slot, name,
                     (std::chrono::steady_clock::now() - t0).count());
    }
};

#define BSC_PROF_CAT2(a, b) a##b
#define BSC_PROF_CAT(a, b) BSC_PROF_CAT2(a, b)
#define BSC_PROF_SCOPE(label)                                   \
    static int BSC_PROF_CAT(_prof_slot_, __LINE__) = -1;        \
    bsc::ProfScope BSC_PROF_CAT(_prof_scope_, __LINE__)(        \
        &BSC_PROF_CAT(_prof_slot_, __LINE__), label)

constexpr int MAX_QUAL = 43;
constexpr int FLT_QUAL = 63;

struct CompBlock {
    std::vector<uint8_t> comp;
    uint32_t isize = 0;
};

// Read one BGZF block at the current file position. Returns false on
// EOF or a malformed header. *total (optional) receives the block's
// total compressed size (BSIZE+1), i.e. the file-offset delta to the
// next block — the unit virtual offsets are built from.
inline bool read_bgzf_block(FILE *f, CompBlock &b, size_t *total) {
    uint8_t hdr[12];
    if (fread(hdr, 1, 12, f) != 12) return false;
    if (hdr[0] != 0x1f || hdr[1] != 0x8b) return false;
    uint16_t xlen = hdr[10] | (hdr[11] << 8);
    std::vector<uint8_t> extra(xlen);
    if (fread(extra.data(), 1, xlen, f) != xlen) return false;
    int bsize = -1;
    for (int i = 0; i + 4 <= xlen;) {
        uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
        if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2)
            bsize = extra[i + 4] | (extra[i + 5] << 8);
        i += 4 + slen;
    }
    if (bsize < 0) return false;
    size_t csize = (size_t)bsize + 1 - 12 - xlen - 8;
    b.comp.resize(csize);
    if (fread(b.comp.data(), 1, csize, f) != csize) return false;
    uint8_t tail[8];
    if (fread(tail, 1, 8, f) != 8) return false;
    b.isize = tail[4] | (tail[5] << 8) | (tail[6] << 16) |
              ((uint32_t)tail[7] << 24);
    if (total) *total = (size_t)bsize + 1;
    return true;
}

#if defined(BSC_USE_LIBDEFLATE) && __has_include(<libdeflate.h>)
#include <libdeflate.h>
// libdeflate raw-deflate decode: ~2-3x zlib's inflate on BGZF-sized
// blocks. Decompressors are not shareable across threads; one per
// inflate-pool thread, reused for the process lifetime.
inline void inflate_bgzf_block(const CompBlock &b, uint8_t *dst) {
    if (b.isize == 0) return;
    static thread_local libdeflate_decompressor *dec =
        libdeflate_alloc_decompressor();
    size_t got = 0;
    if (dec && libdeflate_deflate_decompress(
                   dec, b.comp.data(), b.comp.size(), dst, b.isize,
                   &got) == LIBDEFLATE_SUCCESS &&
        got == b.isize)
        return;
    // corrupt block or allocation failure: zlib is the arbiter
    z_stream zs{};
    inflateInit2(&zs, -15);
    zs.next_in = const_cast<Bytef *>(b.comp.data());
    zs.avail_in = (uInt)b.comp.size();
    zs.next_out = dst;
    zs.avail_out = b.isize;
    inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
}
#else
inline void inflate_bgzf_block(const CompBlock &b, uint8_t *dst) {
    if (b.isize == 0) return;
    z_stream zs{};
    inflateInit2(&zs, -15);
    zs.next_in = const_cast<Bytef *>(b.comp.data());
    zs.avail_in = (uInt)b.comp.size();
    zs.next_out = dst;
    zs.avail_out = b.isize;
    inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
}
#endif

// Linear BGZF input with a background prefetch thread: while the
// consumer (the ingest/producer thread) classifies and builds blocks
// out of batch k, the prefetch thread reads and pool-inflates batch
// k+1 into a bounded queue — taking decompression off the producer's
// critical path (measured ~0.57 s of caller wall per 94 MB BAM, the
// largest single slice of the ingest stage). The reference gets the
// same overlap from htslib's bgzf_mt reader/worker threads
// (process.c:151).
class BgzfStream {
  public:
    explicit BgzfStream(FILE *f, int nthreads)
        : f_(f), nthreads_(nthreads > 0 ? nthreads : 1) {}

    ~BgzfStream() { stop(); }

    // Tear down the prefetch thread and discard queued batches. MUST
    // be called before any out-of-band seek on the underlying FILE*
    // (indexed chunk mode): the prefetch thread and a seeking reader
    // otherwise interleave freads on the same stream and corrupt the
    // block sequence (observed as crashed shard workers on inputs big
    // enough that prefetch was still active when open_chunk ran —
    // small test files reached EOF first and masked it).
    void stop() {
        if (!started_) return;
        {
            std::lock_guard<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_space_.notify_all();
        th_.join();
        started_ = false;
        stop_ = false;
        q_.clear();
        done_ = false;
    }

    size_t fill(std::vector<uint8_t> &out, size_t want) {
        if (eof_) return 0;
        if (!started_ && !first_done_) {
            // the first fill is the header read: serve it synchronously
            // so indexed-region readers (which switch to chunk mode
            // right after) never spin up a prefetch thread whose
            // readahead would be thrown away
            first_done_ = true;
            return fill_sync(out, want);
        }
        if (!started_) {
            started_ = true;
            th_ = std::thread([this]() { prefetch_loop(); });
        }
        size_t added = 0;
        while (added < want) {
            std::vector<uint8_t> batch;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_data_.wait(lk, [&] { return !q_.empty() || done_; });
                if (q_.empty()) { eof_ = true; break; }
                batch = std::move(q_.front());
                q_.pop_front();
            }
            cv_space_.notify_one();
            out.insert(out.end(), batch.begin(), batch.end());
            added += batch.size();
        }
        return added;
    }

    bool eof() const { return eof_; }

  private:
    size_t fill_sync(std::vector<uint8_t> &out, size_t want) {
        size_t added = 0;
        while (added < want) {
            std::vector<CompBlock> blocks;
            for (int i = 0; i < 64; i++) {
                CompBlock b;
                if (!read_bgzf_block(f_, b, nullptr)) {
                    eof_ = true;
                    break;
                }
                blocks.push_back(std::move(b));
            }
            if (blocks.empty()) break;
            std::vector<size_t> offs(blocks.size() + 1);
            offs[0] = out.size();
            for (size_t i = 0; i < blocks.size(); i++)
                offs[i + 1] = offs[i] + blocks[i].isize;
            out.resize(offs.back());
            size_t nb = blocks.size();
            BSC_PROF_SCOPE("inflate.batch");
            if (std::min<size_t>(nthreads_, nb) <= 1) {
                for (size_t i = 0; i < nb; i++)
                    inflate_bgzf_block(blocks[i], out.data() + offs[i]);
            } else {
                uint8_t *base = out.data();
                pool_run((int)nb, [&](int i) {
                    inflate_bgzf_block(blocks[i], base + offs[i]);
                });
            }
            added += offs.back() - offs[0];
            if (eof_) break;
        }
        return added;
    }

    void prefetch_loop() {
        for (;;) {
            std::vector<CompBlock> blocks;
            bool end = false;
            for (int i = 0; i < 64; i++) {
                CompBlock b;
                if (!read_bgzf_block(f_, b, nullptr)) { end = true; break; }
                blocks.push_back(std::move(b));
            }
            std::vector<uint8_t> batch;
            if (!blocks.empty()) {
                std::vector<size_t> offs(blocks.size() + 1);
                offs[0] = 0;
                for (size_t i = 0; i < blocks.size(); i++)
                    offs[i + 1] = offs[i] + blocks[i].isize;
                batch.resize(offs.back());
                size_t nb = blocks.size();
                BSC_PROF_SCOPE("inflate.batch");
                if (std::min<size_t>(nthreads_, nb) <= 1) {
                    for (size_t i = 0; i < nb; i++)
                        inflate_bgzf_block(blocks[i],
                                           batch.data() + offs[i]);
                } else {
                    uint8_t *base = batch.data();
                    pool_run((int)nb, [&](int i) {
                        inflate_bgzf_block(blocks[i], base + offs[i]);
                    });
                }
            }
            {
                std::unique_lock<std::mutex> lk(mu_);
                if (!batch.empty()) {
                    cv_space_.wait(lk, [&] {
                        return q_.size() < kDepth || stop_;
                    });
                    if (stop_) return;
                    q_.push_back(std::move(batch));
                }
                if (end) done_ = true;
            }
            cv_data_.notify_one();
            if (end) return;
            {
                std::lock_guard<std::mutex> lk(mu_);
                if (stop_) return;
            }
        }
    }

    static constexpr size_t kDepth = 3;  // ~4 MB per queued batch

    FILE *f_;
    size_t nthreads_;
    bool eof_ = false;
    bool started_ = false;
    bool first_done_ = false;
    std::thread th_;
    std::mutex mu_;
    std::condition_variable cv_data_, cv_space_;
    std::deque<std::vector<uint8_t>> q_;
    bool done_ = false;
    bool stop_ = false;
};

struct Reader {
    FILE *f = nullptr;
    BgzfStream *stream = nullptr;
    std::vector<uint8_t> buf;
    size_t pos = 0;
    bool corrupt = false;  // malformed record geometry encountered
    std::string header_text;
    std::vector<std::string> ref_names;
    std::vector<int32_t> ref_lens;

    // indexed chunk mode (-C regions / per-contig shard seeks): ensure()
    // draws bytes from one bounded virtual-offset range at a time
    // (io/bai.py _read_range semantics) instead of the linear stream
    bool chunk_mode = false;
    int nthreads = 1;
    uint64_t chunk_coff = 0;  // compressed offset of the next unread block
    uint64_t chunk_end = 0;   // end virtual offset (exclusive)
    size_t chunk_skip = 0;    // bytes to drop from the chunk's first block
    bool chunk_done = true;

    ~Reader() {
        delete stream;
        if (f) fclose(f);
    }

    bool ensure(size_t n) {
        while (buf.size() - pos < n) {
            if (pos > (1u << 22)) {
                buf.erase(buf.begin(), buf.begin() + pos);
                pos = 0;
            }
            size_t want = n - (buf.size() - pos);
            size_t got =
                chunk_mode ? fill_chunk(want) : stream->fill(buf, want);
            if (got == 0) return buf.size() - pos >= n;
        }
        return true;
    }

    // Position the reader at virtual offset vbeg, bounded by vend; the
    // next ensure() calls serve exactly the uncompressed bytes of
    // [vbeg, vend) (chunk boundaries delimit whole records, SAM spec).
    bool open_chunk(uint64_t vbeg, uint64_t vend) {
        // the linear stream's prefetch thread must not touch the FILE*
        // once chunk mode starts seeking it
        if (stream) stream->stop();
        buf.clear();
        pos = 0;
        chunk_mode = true;
        chunk_coff = vbeg >> 16;
        chunk_skip = (size_t)(vbeg & 0xFFFFu);
        chunk_end = vend;
        chunk_done = vbeg >= vend;
        if (chunk_done) return true;
        return fseeko(f, (off_t)chunk_coff, SEEK_SET) == 0;
    }

    // Append up to the chunk's remaining bytes (at least `want` when
    // available): gather a batch of compressed blocks sequentially,
    // inflate them in parallel like the linear stream, then append the
    // in-range window (first-block skip, end-block cut).
    size_t fill_chunk(size_t want) {
        size_t added = 0;
        const uint64_t e_coff = chunk_end >> 16;
        const size_t e_uoff = (size_t)(chunk_end & 0xFFFFu);
        while (added < want && !chunk_done) {
            std::vector<CompBlock> blocks;
            bool end_block = false;  // batch contains the block at e_coff
            for (int i = 0; i < 64 && !chunk_done; i++) {
                if (chunk_coff > e_coff ||
                    (chunk_coff == e_coff && e_uoff == 0)) {
                    chunk_done = true;
                    break;
                }
                CompBlock b;
                size_t total = 0;
                if (!read_bgzf_block(f, b, &total)) {
                    chunk_done = true;
                    break;
                }
                bool is_end = chunk_coff == e_coff;
                chunk_coff += total;
                blocks.push_back(std::move(b));
                if (is_end) {
                    chunk_done = true;
                    end_block = true;
                    break;
                }
            }
            if (blocks.empty()) break;
            size_t nb = blocks.size();
            std::vector<size_t> offs(nb + 1);
            offs[0] = 0;
            for (size_t i = 0; i < nb; i++)
                offs[i + 1] = offs[i] + blocks[i].isize;
            std::vector<uint8_t> scratch(offs[nb]);
            unsigned nt = std::min<size_t>((size_t)nthreads, nb);
            BSC_PROF_SCOPE("inflate.chunk_batch");
            if (nt <= 1) {
                for (size_t i = 0; i < nb; i++)
                    inflate_bgzf_block(blocks[i], scratch.data() + offs[i]);
            } else {
                uint8_t *base = scratch.data();
                pool_run((int)nb, [&](int i) {
                    inflate_bgzf_block(blocks[i], base + offs[i]);
                });
            }
            size_t lo = std::min(chunk_skip, scratch.size());
            chunk_skip = 0;
            size_t hi = scratch.size();
            if (end_block)
                hi = std::min(offs[nb - 1] + e_uoff, scratch.size());
            if (hi > lo) {
                buf.insert(buf.end(), scratch.begin() + lo,
                           scratch.begin() + hi);
                added += hi - lo;
            }
        }
        return added;
    }

    uint32_t u32() {
        uint32_t v;
        memcpy(&v, buf.data() + pos, 4);
        pos += 4;
        return v;
    }
};

inline Reader *open_reader(const char *path, int nthreads) {
    FILE *f = fopen(path, "rb");
    if (!f) return nullptr;
    Reader *r = new Reader();
    r->f = f;
    r->nthreads = nthreads > 0 ? nthreads : 1;
    r->stream = new BgzfStream(f, nthreads);
    if (!r->ensure(12) || memcmp(r->buf.data(), "BAM\x01", 4) != 0) {
        delete r;
        return nullptr;
    }
    r->pos = 4;
    uint32_t l_text = r->u32();
    if (!r->ensure(l_text + 4)) { delete r; return nullptr; }
    r->header_text.assign((const char *)r->buf.data() + r->pos, l_text);
    r->pos += l_text;
    uint32_t n_ref = r->u32();
    for (uint32_t i = 0; i < n_ref; i++) {
        if (!r->ensure(8)) { delete r; return nullptr; }
        uint32_t l_name = r->u32();
        if (!r->ensure(l_name + 4)) { delete r; return nullptr; }
        r->ref_names.emplace_back((const char *)r->buf.data() + r->pos,
                                  l_name - 1);
        r->pos += l_name;
        r->ref_lens.push_back((int32_t)r->u32());
    }
    return r;
}

// Raw view of one BAM record inside the stream buffer.
struct RawRec {
    int32_t tid, pos, mtid, mpos, isize, l_seq;
    uint16_t flag, n_cigar;
    uint8_t mapq;
    const char *name;
    uint8_t name_len;  // excluding NUL
    const uint32_t *cigar;
    const uint8_t *seq;   // 4-bit packed
    const uint8_t *qual;
    const uint8_t *aux;
    const uint8_t *aux_end;
};

// Validate one raw BAM record body before parsing: the pointer layout
// derives every section from length fields inside the record, so a
// corrupt stream would otherwise drive out-of-bounds reads and
// unbounded vector growth downstream.
inline bool validate_raw(const uint8_t *p, uint32_t block_size) {
    if (block_size < 32 || block_size > (1u << 28)) return false;
    uint8_t l_read_name = p[8];
    if (l_read_name < 1) return false;
    uint16_t n_cigar;
    memcpy(&n_cigar, p + 12, 2);
    int32_t l_seq;
    memcpy(&l_seq, p + 16, 4);
    if (l_seq < 0 || l_seq > (1 << 27)) return false;
    uint64_t need = 32ull + l_read_name + 4ull * n_cigar +
                    ((uint64_t)l_seq + 1) / 2 + (uint64_t)l_seq;
    return need <= block_size;
}

// Parse one raw BAM record body (p points past the block_size field).
inline void parse_raw(const uint8_t *p, uint32_t block_size, RawRec &rec) {
    memcpy(&rec.tid, p, 4);
    memcpy(&rec.pos, p + 4, 4);
    uint8_t l_read_name = p[8];
    rec.mapq = p[9];
    memcpy(&rec.n_cigar, p + 12, 2);
    memcpy(&rec.flag, p + 14, 2);
    memcpy(&rec.l_seq, p + 16, 4);
    memcpy(&rec.mtid, p + 20, 4);
    memcpy(&rec.mpos, p + 24, 4);
    memcpy(&rec.isize, p + 28, 4);
    rec.name = (const char *)p + 32;
    rec.name_len = l_read_name - 1;
    rec.cigar = (const uint32_t *)(p + 32 + l_read_name);
    rec.seq = p + 32 + l_read_name + (size_t)rec.n_cigar * 4;
    rec.qual = rec.seq + (rec.l_seq + 1) / 2;
    rec.aux = rec.qual + rec.l_seq;
    rec.aux_end = p + block_size;
}

// Parse the next record; advances r.pos past it. Returns false on EOF.
inline bool next_record(Reader &r, RawRec &rec) {
    if (!r.ensure(4)) return false;
    uint32_t block_size = r.u32();
    if (block_size > (1u << 28)) {
        r.corrupt = true;
        return false;
    }
    if (!r.ensure(block_size)) { r.pos -= 4; return false; }
    if (!validate_raw(r.buf.data() + r.pos, block_size)) {
        r.corrupt = true;
        return false;
    }
    parse_raw(r.buf.data() + r.pos, block_size, rec);
    r.pos += block_size;
    return true;
}

inline const uint8_t NIB2CODE[16] = {0, 1, 2, 0, 3, 0, 0, 0,
                                     4, 0, 0, 0, 0, 0, 0, 0};

// packed (base | qual<<2) byte encoding (input_sam.c:77-87).
// Split into a byte->2-codes LUT expansion plus a branchless
// combine loop so the compiler can vectorize it (~90M bases/run on a
// WGBS batch; the branchy original was ~half of record-classify time).
struct SeqCodeLut {
    uint16_t v[256];  // two 0..4 codes per packed seq byte, LE order
    SeqCodeLut() {
        for (int b = 0; b < 256; b++)
            v[b] = (uint16_t)(NIB2CODE[b >> 4] | (NIB2CODE[b & 0xF] << 8));
    }
};
inline const SeqCodeLut SEQ_CODE_LUT;

inline void pack_read(const RawRec &rec, uint8_t *out) {
    const int32_t n = rec.l_seq;
    // expand 4-bit bases to one code byte each (writes may overrun by
    // one byte into out[n] for odd n; callers size out to l_seq rounded
    // up — see pack_read_cap below)
    for (int32_t k = 0; k < n; k += 2) {
        uint16_t two = SEQ_CODE_LUT.v[rec.seq[k >> 1]];
        memcpy(out + k, &two, 2);
    }
    for (int32_t k = 0; k < n; k++) {
        int code = out[k];
        int qv = rec.qual[k];
        qv = (qv == 0xFF) ? 0 : qv;
        qv = qv > MAX_QUAL ? MAX_QUAL : qv;
        out[k] = (uint8_t)((code - 1) | (qv << 2)) &
                 (uint8_t)-(code != 0);
    }
}

// required capacity of `out` for pack_read (the LUT expansion writes
// whole byte pairs)
inline int32_t pack_read_cap(int32_t l_seq) { return l_seq + (l_seq & 1); }

// bisulfite strand from aux tags (input_sam.c:144-220); later tags win
inline int scan_bs_strand(const uint8_t *s, const uint8_t *end) {
    int strand = 0;
    while (s + 4 <= end) {
        int aligner = 0;  // 1=GEM 2=BOWTIE 3=NOV 4=BSMAP 5=BWAMETH
        if (s[0] == 'Z') {
            if (s[1] == 'B') aligner = 3;
            else if (s[1] == 'S') aligner = 4;
        } else if (s[0] == 'X') {
            if (s[1] == 'G') aligner = 2;
            else if (s[1] == 'B') aligner = 1;
        } else if (s[0] == 'Y' && s[1] == 'D') aligner = 5;
        s += 2;
        uint8_t type = *s++;
        switch (type) {
        case 'A':
            if (aligner == 1) {
                if (*s == 'C') strand = 1;
                else if (*s == 'G') strand = 2;
            }
            s++;
            break;
        case 'C': case 'c': s++; break;
        case 'S': case 's': s += 2; break;
        case 'I': case 'i': case 'f': s += 4; break;
        case 'd': s += 8; break;
        case 'Z':
            if (aligner == 2 || aligner == 3) {
                if (*s == 'C') strand = 1;
                else if (*s == 'G') strand = 2;
            } else if (aligner == 4) {
                if (*s == '+') strand = 1;
                else if (*s == '-') strand = 2;
            } else if (aligner == 5) {
                if (*s == 'f') strand = 1;
                else if (*s == 'r') strand = 2;
            }
            // fallthrough
        case 'H':
            while (s < end && *s) s++;
            if (s < end) s++; else return strand;
            break;
        case 'B': {
            if (s >= end) return strand;
            uint8_t sub = *s++;
            int sz = (sub == 'c' || sub == 'C') ? 1
                   : (sub == 's' || sub == 'S') ? 2
                   : (sub == 'i' || sub == 'I' || sub == 'f') ? 4 : 0;
            if (sz == 0 || s + 4 > end) return strand;
            uint32_t n;
            memcpy(&n, s, 4);
            s += 4 + (size_t)n * sz;
            break;
        }
        default:
            return strand;
        }
    }
    return strand;
}

}  // namespace bsc
