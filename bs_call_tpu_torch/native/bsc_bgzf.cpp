// Multithreaded BGZF deflate (the output analogue of the inflate pool in
// bsc_common.h; the reference gets this from htslib's hts_set_threads
// output pool, parse_args.c:196-211 / print_vcf.c:644).
//
// Contract: splits `data` into 0xFF00-byte payloads and emits one BGZF
// member per payload, byte-identical to a serial zlib deflate at the
// same level (blocks are independent, so parallelism cannot change the
// output bytes).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace bsc {  // bsc_pool.cpp
void pool_run(int n, const std::function<void(int)> &fn);
}

namespace {

constexpr int64_t kPayload = 0xFF00;
constexpr int64_t kHeader = 18;   // gzip header + BC extra subfield
constexpr int64_t kFooter = 8;    // crc32 + isize
// worst-case deflate expansion for an incompressible 64K payload is
// ~payload + payload/16k*5 + 32; one spare KiB is comfortable
constexpr int64_t kSlot = kPayload + 1024 + kHeader + kFooter;

bool deflate_payload(const uint8_t *src, uint32_t plen, int level,
                     uint8_t *dst, uint32_t cap, uint32_t *clen) {
    z_stream zs;
    std::memset(&zs, 0, sizeof zs);
    // match zlib.compressobj(level, DEFLATED, -15): raw window, default
    // memLevel/strategy, so bytes equal the Python writer's
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
        return false;
    zs.next_in = const_cast<Bytef *>(src);
    zs.avail_in = plen;
    zs.next_out = dst;
    zs.avail_out = cap;
    int r = deflate(&zs, Z_FINISH);
    deflateEnd(&zs);
    if (r != Z_STREAM_END) return false;
    *clen = cap - zs.avail_out;
    return true;
}

void put_u16(uint8_t *p, uint32_t v) {
    p[0] = v & 0xFF;
    p[1] = (v >> 8) & 0xFF;
}

void put_u32(uint8_t *p, uint32_t v) {
    p[0] = v & 0xFF;
    p[1] = (v >> 8) & 0xFF;
    p[2] = (v >> 16) & 0xFF;
    p[3] = (v >> 24) & 0xFF;
}

}  // namespace

extern "C" {

// Returns bytes written to `out`, or -1 (out_cap too small / zlib error).
// Required capacity: ceil(len / 0xFF00) * (0xFF00 + 1050).
int64_t bsc_bgzf_deflate_batch(const uint8_t *data, int64_t len, int level,
                               int nthreads, uint8_t *out,
                               int64_t out_cap) {
    if (len <= 0) return 0;
    int64_t nblk = (len + kPayload - 1) / kPayload;
    if (out_cap < nblk * kSlot) return -1;
    std::vector<uint32_t> comp_len(nblk, 0);
    std::atomic<int64_t> next{0};
    std::atomic<bool> fail{false};
    auto work = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= nblk || fail.load(std::memory_order_relaxed)) return;
            const uint8_t *src = data + i * kPayload;
            int64_t rem = len - i * kPayload;
            uint32_t plen = (uint32_t)(rem < kPayload ? rem : kPayload);
            uint8_t *slot = out + i * kSlot;
            uint32_t clen = 0;
            if (!deflate_payload(src, plen, level, slot + kHeader,
                                 (uint32_t)(kSlot - kHeader - kFooter),
                                 &clen)) {
                fail.store(true);
                return;
            }
            // gzip header: magic, CM=8, FLG=FEXTRA, mtime=0, XFL=0,
            // OS=0xFF, XLEN=6, "BC", sublen=2, BSIZE=total-1
            slot[0] = 0x1F;
            slot[1] = 0x8B;
            slot[2] = 8;
            slot[3] = 4;
            put_u32(slot + 4, 0);
            slot[8] = 0;
            slot[9] = 0xFF;
            put_u16(slot + 10, 6);
            slot[12] = 'B';
            slot[13] = 'C';
            put_u16(slot + 14, 2);
            put_u16(slot + 16, (uint32_t)(clen + kHeader + kFooter - 1));
            uint8_t *ftr = slot + kHeader + clen;
            put_u32(ftr, (uint32_t)crc32(crc32(0, nullptr, 0), src, plen));
            put_u32(ftr + 4, plen);
            comp_len[i] = clen;
        }
    };
    int nt = nthreads < 1 ? 1 : (nthreads > 16 ? 16 : nthreads);
    if (nt == 1 || nblk == 1) {
        work();
    } else {
        bsc::pool_run(nt, [&](int) { work(); });
    }
    if (fail.load()) return -1;
    // compact the ordered blocks (slots are larger than blocks, so the
    // destination never overruns the source being moved)
    int64_t w = 0;
    for (int64_t i = 0; i < nblk; i++) {
        int64_t total = kHeader + comp_len[i] + kFooter;
        if (w != i * kSlot) std::memmove(out + w, out + i * kSlot, total);
        w += total;
    }
    return w;
}

}  // extern "C"
