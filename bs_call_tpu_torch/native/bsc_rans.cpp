// rANS4x8 order-0/order-1 decode for CRAM blocks (native counterpart of
// io/cram_codecs.py rans_decode; htslib-compatible constants TF_SHIFT=12,
// RANS_BYTE_L=1<<23). Semantics mirror the Python implementation byte
// for byte, including its tolerance of under-normalized tables (lookup
// slots past the cumulative total decode as symbol 0).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTotFreq = 1u << 12;
constexpr uint32_t kRansL = 1u << 23;

bool read_freqs(const uint8_t *buf, int64_t n, int64_t &off,
                uint32_t *freqs) {
    std::memset(freqs, 0, 256 * sizeof(uint32_t));
    if (off >= n) return false;
    int s = buf[off++];
    int rle = 0;
    for (;;) {
        if (off >= n) return false;
        uint32_t f = buf[off++];
        if (f >= 0x80) {
            if (off >= n) return false;
            f = ((f & 0x7F) << 8) | buf[off++];
        }
        if (s > 255) return false;
        freqs[s] = f;
        if (rle) {
            rle--;
            s++;
        } else {
            if (off >= n) return false;
            int nxt = buf[off++];
            if (nxt == 0) break;
            if (nxt == s + 1) {
                if (off >= n) return false;
                rle = buf[off++];
            }
            s = nxt;
        }
    }
    return true;
}

void build_tables(const uint32_t *freqs, uint32_t *cum, uint8_t *lut) {
    cum[0] = 0;
    for (int i = 0; i < 256; i++) cum[i + 1] = cum[i] + freqs[i];
    std::memset(lut, 0, kTotFreq);
    for (int s = 0; s < 256; s++) {
        uint32_t lo = cum[s], hi = cum[s + 1];
        if (hi > kTotFreq) hi = kTotFreq;
        for (uint32_t k = lo; k < hi; k++) lut[k] = (uint8_t)s;
    }
}

bool read_states(const uint8_t *buf, int64_t n, int64_t &off,
                 uint32_t *st) {
    if (off + 16 > n) return false;
    for (int j = 0; j < 4; j++) {
        st[j] = (uint32_t)buf[off] | ((uint32_t)buf[off + 1] << 8) |
                ((uint32_t)buf[off + 2] << 16) |
                ((uint32_t)buf[off + 3] << 24);
        off += 4;
    }
    return true;
}

}  // namespace

extern "C" {

// buf points past the 9-byte block header. Returns usize or -1.
int64_t bsc_rans_decode_o0(const uint8_t *buf, int64_t n, uint8_t *out,
                           int64_t usize) {
    uint32_t freqs[256], cum[257];
    uint8_t lut[kTotFreq];
    int64_t off = 0;
    if (!read_freqs(buf, n, off, freqs)) return -1;
    uint32_t tot = 0;
    for (int i = 0; i < 256; i++) tot += freqs[i];
    if (tot > kTotFreq) return -1;  // over-normalized: Python fallback
    build_tables(freqs, cum, lut);
    uint32_t st[4];
    if (!read_states(buf, n, off, st)) return -1;
    for (int64_t i = 0; i < usize; i++) {
        int j = i & 3;
        uint32_t x = st[j];
        uint32_t slot = x & (kTotFreq - 1);
        uint8_t s = lut[slot];
        out[i] = s;
        x = freqs[s] * (x >> 12) + slot - cum[s];
        while (x < kRansL && off < n) x = (x << 8) | buf[off++];
        st[j] = x;
    }
    return usize;
}

int64_t bsc_rans_decode_o1(const uint8_t *buf, int64_t n, uint8_t *out,
                           int64_t usize) {
    std::vector<uint32_t> freqs(256 * 256, 0);
    std::vector<uint32_t> cum(256 * 257);
    std::vector<uint8_t> lut(256 * kTotFreq);
    std::vector<uint8_t> built(256, 0);
    int64_t off = 0;
    if (off >= n) return -1;
    int c = buf[off++];
    int rle = 0;
    for (;;) {
        if (c > 255) return -1;
        if (!read_freqs(buf, n, off, &freqs[c * 256])) return -1;
        if (rle) {
            rle--;
            c++;
        } else {
            if (off >= n) return -1;
            int nxt = buf[off++];
            if (nxt == 0) break;
            if (nxt == c + 1) {
                if (off >= n) return -1;
                rle = buf[off++];
            }
            c = nxt;
        }
    }
    for (int ctx = 0; ctx < 256; ctx++) {
        uint32_t tot = 0;
        for (int i = 0; i < 256; i++) tot += freqs[ctx * 256 + i];
        if (tot > kTotFreq) return -1;  // over-normalized: fallback
    }
    uint32_t st[4];
    if (!read_states(buf, n, off, st)) return -1;
    int64_t q = usize >> 2;
    int64_t starts[4] = {0, q, 2 * q, 3 * q};
    uint8_t last[4] = {0, 0, 0, 0};
    auto dec = [&](int k, int64_t i) {
        int ctx = last[k];
        if (!built[ctx]) {
            build_tables(&freqs[ctx * 256], &cum[ctx * 257],
                         &lut[(size_t)ctx * kTotFreq]);
            built[ctx] = 1;
        }
        const uint32_t *fr = &freqs[ctx * 256];
        const uint32_t *cm = &cum[ctx * 257];
        uint32_t x = st[k];
        uint32_t slot = x & (kTotFreq - 1);
        uint8_t s = lut[(size_t)ctx * kTotFreq + slot];
        out[i] = s;
        x = fr[s] * (x >> 12) + slot - cm[s];
        while (x < kRansL && off < n) x = (x << 8) | buf[off++];
        st[k] = x;
        last[k] = s;
    };
    for (int64_t step = 0; step < q; step++)
        for (int k = 0; k < 4; k++) dec(k, starts[k] + step);
    for (int64_t i = starts[3] + q; i < usize; i++) dec(3, i);
    return usize;
}

}  // extern "C"
