"""CRAM primitive codecs: ITF8/LTF8 varints and the rANS 4x8 entropy codec
(orders 0 and 1), per the CRAM 3.0 specification.

Implemented from the specification; validated by encoder/decoder
round-trips (no htslib is available in this environment to cross-check
against foreign files — see io/cram.py docstring)."""

from __future__ import annotations

import struct
from typing import List, Tuple

# ---------------- ITF8 / LTF8 ----------------


def read_itf8(buf: bytes, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    if b0 < 0x80:
        return b0, off + 1
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | buf[off + 1], off + 2
    if b0 < 0xE0:
        return (
            ((b0 & 0x3F) << 16) | (buf[off + 1] << 8) | buf[off + 2],
            off + 3,
        )
    if b0 < 0xF0:
        return (
            ((b0 & 0x1F) << 24)
            | (buf[off + 1] << 16)
            | (buf[off + 2] << 8)
            | buf[off + 3],
            off + 4,
        )
    v = (
        ((b0 & 0x0F) << 28)
        | (buf[off + 1] << 20)
        | (buf[off + 2] << 12)
        | (buf[off + 3] << 4)
        | (buf[off + 4] & 0x0F)
    )
    # interpret as signed 32-bit
    if v & 0x80000000:
        v -= 1 << 32
    return v, off + 5


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x400000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes(
            [0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF]
        )
    return bytes(
        [
            0xF0 | ((v >> 28) & 0x0F),
            (v >> 20) & 0xFF,
            (v >> 12) & 0xFF,
            (v >> 4) & 0xFF,
            v & 0x0F,
        ]
    )


def read_ltf8(buf: bytes, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    n = 0
    for i in range(8):
        if not (b0 & (0x80 >> i)):
            n = i
            break
    else:
        n = 8
    if n == 0:
        return b0, off + 1
    if n == 8:
        v = int.from_bytes(buf[off + 1 : off + 9], "big")
        if v & (1 << 63):
            v -= 1 << 64
        return v, off + 9
    v = b0 & (0xFF >> (n + 1))
    for i in range(n):
        v = (v << 8) | buf[off + 1 + i]
    return v, off + 1 + n


def write_ltf8(v: int) -> bytes:
    v &= (1 << 64) - 1
    if v < 0x80:
        return bytes([v])
    for n in range(1, 8):
        if v < (1 << (7 * (n + 1))):
            prefix = (0xFF << (8 - n)) & 0xFF
            head = prefix | (v >> (8 * n))
            body = v.to_bytes(8, "big")[-n:]
            return bytes([head]) + body
    return b"\xff" + v.to_bytes(8, "big")


# ---------------- rANS 4x8 ----------------

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT
RANS_BYTE_L = 1 << 23


def _normalize_freqs(hist: List[int], total: int) -> List[int]:
    freqs = [0] * 256
    if total == 0:
        return freqs
    # scale to TOTFREQ, ensuring every present symbol keeps freq >= 1
    acc = 0
    present = [i for i in range(256) if hist[i]]
    for i in present:
        f = hist[i] * TOTFREQ // total
        if f == 0:
            f = 1
        freqs[i] = f
        acc += f
    # adjust to exactly TOTFREQ on the most frequent symbol
    if acc != TOTFREQ:
        mx = max(present, key=lambda i: freqs[i])
        freqs[mx] += TOTFREQ - acc
        assert freqs[mx] > 0
    return freqs


def _write_sym_runs(syms: List[int], payloads: List[bytes]) -> bytes:
    """Symbol-run serialization shared by the order-0 table (payload =
    freq bytes) and the order-1 table of tables (payload = inner table):
       sym0, payload0, [nxt, (rle if nxt==sym+1)], payload1, ..., 0
    mirroring the decoder's traversal."""
    out = bytearray()
    if not syms:
        return b"\x00\x00"  # unreachable for non-empty input
    out.append(syms[0])
    rle = 0
    for i, s in enumerate(syms):
        out += payloads[i]
        if rle:
            rle -= 1
        elif i + 1 == len(syms):
            out.append(0)
        else:
            nxt = syms[i + 1]
            out.append(nxt)
            if nxt == s + 1:
                cnt = 1
                while i + 1 + cnt < len(syms) and syms[i + 1 + cnt] == (
                    nxt + cnt
                ):
                    cnt += 1
                out.append(cnt - 1)
                rle = cnt - 1
    return bytes(out)


def _freq_bytes(f: int) -> bytes:
    if f < 128:
        return bytes([f])
    return bytes([0x80 | (f >> 8), f & 0xFF])


def _write_freqs(freqs: List[int]) -> bytes:
    """Order-0 frequency table serialization."""
    syms = [i for i in range(256) if freqs[i] > 0]
    return _write_sym_runs(syms, [_freq_bytes(freqs[s]) for s in syms])


def _read_freqs(buf: bytes, off: int):
    """Order-0 frequency table parse. Returns (freqs, off)."""
    freqs = [0] * 256
    s = buf[off]
    off += 1
    rle = 0
    while True:
        f = buf[off]
        off += 1
        if f >= 0x80:
            f = ((f & 0x7F) << 8) | buf[off]
            off += 1
        freqs[s] = f
        if rle:
            rle -= 1
            s += 1
        else:
            nxt = buf[off]
            off += 1
            if nxt == 0:
                break
            if nxt == s + 1:
                rle = buf[off]
                off += 1
            s = nxt
    return freqs, off


def _cum(freqs: List[int]) -> List[int]:
    c = [0] * 257
    for i in range(256):
        c[i + 1] = c[i] + freqs[i]
    return c


def rans_encode_o0(data: bytes) -> bytes:
    hist = [0] * 256
    for b in data:
        hist[b] += 1
    freqs = _normalize_freqs(hist, len(data))
    cum = _cum(freqs)
    table = _write_freqs(freqs)
    # 4 interleaved states; bytes encoded in reverse
    states = [RANS_BYTE_L] * 4
    out = bytearray()
    n = len(data)
    for i in range(n - 1, -1, -1):
        j = i & 3
        s = data[i]
        f = freqs[s]
        x = states[j]
        x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + cum[s]
    head = bytearray()
    for j in range(4):
        head += struct.pack("<I", states[j])
    comp = bytes(head) + bytes(out[::-1])
    payload = table + comp
    return (
        b"\x00"
        + struct.pack("<I", len(payload))
        + struct.pack("<I", n)
        + payload
    )


def rans_decode(data: bytes) -> bytes:
    order = data[0]
    # comp_size = data[1:5]; uncompressed size:
    (usize,) = struct.unpack_from("<I", data, 5)
    if usize == 0:
        return b""
    out = _rans_decode_native(order, data[9:], usize)
    if out is not None:
        return out
    if order == 0:
        return _rans_decode_o0(data[9:], usize)
    return _rans_decode_o1(data[9:], usize)


def _rans_decode_native(order: int, buf: bytes, usize: int):
    """C++ decoder (native/bsc_rans.cpp); None -> Python fallback."""
    try:
        import ctypes

        from bs_call_tpu_torch.native import load

        lib = load()
        if lib is None:
            return None
    except Exception:
        return None
    import numpy as np

    out = np.empty(usize, dtype=np.uint8)
    fn = lib.bsc_rans_decode_o0 if order == 0 else lib.bsc_rans_decode_o1
    r = fn(
        buf,
        ctypes.c_int64(len(buf)),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(usize),
    )
    if r != usize:
        return None
    return out.tobytes()


def _decode_tables(freqs):
    cum = _cum(freqs)
    # symbol lookup per 12-bit slot
    lut = bytearray(TOTFREQ)
    for s in range(256):
        if freqs[s]:
            lut[cum[s] : cum[s + 1]] = bytes([s]) * freqs[s]
    return cum, bytes(lut)


def _rans_decode_o0(buf: bytes, usize: int) -> bytes:
    freqs, off = _read_freqs(buf, 0)
    cum, lut = _decode_tables(freqs)
    states = list(struct.unpack_from("<4I", buf, off))
    off += 16
    out = bytearray(usize)
    n = len(buf)
    for i in range(usize):
        j = i & 3
        x = states[j]
        slot = x & (TOTFREQ - 1)
        s = lut[slot]
        out[i] = s
        x = freqs[s] * (x >> TF_SHIFT) + slot - cum[s]
        while x < RANS_BYTE_L and off < n:
            x = (x << 8) | buf[off]
            off += 1
        states[j] = x
    return bytes(out)


def rans_encode_o1(data: bytes) -> bytes:
    n = len(data)
    if n < 4:
        return rans_encode_o0(data)
    # order-1 context histograms
    hist = [[0] * 256 for _ in range(256)]
    # 4 interleaved streams, each encodes a quarter (last takes remainder)
    q = n >> 2
    starts = [0, q, 2 * q, 3 * q]
    ends = [q, 2 * q, 3 * q, n]
    for k in range(4):
        last = 0
        for i in range(starts[k], ends[k]):
            hist[last][data[i]] += 1
            last = data[i]
    freqs = []
    cums = []
    for c in range(256):
        tot = sum(hist[c])
        f = _normalize_freqs(hist[c], tot)
        freqs.append(f)
        cums.append(_cum(f))
    # serialize table of tables: context symbol runs like order-0
    ctxs = [c for c in range(256) if any(hist[c])]
    table = _write_sym_runs(ctxs, [_write_freqs(freqs[c]) for c in ctxs])
    # Encode into a single shared byte stream: symbols are consumed by the
    # decoder in round-robin order (per step, streams 0..3, plus stream
    # 3's tail), so we encode in the exact reverse order, appending
    # renormalization bytes to one buffer and reversing it at the end.
    states = [RANS_BYTE_L] * 4
    out = bytearray()

    def enc(k, ctx, s):
        f = freqs[ctx][s]
        x = states[k]
        x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        states[k] = ((x // f) << TF_SHIFT) + (x % f) + cums[ctx][s]

    isz4 = q
    # stream 3 tail, reversed
    for i in range(ends[3] - 1, starts[3] + isz4 - 1, -1):
        enc(3, data[i - 1], data[i])
    # common steps, last to first, streams 3..0
    for step in range(isz4 - 1, -1, -1):
        for k in range(3, -1, -1):
            i = starts[k] + step
            ctx = data[i - 1] if step > 0 else 0
            enc(k, ctx, data[i])
    payload = bytes(table)
    for k in range(4):
        payload += struct.pack("<I", states[k])
    payload += bytes(out[::-1])
    return (
        b"\x01"
        + struct.pack("<I", len(payload))
        + struct.pack("<I", n)
        + payload
    )


def _rans_decode_o1(buf: bytes, usize: int) -> bytes:
    # parse table of tables
    freqs = [[0] * 256 for _ in range(256)]
    off = 0
    c = buf[off]
    off += 1
    rle = 0
    while True:
        f, off = _read_freqs(buf, off)
        freqs[c] = f
        if rle:
            rle -= 1
            c += 1
        else:
            nxt = buf[off]
            off += 1
            if nxt == 0:
                break
            if nxt == c + 1:
                rle = buf[off]
                off += 1
            c = nxt
    cums = [_cum(f) for f in freqs]
    luts = {}
    states = list(struct.unpack_from("<4I", buf, off))
    off += 16
    q = usize >> 2
    starts = [0, q, 2 * q, 3 * q]
    out = bytearray(usize)
    last = [0, 0, 0, 0]
    n = len(buf)

    def dec(k, i):
        nonlocal off
        ctx = last[k]
        fr = freqs[ctx]
        if ctx not in luts:
            luts[ctx] = _decode_tables(fr)[1]
        lut = luts[ctx]
        x = states[k]
        slot = x & (TOTFREQ - 1)
        s = lut[slot]
        out[i] = s
        x = fr[s] * (x >> TF_SHIFT) + slot - cums[ctx][s]
        while x < RANS_BYTE_L and off < n:
            x = (x << 8) | buf[off]
            off += 1
        states[k] = x
        last[k] = s

    for step in range(q):
        for k in range(4):
            dec(k, starts[k] + step)
    for i in range(starts[3] + q, usize):
        dec(3, i)
    return bytes(out)
