"""Writers for the inputs a pass reads: BGZF/BAM, FASTA with its .fai, and
bs_call's dbSNP index. NumPy and zlib only; nothing of the port.

Modelled on the port's `io/bgzf.py`, `io/bam.py` and `io/dbsnp_idx.py`,
vectorised: a BAM record is a row of bytes built for all records of one
layout at once, and BGZF blocks deflate on a thread pool (zlib releases
the interpreter lock)."""

from __future__ import annotations

import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BGZF_PAYLOAD = 0xFF00
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_NIB = np.full(256, 15, dtype=np.uint8)
for _c, _v in zip(b"=ACGT", (0, 1, 2, 4, 8)):
    _NIB[_c] = _v


def _bgzf_block(payload: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = c.compress(payload) + c.flush()
    hdr = struct.pack("<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6,
                      66, 67, 2, len(data) + 25)
    return hdr + data + struct.pack("<II", zlib.crc32(payload),
                                    len(payload))


class BgzfWriter:
    """BGZF stream: payloads of 0xFF00 bytes deflated on `pool` while the
    caller goes on, written in order, the EOF block on close."""

    def __init__(self, path: str, pool: ThreadPoolExecutor, level: int = 6):
        self._f = open(path, "wb")
        self._pool = pool
        self._level = level
        self._buf = bytearray()
        self._pending = deque()
        self.block_sizes = []  # compressed size of each block, in order

    def write(self, data) -> None:
        self._buf += data
        n = len(self._buf) // BGZF_PAYLOAD * BGZF_PAYLOAD
        if n:
            self._submit(bytes(self._buf[:n]))
            del self._buf[:n]
        while self._pending and self._pending[0].done():
            self._put(self._pending.popleft().result())

    def _put(self, block: bytes) -> None:
        self._f.write(block)
        self.block_sizes.append(len(block))

    def _submit(self, data: bytes) -> None:
        for i in range(0, len(data), BGZF_PAYLOAD):
            self._pending.append(self._pool.submit(
                _bgzf_block, data[i:i + BGZF_PAYLOAD], self._level))

    def close(self) -> None:
        if self._buf:
            self._submit(bytes(self._buf))
            self._buf.clear()
        while self._pending:
            self._put(self._pending.popleft().result())
        self._f.write(_BGZF_EOF)
        self._f.close()


def bam_header_bytes(names, lengths, text: str) -> bytes:
    tb = text.encode()
    out = bytearray(b"BAM\x01" + struct.pack("<i", len(tb)) + tb)
    out += struct.pack("<i", len(names))
    for n, ln in zip(names, lengths):
        nb = n.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return bytes(out)


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """SAM spec's reg2bin, vectorised; `end` exclusive."""
    end = end - 1
    out = np.zeros(len(beg), dtype=np.int64)
    done = np.zeros(len(beg), dtype=bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _layouts(rec: dict, cigar, name_width: int):
    """The records' layouts, (kind, length) pairs: the distinct keys, each
    record's index into them, and each record's size in bytes."""
    kind = rec["kind"].astype(np.int64)
    length = rec["length"].astype(np.int64)
    key = kind * 65536 + length
    ukeys, inv = np.unique(key, return_inverse=True)
    lay_ncig = np.array([len(cigar(int(k // 65536), int(k % 65536)))
                         for k in ukeys])
    ncig = lay_ncig[inv]
    rowlen = 36 + name_width + 1 + 4 * ncig + (length + 1) // 2 + length + 4
    return ukeys, inv, rowlen


def record_sizes(rec: dict, cigar, name_width: int = 10) -> np.ndarray:
    """Bytes of each record `encode_records` writes, its length field
    included."""
    if len(rec["pos"]) == 0:
        return np.zeros(0, dtype=np.int64)
    return _layouts(rec, cigar, name_width)[2]


def _put(rows, col, values, dtype):
    v = np.ascontiguousarray(np.asarray(values).astype(dtype))
    w = np.dtype(dtype).itemsize
    rows[:, col:col + w] = v.view(np.uint8).reshape(len(rows), w)
    return col + w


def encode_records(rec: dict, cigar, name_width: int = 10) -> bytes:
    """BAM records, in the order given, as one byte string.

    `rec` holds equal-length arrays: tid, pos (0-based), flag, mapq, mtid,
    mpos, tlen, name (int, printed as `r` and `name_width - 1` digits), xb
    (the GEM bisulfite-strand tag `XB:A:<xb>`), length (bases), kind (the
    layout), end (exclusive reference end), and seq, qual: [n, Lmax] uint8
    (ASCII bases; raw qualities). `cigar(kind, length)` is the list of
    (oplen, op) of a layout."""
    n = len(rec["pos"])
    if n == 0:
        return b""
    ukeys, inv, rowlen = _layouts(rec, cigar, name_width)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rowlen, out=offs[1:])
    flat = np.zeros(offs[-1], dtype=np.uint8)
    bins = reg2bin(rec["pos"].astype(np.int64), rec["end"].astype(np.int64))
    digits = name_width - 1
    for li, k in enumerate(ukeys):
        sel = np.nonzero(inv == li)[0]
        m = len(sel)
        kd, ln = int(k // 65536), int(k % 65536)
        cig = cigar(kd, ln)
        rl = int(rowlen[sel[0]])
        rows = np.zeros((m, rl), dtype=np.uint8)
        c = _put(rows, 0, rowlen[sel] - 4, "<i4")
        c = _put(rows, c, rec["tid"][sel], "<i4")
        c = _put(rows, c, rec["pos"][sel], "<i4")
        c = _put(rows, c, np.full(m, name_width + 1), "u1")
        c = _put(rows, c, rec["mapq"][sel], "u1")
        c = _put(rows, c, bins[sel], "<u2")
        c = _put(rows, c, np.full(m, len(cig)), "<u2")
        c = _put(rows, c, rec["flag"][sel], "<u2")
        c = _put(rows, c, np.full(m, ln), "<i4")
        c = _put(rows, c, rec["mtid"][sel], "<i4")
        c = _put(rows, c, rec["mpos"][sel], "<i4")
        c = _put(rows, c, rec["tlen"][sel], "<i4")
        rows[:, c] = ord("r")
        ids = rec["name"][sel].astype(np.int64)
        for d in range(digits):
            rows[:, c + digits - d] = 48 + (ids // 10 ** d) % 10
        c += name_width + 1
        for oplen, op in cig:
            c = _put(rows, c, np.full(m, (oplen << 4) | op), "<u4")
        nib = _NIB[rec["seq"][sel, :ln]]
        if ln % 2:
            nib = np.concatenate([nib, np.zeros((m, 1), np.uint8)], axis=1)
        rows[:, c:c + (ln + 1) // 2] = (nib[:, 0::2] << 4) | nib[:, 1::2]
        c += (ln + 1) // 2
        rows[:, c:c + ln] = rec["qual"][sel, :ln]
        c += ln
        rows[:, c:c + 3] = np.frombuffer(b"XBA", np.uint8)
        rows[:, c + 3] = rec["xb"][sel]
        flat[offs[sel][:, None] + np.arange(rl)] = rows
    return flat.tobytes()


def write_fasta(path: str, names, seqs, width: int = 60) -> None:
    """FASTA of `seqs` (uint8 ASCII arrays), `width` bases a line, and its
    .fai beside it."""
    fai = []
    off = 0
    with open(path, "wb") as f:
        for name, s in zip(names, seqs):
            head = f">{name}\n".encode()
            f.write(head)
            off += len(head)
            n = len(s)
            full = n // width
            body = np.full((full, width + 1), 10, dtype=np.uint8)
            body[:, :width] = s[:full * width].reshape(full, width)
            data = body.tobytes()
            if n % width:
                data += s[full * width:].tobytes() + b"\n"
            f.write(data)
            fai.append(f"{name}\t{n}\t{off}\t{width}\t{width + 1}\n")
            off += len(data)
    with open(path + ".fai", "w") as f:
        f.write("".join(fai))


def _pack_digits(ds: str) -> bytes:
    out = bytearray()
    for z in range(0, len(ds) - 1, 2):
        out.append(33 + int(ds[z]) * 10 + int(ds[z + 1]))
    if len(ds) % 2:
        out.append(133 + int(ds[-1]))
    return bytes(out)


def write_dbsnp_index(path: str, contigs, header: str) -> None:
    """bs_call's dbSNP index (the reference's `dbSNP_idx` output, as the
    port's `io/dbsnp_idx.py` writes it) of `contigs`: a list of (name,
    positions, ids), positions 1-based and increasing, each named
    `rs<id>`. No entry is MAF-selected."""
    items_per_block = 2048
    blocks_of = []
    max_buf = 0
    bounds = []
    for name, pos, ids in contigs:
        pos = np.asarray(pos, dtype=np.int64)
        binx = pos >> 6
        ubins, first = np.unique(binx, return_index=True)
        ends = list(first[1:]) + [len(pos)]
        blocks = []
        buf = bytearray()
        curr = int(ubins[0]) if len(ubins) else 0
        n_items = 0
        for b, lo, hi in zip(ubins.tolist(), first.tolist(), ends):
            k = b - curr
            if k < 64:
                buf.append(k << 2)
            elif k < 256:
                buf += bytes((1, k))
            elif k < 65536:
                buf.append(2)
                buf += struct.pack("<H", k)
            else:
                buf.append(3)
                buf += struct.pack("<I", k)
            curr = b
            for j in range(lo, hi):
                if j > lo:
                    buf.append(0)
                buf.append((int(pos[j]) & 63) | (1 << 6))
                buf += _pack_digits(str(int(ids[j])))
            buf.append(1)
            n_items += 1
            if n_items == items_per_block:
                max_buf = max(max_buf, len(buf))
                blocks.append(buf)
                buf = bytearray()
                n_items = 0
        if n_items or not blocks:
            max_buf = max(max_buf, len(buf))
            blocks.append(buf)
        blocks_of.append(blocks)
        bounds.append((int(ubins[0]) if len(ubins) else 0,
                       int(ubins[-1]) if len(ubins) else 0))
    with open(path, "wb") as fp:
        fp.seek(32)
        offsets = []
        for blocks in blocks_of:
            offsets.append(fp.tell())
            for blk in blocks:
                comp = zlib.compress(bytes(blk))
                fp.write(struct.pack("<Q", len(comp)) + comp)
            fp.write(struct.pack("<Q", 0))
        hdr_off = fp.tell()
        hdr = bytearray(struct.pack("<BBHI", 2, 0, 1, len(contigs)))
        hdr += header.encode() + b"\x00" + b"rs\x00"
        for (name, _p, _i), (lo, hi), off in zip(contigs, bounds, offsets):
            hdr += struct.pack("<IIQ", lo, hi, off) + name.encode() + b"\x00"
        max_buf = max(max_buf, len(hdr))
        comp = zlib.compress(bytes(hdr))
        fp.write(comp + struct.pack("<I", 0xD7278434))
        fp.seek(0)
        fp.write(struct.pack("<IIQQQ", 0xD7278434, 0, hdr_off, max_buf,
                             len(comp)))


BAI_META_BIN = 37450  # the pseudo-bin of a reference's span and counts
_U16 = np.uint64(16)


def virtual_offsets(u, block_sizes) -> np.ndarray:
    """BGZF virtual offsets (the block's file offset << 16 | the offset in
    its payload) of offsets `u` into the uncompressed stream that
    `BgzfWriter` cut every BGZF_PAYLOAD bytes into blocks of
    `block_sizes` compressed bytes. An offset at a block's end is the next
    block's start, as htslib's `bgzf_tell` gives it."""
    coff = np.concatenate([[0], np.cumsum(block_sizes)]).astype(np.uint64)
    u = np.asarray(u, dtype=np.int64)
    return (coff[u // BGZF_PAYLOAD] << _U16) | (u % BGZF_PAYLOAD).astype(
        np.uint64)


def write_bai(path: str, n_ref: int, tid, pos, end, flag, vbeg, vend):
    """The BAI index (SAM spec 5.2) of coordinate-sorted records, in the
    layout `samtools index` writes: for each reference its bins (SAM's
    reg2bin of [pos, end)), each a list of chunks of virtual offsets, the
    pseudo-bin 37450 (the reference's first and last offsets, mapped and
    unmapped counts), and the linear index (the least start offset of the
    records that meet each 16 kbp window); then no unplaced records.

    A chunk is a run of records in one bin that follow each other in the
    file; chunks of a bin merge where one begins in the BGZF block in
    which the one before it ends (htslib's rule). `vbeg`, `vend`: each
    record's start and end offsets (`virtual_offsets`)."""
    tid = np.asarray(tid, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)
    end = np.maximum(np.asarray(end, dtype=np.int64), pos + 1)
    vbeg = np.asarray(vbeg, dtype=np.uint64)
    vend = np.asarray(vend, dtype=np.uint64)
    bins = reg2bin(pos, end)
    out = bytearray(b"BAI\x01" + struct.pack("<i", n_ref))
    for t in range(n_ref):
        sel = np.nonzero(tid == t)[0]
        if not len(sel):
            out += struct.pack("<ii", 0, 0)
            continue
        b, vb, ve = bins[sel], vbeg[sel], vend[sel]
        run = np.ones(len(sel), dtype=bool)
        run[1:] = b[1:] != b[:-1]
        first = np.nonzero(run)[0]
        last = np.append(first[1:], len(sel)) - 1
        cbin, cb, ce = b[first], vb[first], ve[last]
        order = np.lexsort((cb, cbin))
        cbin, cb, ce = cbin[order], cb[order], ce[order]
        new = np.ones(len(cb), dtype=bool)
        new[1:] = (cbin[1:] != cbin[:-1]) | ((cb[1:] >> _U16)
                                             != (ce[:-1] >> _U16))
        at = np.nonzero(new)[0]
        mbin, mb, me = cbin[at], cb[at], np.maximum.reduceat(ce, at)
        ubins, bfirst = np.unique(mbin, return_index=True)
        bounds = np.append(bfirst, len(mbin))
        out += struct.pack("<i", len(ubins) + 1)
        for i, ub in enumerate(ubins.tolist()):
            k0, k1 = int(bounds[i]), int(bounds[i + 1])
            out += struct.pack("<Ii", ub, k1 - k0)
            out += np.stack([mb[k0:k1], me[k0:k1]], axis=1).astype(
                "<u8").tobytes()
        mapped = int(((np.asarray(flag)[sel] & 0x4) == 0).sum())
        out += struct.pack("<IiQQQQ", BAI_META_BIN, 2, int(vb[0]),
                           int(ve[-1]), mapped, len(sel) - mapped)
        w0, w1 = pos[sel] >> 14, (end[sel] - 1) >> 14
        none = np.iinfo(np.uint64).max
        lin = np.full(int(w1.max()) + 1, none, dtype=np.uint64)
        for k in range(int((w1 - w0).max()) + 1):
            m = w0 + k <= w1
            np.minimum.at(lin, (w0 + k)[m], vb[m])
        # windows before the first record take its offset, the other
        # empty ones the offset of the window before them
        lin[:int(w0.min())] = vb[0]
        have = np.where(lin == none, 0, np.arange(len(lin)))
        lin = lin[np.maximum.accumulate(have)]
        out += struct.pack("<i", len(lin)) + lin.astype("<u8").tobytes()
    out += struct.pack("<Q", 0)
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_bed(path: str, names, regions) -> None:
    """BED3 of `regions` ([(tid, lo, hi)], 0-based, half-open)."""
    with open(path, "w") as f:
        f.write("".join(f"{names[t]}\t{lo}\t{hi}\n" for t, lo, hi in regions))
