"""BAI index support: random-access region iteration over BAM files.

Replaces htslib's sam_index_load + sam_itr_queryi (process.c:125,
get_template_vector.c:71): reads the UCSC-binning index, selects chunks
for a region, seeks the BGZF stream to virtual offsets and yields records
overlapping the region.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, Tuple

import numpy as np

from bs_call_tpu_torch.io.bam import BamRec, BamReader


class BgzfRandomAccess:
    """Seekable BGZF reader keyed by virtual offsets
    (coffset << 16 | uoffset)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._cache_coff = -1
        self._cache_data = b""

    def block_at(self, coffset: int) -> Tuple[bytes, int]:
        """Returns (decompressed block, next coffset)."""
        if coffset == self._cache_coff:
            return self._cache_data, self._cache_next
        f = self._f
        f.seek(coffset)
        hdr = f.read(12)
        if len(hdr) < 12:
            return b"", coffset
        xlen = struct.unpack_from("<H", hdr, 10)[0]
        extra = f.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= xlen:
            slen = struct.unpack_from("<H", extra, i + 2)[0]
            if extra[i : i + 2] == b"BC" and slen == 2:
                bsize = struct.unpack_from("<H", extra, i + 4)[0]
            i += 4 + slen
        if bsize is None:
            raise ValueError("not a BGZF block")
        csize = bsize + 1 - 12 - xlen - 8
        comp = f.read(csize)
        f.read(8)
        data = zlib.decompress(comp, -15)
        self._cache_coff = coffset
        self._cache_data = data
        self._cache_next = coffset + bsize + 1
        return data, self._cache_next

    def read_from(self, voffset: int, n: int) -> bytes:
        """Read n bytes starting at a virtual offset."""
        coff = voffset >> 16
        uoff = voffset & 0xFFFF
        out = bytearray()
        while len(out) < n:
            data, nxt = self.block_at(coff)
            if not data and len(out) < n:
                break
            out += data[uoff:]
            uoff = 0
            coff = nxt
        return bytes(out[:n])

    def close(self):
        self._f.close()


def _reg2bins(beg: int, end: int) -> List[int]:
    """UCSC binning scheme (SAM spec 5.3)."""
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] != b"BAI\x01":
            raise ValueError(f"{path}: not a BAI index")
        (n_ref,) = struct.unpack_from("<i", raw, 4)
        off = 8
        self.refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            bins = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", raw, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", raw, off)
                    off += 16
                    chunks.append((cb, ce))
                bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", raw, off)
            off += 4
            intv = list(struct.unpack_from(f"<{n_intv}Q", raw, off))
            off += 8 * n_intv
            self.refs.append((bins, intv))

    def chunks_for(self, tid: int, beg: int, end: int):
        """Merged candidate chunk list for 0-based [beg, end)."""
        if tid < 0 or tid >= len(self.refs):
            return []
        bins, intv = self.refs[tid]
        min_off = 0
        iv = beg >> 14
        if iv < len(intv):
            min_off = intv[iv]
        chunks = []
        for b in _reg2bins(beg, end):
            if b == 37450:  # pseudo-bin with metadata
                continue
            for cb, ce in bins.get(b, []):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        merged = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        return merged


class IndexedBamReader:
    """Region iteration over an indexed BAM (the sam_itr_queryi
    analogue)."""

    def __init__(self, bam_path: str, bai_path: str = None):
        import os

        self._reader = BamReader(bam_path)  # header parse
        self.header = self._reader.header
        self._reader.close()
        self._bgzf = BgzfRandomAccess(bam_path)
        # index resolution like htslib's sam_index_load: explicit path,
        # else <bam>.bai then <bam>.csi (process.c:125)
        if bai_path is None:
            if os.path.exists(bam_path + ".bai"):
                bai_path = bam_path + ".bai"
            elif os.path.exists(bam_path + ".csi"):
                bai_path = bam_path + ".csi"
            else:
                bai_path = bam_path + ".bai"  # raise the usual error
        if bai_path.endswith(".csi"):
            from bs_call_tpu_torch.io.csi import CsiIndex

            self.index = CsiIndex(bai_path)
        else:
            self.index = BaiIndex(bai_path)

    def query(self, tid: int, beg: int, end: int) -> Iterator[BamRec]:
        """Yield records overlapping 0-based [beg, end), in order."""
        for cb, ce in self.index.chunks_for(tid, beg, end):
            for rec in self._iter_chunk(cb, ce):
                if rec.tid != tid or rec.pos >= end:
                    return
                span = sum(
                    ln for ln, op in rec.cigar if op in (0, 2, 3, 7, 8)
                )
                if rec.pos + max(span, 1) > beg:
                    yield rec

    def _read_range(self, cb: int, ce: int) -> bytes:
        """Exact uncompressed bytes between two virtual offsets; chunk
        boundaries delimit whole records (SAM spec), so reading past ce —
        which would duplicate the next chunk's records — never happens."""
        coff, uoff = cb >> 16, cb & 0xFFFF
        e_coff, e_uoff = ce >> 16, ce & 0xFFFF
        out = bytearray()
        while coff < e_coff:
            data, nxt = self._bgzf.block_at(coff)
            if not data:
                return bytes(out)
            out += data[uoff:]
            uoff = 0
            coff = nxt
        if coff == e_coff and e_uoff > uoff:
            data, _ = self._bgzf.block_at(coff)
            out += data[uoff:e_uoff]
        return bytes(out)

    def _iter_chunk(self, cb: int, ce: int) -> Iterator[BamRec]:
        buf = self._read_range(cb, ce)
        pos = 0
        while len(buf) - pos >= 4:
            (bs,) = struct.unpack_from("<i", buf, pos)
            if len(buf) - pos < 4 + bs:
                break
            yield _parse_record(buf, pos + 4, bs)
            pos += 4 + bs

    def close(self):
        self._bgzf.close()


def _parse_record(data: bytes, off: int, bs: int) -> BamRec:
    from bs_call_tpu_torch.io.bam import _NIB2CODE

    (
        tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, mtid, mpos
    ) = struct.unpack_from("<iiBBHHHiii", data, off)
    (isize,) = struct.unpack_from("<i", data, off + 28)
    p = off + 32
    name = data[p : p + l_read_name - 1].decode()
    p += l_read_name
    cigar = []
    for _ in range(n_cigar):
        (w,) = struct.unpack_from("<I", data, p)
        p += 4
        cigar.append((w >> 4, w & 0xF))
    nb = (l_seq + 1) // 2
    seq_raw = np.frombuffer(data, np.uint8, nb, p)
    p += nb
    nib = np.empty(nb * 2, np.uint8)
    nib[0::2] = seq_raw >> 4
    nib[1::2] = seq_raw & 0xF
    seq_code = _NIB2CODE[nib[:l_seq]]
    qual = np.frombuffer(data, np.uint8, l_seq, p).copy()
    if l_seq and qual[0] == 0xFF:
        qual = np.zeros(l_seq, np.uint8)
    p += l_seq
    aux = bytes(data[p : off + bs])
    return BamRec(
        name=name, flag=flag, tid=tid, pos=pos, mapq=mapq, cigar=cigar,
        mtid=mtid, mpos=mpos, isize=isize, seq_code=seq_code, qual=qual,
        aux=aux, l_qseq=l_seq,
    )


def _walk_records(bam_path: str, reg2bin_fn):
    """Walk a BAM recording (bin -> chunk list) and 16kb linear-interval
    offsets per reference; shared by the .bai and .csi builders.
    Returns (n_ref, refs, intvs)."""
    bg = BgzfRandomAccess(bam_path)
    # parse header length first to find the first record voffset
    coff = 0
    buf = bytearray()
    offs: List[int] = []  # virtual offset of each buffered byte's origin
    block_bounds: List[Tuple[int, int]] = []  # (ustart_in_buf, coff)
    total_u = 0
    blocks = []
    while True:
        data, nxt = bg.block_at(coff)
        if not data:
            break
        blocks.append((coff, total_u, len(data)))
        total_u += len(data)
        buf += data
        coff = nxt

    def voff_of(upos: int) -> int:
        # binary search block
        lo, hi = 0, len(blocks) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if blocks[mid][1] <= upos:
                lo = mid
            else:
                hi = mid - 1
        coff_, ustart, _ = blocks[lo]
        return (coff_ << 16) | (upos - ustart)

    b = bytes(buf)
    if b[:4] != b"BAM\x01":
        raise ValueError("not BAM")
    (l_text,) = struct.unpack_from("<i", b, 4)
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", b, p)
    p += 4
    for _ in range(n_ref):
        (ln,) = struct.unpack_from("<i", b, p)
        p += 4 + ln + 4
    refs = [dict() for _ in range(n_ref)]
    intvs = [dict() for _ in range(n_ref)]
    while p + 4 <= len(b):
        (bs,) = struct.unpack_from("<i", b, p)
        if p + 4 + bs > len(b):
            break
        start_v = voff_of(p)
        end_v = voff_of(p + 4 + bs)
        tid, pos = struct.unpack_from("<ii", b, p + 4)
        n_cigar, = struct.unpack_from("<H", b, p + 4 + 12)
        l_read_name = b[p + 4 + 8]
        cig_off = p + 4 + 32 + l_read_name
        span = 0
        for ci in range(n_cigar):
            (w,) = struct.unpack_from("<I", b, cig_off + 4 * ci)
            if (w & 0xF) in (0, 2, 3, 7, 8):
                span += w >> 4
        if tid >= 0 and pos >= 0:
            end = pos + max(span, 1)
            bin_ = reg2bin_fn(pos, end)
            refs[tid].setdefault(bin_, []).append((start_v, end_v))
            for iv in range(pos >> 14, ((end - 1) >> 14) + 1):
                cur = intvs[tid].get(iv)
                if cur is None or start_v < cur:
                    intvs[tid][iv] = start_v
        p += 4 + bs
    bg.close()
    return n_ref, refs, intvs


def write_bai(bam_path: str, out_path: str = None):
    """Build a .bai for a coordinate-sorted BAM (the `samtools index`
    analogue, used by tests and as a utility)."""
    out_path = out_path or bam_path + ".bai"
    n_ref, refs, intvs = _walk_records(bam_path, _reg2bin)
    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", n_ref)
    for tid in range(n_ref):
        bins = refs[tid]
        # merge adjacent chunks per bin
        out += struct.pack("<i", len(bins))
        for bin_ in sorted(bins):
            chunks = []
            for cb, ce in sorted(bins[bin_]):
                if chunks and cb <= chunks[-1][1]:
                    chunks[-1] = (chunks[-1][0], max(chunks[-1][1], ce))
                else:
                    chunks.append((cb, ce))
            out += struct.pack("<Ii", bin_, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        iv = intvs[tid]
        n_intv = max(iv) + 1 if iv else 0
        out += struct.pack("<i", n_intv)
        last = 0
        for i in range(n_intv):
            last = iv.get(i, last)
            out += struct.pack("<Q", last)
    with open(out_path, "wb") as f:
        f.write(bytes(out))
    return out_path


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0
