"""BAM reader/writer (self-contained, no htslib).

Decodes BAM records into numpy-backed `BamRec` objects carrying exactly the
information the calling pipeline needs. The packed read encoding matches the
reference (input_sam.c:61-88): one byte per base, low 2 bits base A,C,G,T =
0..3, high 6 bits quality clamped to MAX_QUAL; N bases become byte 0.

The writer exists to build test fixtures and for utility conversions.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from portbench.ref.constants import MAX_QUAL, NON_CONVERTED, STRAND_C2T, STRAND_G2A
from portbench.ref.io.bgzf import BgzfWriter, open_reader

# BAM flags (standard SAM spec)
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

CIGAR_OPS = "MIDNSHP=X"

# 4-bit nibble -> base code 0..4 (N,A,C,G,T)
_NIB2CODE = np.zeros(16, dtype=np.uint8)
_NIB2CODE[1] = 1  # A
_NIB2CODE[2] = 2  # C
_NIB2CODE[4] = 3  # G
_NIB2CODE[8] = 4  # T

_SEQ_CHARS = "=ACMGRSVTWYHKDBN"
_CHAR2NIB = {c: i for i, c in enumerate(_SEQ_CHARS)}
_CHAR2NIB_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in _CHAR2NIB.items():
    _CHAR2NIB_LUT[ord(_c)] = _i
    _CHAR2NIB_LUT[ord(_c.lower())] = _i
del _c, _i


@dataclass
class BamHeader:
    text: str = ""
    ref_names: List[str] = field(default_factory=list)
    ref_lens: List[int] = field(default_factory=list)


@dataclass
class BamRec:
    name: str
    flag: int
    tid: int
    pos: int  # 0-based
    mapq: int
    cigar: List[Tuple[int, int]]  # (oplen, op index into CIGAR_OPS)
    mtid: int
    mpos: int  # 0-based
    isize: int
    seq_code: np.ndarray  # base codes 0..4
    qual: np.ndarray  # raw quality (not clamped)
    aux: bytes
    l_qseq: int = 0

    def packed_read(self) -> np.ndarray:
        """(base-1)|(qual<<2) packed bytes (input_sam.c:77-87)."""
        q = np.minimum(self.qual, MAX_QUAL).astype(np.uint8)
        code = self.seq_code
        out = np.where(code > 0, (code - 1) | (q << 2), 0).astype(np.uint8)
        return out


def decode_bs_strand(aux: bytes) -> int:
    """Bisulfite strand from aligner-specific aux tags (input_sam.c:144-220):
    GEM XB:A:C/G, Bowtie/Bismark XG:Z, Novoalign ZB:Z, BSMAP ZS:Z:+/-,
    bwa-meth YD:Z:f/r. Later tags win, as in the reference scan loop."""
    strand = NON_CONVERTED
    i = 0
    n = len(aux)
    while i + 4 <= n:
        tag = aux[i : i + 2]
        typ = aux[i + 2 : i + 3]
        i += 3
        aligner = None
        if tag == b"ZB":
            aligner = "nov"
        elif tag == b"ZS":
            aligner = "bsmap"
        elif tag == b"XG":
            aligner = "bowtie"
        elif tag == b"XB":
            aligner = "gem"
        elif tag == b"YD":
            aligner = "bwameth"
        if typ == b"A":
            if aligner == "gem" and i < n:
                c = aux[i : i + 1]
                if c == b"C":
                    strand = STRAND_C2T
                elif c == b"G":
                    strand = STRAND_G2A
            i += 1
        elif typ in (b"C", b"c"):
            i += 1
        elif typ in (b"S", b"s"):
            i += 2
        elif typ in (b"I", b"i", b"f"):
            i += 4
        elif typ == b"d":
            i += 8
        elif typ in (b"Z", b"H"):
            end = aux.find(b"\x00", i)
            if end < 0:
                break
            if typ == b"Z" and aligner is not None and end > i:
                c = aux[i : i + 1]
                if aligner in ("bowtie", "nov"):
                    if c == b"C":
                        strand = STRAND_C2T
                    elif c == b"G":
                        strand = STRAND_G2A
                elif aligner == "bsmap":
                    if c == b"+":
                        strand = STRAND_C2T
                    elif c == b"-":
                        strand = STRAND_G2A
                elif aligner == "bwameth":
                    if c == b"f":
                        strand = STRAND_C2T
                    elif c == b"r":
                        strand = STRAND_G2A
            i = end + 1
        elif typ == b"B":
            if i >= n:
                break
            sub = aux[i : i + 1]
            i += 1
            sizes = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}
            if sub not in sizes or i + 4 > n:
                break
            cnt = struct.unpack_from("<I", aux, i)[0]
            i += 4 + cnt * sizes[sub]
        else:
            break
    return strand


class BamReader:
    """Sequential BAM reader (path, or any stream with read() — e.g.
    gzip-wrapped stdin; the reference reads BAM from pipes through
    htslib, process.c:112-137)."""

    def __init__(self, path: str = None, fileobj=None):
        self._f = fileobj if fileobj is not None else open_reader(path)
        magic = self._f.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path or '<stream>'}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._f.read(4))
        text = self._f.read(l_text).rstrip(b"\x00").decode()
        (n_ref,) = struct.unpack("<i", self._f.read(4))
        names, lens = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._f.read(4))
            names.append(self._f.read(l_name)[:-1].decode())
            lens.append(struct.unpack("<i", self._f.read(4))[0])
        self.header = BamHeader(text=text, ref_names=names, ref_lens=lens)

    def __iter__(self) -> Iterator[BamRec]:
        unpack_core = struct.Struct("<iiBBHHHiii").unpack
        while True:
            bs = self._f.read(4)
            if len(bs) < 4:
                return
            (block_size,) = struct.unpack("<i", bs)
            data = self._f.read(block_size)
            if len(data) < block_size:
                raise EOFError("BAM input truncated")
            (
                tid,
                pos,
                l_read_name,
                mapq,
                _bin,
                n_cigar,
                flag,
                l_seq,
                mtid,
                mpos,
            ) = struct.unpack_from("<iiBBHHHiii", data, 0)
            (isize,) = struct.unpack_from("<i", data, 28)
            off = 32
            name = data[off : off + l_read_name - 1].decode()
            off += l_read_name
            cigar = []
            for k in range(n_cigar):
                (v,) = struct.unpack_from("<I", data, off)
                off += 4
                cigar.append((v >> 4, v & 0xF))
            nbytes = (l_seq + 1) // 2
            seq_raw = np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=off)
            off += nbytes
            nib = np.empty(nbytes * 2, dtype=np.uint8)
            nib[0::2] = seq_raw >> 4
            nib[1::2] = seq_raw & 0xF
            seq_code = _NIB2CODE[nib[:l_seq]]
            qual = np.frombuffer(
                data, dtype=np.uint8, count=l_seq, offset=off
            ).copy()
            if l_seq and qual[0] == 0xFF:
                qual = np.zeros(l_seq, dtype=np.uint8)
            off += l_seq
            aux = bytes(data[off:])
            yield BamRec(
                name=name,
                flag=flag,
                tid=tid,
                pos=pos,
                mapq=mapq,
                cigar=cigar,
                mtid=mtid,
                mpos=mpos,
                isize=isize,
                seq_code=seq_code,
                qual=qual,
                aux=aux,
                l_qseq=l_seq,
            )

    def close(self):
        self._f.close()


_CODE2NIB = np.array([15, 1, 2, 4, 8], dtype=np.uint8)  # N,A,C,G,T
_CORE = struct.Struct("<iiBBHHHiiii")


def encode_bam_record(rec: "BamRec") -> bytes:
    """Serialize a BamRec to the raw BAM record layout
    ([u32 size][body]) — feeds the native pipeline's push mode for
    CRAM/SAM inputs. seq comes from rec.seq_code (0..4)."""
    nb = rec.name.encode() + b"\x00"
    code = rec.seq_code
    if code is None or len(code) == 0:
        l_seq = 0
        seq_bytes = b""
        qual_bytes = b""
    else:
        l_seq = len(code)
        nibs = _CODE2NIB[code]
        if l_seq & 1:
            nibs = np.append(nibs, np.uint8(0))
        seq_bytes = ((nibs[0::2] << 4) | nibs[1::2]).tobytes()
        if rec.qual is None:
            qual_bytes = b"\xff" * l_seq
        else:
            qual_bytes = rec.qual.astype(np.uint8).tobytes()
    cig = b"".join(
        struct.pack("<I", (ln << 4) | op) for ln, op in rec.cigar
    )
    body = (
        _CORE.pack(
            rec.tid, rec.pos, len(nb), rec.mapq, 0, len(rec.cigar),
            rec.flag, l_seq, rec.mtid, rec.mpos, rec.isize,
        )
        + nb + cig + seq_bytes + qual_bytes + rec.aux
    )
    return struct.pack("<i", len(body)) + body


class BamWriter:
    """BAM writer (fixtures/utilities)."""

    def __init__(self, path: str, header: BamHeader):
        self._raw = open(path, "wb")
        self._w = BgzfWriter(self._raw)
        text = header.text.encode()
        out = b"BAM\x01" + struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(header.ref_names))
        for name, ln in zip(header.ref_names, header.ref_lens):
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self._w.write(out)

    def write(
        self,
        name: str,
        flag: int,
        tid: int,
        pos: int,
        mapq: int,
        cigar: List[Tuple[int, int]],
        mtid: int,
        mpos: int,
        isize: int,
        seq: str,
        qual: Optional[np.ndarray],
        aux: bytes = b"",
    ):
        nb = name.encode() + b"\x00"
        l_seq = len(seq)
        nib = _CHAR2NIB_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]
        if len(nib) % 2:
            nib = np.append(nib, np.uint8(0))
        seq_bytes = ((nib[0::2] << 4) | nib[1::2]).tobytes()
        if qual is None:
            qual_bytes = b"\xff" * l_seq
        else:
            qual_bytes = np.ascontiguousarray(
                np.asarray(qual, dtype=np.uint8)
            ).tobytes()
        core = struct.pack(
            "<iiBBHHHiii",
            tid,
            pos,
            len(nb),
            mapq,
            0,
            len(cigar),
            flag,
            l_seq,
            mtid,
            mpos,
        ) + struct.pack("<i", isize)
        cig = b"".join(
            struct.pack("<I", (ln << 4) | op) for ln, op in cigar
        )
        rec = core + nb + cig + seq_bytes + qual_bytes + aux
        self._w.write(struct.pack("<i", len(rec)) + rec)

    def close(self):
        self._w.close()
        self._raw.close()


def aux_tag(tag: str, typ: str, value) -> bytes:
    """Encode a single aux field (helper for fixtures)."""
    out = tag.encode() + typ.encode()
    if typ == "A":
        out += value.encode()
    elif typ == "Z":
        out += value.encode() + b"\x00"
    elif typ == "i":
        out += struct.pack("<i", value)
    elif typ == "C":
        out += struct.pack("<B", value)
    elif typ == "f":
        out += struct.pack("<f", value)
    else:
        raise ValueError(typ)
    return out
