"""FASTA reference access with .fai index.

Replaces htslib's faidx + the reference's packed contig loader
(read_reference.c:44-141). Each contig is loaded on demand into a uint8
code array (0=N, 1..4=ACGT) — 1 byte/base instead of the reference's 3
bits/base; at one-contig-at-a-time residency this is ≤250 MB for human
chr1, irrelevant next to HBM-oriented batching, and makes the window
extraction a plain numpy slice.

GC bins (per-100bp %GC from the first non-N base) reproduce
read_reference.c:92-105 for the stats report.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

_BASE2CODE = np.zeros(256, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _BASE2CODE[ord(c)] = i + 1
    _BASE2CODE[ord(c.lower())] = i + 1
_ISGRAPH = np.zeros(256, dtype=bool)
for i in range(0x21, 0x7F):
    _ISGRAPH[i] = True


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int
    line_blen: int
    line_len: int


@dataclass
class ContigSeq:
    name: str
    codes: np.ndarray  # uint8 [length], 0=N
    start_pos: int  # 1-based first non-N base (read_reference.c:80)
    end_pos: int  # 1-based contig length
    gc_bins: Optional[np.ndarray] = None  # uint8 per 100bp from start_pos


def build_fai(path: str) -> List[FaiEntry]:
    """Scan the FASTA (plain or BGZF; offsets are uncompressed-byte
    offsets either way, as in htslib's .fai) and build the index."""
    from portbench.ref.io.bgzf import open_reader

    entries = []
    with open_reader(path) as f:
        name = None
        length = 0
        offset = 0
        line_blen = line_len = 0
        first_line = True
        pos = 0
        for raw in f:
            n = len(raw)
            if raw.startswith(b">"):
                if name is not None:
                    entries.append(FaiEntry(name, length, offset, line_blen, line_len))
                name = raw[1:].split()[0].decode()
                length = 0
                offset = pos + n
                first_line = True
            else:
                stripped = raw.rstrip(b"\r\n")
                if first_line and name is not None:
                    line_blen = len(stripped)
                    line_len = n
                    first_line = False
                length += len(stripped)
            pos += n
        if name is not None:
            entries.append(FaiEntry(name, length, offset, line_blen, line_len))
    return entries


def load_fai(path: str) -> List[FaiEntry]:
    entries = []
    with open(path) as f:
        for line in f:
            fld = line.rstrip("\n").split("\t")
            if len(fld) >= 5:
                entries.append(
                    FaiEntry(
                        fld[0], int(fld[1]), int(fld[2]), int(fld[3]), int(fld[4])
                    )
                )
    return entries


def write_fai(entries: List[FaiEntry], path: str):
    with open(path, "w") as f:
        for e in entries:
            f.write(
                f"{e.name}\t{e.length}\t{e.offset}\t{e.line_blen}\t{e.line_len}\n"
            )


class FastaIndex:
    """fai-indexed FASTA reader: plain text, or bgzip-compressed with a
    .gzi block index (built on demand when absent) — htslib's
    BGZF-backed faidx that the reference reads the genome through
    (read_reference.c:60-87, parse_args.c:219-229). Plain (non-blocked)
    gzip is rejected, as htslib does: it cannot be random-accessed."""

    def __init__(self, path: str):
        from portbench.ref.io.bgzf import is_bgzf, is_gzip

        self.path = path
        self._rr = None
        self._bgzf = False
        if is_gzip(path):
            if not is_bgzf(path):
                raise ValueError(
                    f"{path}: plain gzip FASTA cannot be indexed; "
                    "recompress with bgzip"
                )
            self._bgzf = True
            from portbench.ref.io.bgzf import BgzfRandomReader

            self._rr = BgzfRandomReader(path)
        fai = path + ".fai"
        if os.path.exists(fai):
            self.entries = load_fai(fai)
        else:
            self.entries = build_fai(path)
            try:
                write_fai(self.entries, fai)
            except OSError:
                pass
        self.by_name: Dict[str, FaiEntry] = {e.name: e for e in self.entries}

    def names(self) -> List[str]:
        return [e.name for e in self.entries]

    def seq_len(self, name: str) -> int:
        return self.by_name[name].length

    def fai_id(self, name: str) -> int:
        for i, e in enumerate(self.entries):
            if e.name == name:
                return i
        return -1

    def load_contig(self, name: str, calc_gc: bool = False) -> ContigSeq:
        e = self.by_name[name]
        nlines = (e.length + e.line_blen - 1) // e.line_blen if e.line_blen else 0
        span = (
            (nlines - 1) * e.line_len
            + (e.length - (nlines - 1) * e.line_blen)
            if nlines
            else 0
        )
        if self._bgzf:
            raw = np.frombuffer(
                self._rr.read_at(e.offset, span), dtype=np.uint8
            )
        else:
            with open(self.path, "rb") as f:
                f.seek(e.offset)
                raw = np.frombuffer(f.read(span), dtype=np.uint8)
        # Keep printable characters only (read_reference.c:71 isgraph check)
        graph = raw[_ISGRAPH[raw]]
        codes = _BASE2CODE[graph[: e.length]]
        nz = np.nonzero(codes)[0]
        start_pos = int(nz[0]) + 1 if len(nz) else e.length + 1
        gc_bins = None
        if calc_gc and start_pos <= e.length:
            tail = codes[start_pos - 1 :]
            nbins = len(tail) // 100
            if nbins:
                blk = tail[: nbins * 100].reshape(nbins, 100)
                nonn = (blk > 0).sum(axis=1)
                gc = ((blk == 2) | (blk == 3)).sum(axis=1)
                gc_bins = np.where(nonn == 100, gc, 255).astype(np.uint8)
            else:
                gc_bins = np.zeros(0, dtype=np.uint8)
        return ContigSeq(
            name=name,
            codes=codes,
            start_pos=start_pos,
            end_pos=e.length,
            gc_bins=gc_bins,
        )


def sequence_window(ctg: ContigSeq, x: int, sz: int) -> np.ndarray:
    """Reference window codes for 1-based positions [x, x+sz), zero-padded
    outside the contig (get_sequence.c:20-55). Positions before the first
    non-N base are genuinely 0 in `codes` already.

    Reference quirk reproduced: the C decode loop runs while
    `x1 < contig->end_pos` (get_sequence.c:40), so the contig's final base
    is never decoded and always reads as N."""
    out = np.zeros(sz, dtype=np.uint8)
    lo = max(x, 1)
    hi = min(x + sz - 1, ctg.end_pos - 1)
    if hi >= lo:
        out[lo - x : hi - x + 1] = ctg.codes[lo - 1 : hi]
    return out
