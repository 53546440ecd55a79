"""CSI (coordinate-sorted index) v1 reader + builder.

The reference loads whatever index htslib finds — `.bai` or `.csi`
(process.c:125 sam_index_load) — so region queries must work with both.
CSI generalizes the UCSC binning of BAI to arbitrary `min_shift`/`depth`
(contigs beyond the 512 Mb BAI limit). The file is BGZF-compressed.

Layout (CSIv1 spec): magic "CSI\\x01", min_shift, depth, l_aux+aux,
n_ref, then per ref: n_bin x { bin(u32), loffset(u64), n_chunk x
{ cbeg(u64), cend(u64) } }.
"""

from __future__ import annotations

import struct
from typing import List

from bs_call_tpu_torch.io.bgzf import open_reader


def reg2bin(beg: int, end: int, min_shift: int = 14,
            depth: int = 5) -> int:
    """Smallest bin containing [beg, end) in the generalized scheme."""
    end -= 1
    level, s = depth, min_shift
    t = ((1 << (depth * 3)) - 1) // 7
    while level > 0:
        if beg >> s == end >> s:
            return t + (beg >> s)
        level -= 1
        s += 3
        t -= 1 << (level * 3)
    return 0


def reg2bins(beg: int, end: int, min_shift: int = 14,
             depth: int = 5) -> List[int]:
    """All bins overlapping [beg, end)."""
    end -= 1
    bins: List[int] = []
    s = min_shift + depth * 3
    t = 0
    for level in range(depth + 1):
        bins.extend(range(t + (beg >> s), t + (end >> s) + 1))
        t += 1 << (level * 3)
        s -= 3
    return bins


class CsiIndex:
    """Same chunks_for interface as BaiIndex."""

    def __init__(self, path: str):
        with open_reader(path) as f:
            raw = f.read()
        if raw[:4] != b"CSI\x01":
            raise ValueError(f"{path}: not a CSI index")
        self.min_shift, self.depth, l_aux = struct.unpack_from(
            "<iii", raw, 4
        )
        off = 16 + l_aux
        (n_ref,) = struct.unpack_from("<i", raw, off)
        off += 4
        self.refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            bins = {}
            loff = {}
            for _ in range(n_bin):
                b, lo, n_chunk = struct.unpack_from("<IQi", raw, off)
                off += 16
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", raw, off)
                    off += 16
                    chunks.append((cb, ce))
                bins[b] = chunks
                loff[b] = lo
            self.refs.append((bins, loff))

    def _min_offset(self, bins, loff, beg: int) -> int:
        """loffset-based pruning floor: walk from the leaf bin containing
        beg toward the root, through earlier siblings, until a bin with a
        recorded loffset is found (htslib hts_itr_query semantics; 0 when
        nothing is found, which only costs pruning)."""
        b = ((1 << (self.depth * 3)) - 1) // 7 + (
            beg >> self.min_shift
        )
        while b > 0:
            first_sib = (((b - 1) >> 3) << 3) + 1
            while b > first_sib and b not in loff:
                b -= 1
            if b in loff:
                return loff[b]
            b = (b - 1) >> 3  # parent
        return loff.get(0, 0)

    def chunks_for(self, tid: int, beg: int, end: int):
        """Merged candidate chunk list for 0-based [beg, end)."""
        if tid < 0 or tid >= len(self.refs):
            return []
        bins, loff = self.refs[tid]
        min_off = self._min_offset(bins, loff, beg)
        chunks = []
        for b in reg2bins(beg, end, self.min_shift, self.depth):
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


def write_csi(bam_path: str, out_path: str = None, min_shift: int = 14,
              depth: int = 5):
    """Build a .csi for a coordinate-sorted BAM (`samtools index -c`
    analogue). loffset is written as the earliest chunk start recorded
    for the bin — a valid (conservative) pruning floor."""
    from bs_call_tpu_torch.io.bai import _walk_records
    from bs_call_tpu_torch.io.bgzf import BgzfWriter

    out_path = out_path or bam_path + ".csi"
    n_ref, refs, _ = _walk_records(
        bam_path, lambda b, e: reg2bin(b, e, min_shift, depth)
    )
    out = bytearray(b"CSI\x01")
    out += struct.pack("<iii", min_shift, depth, 0)
    out += struct.pack("<i", n_ref)
    for tid in range(n_ref):
        bins = refs[tid]
        out += struct.pack("<i", len(bins))
        for bin_ in sorted(bins):
            chunks = []
            for cb, ce in sorted(bins[bin_]):
                if chunks and cb <= chunks[-1][1]:
                    chunks[-1] = (chunks[-1][0], max(chunks[-1][1], ce))
                else:
                    chunks.append((cb, ce))
            out += struct.pack("<IQi", bin_, chunks[0][0], len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
    with open(out_path, "wb") as f:
        w = BgzfWriter(f)
        w.write(bytes(out))
        w.close()
    return out_path
