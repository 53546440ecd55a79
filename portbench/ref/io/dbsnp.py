"""Reader for bs_call's custom compressed dbSNP index format.

Format contract (dbSNP.c:27-350):
  file   := magic(u32=0xd7278434) reserved(u32) hdr_off(u64) ubuf_sz(u64)
            hdr_comp_sz(u64) contig_data... header_block magic(u32)
  header := zlib block; layout: u16 ?, u16 n_prefixes, u32 n_ctgs,
            "track ..."\0, prefix\0 * n_prefixes,
            { u32 min_bin, u32 max_bin, u64 file_offset, name\0 } * n_ctgs
  contig := { u64 comp_size, zlib block }*, 0-size terminator. Each block
            holds bins of 64 positions: varint bin gap, entries of
            (prefix|offset byte, optional 2-byte explicit prefix id,
            packed BCD digits, terminator<=3 with maf/end-of-bin bits).
Lookup(pos) returns 0 absent, 1 present, 3 present+maf-selected
(dbSNP_lookup_name, dbSNP.c:306-350).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

MAGIC = 0xD7278434

# packed-digit byte -> two chars; high nibble then low nibble, 0xa-0xf = end
_DTAB = "0123456789\x00\x00\x00\x00\x00\x00"

# stored file byte -> packed BCD (db_tab, dbSNP.c:160-177): bytes
# 0x21..0x84 encode digit pairs 00..99, bytes 0x85..0x8e encode a single
# leading digit + 0xf terminator
_DB_TAB = [0xFF] * 256
for _b in range(0x21, 0x85):
    _v = _b - 0x21
    _DB_TAB[_b] = ((_v // 10) << 4) | (_v % 10)
for _b in range(0x85, 0x8F):
    _DB_TAB[_b] = ((_b - 0x85) << 4) | 0xF

@dataclass
class DbSnpBin:
    mask: int = 0
    fq_mask: int = 0
    entries: List[int] = None
    name_buf: bytes = b""


@dataclass
class DbSnpContigInfo:
    name: str
    min_bin: int
    max_bin: int
    file_offset: int


class DbSnpContig:
    """Loaded per-contig bin table with O(popcount) name lookup."""

    def __init__(self, hdr: "DbSnpIndex", info: DbSnpContigInfo):
        self._hdr = hdr
        self.info = info
        self.bins: Dict[int, DbSnpBin] = {}
        self._load()

    def _load(self):
        info = self.info
        f = self._hdr._f
        f.seek(info.file_offset)
        curr_bin = info.min_bin
        bin_obj: Optional[DbSnpBin] = None
        entries: List[int] = []
        name_buf = bytearray()
        mask = [0, 0]
        prev_ix = -1
        while True:
            raw = f.read(8)
            if len(raw) < 8:
                break
            (sz,) = struct.unpack("<Q", raw)
            if sz == 0:
                break
            data = zlib.decompress(f.read(sz))
            bp = 0
            n = len(data)
            n_entries = 0
            while bp < n:
                if not n_entries:
                    x = data[bp]
                    bp += 1
                    t = x & 3
                    if t == 0:
                        bin_inc = x >> 2
                    elif t == 1:
                        bin_inc = data[bp]
                        bp += 1
                    elif t == 2:
                        (bin_inc,) = struct.unpack_from("<H", data, bp)
                        bp += 2
                    else:
                        (bin_inc,) = struct.unpack_from("<I", data, bp)
                        bp += 4
                    curr_bin += bin_inc
                    if curr_bin > info.max_bin or bp >= n:
                        break
                x = data[bp]
                bp += 1
                prefix_ix = x >> 6
                start_nb = len(name_buf)
                if prefix_ix == 0:
                    name_buf.append(data[bp])
                    name_buf.append(data[bp + 1])
                    bp += 2
                if (x & 63) <= prev_ix:
                    raise ValueError("dbSNP index corrupt: bin offsets")
                prev_ix = x & 63
                k0 = len(name_buf)
                while bp < n and data[bp] > 3:
                    name_buf.append(_DB_TAB[data[bp]])
                    bp += 1
                k = len(name_buf) - k0
                if bp >= n or data[bp] > 3:
                    raise ValueError("dbSNP index corrupt: name")
                msk = 1 << prev_ix
                mask[0] |= msk
                tm = data[bp]
                bp += 1
                if tm & 2:
                    mask[1] |= msk
                entries.append((k << 8) | x)
                n_entries += 1
                if tm & 1:  # end of bin
                    self.bins[curr_bin] = DbSnpBin(
                        mask=mask[0],
                        fq_mask=mask[1],
                        entries=entries,
                        name_buf=bytes(name_buf),
                    )
                    entries = []
                    name_buf = bytearray()
                    mask = [0, 0]
                    prev_ix = -1
                    n_entries = 0

    def range_flags(self, x0: int, x1: int):
        """Vectorized presence for 1-based positions [x0, x1]: returns
        (present bool [n], selected bool [n]) from the per-bin masks."""
        import numpy as np

        n = x1 - x0 + 1
        present = np.zeros(n, dtype=bool)
        selected = np.zeros(n, dtype=bool)
        for bn in range(x0 >> 6, (x1 >> 6) + 1):
            b = self.bins.get(bn)
            if b is None:
                continue
            base = bn << 6
            offs = np.arange(64)
            # masks are 64-bit python ints (can exceed int64 range)
            mask_bits = np.array(
                [(b.mask >> int(o)) & 1 for o in range(64)], dtype=np.int64
            )
            fq_bits = np.array(
                [(b.fq_mask >> int(o)) & 1 for o in range(64)],
                dtype=np.int64,
            )
            posns = base + offs
            sel = (posns >= x0) & (posns <= x1)
            present[posns[sel] - x0] = mask_bits[sel].astype(bool)
            selected[posns[sel] - x0] = fq_bits[sel].astype(bool)
        return present, selected

    def lookup(self, x: int) -> Tuple[int, str]:
        """Returns (0/1/3, rs-name) for 1-based position x."""
        bn = x >> 6
        if bn < self.info.min_bin or bn > self.info.max_bin:
            return 0, ""
        b = self.bins.get(bn)
        if b is None:
            return 0, ""
        ix = x & 63
        mk = 1 << ix
        if not (b.mask & mk):
            return 0, ""
        res = 3 if (b.fq_mask & mk) else 1
        mk1 = b.mask & (mk - 1)
        i = 0
        j = 0
        while mk1:
            if mk1 & 1:
                en = b.entries[i]
                i += 1
                j += en >> 8
                if not ((en >> 6) & 3):
                    j += 2
            mk1 >>= 1
        en = b.entries[i]
        prefix_id = (en >> 6) & 3
        tp1 = j
        if prefix_id == 0:
            prefix_id = (b.name_buf[tp1] << 8) | b.name_buf[tp1 + 1]
            tp1 += 2
        else:
            prefix_id -= 1
        name = self._hdr.prefixes[prefix_id]
        digits = []
        for k in range(en >> 8):
            z = b.name_buf[tp1 + k]
            digits.append(_DTAB[z >> 4])
            digits.append(_DTAB[z & 15])
        # the reference decodes two chars per packed byte UNCONDITIONALLY
        # (dbSNP.c:341-342) and *rs_len = tp - rs counts the decoded
        # padding nibble too — so odd-digit names carry a trailing NUL
        # that lands in the VCF ID field (bcf_enc_size(rs_len) +
        # kputsn, print_vcf.c:169-170). Keep it verbatim: byte parity
        # vs the compiled binary (tests/test_reference_matrix.py)
        # depends on it.
        num = "".join(digits)
        return res, name + num


class DbSnpIndex:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        magic, _res = struct.unpack("<II", self._f.read(8))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a dbSNP index")
        hdr_off, ubuf_sz, comp_sz = struct.unpack("<QQQ", self._f.read(24))
        self.bufsize = ubuf_sz
        self._f.seek(hdr_off)
        comp = self._f.read(comp_sz)
        (tail_magic,) = struct.unpack("<I", self._f.read(4))
        if tail_magic != MAGIC:
            raise ValueError("dbSNP index truncated")
        buf = zlib.decompress(comp)
        n_prefixes = struct.unpack_from("<H", buf, 2)[0]
        n_ctgs = struct.unpack_from("<I", buf, 4)[0]
        p = 8
        end = buf.find(b"\x00", p)
        track = buf[p:end].decode()
        if not track.startswith("track "):
            raise ValueError("dbSNP header missing track line")
        self.header_line = track[6:]
        p = end + 1
        self.prefixes = []
        for _ in range(n_prefixes):
            end = buf.find(b"\x00", p)
            self.prefixes.append(buf[p:end].decode())
            p = end + 1
        self.contigs: Dict[str, DbSnpContigInfo] = {}
        for _ in range(n_ctgs):
            min_bin, max_bin = struct.unpack_from("<II", buf, p)
            (off,) = struct.unpack_from("<Q", buf, p + 8)
            p += 16
            end = buf.find(b"\x00", p)
            name = buf[p:end].decode()
            p = end + 1
            self.contigs[name] = DbSnpContigInfo(name, min_bin, max_bin, off)

    def load_contig(self, name: str) -> Optional[DbSnpContig]:
        info = self.contigs.get(name)
        if info is None:
            return None
        return DbSnpContig(self, info)

    def close(self):
        self._f.close()
