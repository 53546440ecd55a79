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
(dbSNP_lookup_name, dbSNP.c:306-350). A loaded contig is flat arrays in
position order (DbSnpContig), queried by searchsorted.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

MAGIC = 0xD7278434

# packed-digit byte -> its two chars, high nibble then low; a nibble of
# 0xa-0xf (the padding of an odd-digit name) decodes to a NUL
_NIB = "0123456789" + "\x00" * 6
_DIGITS = [_NIB[z >> 4] + _NIB[z & 15] for z in range(256)]

# stored file byte -> packed BCD (db_tab, dbSNP.c:160-177): bytes
# 0x21..0x84 encode digit pairs 00..99, bytes 0x85..0x8e encode a single
# leading digit + 0xf terminator
_DB_TAB = [0xFF] * 256
for _b in range(0x21, 0x85):
    _v = _b - 0x21
    _DB_TAB[_b] = ((_v // 10) << 4) | (_v % 10)
for _b in range(0x85, 0x8F):
    _DB_TAB[_b] = ((_b - 0x85) << 4) | 0xF

# bsc_dbsnp_load's error codes
_CORRUPT = {1: "bin offsets", 2: "name", 3: "block"}


def _native():
    """The native library (native/bsc_dbsnp.cpp), None where it does not
    build: contigs are then decoded in Python."""
    from bs_call_tpu_torch.native import load

    return load()


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@dataclass
class DbSnpContigInfo:
    name: str
    min_bin: int
    max_bin: int
    file_offset: int


class DbSnpContig:
    """One contig's entries as flat arrays in position order: `pos`
    (int64, 1-based, strictly increasing), `sel` (uint8: 1 present, 3
    present and maf-selected), `pfx` (uint16, index into the header's
    prefixes) and each entry's packed digit bytes,
    `names[name_off[i]:name_off[i + 1]]`.

    Decoded once, by `bsc_dbsnp_load` where the native library loads
    (`native` is True; a ctypes call holds no interpreter lock), else by
    `_py_arrays`, which follows it step for step."""

    def __init__(self, hdr: "DbSnpIndex", info: DbSnpContigInfo):
        self._hdr = hdr
        self.info = info
        self._lib = _native()
        self.native = self._lib is not None
        self.pos, self.sel, self.pfx, self.name_off, self.names = (
            self._native_arrays() if self.native else self._py_arrays()
        )

    def _native_arrays(self):
        lib, info = self._lib, self.info
        n_ent, n_name = ctypes.c_int64(), ctypes.c_int64()
        err = ctypes.c_int32()
        h = lib.bsc_dbsnp_load(
            os.fsencode(self._hdr.path), info.file_offset, info.min_bin,
            info.max_bin, ctypes.byref(n_ent), ctypes.byref(n_name),
            ctypes.byref(err),
        )
        if not h:
            if err.value in _CORRUPT:
                raise ValueError(f"dbSNP index corrupt: {_CORRUPT[err.value]}")
            raise OSError(f"{self._hdr.path}: cannot read")
        try:
            n = n_ent.value
            out = (np.empty(n, np.int64), np.empty(n, np.uint8),
                   np.empty(n, np.uint16), np.empty(n + 1, np.int64),
                   np.empty(n_name.value, np.uint8))
            lib.bsc_dbsnp_take(h, *map(_ptr, out))
        finally:
            lib.bsc_dbsnp_free(h)
        return out

    def _py_arrays(self):
        """The block chain decoded in Python (format in the module
        docstring). An entry's bin is the bin current at its end-of-bin
        mark; a bin that comes again replaces the earlier one; a bin gap
        past max_bin ends the block; an unfinished bin at the chain's end
        is dropped."""
        info = self.info
        f = self._hdr._f
        f.seek(info.file_offset)
        pos, sel, pfx, nlen = [], [], [], []
        names = bytearray()
        pend = []  # (offset in bin, sel, prefix id, digit bytes)
        pend_names = bytearray()
        curr_bin = info.min_bin
        last_bin = -1
        last_start = last_nstart = 0
        prev_ix = -1
        while True:
            raw = f.read(8)
            if len(raw) < 8:
                break
            (sz,) = struct.unpack("<Q", raw)
            if sz == 0:
                break
            try:
                data = zlib.decompress(f.read(sz))
            except zlib.error:
                raise ValueError("dbSNP index corrupt: block") from None
            bp = 0
            n = len(data)
            n_entries = 0
            while bp < n:
                if not n_entries:
                    x = data[bp]
                    bp += 1
                    w = (0, 1, 2, 4)[x & 3]
                    if bp + w > n:
                        raise ValueError("dbSNP index corrupt: block")
                    if w:
                        curr_bin += int.from_bytes(data[bp:bp + w], "little")
                    else:
                        curr_bin += x >> 2
                    bp += w
                    if curr_bin > info.max_bin or bp >= n:
                        break
                x = data[bp]
                bp += 1
                if x >> 6:
                    p = (x >> 6) - 1
                else:
                    # explicit prefix id: read big-endian, as the reference
                    # does (dbSNP.c:332)
                    if bp + 2 > n:
                        raise ValueError("dbSNP index corrupt: name")
                    p = (data[bp] << 8) | data[bp + 1]
                    bp += 2
                if (x & 63) <= prev_ix:
                    raise ValueError("dbSNP index corrupt: bin offsets")
                prev_ix = x & 63
                k0 = len(pend_names)
                while bp < n and data[bp] > 3:
                    pend_names.append(_DB_TAB[data[bp]])
                    bp += 1
                if bp >= n:
                    raise ValueError("dbSNP index corrupt: name")
                tm = data[bp]
                bp += 1
                pend.append((prev_ix, 3 if tm & 2 else 1, p,
                             len(pend_names) - k0))
                n_entries += 1
                if tm & 1:  # end of bin
                    if last_bin == curr_bin:
                        for a in (pos, sel, pfx, nlen):
                            del a[last_start:]
                        del names[last_nstart:]
                    last_bin = curr_bin
                    last_start, last_nstart = len(pos), len(names)
                    base = curr_bin << 6
                    for off, s, p, k in pend:
                        pos.append(base + off)
                        sel.append(s)
                        pfx.append(p)
                        nlen.append(k)
                    names += pend_names
                    pend = []
                    pend_names = bytearray()
                    prev_ix = -1
                    n_entries = 0
        name_off = np.zeros(len(nlen) + 1, np.int64)
        np.cumsum(np.asarray(nlen, np.int64), out=name_off[1:])
        return (np.array(pos, np.int64), np.array(sel, np.uint8),
                np.array(pfx, np.uint16), name_off,
                np.frombuffer(bytes(names), np.uint8))

    def range_flags(self, x0: int, x1: int):
        """Presence for 1-based positions [x0, x1]: (present bool [n],
        selected bool [n]), selected where the entry is maf-selected."""
        n = x1 - x0 + 1
        present = np.zeros(n, dtype=bool)
        selected = np.zeros(n, dtype=bool)
        lo, hi = np.searchsorted(self.pos, (x0, x1 + 1))
        at = self.pos[lo:hi] - x0
        present[at] = True
        selected[at] = self.sel[lo:hi] == 3
        return present, selected

    def _name(self, i: int) -> str:
        # the reference decodes two chars per packed byte UNCONDITIONALLY
        # (dbSNP.c:341-342) and *rs_len = tp - rs counts the decoded
        # padding nibble too — so odd-digit names carry a trailing NUL
        # that lands in the VCF ID field (bcf_enc_size(rs_len) +
        # kputsn, print_vcf.c:169-170). Keep it verbatim: byte parity
        # vs the compiled binary (tests/test_reference_matrix.py)
        # depends on it.
        z = self.names[self.name_off[i]:self.name_off[i + 1]].tolist()
        return self._hdr.prefixes[self.pfx[i]] + "".join(
            _DIGITS[b] for b in z)

    def lookup(self, x: int) -> Tuple[int, str]:
        """Returns (0/1/3, rs-name) for 1-based position x."""
        i = int(self.pos.searchsorted(x))
        if i == len(self.pos) or self.pos.item(i) != x:
            return 0, ""
        return int(self.sel[i]), self._name(i)

    def rs_ids(self, x: np.ndarray, rows: np.ndarray):
        """The rs names of positions `x[rows]`, each one of the contig's,
        as (offsets int64 [len(x) + 1], blob uint8): row i's name is
        `blob[offsets[i]:offsets[i + 1]]`, as `lookup` gives it, and empty
        for a row not in `rows`."""
        hdr = self._hdr
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        ent = np.searchsorted(self.pos, x[rows])
        lens = np.zeros(len(x), np.int64)
        lens[rows] = hdr._pfx_len[self.pfx[ent]] + 2 * (
            self.name_off[ent + 1] - self.name_off[ent])
        off = np.zeros(len(x) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        blob = np.empty(int(off[-1]), np.uint8)
        if self._lib is not None:
            self._lib.bsc_dbsnp_names(
                len(ent), _ptr(rows), _ptr(ent), _ptr(self.pfx),
                _ptr(self.name_off), _ptr(self.names), _ptr(hdr._pfx_off),
                _ptr(hdr._pfx_blob), _ptr(off), _ptr(blob),
            )
        else:
            for i, e in zip(rows.tolist(), ent.tolist()):
                blob[off[i]:off[i + 1]] = np.frombuffer(
                    self._name(e).encode(), np.uint8)
        return off, blob


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
        # the prefixes' bytes, for the rs-id blobs (DbSnpContig.rs_ids)
        enc = [s.encode() for s in self.prefixes]
        self._pfx_len = np.array([len(b) for b in enc], np.int64)
        self._pfx_off = np.zeros(len(enc) + 1, np.int64)
        np.cumsum(self._pfx_len, out=self._pfx_off[1:])
        self._pfx_blob = np.frombuffer(b"".join(enc), np.uint8)
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
