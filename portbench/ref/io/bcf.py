"""BCF2.2 binary output writer (htslib-compatible, self-contained).

Encodes the same record layout the reference produces through htslib's
bcf_enc_* calls (print_vcf.c:160-381): shared block with ID/alleles/FILTER/
INFO(CX), indiv block with the GT,FT,DP,MQ,GQ,QD,GL,MC8[,AMQ],CS,CG,CX[,FS]
series. The ID dictionary is implicit: PASS = 0, then FILTER/INFO/FORMAT
IDs in order of first appearance in the header text; contigs in ##contig
order.
"""

from __future__ import annotations

import re
import struct
from typing import List

import numpy as np

from portbench.ref.io.bgzf import BgzfWriter
from portbench.ref.output.site import VcfSite

BCF_BT_INT8 = 1
BCF_BT_INT16 = 2
BCF_BT_INT32 = 3
BCF_BT_FLOAT = 5
BCF_BT_CHAR = 7

_ID_RE = re.compile(r"##(FILTER|INFO|FORMAT)=<ID=([^,>]+)")
_CTG_RE = re.compile(r"##contig=<ID=([^,>]+)")


def build_dictionaries(header_lines: List[str]):
    ids = {"PASS": 0}
    ctgs = {}
    for line in header_lines:
        m = _ID_RE.match(line)
        if m:
            name = m.group(2)
            if name not in ids:
                ids[name] = len(ids)
            continue
        m = _CTG_RE.match(line)
        if m and m.group(1) not in ctgs:
            ctgs[m.group(1)] = len(ctgs)
    return ids, ctgs


def enc_size(size: int, btype: int) -> bytes:
    if size < 15:
        return bytes([(size << 4) | btype])
    out = bytes([0xF0 | btype])
    return out + enc_int1(size)


def enc_int1(v: int) -> bytes:
    if -120 <= v <= 127:
        return bytes([(1 << 4) | BCF_BT_INT8]) + struct.pack("<b", v)
    if -32760 <= v <= 32767:
        return bytes([(1 << 4) | BCF_BT_INT16]) + struct.pack("<h", v)
    return bytes([(1 << 4) | BCF_BT_INT32]) + struct.pack("<i", v)


def enc_vint(vals: List[int]) -> bytes:
    if not vals:
        return bytes([BCF_BT_INT8])
    lo, hi = min(vals), max(vals)
    if -120 <= lo and hi <= 127:
        return enc_size(len(vals), BCF_BT_INT8) + struct.pack(
            f"<{len(vals)}b", *vals
        )
    if -32760 <= lo and hi <= 32767:
        return enc_size(len(vals), BCF_BT_INT16) + struct.pack(
            f"<{len(vals)}h", *vals
        )
    return enc_size(len(vals), BCF_BT_INT32) + struct.pack(
        f"<{len(vals)}i", *vals
    )


def enc_vfloat(vals: List[float]) -> bytes:
    arr = np.asarray(vals, dtype=np.float32)
    return enc_size(len(arr), BCF_BT_FLOAT) + arr.tobytes()


def enc_string(s: str) -> bytes:
    b = s.encode()
    return enc_size(len(b), BCF_BT_CHAR) + b


class BcfWriter:
    def __init__(self, fileobj, header_lines: List[str], threads: int = 0,
                 compressed: bool = True):
        """compressed=False mirrors htslib's -O u: the raw BCF stream
        with no BGZF framing (vcf.c 'wbu' -> bgzf 'u' uncompressed)."""
        self._raw = fileobj
        self._w = (
            BgzfWriter(fileobj, threads=threads) if compressed else fileobj
        )
        text = "\n".join(header_lines) + "\n\x00"
        tb = text.encode()
        self._w.write(b"BCF\x02\x02" + struct.pack("<I", len(tb)) + tb)
        self.ids, self.ctgs = build_dictionaries(header_lines)

    def write_header(self, lines):
        # header already written in constructor; kept for interface parity
        pass

    def write_site(self, s: VcfSite):
        ids = self.ids
        shared = bytearray()
        # ID
        if s.rs_id and s.rs_id != ".":
            shared += enc_string(s.rs_id)
        else:
            shared += enc_size(0, BCF_BT_CHAR)
        # alleles
        n_allele = 1
        shared += enc_string(s.ref)
        for a in s.alts:
            shared += enc_string(a)
            n_allele += 1
        # FILTER
        fid = ids[s.filters[0]] if s.filters else ids["PASS"]
        shared += enc_vint([fid])
        # INFO: CX
        shared += enc_int1(ids["CX"])
        shared += enc_string(s.cx_info)

        indiv = bytearray()
        n_fmt = 0

        def fmt(key: str, payload: bytes):
            nonlocal n_fmt
            indiv.extend(enc_int1(ids[key]))
            indiv.extend(payload)
            n_fmt += 1

        fmt("GT", enc_vint(s.gt_ints))
        fmt("FT", enc_string(s.ft))
        fmt("DP", enc_int1(s.dp))
        fmt("MQ", enc_int1(s.mq))
        fmt("GQ", enc_int1(s.gq))
        fmt("QD", enc_int1(s.qd))
        fmt("GL", enc_vfloat(s.gl))
        fmt("MC8", enc_vint(s.mc8))
        if s.amq:
            fmt("AMQ", enc_vint(s.amq))
        fmt("CS", enc_string(s.cs))
        fmt("CG", enc_string(s.cg))
        fmt("CX", enc_string(s.cx_fmt))
        if s.fs is not None:
            fmt("FS", enc_int1(s.fs))

        core = struct.pack(
            "<iiifHHI",
            s.rid,
            s.pos - 1,
            1,  # rlen
            float(s.qual),
            1,  # n_info
            n_allele,
            (n_fmt << 24) | 1,  # n_sample = 1, n_fmt high byte
        )
        rec = core + bytes(shared)
        self._w.write(
            struct.pack("<II", len(rec), len(indiv)) + rec + bytes(indiv)
        )

    def close(self):
        if isinstance(self._w, BgzfWriter):
            self._w.close()
        else:  # uncompressed: the stream belongs to the caller
            self._w.flush()


def _dec_typed(data: bytes, off: int):
    """Decode one typed value; returns (value(s), new offset)."""
    tb = data[off]
    off += 1
    btype = tb & 0xF
    size = tb >> 4
    if size == 15:
        size, off = _dec_typed(data, off)
        size = size[0] if isinstance(size, list) else size
    if btype == 0:
        return None, off
    if btype == BCF_BT_CHAR:
        s = data[off : off + size].decode()
        return s, off + size
    fmt = {BCF_BT_INT8: "b", BCF_BT_INT16: "h", BCF_BT_INT32: "i",
           BCF_BT_FLOAT: "f"}[btype]
    width = {BCF_BT_INT8: 1, BCF_BT_INT16: 2, BCF_BT_INT32: 4,
             BCF_BT_FLOAT: 4}[btype]
    vals = list(struct.unpack_from(f"<{size}{fmt}", data, off))
    return vals, off + size * width


class BcfReader:
    """Minimal BCF reader: yields dict records (tests/utilities)."""

    def __init__(self, path_or_fileobj):
        import gzip

        if isinstance(path_or_fileobj, str):
            raw = open(path_or_fileobj, "rb")
        else:
            raw = path_or_fileobj
        # compressed (-O b, BGZF) or raw uncompressed (-O u) stream
        head = raw.read(2)
        raw.seek(-2, 1)
        if head == b"\x1f\x8b":
            self._f = gzip.GzipFile(fileobj=raw)
        else:
            self._f = raw
        magic = self._f.read(5)
        if magic != b"BCF\x02\x02":
            raise ValueError("not a BCF2.2 file")
        (l_text,) = struct.unpack("<I", self._f.read(4))
        self.header_text = self._f.read(l_text).rstrip(b"\x00").decode()
        self.ids, self.ctgs = build_dictionaries(
            self.header_text.splitlines()
        )
        self._id_names = {v: k for k, v in self.ids.items()}
        self._ctg_names = {v: k for k, v in self.ctgs.items()}

    def __iter__(self):
        while True:
            head = self._f.read(8)
            if len(head) < 8:
                return
            l_shared, l_indiv = struct.unpack("<II", head)
            shared = self._f.read(l_shared)
            indiv = self._f.read(l_indiv)
            rid, pos, rlen, qual = struct.unpack_from("<iiif", shared, 0)
            n_info, n_allele = struct.unpack_from("<HH", shared, 16)
            (ns_nf,) = struct.unpack_from("<I", shared, 20)
            n_fmt = ns_nf >> 24
            off = 24
            rec_id, off = _dec_typed(shared, off)
            alleles = []
            for _ in range(n_allele):
                a, off = _dec_typed(shared, off)
                alleles.append(a)
            filters, off = _dec_typed(shared, off)
            info = {}
            for _ in range(n_info):
                k, off = _dec_typed(shared, off)
                v, off = _dec_typed(shared, off)
                info[self._id_names[k[0]]] = v
            fmt = {}
            off = 0
            for _ in range(n_fmt):
                k, off = _dec_typed(indiv, off)
                v, off = _dec_typed(indiv, off)
                fmt[self._id_names[k[0]]] = v
            yield {
                "chrom": self._ctg_names.get(rid, str(rid)),
                "pos": pos + 1,
                "id": rec_id if rec_id else ".",
                "alleles": alleles,
                "qual": qual,
                "filters": [self._id_names[f] for f in filters],
                "info": info,
                "fmt": fmt,
            }

    def close(self):
        self._f.close()
