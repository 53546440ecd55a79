"""CRAM 3.0 writer — primarily the round-trip test vehicle for the reader,
and a utility converter. Uses a deliberately diverse codec spread so the
reader's codec set is exercised: core-bit BETA (MQ) and GAMMA (RG), HUFFMAN
single-symbol (CF on uniform slices falls back to external), external ITF8
series compressed with rANS/gzip, BYTE_ARRAY_STOP read names and
BYTE_ARRAY_LEN tags."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from bs_call_tpu_torch.io.cram import (
    BitWriter,
    CT_COMP_HEADER,
    CT_CORE,
    CT_EXTERNAL,
    CT_FILE_HEADER,
    CT_SLICE_HEADER,
    M_GZIP,
    M_RANS,
    M_RAW,
    MAGIC,
    _write_block,
)
from bs_call_tpu_torch.io.cram_codecs import write_itf8, write_ltf8

_CODE2B = "NACGT"

# content ids for external streams
E = {
    "BF": 1, "CF": 2, "RL": 3, "AP": 4, "RG": 5, "RN": 6, "MF": 7,
    "NS": 8, "NP": 9, "TS": 10, "NF": 11, "TL": 12, "FN": 13, "FC": 14,
    "FP": 15, "DL": 16, "BA": 17, "QS": 18, "SC": 19, "IN": 20,
    "TAGL": 21, "TAGV": 22, "RI": 23,
}


def _codec_external(cid: int) -> bytes:
    params = write_itf8(cid)
    return write_itf8(1) + write_itf8(len(params)) + params


def _codec_beta(offset: int, nbits: int) -> bytes:
    params = write_itf8(offset) + write_itf8(nbits)
    return write_itf8(6) + write_itf8(len(params)) + params


def _codec_gamma(offset: int) -> bytes:
    params = write_itf8(offset)
    return write_itf8(9) + write_itf8(len(params)) + params


def _codec_bastop(stop: int, cid: int) -> bytes:
    params = bytes([stop]) + write_itf8(cid)
    return write_itf8(5) + write_itf8(len(params)) + params


def _codec_balen(len_codec: bytes, val_codec: bytes) -> bytes:
    params = len_codec + val_codec
    return write_itf8(4) + write_itf8(len(params)) + params


class CramWriter:
    SLICE_RECORDS = 2000

    def __init__(self, path: str, header, reference: Optional[str] = None,
                 multi_ref: bool = False):
        """header: BamHeader; reference: FASTA path (for reference-based
        sequence encoding; without it all bases are stored verbatim).
        multi_ref packs records of several contigs into one slice
        (ref_id -2 + per-record RI, CRAM 3.0 §8.5 — what htslib emits
        for many-small-contig inputs); positions are stored absolute
        (AP preservation 0)."""
        self._f = open(path, "wb")
        self.multi_ref = bool(multi_ref)
        self.header = header
        self._recs: List[tuple] = []
        self._fasta = None
        if reference:
            from bs_call_tpu_torch.io.fasta import FastaIndex

            self._fasta = FastaIndex(reference)
        self._ref_cache = (-2, None)
        self._f.write(MAGIC + bytes([3, 0]) + b"bs_call_tpu\x00".ljust(20, b"\x00"))
        # header container
        text = header.text.encode()
        raw = struct.pack("<i", len(text)) + text
        blk = _write_block(M_RAW, CT_FILE_HEADER, 0, raw)
        self._write_container(blk, 1, ref_id=-1, n_records=0)

    def _write_container(self, payload: bytes, n_blocks: int, ref_id=-1,
                         start=0, span=0, n_records=0):
        head = write_itf8(ref_id & 0xFFFFFFFF if ref_id >= 0 else ref_id + (1 << 32))
        # itf8 stores signed 32-bit: encode two's complement
        head = write_itf8(ref_id & 0xFFFFFFFF)
        head += write_itf8(start) + write_itf8(span)
        head += write_itf8(n_records)
        head += write_ltf8(0) + write_ltf8(0)
        head += write_itf8(n_blocks)
        head += write_itf8(0)  # no landmarks
        head += struct.pack("<I", 0)  # crc placeholder
        self._f.write(struct.pack("<i", len(payload)) + head + payload)

    def _ref_codes(self, tid: int):
        if self._ref_cache[0] == tid:
            return self._ref_cache[1]
        codes = None
        if self._fasta is not None and 0 <= tid < len(self.header.ref_names):
            name = self.header.ref_names[tid]
            if name in self._fasta.by_name:
                codes = self._fasta.load_contig(name).codes
        self._ref_cache = (tid, codes)
        return codes

    def write(self, name, flag, tid, pos, mapq, cigar, mtid, mpos, isize,
              seq, qual, aux: bytes = b""):
        """Same argument shape as BamWriter.write; aux is raw BAM aux
        bytes (only simple A/Z/i/C/f tags are re-encoded)."""
        self._recs.append(
            (name, flag, tid, pos, mapq, list(cigar), mtid, mpos, isize,
             seq, np.asarray(qual, dtype=np.uint8) if qual is not None
             else np.zeros(len(seq), np.uint8), aux)
        )

    def close(self):
        # group into slices in input order: single-ref splits at contig
        # boundaries; multi-ref packs across them
        i = 0
        while i < len(self._recs):
            tid = self._recs[i][2]
            j = i
            while (
                j < len(self._recs)
                and (self.multi_ref or self._recs[j][2] == tid)
                and j - i < self.SLICE_RECORDS
            ):
                j += 1
            self._emit_slice(self._recs[i:j])
            i = j
        # EOF container (spec special container: empty, ref -1)
        self._write_container(b"", 0, ref_id=-1, n_records=0)
        self._f.close()

    # ---- slice emission ----

    def _emit_slice(self, recs):
        ext: Dict[int, bytearray] = {cid: bytearray() for cid in E.values()}
        core = BitWriter()
        tid = recs[0][2]
        mixed = self.multi_ref and any(r[2] != tid for r in recs)
        if mixed:
            tid = -2
            start = 0
            end = 0
        else:
            start = min(r[3] for r in recs) + 1
            end = max(r[3] + max(1, _ref_len(r[5])) for r in recs)

        # tag dictionary
        tag_lines: List[Tuple[Tuple[str, str], ...]] = []
        line_of: Dict[Tuple, int] = {}
        rec_tl = []
        parsed_tags = [_parse_aux(r[11]) for r in recs]
        for tags in parsed_tags:
            key = tuple((t, ty) for t, ty, _ in tags)
            if key not in line_of:
                line_of[key] = len(tag_lines)
                tag_lines.append(key)
            rec_tl.append(line_of[key])

        # mate-downstream links by name
        index_of = {}
        for k, r in enumerate(recs):
            index_of.setdefault(r[0], []).append(k)

        def put_itf8(series, v):
            ext[E[series]] += write_itf8(v)

        prev_pos = start
        for k, r in enumerate(recs):
            (name, flag, rtid, pos, mapq, cigar, mtid, mpos, isize, seq,
             qual, aux) = r
            mates = index_of[name]
            downstream_mate = None
            if flag & 0x1 and len(mates) == 2:
                other = mates[0] if mates[1] == k else mates[1]
                if other > k:
                    downstream_mate = other
            cf = 0x1  # quality scores preserved
            if flag & 0x1 and downstream_mate is None and (
                len(mates) < 2 or mates[0] != k
            ):
                # second of pair (decoded via its mate's NF) — no extra
                pass
            detached = flag & 0x1 and len(mates) != 2
            if downstream_mate is not None:
                cf |= 0x4
            elif detached:
                cf |= 0x2
            put_itf8("BF", flag & 0xFFF)
            put_itf8("CF", cf)
            if tid == -2:
                put_itf8("RI", rtid)
            put_itf8("RL", len(seq))
            if self.multi_ref:
                put_itf8("AP", pos + 1)  # absolute (AP preservation 0)
            else:
                put_itf8("AP", (pos + 1) - prev_pos)
                prev_pos = pos + 1
            # RG via gamma in core: value -1
            _gamma_write(core, -1, offset=1)
            ext[E["RN"]] += name.encode() + b"\x00"
            if cf & 0x4:
                put_itf8("NF", downstream_mate - k - 1)
            elif cf & 0x2:
                mf = 0
                if flag & 0x20:
                    mf |= 1
                if flag & 0x8:
                    mf |= 2
                put_itf8("MF", mf)
                put_itf8("NS", mtid)
                put_itf8("NP", mpos + 1)
                put_itf8("TS", isize)
            put_itf8("TL", rec_tl[k])
            for tag, typ, val in parsed_tags[k]:
                ext[E["TAGL"]] += write_itf8(len(val))
                ext[E["TAGV"]] += val
            if not (flag & 4):
                feats = self._features(
                    seq, qual, cigar, pos, self._ref_codes(rtid)
                )
                put_itf8("FN", len(feats))
                prev_fp = 0
                for fpos, fc, payload in feats:
                    ext[E["FC"]].append(ord(fc))
                    put_itf8("FP", fpos - prev_fp)
                    prev_fp = fpos
                    if fc == "B":
                        ext[E["BA"]].append(payload[0])
                        ext[E["QS"]].append(payload[1])
                    elif fc == "S":
                        ext[E["SC"]] += payload + b"\x00"
                    elif fc == "I":
                        ext[E["IN"]] += payload + b"\x00"
                    elif fc == "D":
                        put_itf8("DL", payload)
                # MQ via beta(0,8) in core
                core.write_bits(mapq, 8)
                ext[E["QS"]] += bytes(qual.tolist())
            else:
                ext[E["BA"]] += seq.encode() if isinstance(seq, str) else seq
                ext[E["QS"]] += bytes(qual.tolist())

        comp = self._comp_header(tag_lines)
        span = 0 if tid == -2 else end - start + 1
        blocks = []
        core_data = core.getvalue()
        blocks.append(_write_block(M_RAW, CT_CORE, 0, core_data))
        used = [cid for cid in sorted(ext) if ext[cid]]
        for cid in used:
            method = M_RANS if len(ext[cid]) > 100 else M_GZIP
            blocks.append(
                _write_block(method, CT_EXTERNAL, cid, bytes(ext[cid]))
            )
        sh = write_itf8(tid) + write_itf8(start) + write_itf8(span)
        sh += write_itf8(len(recs)) + write_ltf8(0)
        sh += write_itf8(len(blocks))
        sh += write_itf8(len(used))
        for cid in used:
            sh += write_itf8(cid)
        sh += write_itf8(-1 & 0xFFFFFFFF)  # no embedded reference
        sh += b"\x00" * 16  # md5
        slice_hdr = _write_block(M_RAW, CT_SLICE_HEADER, 0, sh)
        payload = comp + slice_hdr + b"".join(blocks)
        self._write_container(
            payload, 2 + len(blocks), ref_id=tid, start=start,
            span=span, n_records=len(recs),
        )

    def _features(self, seq, qual, cigar, pos, ref_codes):
        feats = []
        if isinstance(seq, str):
            s = seq
        else:
            s = "".join(_CODE2B[c] for c in seq)
        out_i = 0
        ref_i = pos  # 0-based
        if not cigar:
            cigar = [(len(s), 0)]
        for ln, op in cigar:
            if op in (0, 7, 8):  # M
                for k in range(ln):
                    b = s[out_i + k]
                    rb = (
                        _CODE2B[ref_codes[ref_i + k]]
                        if ref_codes is not None
                        and ref_i + k < len(ref_codes)
                        else "N"
                    )
                    if b != rb:
                        feats.append(
                            (out_i + k + 1, "B",
                             (ord(b), int(qual[out_i + k])))
                        )
                out_i += ln
                ref_i += ln
            elif op == 4:  # S
                feats.append(
                    (out_i + 1, "S", s[out_i : out_i + ln].encode())
                )
                out_i += ln
            elif op == 1:  # I
                feats.append(
                    (out_i + 1, "I", s[out_i : out_i + ln].encode())
                )
                out_i += ln
            elif op in (2, 3):  # D / N
                feats.append((out_i + 1, "D", ln))
                ref_i += ln  # deletions consume reference
            elif op in (5, 6):
                pass
        return feats

    def _comp_header(self, tag_lines):
        pres = bytearray()
        entries = []
        entries.append((b"RN", b"\x01"))
        entries.append((b"AP", b"\x00" if self.multi_ref else b"\x01"))
        entries.append((b"RR", b"\x01"))
        entries.append((b"SM", bytes([0x1B] * 5)))
        td = b"\x00".join(
            b"".join(t.encode() + ty.encode() for t, ty in line)
            for line in tag_lines
        )
        entries.append((b"TD", write_itf8(len(td)) + td))
        body = write_itf8(len(entries))
        for k, v in entries:
            body += k + v
        pres += write_itf8(len(body)) + body

        series = {
            "BF": _codec_external(E["BF"]),
            "CF": _codec_external(E["CF"]),
            "RL": _codec_external(E["RL"]),
            "AP": _codec_external(E["AP"]),
            "RG": _codec_gamma(1),
            "RN": _codec_bastop(0, E["RN"]),
            "MF": _codec_external(E["MF"]),
            "NS": _codec_external(E["NS"]),
            "NP": _codec_external(E["NP"]),
            "TS": _codec_external(E["TS"]),
            "NF": _codec_external(E["NF"]),
            "TL": _codec_external(E["TL"]),
            "FN": _codec_external(E["FN"]),
            "FC": _codec_external(E["FC"]),
            "FP": _codec_external(E["FP"]),
            "DL": _codec_external(E["DL"]),
            "BA": _codec_external(E["BA"]),
            "QS": _codec_external(E["QS"]),
            "SC": _codec_bastop(0, E["SC"]),
            "IN": _codec_bastop(0, E["IN"]),
            "MQ": _codec_beta(0, 8),
        }
        if self.multi_ref:
            series["RI"] = _codec_external(E["RI"])
        sbody = write_itf8(len(series))
        for key, spec in series.items():
            sbody += key.encode() + spec
        sblock = write_itf8(len(sbody)) + sbody

        tag_enc: Dict[int, bytes] = {}
        for line in tag_lines:
            for t, ty in line:
                key = (ord(t[0]) << 16) | (ord(t[1]) << 8) | ord(ty)
                tag_enc[key] = _codec_balen(
                    _codec_external(E["TAGL"]), _codec_external(E["TAGV"])
                )
        tbody = write_itf8(len(tag_enc))
        for key, spec in tag_enc.items():
            tbody += write_itf8(key) + spec
        tblock = write_itf8(len(tbody)) + tbody

        raw = bytes(pres) + sblock + tblock
        return _write_block(M_GZIP, CT_COMP_HEADER, 0, raw)


def _gamma_write(core: BitWriter, v: int, offset: int):
    n = v + 1 + offset
    nbits = n.bit_length()
    core.write_bits(0, nbits - 1)
    core.write_bits(n, nbits)


def _ref_len(cigar):
    return sum(ln for ln, op in cigar if op in (0, 2, 3, 7, 8))


def _parse_aux(aux: bytes):
    """Split BAM aux bytes into (tag, type, value-bytes incl. any NUL)."""
    out = []
    i = 0
    n = len(aux)
    sizes = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
    while i + 3 <= n:
        tag = aux[i : i + 2].decode()
        typ = chr(aux[i + 2])
        i += 3
        if typ in sizes:
            ln = sizes[typ]
            out.append((tag, typ, aux[i : i + ln]))
            i += ln
        elif typ in "ZH":
            end = aux.find(b"\x00", i)
            if end < 0:
                end = n
            out.append((tag, typ, aux[i : end + 1]))
            i = end + 1
        else:
            break
    return out
