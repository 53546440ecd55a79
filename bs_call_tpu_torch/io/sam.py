"""SAM text reader producing the same BamRec stream as the BAM reader."""

from __future__ import annotations

import re
import struct
from typing import Iterator, Optional

import numpy as np

from bs_call_tpu_torch.io.bam import BamHeader, BamRec, CIGAR_OPS
from bs_call_tpu_torch.io.bgzf import open_reader

_BASE2CODE = np.zeros(256, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _BASE2CODE[ord(c)] = i + 1
    _BASE2CODE[ord(c.lower())] = i + 1

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")
_OP_IDX = {op.encode(): i for i, op in enumerate(CIGAR_OPS)}


def _encode_aux(fields) -> bytes:
    """Re-encode SAM text aux fields into BAM binary aux format so that
    decode_bs_strand works uniformly."""
    out = b""
    for f in fields:
        parts = f.split(b":", 2)
        if len(parts) != 3:
            continue
        tag, typ, val = parts
        if typ == b"A":
            out += tag + b"A" + val[:1]
        elif typ == b"i":
            out += tag + b"i" + struct.pack("<i", int(val))
        elif typ == b"f":
            out += tag + b"f" + struct.pack("<f", float(val))
        elif typ == b"Z":
            out += tag + b"Z" + val + b"\x00"
        elif typ == b"H":
            out += tag + b"H" + val + b"\x00"
        elif typ == b"B":
            sub = val[:1]
            items = val[1:].split(b",")[1:] if val[1:2] == b"," else []
            fmt = {b"c": "b", b"C": "B", b"s": "h", b"S": "H", b"i": "i", b"I": "I", b"f": "f"}[sub]
            out += tag + b"B" + sub + struct.pack("<I", len(items))
            for it in items:
                out += struct.pack(
                    "<" + fmt, float(it) if fmt == "f" else int(it)
                )
    return out


class SamReader:
    """Sequential SAM reader (plain or gzip-compressed text)."""

    def __init__(self, path_or_fileobj):
        if isinstance(path_or_fileobj, str):
            self._f = open_reader(path_or_fileobj)
        else:
            self._f = path_or_fileobj
        self.header = BamHeader()
        self._tid = {}
        self._pending: Optional[bytes] = None
        hdr_lines = []
        while True:
            line = self._f.readline()
            if not line:
                break
            if line.startswith(b"@"):
                hdr_lines.append(line.decode())
                if line.startswith(b"@SQ"):
                    name, ln = None, None
                    for fld in line.rstrip(b"\n").split(b"\t")[1:]:
                        if fld.startswith(b"SN:"):
                            name = fld[3:].decode()
                        elif fld.startswith(b"LN:"):
                            ln = int(fld[3:])
                    if name is not None:
                        self._tid[name] = len(self.header.ref_names)
                        self.header.ref_names.append(name)
                        self.header.ref_lens.append(ln or 0)
            else:
                self._pending = line
                break
        self.header.text = "".join(hdr_lines)

    def __iter__(self) -> Iterator[BamRec]:
        while True:
            if self._pending is not None:
                line = self._pending
                self._pending = None
            else:
                line = self._f.readline()
            if not line:
                return
            line = line.rstrip(b"\n")
            if not line:
                continue
            f = line.split(b"\t")
            name = f[0].decode()
            flag = int(f[1])
            rname = f[2].decode()
            tid = self._tid.get(rname, -1) if rname != "*" else -1
            pos = int(f[3]) - 1
            mapq = int(f[4])
            cigar = []
            if f[5] != b"*":
                for m in _CIGAR_RE.finditer(f[5]):
                    cigar.append((int(m.group(1)), _OP_IDX[m.group(2)]))
            rnext = f[6]
            if rnext == b"=":
                mtid = tid
            elif rnext == b"*":
                mtid = -1
            else:
                mtid = self._tid.get(rnext.decode(), -1)
            mpos = int(f[7]) - 1
            isize = int(f[8])
            seq = f[9]
            if seq == b"*":
                seq_code = np.zeros(0, dtype=np.uint8)
                l_seq = 0
            else:
                seq_code = _BASE2CODE[np.frombuffer(seq, dtype=np.uint8)]
                l_seq = len(seq)
            if f[10] == b"*":
                qual = np.zeros(l_seq, dtype=np.uint8)
            else:
                qual = np.frombuffer(f[10], dtype=np.uint8) - 33
            aux = _encode_aux(f[11:]) if len(f) > 11 else b""
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
                qual=qual.astype(np.uint8),
                aux=aux,
                l_qseq=l_seq,
            )

    def close(self):
        self._f.close()


class _PrefixedStream:
    """read()-only stream serving `prefix` bytes before delegating to the
    wrapped stream (lets a sniffed magic be pushed back on a pipe)."""

    def __init__(self, prefix: bytes, f):
        self._p = prefix
        self._f = f

    def read(self, n: int = -1) -> bytes:
        if self._p:
            if n is None or n < 0:
                out = self._p + self._f.read()
                self._p = b""
                return out
            out = self._p[:n]
            self._p = self._p[n:]
            if len(out) < n:
                out += self._f.read(n - len(out))
            return out
        return self._f.read(n)

    def close(self):
        self._f.close()


def open_alignment_file(
    path: str, native: bool = True, threads: int = 4, reference=None
):
    """Open SAM/BAM by sniffing content (process.c:112-137 analogue).
    BAM prefers the native C++ batch decoder when the toolchain is
    available; falls back to the pure-Python reader. path "-" reads SAM
    (optionally gzip) or BAM from stdin."""
    import gzip
    import io as iomod
    import sys

    from bs_call_tpu_torch.io.bam import BamReader

    if path == "-":
        buf = iomod.BufferedReader(sys.stdin.buffer)
        head = buf.peek(4)[:4]
        if head == b"CRAM":
            from bs_call_tpu_torch.io.cram import CramReader

            return CramReader(fileobj=buf, reference=reference)
        if head[:2] == b"\x1f\x8b":
            gz = gzip.GzipFile(fileobj=buf)
            # BAM = gzip(BGZF)-wrapped binary with BAM\1 magic; stream it
            # (no full buffering) through a probe-prefixed shim
            probe = gz.read(4)
            if probe == b"BAM\x01":
                return BamReader(fileobj=_PrefixedStream(probe, gz))
            data = iomod.BytesIO(probe + gz.read())
            data.seek(0)
            return SamReader(iomod.BufferedReader(data))
        return SamReader(buf)
    f = open_reader(path)
    magic = f.read(4)
    f.close()
    if magic == b"BAM\x01":
        if native:
            try:
                from bs_call_tpu_torch.native.reader import NativeBamReader

                return NativeBamReader(path, threads=threads)
            except (RuntimeError, ValueError, OSError):
                pass
        return BamReader(path)
    if magic[:4] == b"CRAM":
        from bs_call_tpu_torch.io.cram import CramReader

        return CramReader(path, reference=reference)
    return SamReader(path)
