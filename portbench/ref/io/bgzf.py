"""BGZF (blocked gzip) codec.

Self-contained replacement for htslib's bgzf layer: BGZF files are
concatenated gzip members, each at most 64 KiB of payload, carrying a BC
extra subfield with the compressed block size, terminated by a 28-byte EOF
block. Reading uses zlib directly per block; plain (non-blocked) gzip and
raw uncompressed streams are auto-detected.
"""

from __future__ import annotations

import gzip
import io
import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<BBBBIBBH")


def is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        magic = f.read(2)
    return magic == b"\x1f\x8b"


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(18)
    if len(head) < 18 or head[:2] != b"\x1f\x8b":
        return False
    flg = head[3]
    if not flg & 4:  # FEXTRA
        return False
    xlen = struct.unpack_from("<H", head, 10)[0]
    # scan extra subfields for BC
    return xlen >= 6 and head[12:14] == b"BC"


def open_reader(path: str):
    """Open path for binary reading, transparently decompressing
    gzip/BGZF."""
    if is_gzip(path):
        return gzip.open(path, "rb")
    return open(path, "rb")


class BgzfWriter:
    """Streaming BGZF writer (used for .vcf.gz / BAM test fixtures).

    With threads > 1 (and the native library available), complete 64K
    payloads are batched and deflated in parallel by
    native/bsc_bgzf.cpp — the reference's htslib output thread pool
    (parse_args.c:196-211). Blocks are compressed independently at the
    same zlib level, so the output bytes are identical to the serial
    path."""

    # buffer this much before a native batch (64 payloads ≈ 4 MiB)
    _BATCH = 64 * 0xFF00

    def __init__(self, fileobj, level: int = 6, threads: int = 0):
        self._f = fileobj
        self._level = level
        self._buf = bytearray()
        self._closed = False
        self._native = None
        self._threads = max(1, int(threads or 0))
        if self._threads > 1:
            try:
                from portbench.ref.native import load

                self._native = load()
            except Exception:
                self._native = None

    def write(self, data: bytes) -> int:
        self._buf += data
        if self._native is not None:
            if len(self._buf) >= self._BATCH:
                self._drain_native()
            return len(data)
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]
        return len(data)

    def _drain_native(self):
        """Compress all complete 64K payloads in one parallel batch."""
        import ctypes

        import numpy as np

        nblk = len(self._buf) // 0xFF00
        if not nblk:
            return
        take = nblk * 0xFF00
        # copy out of the bytearray: a frombuffer view would block the
        # `del self._buf[:take]` resize below (exported buffer)
        src = np.frombuffer(bytes(self._buf[:take]), dtype=np.uint8)
        cap = nblk * (0xFF00 + 1050)
        out = np.empty(cap, dtype=np.uint8)
        w = self._native.bsc_bgzf_deflate_batch(
            src.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(take),
            ctypes.c_int(self._level),
            ctypes.c_int(self._threads),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(cap),
        )
        if w < 0:  # zlib error: fall back to the serial path for good
            self._native = None
            while len(self._buf) >= 0xFF00:
                self._flush_block(self._buf[:0xFF00])
                del self._buf[:0xFF00]
            return
        self._f.write(memoryview(out.data)[:w])
        del self._buf[:take]

    def _flush_block(self, payload: bytes):
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        comp = co.compress(bytes(payload)) + co.flush()
        crc = zlib.crc32(bytes(payload)) & 0xFFFFFFFF
        # BSIZE field = total block length - 1; block is
        # header(12) + extra(6) + comp + crc/isize(8)
        bsize = len(comp) + 26 - 1
        block = (
            _HEADER.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
            + b"BC"
            + struct.pack("<HH", 2, bsize)
            + comp
            + struct.pack("<II", crc, len(payload) & 0xFFFFFFFF)
        )
        self._f.write(block)

    def flush(self):
        if self._native is not None:
            self._drain_native()
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]
        if self._buf:
            self._flush_block(self._buf)
            self._buf.clear()

    def close(self):
        if self._closed:
            return
        self.flush()
        self._f.write(BGZF_EOF)
        self._f.flush()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def bgzf_compress(data: bytes, level: int = 6) -> bytes:
    """One-shot BGZF compression including the EOF block."""
    out = io.BytesIO()
    w = BgzfWriter(out, level)
    w.write(data)
    w.close()
    return out.getvalue()


def _parse_block_header(head: bytes) -> int:
    """Total compressed size of the BGZF block whose first 18+ bytes are
    `head`, or -1 if it is not a BGZF block. Walks the FEXTRA subfields
    for BC (htslib writes it first, but the spec doesn't require it)."""
    if len(head) < 18 or head[:2] != b"\x1f\x8b" or not head[3] & 4:
        return -1
    xlen = struct.unpack_from("<H", head, 10)[0]
    off = 12
    end = 12 + xlen
    while off + 4 <= min(end, len(head)):
        si1, si2, slen = head[off], head[off + 1], struct.unpack_from(
            "<H", head, off + 2
        )[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:  # 'B','C'
            if off + 6 > len(head):
                return -1
            return struct.unpack_from("<H", head, off + 4)[0] + 1
        off += 4 + slen
    return -1


def load_gzi(path: str):
    """Read an htslib .gzi block index: [u64 n][n x (u64 coff, u64 uoff)]
    (the first block at (0,0) is implicit). Returns (coffs, uoffs) lists
    including the implicit first entry."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        raw = f.read(16 * n)
    coffs, uoffs = [0], [0]
    for i in range(n):
        c, u = struct.unpack_from("<QQ", raw, 16 * i)
        coffs.append(c)
        uoffs.append(u)
    return coffs, uoffs


def write_gzi(path: str, coffs, uoffs):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(coffs) - 1))
        for c, u in zip(coffs[1:], uoffs[1:]):
            f.write(struct.pack("<QQ", c, u))


def build_gzi(path: str):
    """Build the block index by walking BGZF headers (no inflation):
    each member's ISIZE trailer gives its uncompressed length."""
    coffs, uoffs = [0], [0]
    with open(path, "rb") as f:
        f.seek(0, 2)
        fsize = f.tell()
        coff = uoff = 0
        while coff < fsize:
            f.seek(coff)
            head = f.read(18)
            bsize = _parse_block_header(head)
            if bsize < 0 or coff + bsize > fsize:
                raise ValueError(f"{path}: corrupt BGZF block at {coff}")
            f.seek(coff + bsize - 4)
            (isize,) = struct.unpack("<I", f.read(4))
            coff += bsize
            uoff += isize
            if isize == 0 and coff >= fsize:
                break  # EOF block
            coffs.append(coff)
            uoffs.append(uoff)
    # drop the trailing entry that points past the last payload block
    if len(coffs) > 1 and coffs[-1] >= fsize:
        coffs.pop()
        uoffs.pop()
    return coffs, uoffs


class BgzfRandomReader:
    """Random access into a BGZF file by uncompressed offset — htslib's
    `bgzf_useek` (the reference reads bgzipped FASTA through it,
    read_reference.c:60-87). Uses the .gzi block index when present
    (writing one back otherwise, best-effort) and caches the last
    inflated block for sequential scans."""

    def __init__(self, path: str):
        self.path = path
        import os

        gzi = path + ".gzi"
        if os.path.exists(gzi):
            self._coffs, self._uoffs = load_gzi(gzi)
        else:
            self._coffs, self._uoffs = build_gzi(path)
            try:
                write_gzi(gzi, self._coffs, self._uoffs)
            except OSError:
                pass
        self._f = open(path, "rb")
        self._cache_i = -1
        self._cache = b""

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _block(self, i: int) -> bytes:
        if i == self._cache_i:
            return self._cache
        self._f.seek(self._coffs[i])
        head = self._f.read(18)
        bsize = _parse_block_header(head)
        if bsize < 0:
            raise ValueError(
                f"{self.path}: corrupt BGZF block at {self._coffs[i]}"
            )
        body = head + self._f.read(bsize - 18)
        data = zlib.decompress(body, wbits=31)
        self._cache_i, self._cache = i, data
        return data

    def read_at(self, uoffset: int, length: int) -> bytes:
        """Read `length` uncompressed bytes starting at `uoffset`."""
        import bisect

        out = []
        need = length
        i = bisect.bisect_right(self._uoffs, uoffset) - 1
        pos = uoffset
        while need > 0 and i < len(self._coffs):
            data = self._block(i)
            skip = pos - self._uoffs[i]
            take = data[skip : skip + need]
            if not take and not data:
                break  # EOF block
            out.append(take)
            need -= len(take)
            pos += len(take)
            i += 1
        return b"".join(out)
