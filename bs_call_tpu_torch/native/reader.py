"""NativeBamReader: drop-in replacement for io.bam.BamReader backed by the
C++ batch decoder. Yields the same BamRec objects (with packed read bytes
and bisulfite strand precomputed natively), plus a raw batch API for fully
vectorized consumers."""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional

import numpy as np

from bs_call_tpu_torch.io.bam import BamHeader, BamRec
from bs_call_tpu_torch.native import load


class NativeBamReader:
    BATCH = 16384
    CIGAR_CAP = BATCH * 8
    SEQ_CAP = BATCH * 512
    NAME_CAP = BATCH * 64

    def __init__(self, path: str, threads: int = 4):
        lib = load()
        if lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._lib = lib
        self._h = lib.bsc_open(path.encode(), threads)
        if not self._h:
            raise ValueError(f"{path}: cannot open as BAM")
        names = [
            lib.bsc_ref_name(self._h, i).decode()
            for i in range(lib.bsc_n_refs(self._h))
        ]
        lens = [lib.bsc_ref_len(self._h, i) for i in range(len(names))]
        self.header = BamHeader(
            text=lib.bsc_header_text(self._h).decode(),
            ref_names=names,
            ref_lens=lens,
        )
        b = self.BATCH
        self._tid = np.empty(b, np.int32)
        self._pos = np.empty(b, np.int32)
        self._mtid = np.empty(b, np.int32)
        self._mpos = np.empty(b, np.int32)
        self._isize = np.empty(b, np.int32)
        self._flag = np.empty(b, np.uint16)
        self._mapq = np.empty(b, np.uint8)
        self._strand = np.empty(b, np.int32)
        self._cigar_off = np.empty(b + 1, np.int64)
        self._cigar = np.empty(self.CIGAR_CAP, np.uint32)
        self._seq_off = np.empty(b + 1, np.int64)
        self._seq = np.empty(self.SEQ_CAP, np.uint8)
        self._name_off = np.empty(b + 1, np.int64)
        self._name = np.empty(self.NAME_CAP, np.uint8)

    def _ptr(self, arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    def next_batch(self) -> Optional[dict]:
        """Raw struct-of-arrays batch (views into reusable buffers)."""
        n = self._lib.bsc_next_batch(
            ctypes.c_void_p(self._h),
            self.BATCH,
            self._ptr(self._tid, ctypes.c_int32),
            self._ptr(self._pos, ctypes.c_int32),
            self._ptr(self._mtid, ctypes.c_int32),
            self._ptr(self._mpos, ctypes.c_int32),
            self._ptr(self._isize, ctypes.c_int32),
            self._ptr(self._flag, ctypes.c_uint16),
            self._ptr(self._mapq, ctypes.c_uint8),
            self._ptr(self._strand, ctypes.c_int32),
            self._ptr(self._cigar_off, ctypes.c_int64),
            self._ptr(self._cigar, ctypes.c_uint32),
            ctypes.c_int64(self.CIGAR_CAP),
            self._ptr(self._seq_off, ctypes.c_int64),
            self._ptr(self._seq, ctypes.c_uint8),
            ctypes.c_int64(self.SEQ_CAP),
            self._ptr(self._name_off, ctypes.c_int64),
            self._ptr(self._name, ctypes.c_char),
            ctypes.c_int64(self.NAME_CAP),
        )
        if n <= 0:
            return None
        return {
            "n": n,
            "tid": self._tid[:n],
            "pos": self._pos[:n],
            "mtid": self._mtid[:n],
            "mpos": self._mpos[:n],
            "isize": self._isize[:n],
            "flag": self._flag[:n],
            "mapq": self._mapq[:n],
            "strand": self._strand[:n],
            "cigar_off": self._cigar_off[: n + 1],
            "cigar": self._cigar,
            "seq_off": self._seq_off[: n + 1],
            "seq": self._seq,
            "name_off": self._name_off[: n + 1],
            "name": self._name,
        }

    def __iter__(self) -> Iterator[BamRec]:
        name_bytes = self._name
        while True:
            b = self.next_batch()
            if b is None:
                return
            n = b["n"]
            co, so, no = b["cigar_off"], b["seq_off"], b["name_off"]
            for i in range(n):
                packed = b["seq"][so[i] : so[i + 1]].copy()
                cig_words = b["cigar"][co[i] : co[i + 1]]
                cigar = [
                    (int(w) >> 4, int(w) & 0xF) for w in cig_words
                ]
                rec = BamRec(
                    name=bytes(name_bytes[no[i] : no[i + 1]]).decode(),
                    flag=int(b["flag"][i]),
                    tid=int(b["tid"][i]),
                    pos=int(b["pos"][i]),
                    mapq=int(b["mapq"][i]),
                    cigar=cigar,
                    mtid=int(b["mtid"][i]),
                    mpos=int(b["mpos"][i]),
                    isize=int(b["isize"][i]),
                    seq_code=None,  # packed bytes precomputed natively
                    qual=None,
                    aux=b"",
                    l_qseq=len(packed),
                )
                rec.packed = packed
                rec.bs_strand = int(b["strand"][i])
                yield rec

    def close(self):
        if self._h:
            self._lib.bsc_close(ctypes.c_void_p(self._h))
            self._h = None
