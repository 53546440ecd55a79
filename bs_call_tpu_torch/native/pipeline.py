"""Python driver for the native ingest-to-pileup pipeline."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from bs_call_tpu_torch.config import CallerConfig
from bs_call_tpu_torch.io.bam import BamHeader
from bs_call_tpu_torch.native import load


class NativePipeline:
    """Streams (tid, x, y, counts2, qual_sum, mapq2_sum) blocks from the
    C++ pipeline. Mirrors the Python read_blocks -> process_template ->
    build_pileup chain."""

    def __init__(self, path: str, cfg: CallerConfig, tid_keep: np.ndarray,
                 collect_stats: bool = False, threads: int = 4,
                 regions: Optional[np.ndarray] = None):
        """regions: packed int64 region table for indexed -C iteration
        (see runner._pack_native_regions); None = linear whole-file scan."""
        lib = load()
        if lib is None:
            raise RuntimeError("native pipeline unavailable")
        self._lib = lib
        self._args = (path, cfg, tid_keep, threads, regions)
        keep = np.ascontiguousarray(tid_keep, dtype=np.int8)
        self._h = lib.bsp_open(
            path.encode(),
            threads,
            cfg.mapq_thresh,
            ctypes.c_longlong(cfg.max_template_len),
            cfg.min_qual,
            int(cfg.keep_unmatched),
            int(cfg.ignore_duplicates),
            int(cfg.keep_duplicates),
            int(cfg.reference_quirks),
            cfg.left_trim[0],
            cfg.left_trim[1],
            cfg.right_trim[0],
            cfg.right_trim[1],
            int(collect_stats),
            keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            len(keep),
        )
        if not self._h:
            raise ValueError(f"{path}: cannot open")
        if regions is not None:
            payload = np.ascontiguousarray(regions, dtype=np.int64)
            ok = lib.bsp_set_regions(
                ctypes.c_void_p(self._h),
                payload.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(payload),
            )
            if not ok:
                self.close()
                raise ValueError("malformed native region table")
        self.stats_on = bool(collect_stats)
        self.header = BamHeader(
            text=lib.bsp_header_text(ctypes.c_void_p(self._h)).decode(),
            ref_names=[
                lib.bsp_ref_name(ctypes.c_void_p(self._h), i).decode()
                for i in range(lib.bsp_n_refs(ctypes.c_void_p(self._h)))
            ],
            ref_lens=[
                lib.bsp_ref_len(ctypes.c_void_p(self._h), i)
                for i in range(lib.bsp_n_refs(ctypes.c_void_p(self._h)))
            ],
        )
        self._meta = np.zeros(7, np.int64)

    def next_block(self) -> Optional[dict]:
        if self.next_block_meta() is None:
            return None
        return self._collect_block()

    def next_block_meta(self) -> Optional[dict]:
        """Advance to the next staged block and return its metadata
        WITHOUT exporting the pileup tensors — the row-engine path
        (native/rowengine.py) consumes the staged block natively; the
        regular path follows up with _collect_block()."""
        ok = self._lib.bsp_next_block(
            ctypes.c_void_p(self._h),
            self._meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if ok == -1:
            raise ValueError(
                "corrupt or unsorted alignment stream (input must be "
                "coordinate-sorted)"
            )
        if ok != 1:
            return None
        (tid, x, y, max_pos, n_templates, partial, meth_x) = (
            int(v) for v in self._meta
        )
        return {
            "tid": tid,
            "x": x,
            "y": y,
            "max_pos": max_pos,
            "n_templates": n_templates,
            "partial": bool(partial),
            "meth_x": meth_x,
        }

    def set_partial(self, limit: int):
        """Enable settled-prefix partial staging: open blocks hand over
        ranges of ~limit positions (4-position overlaps matching the
        emitter's hold_back contract) instead of waiting for the block to
        close — bounding builder memory and overlapping ingest with
        call/emit on gap-free contigs."""
        self._lib.bsp_set_partial(
            ctypes.c_void_p(self._h), ctypes.c_int64(int(limit))
        )

    def set_stream_regions(self, payload: np.ndarray) -> None:
        """Enable the sequential -C record filter (the C++ twin of
        blocks.region_filtered_records) — for input kinds without a
        seekable index (push-mode CRAM/SAM, non-indexed BAM). payload:
        int64 [n, (tid, start, stop) * n], start/stop 1-based
        inclusive."""
        payload = np.ascontiguousarray(payload, dtype=np.int64)
        self._stream_regions = payload  # reopen() replays it
        ok = self._lib.bsp_set_stream_regions(
            ctypes.c_void_p(self._h),
            payload.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(payload)),
        )
        if not ok:
            raise ValueError("malformed stream region table")

    def _carry_stream_regions(self, p):
        """Replay the stream -C filter onto a reopened pipeline."""
        sr = getattr(self, "_stream_regions", None)
        if sr is not None:
            p.set_stream_regions(sr)
        return p

    def _collect_block(self) -> dict:
        (tid, x, y, max_pos, n_templates, partial, meth_x) = (
            int(v) for v in self._meta
        )
        sz = y - x + 1
        # no np.zeros: the C++ pileup memsets these buffers itself
        counts2 = np.empty((sz, 2, 8), np.int32)
        qual_sum = np.empty((sz, 8), np.float32)
        mapq2 = np.empty(sz, np.float32)
        from bs_call_tpu_torch.ops.genotype_native import _n_threads

        nthr = ctypes.c_int32(_n_threads())
        self._lib.bsp_block_pileup(
            ctypes.c_void_p(self._h),
            counts2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            qual_sum.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mapq2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nthr,
        )
        # aggregated per-position stats (call_thread semantics) computed
        # natively so Python skips aggregate_pileup
        counts8 = np.empty((sz, 8), np.int32)
        quals8 = np.empty((sz, 8), np.int32)
        mq = np.empty(sz, np.int32)
        aq = np.empty(sz, np.int32)
        ntot = np.empty(sz, np.int32)
        i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
        self._lib.bsp_block_aggregate(
            ctypes.c_void_p(self._h),
            i32p(counts2),
            qual_sum.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mapq2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            i32p(counts8),
            i32p(quals8),
            i32p(mq),
            i32p(aq),
            i32p(ntot),
            nthr,
        )
        return {
            "tid": tid,
            "x": x,
            "y": y,
            "max_pos": max_pos,
            "n_templates": n_templates,
            "partial": bool(partial),
            "meth_x": meth_x,
            "counts2": counts2,
            "qual_sum": qual_sum,
            "mapq2_sum": mapq2,
            "agg": {
                "counts": counts8,
                "quals": quals8,
                "mq": mq,
                "aq": aq,
                "n": ntot,
            },
        }

    def block_reads(self) -> Optional[dict]:
        """Normalized read batch of the currently staged block — the
        exact segments the C++ pileup iterates, in the same order, with
        block-relative starts (may be negative at partial-range
        boundaries). Feeds the fused device pileup+call tier. Must be
        called before the next next_block()."""
        n = np.zeros(1, np.int64)
        ml = np.zeros(1, np.int64)
        self._lib.bsp_block_reads_size(
            ctypes.c_void_p(self._h), n.ctypes.data, ml.ctypes.data
        )
        R, L = int(n[0]), int(ml[0])
        if R == 0:
            return None
        rd = np.empty((R, L), np.uint8)
        starts = np.empty(R, np.int32)
        ori = np.empty(R, np.int32)
        strand = np.empty(R, np.int32)
        mapq = np.empty(R, np.int32)
        lens = np.empty(R, np.int32)
        self._lib.bsp_block_reads(
            ctypes.c_void_p(self._h),
            rd.ctypes.data, ctypes.c_int64(R), ctypes.c_int64(L),
            starts.ctypes.data, ori.ctypes.data, strand.ctypes.data,
            mapq.ctypes.data, lens.ctypes.data,
        )
        return {
            "rd": rd, "starts": starts, "ori": ori, "strand": strand,
            "mapq": mapq, "lens": lens,
        }

    def block_meth_profile(self, ref_window: np.ndarray, mprof: np.ndarray):
        """Accumulate this block's meth-profile counts into mprof
        [rows, 4] int64 (row = original read position + 1)."""
        ref = np.ascontiguousarray(ref_window, dtype=np.uint8)
        assert mprof.dtype == np.int64 and mprof.flags.c_contiguous
        self._lib.bsp_block_meth_profile(
            ctypes.c_void_p(self._h),
            ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(len(ref)),
            mprof.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(mprof)),
        )

    def get_stats(self):
        fc = np.zeros(15, np.int64)
        fb = np.zeros(15, np.int64)
        bf = np.zeros(5, np.int64)
        self._lib.bsp_get_stats(
            ctypes.c_void_p(self._h),
            fc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            fb.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            bf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return fc, fb, bf

    def close(self):
        if self._h:
            self._lib.bsp_close(ctypes.c_void_p(self._h))
            self._h = None

    def reopen(self, collect_stats: bool) -> "NativePipeline":
        """Fresh pipeline over the same input (used to turn on stats)."""
        path, cfg, tid_keep, threads, regions = self._args
        self.close()
        return self._carry_stream_regions(NativePipeline(
            path, cfg, tid_keep, collect_stats=collect_stats,
            threads=threads, regions=regions,
        ))


class NativePushPipeline(NativePipeline):
    """Push-mode variant: records are decoded host-side (CRAM/SAM/stdin),
    serialized to the raw BAM record layout, and fed to the C++ block
    builder in batches. Same block/stats/meth-profile surface as
    NativePipeline."""

    BATCH = 512  # records per push

    def __init__(self, record_iter_factory, header: BamHeader,
                 cfg: CallerConfig, tid_keep: np.ndarray,
                 collect_stats: bool = False, threads: int = 4):
        lib = load()
        if lib is None:
            raise RuntimeError("native pipeline unavailable")
        self._lib = lib
        self._push_args = (
            record_iter_factory, header, cfg, tid_keep, threads
        )
        self._records = iter(record_iter_factory())
        self._eof_sent = False
        keep = np.ascontiguousarray(tid_keep, dtype=np.int8)
        self._keep = keep
        self._h = lib.bsp_open_push(
            cfg.mapq_thresh,
            ctypes.c_longlong(cfg.max_template_len),
            cfg.min_qual,
            int(cfg.keep_unmatched),
            int(cfg.ignore_duplicates),
            int(cfg.keep_duplicates),
            int(cfg.reference_quirks),
            cfg.left_trim[0],
            cfg.left_trim[1],
            cfg.right_trim[0],
            cfg.right_trim[1],
            int(collect_stats),
            keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            len(keep),
        )
        if not self._h:
            raise RuntimeError("bsp_open_push failed")
        lib.bsp_set_threads(
            ctypes.c_void_p(self._h), ctypes.c_int32(max(1, threads))
        )
        if header.ref_lens:
            lens = np.asarray(header.ref_lens, dtype=np.int64)
            lib.bsp_set_ref_lens(
                ctypes.c_void_p(self._h), lens.ctypes.data, len(lens)
            )
        self.stats_on = bool(collect_stats)
        self.header = header
        self._meta = np.zeros(7, np.int64)

    def _feed(self) -> bool:
        """Serialize and push up to BATCH records; False at source EOF."""
        from bs_call_tpu_torch.io.bam import encode_bam_record

        chunks = []
        for rec in self._records:
            chunks.append(encode_bam_record(rec))
            if len(chunks) >= self.BATCH:
                break
        if not chunks:
            return False
        blob = b"".join(chunks)
        self._lib.bsp_push(
            ctypes.c_void_p(self._h), blob, ctypes.c_int64(len(blob))
        )
        return True

    def next_block(self) -> Optional[dict]:
        if self.next_block_meta() is None:
            return None
        return self._collect_block()

    def next_block_meta(self) -> Optional[dict]:
        while True:
            rc = self._lib.bsp_next_block(
                ctypes.c_void_p(self._h),
                self._meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            if rc == 1:
                (tid, x, y, max_pos, n_templates, partial, meth_x) = (
                    int(v) for v in self._meta
                )
                return {
                    "tid": tid,
                    "x": x,
                    "y": y,
                    "max_pos": max_pos,
                    "n_templates": n_templates,
                    "partial": bool(partial),
                    "meth_x": meth_x,
                }
            if rc == -1:
                raise ValueError(
                    "corrupt or unsorted alignment stream (input must "
                    "be coordinate-sorted)"
                )
            if rc == 0:
                return None
            # starved
            if not self._feed():
                if self._eof_sent:
                    return None  # defensive: should not loop forever
                self._lib.bsp_push_eof(ctypes.c_void_p(self._h))
                self._eof_sent = True

    def reopen(self, collect_stats: bool) -> "NativePushPipeline":
        factory, header, cfg, tid_keep, threads = self._push_args
        self.close()
        return self._carry_stream_regions(NativePushPipeline(
            factory, header, cfg, tid_keep, collect_stats=collect_stats,
            threads=threads,
        ))


class NativeCramPipeline(NativePushPipeline):
    """CRAM input with the record hot loop in C++: containers/blocks are
    parsed and decompressed host-side (zlib + native rANS), each slice is
    decoded to raw-BAM blobs by bsc_cram.cpp, and the blobs feed the same
    C++ block builder as BAM input. Python never touches individual
    records."""

    def __init__(self, path: str, cfg: CallerConfig, tid_keep: np.ndarray,
                 collect_stats: bool = False, threads: int = 4,
                 reference=None, region_windows=None):
        """region_windows ({tid: [(start, stop)]}, 1-based inclusive):
        container/slice pruning hint for -C runs — non-overlapping
        containers skip decompression and decoding entirely (the .crai
        fast path, served from the spec's own container header fields);
        record-level filtering still happens in the C++ stream region
        filter."""
        from bs_call_tpu_torch.io.cram import CramReader

        rdr = CramReader(path, reference=reference)
        self._cram_args = (
            path, cfg, tid_keep, threads, reference, region_windows
        )
        NativePushPipeline.__init__(
            self, lambda: iter(()), rdr.header, cfg, tid_keep,
            collect_stats=collect_stats, threads=threads,
        )
        self._blobs = rdr.iter_record_blobs(regions=region_windows)
        # probe: decode the first slice now so unsupported layouts fail
        # at construction (the caller falls back to the Python decoder)
        self._pending_blob = next(self._blobs, None)

    def _feed(self) -> bool:
        if self._pending_blob is not None:
            blob, _tid = self._pending_blob
            self._pending_blob = None
        else:
            nxt = next(self._blobs, None)
            if nxt is None:
                return False
            blob, _tid = nxt
        if not blob:
            return True
        self._lib.bsp_push(
            ctypes.c_void_p(self._h), blob, ctypes.c_int64(len(blob))
        )
        return True

    def reopen(self, collect_stats: bool) -> "NativeCramPipeline":
        (path, cfg, tid_keep, threads, reference,
         region_windows) = self._cram_args
        self.close()
        return self._carry_stream_regions(NativeCramPipeline(
            path, cfg, tid_keep, collect_stats=collect_stats,
            threads=threads, reference=reference,
            region_windows=region_windows,
        ))


class NativeSamPipeline(NativePushPipeline):
    """SAM text input parsed entirely in C++: the file's bytes (plain or
    gzip-decompressed) stream into the push pipeline with sam_mode on —
    line tokenization, CIGAR/seq/qual/aux conversion to the BAM layout,
    and the block builder all run natively."""

    CHUNK = 1 << 20

    def __init__(self, path: str, header: BamHeader, cfg: CallerConfig,
                 tid_keep: np.ndarray, collect_stats: bool = False,
                 threads: int = 4):
        NativePushPipeline.__init__(
            self, lambda: iter(()), header, cfg, tid_keep,
            collect_stats=collect_stats, threads=threads,
        )
        self._sam_args = (path, header, cfg, tid_keep, threads)
        names = b"".join(
            n.encode() + b"\x00" for n in header.ref_names
        )
        self._lib.bsp_set_sam_mode(
            ctypes.c_void_p(self._h), names, len(names)
        )
        self._stream = self._open_stream(path)

    @staticmethod
    def _open_stream(path):
        import gzip

        with open(path, "rb") as probe:
            magic = probe.read(2)
        if magic == b"\x1f\x8b":
            return gzip.open(path, "rb")
        return open(path, "rb")

    def _feed(self) -> bool:
        data = self._stream.read(self.CHUNK)
        if not data:
            return False
        self._lib.bsp_push(
            ctypes.c_void_p(self._h), bytes(data),
            ctypes.c_int64(len(data)),
        )
        return True

    def reopen(self, collect_stats: bool) -> "NativeSamPipeline":
        path, header, cfg, tid_keep, threads = self._sam_args
        self.close()
        return self._carry_stream_regions(NativeSamPipeline(
            path, header, cfg, tid_keep, collect_stats=collect_stats,
            threads=threads,
        ))


class NativeSamStreamPipeline(NativePushPipeline):
    """SAM text from a non-seekable stream (stdin): the header was already
    consumed by the Python SamReader; its pending first record line plus
    the remaining raw bytes feed the C++ sam_mode parser. Not
    reopenable."""

    CHUNK = 1 << 20

    def __init__(self, stream, pending, header: BamHeader,
                 cfg: CallerConfig, tid_keep: np.ndarray,
                 collect_stats: bool = False, threads: int = 4):
        NativePushPipeline.__init__(
            self, lambda: iter(()), header, cfg, tid_keep,
            collect_stats=collect_stats, threads=threads,
        )
        names = b"".join(
            n.encode() + b"\x00" for n in header.ref_names
        )
        self._lib.bsp_set_sam_mode(
            ctypes.c_void_p(self._h), names, len(names)
        )
        self._stream = stream
        if pending:
            self._lib.bsp_push(
                ctypes.c_void_p(self._h), bytes(pending),
                ctypes.c_int64(len(pending)),
            )

    def _feed(self) -> bool:
        data = self._stream.read(self.CHUNK)
        if not data:
            return False
        self._lib.bsp_push(
            ctypes.c_void_p(self._h), bytes(data),
            ctypes.c_int64(len(data)),
        )
        return True

    def reopen(self, collect_stats: bool):
        raise RuntimeError("SAM stream pipelines cannot be reopened")


class NativeBamStreamPipeline(NativePushPipeline):
    """Push-mode over an already-decompressed BAM byte stream positioned
    at the first record (stdin pipes): bytes are forwarded verbatim to
    the C++ record parser — no Python-side record decode at all. Not
    reopenable (the stream is consumed), so callers must set
    collect_stats up front."""

    CHUNK = 1 << 20

    def __init__(self, stream, header: BamHeader, cfg: CallerConfig,
                 tid_keep: np.ndarray, collect_stats: bool = False,
                 threads: int = 4):
        NativePushPipeline.__init__(
            self, lambda: iter(()), header, cfg, tid_keep,
            collect_stats=collect_stats, threads=threads,
        )
        self._stream = stream

    def _feed(self) -> bool:
        data = self._stream.read(self.CHUNK)
        if not data:
            return False
        self._lib.bsp_push(
            ctypes.c_void_p(self._h), bytes(data),
            ctypes.c_int64(len(data)),
        )
        return True

    def reopen(self, collect_stats: bool):
        raise RuntimeError("BAM stream pipelines cannot be reopened")
