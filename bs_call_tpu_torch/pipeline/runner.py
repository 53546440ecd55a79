"""End-to-end pipeline with the PyTorch engine.

Open input and reference, reconcile contigs, build the writer and the
emitters, drive the block pipeline (the native C++ one when the input
allows it, else the Python one), flush. The orchestration and the host
side it drives (ingest, emission, statistics) are this package's own
copy of `bs_call_tpu`'s, so both packages write the same bytes; the
engine is a `TorchCallEngine` on the caller's device.
"""

from __future__ import annotations

import itertools
import os
import queue
import sys
import threading
from functools import partial

import numpy as np
import torch

from bs_call_tpu_torch import constants as C
from bs_call_tpu_torch.config import CallerConfig
from bs_call_tpu_torch.device import HOST
from bs_call_tpu_torch.io.fasta import FastaIndex, sequence_window
from bs_call_tpu_torch.io.sam import open_alignment_file
from bs_call_tpu_torch.ops.pileup import build_pileup
from bs_call_tpu_torch.output.site import SiteEmitter
from bs_call_tpu_torch.output.vcf_writer import (
    VcfTextWriter,
    build_header_lines,
)
from bs_call_tpu_torch.pipeline.blocks import read_blocks
from bs_call_tpu_torch.pipeline.contigs import reconcile_contigs
from bs_call_tpu_torch.pipeline.engine import (
    HostCallEngine,
    TorchCallEngine,
    soa_to_calls,
)
from bs_call_tpu_torch.pipeline.template import process_template
from bs_call_tpu_torch.stats.meth_profile import meth_profile
from bs_call_tpu_torch.utils.trace import NULL_TRACER, Tracer

# blocks of fewer positions take the scalar emitter, and under the row
# engine the host engine's call
_MIN_VECTOR_POSITIONS = 9


def run_caller(cfg: CallerConfig, device: torch.device | str,
               out_fileobj=None, stats=None, dbsnp=None, tracer=None,
               devices=None):
    """Run the full pipeline with the engine on `device`, or position
    sharded over `devices` (default `engine.engine_devices`). With
    `device` HOST (`--device numpy`) no torch device work runs: where
    `_row_engine_gate` holds and the native ingest opens the input, native
    ingest and the host row engine (`native/rowengine.py`) carry the run,
    as they do `bs_call_tpu --device cpu`'s; otherwise the host engine on
    the Python record path, as `bs_call_tpu --device numpy` runs. Both
    write the same bytes. Returns (stats, contig_table). The tracer, when
    given, also receives the engine's per-tier position counts as
    `tier_<name>` counters, the number of chunks the fused and the
    column tiers carried as `fused_chunks` and `column_chunks`, and the
    blocks the fused chunks carried as `fused_blocks`."""
    from bs_call_tpu_torch.ops.genotype_native import _n_threads

    cfg.sanitize()
    if tracer is None:
        tracer = Tracer(enabled=cfg.verbose)
    with tracer.stage("job.open"):
        # -t calc,input,output shares, clamped to this process's CPU affinity
        aff = _n_threads()
        in_threads = min(cfg.input_threads or cfg.threads, aff)
        out_threads = min(
            cfg.output_threads if cfg.output_threads else cfg.threads, aff
        )
        reader = open_alignment_file(
            cfg.input_file, threads=in_threads, reference=cfg.reference_file
        )
        fasta = FastaIndex(cfg.reference_file)
        table = reconcile_contigs(
            fasta,
            reader.header,
            cfg.contig_bed,
            cfg.contig_sizes,
            make_stats=stats is not None,
        )
        if dbsnp is None and cfg.dbsnp_file:
            from bs_call_tpu_torch.io.dbsnp import DbSnpIndex

            dbsnp = DbSnpIndex(cfg.dbsnp_file)

        # before the output opens: an engine that cannot start leaves no file
        engine = (HostCallEngine(cfg) if device == HOST
                  else TorchCallEngine(cfg, device, devices))
        engine.tracer = tracer
        # the row engine, where the gate holds, is built here too; it is
        # closed below if anything fails before the native path owns it
        rowe = stats_acc = None
        if device == HOST and _row_engine_gate(
            cfg, table, engine, dbsnp, stats is not None
        ):
            rowe, stats_acc = _make_row_engine(cfg, stats is not None)
        try:
            out_fileobj, close_out, writer, emitter, vector_emitter = (
                _open_output(cfg, table, reader, dbsnp, stats, out_fileobj,
                             out_threads)
            )
            native = None
            if device != HOST or rowe is not None:
                native = _try_native(
                    cfg, table, reader=reader, collect_stats=stats is not None
                )
        except BaseException:
            if rowe is not None:
                rowe.close()
            raise
        if vector_emitter is not None:
            vector_emitter.tracer = tracer
        if native is None and rowe is not None:
            # the native ingest does not take this input: the Python record
            # path carries the run
            rowe.close()
            rowe = stats_acc = None
        if stats_acc is not None:
            # one accumulator for the row engine's blocks and the vector
            # emitter's, folded into `stats` by finalize_stats
            vector_emitter._nacc = stats_acc
            vector_emitter._nacc_tried = True
    if native is not None:
        tracer.progress("using native C++ ingest pipeline")
        if rowe is not None:
            tracer.progress("using native row engine")
        process_contig_blocks_native(
            cfg, native, table, fasta, engine, emitter, stats, tracer,
            rowe=rowe,
        )
    else:
        process_contig_blocks(
            cfg, reader, table, fasta, engine, emitter, stats, tracer
        )
    with tracer.stage("job.close"):
        emitter.flush()
        writer.close()
        if close_out:
            out_fileobj.close()
        if vector_emitter is not None and stats is not None:
            # fold natively accumulated report counters into the Python
            # BsStats before anyone reports it
            vector_emitter.finalize_stats(table)
    for name, n in engine.tier_positions.items():
        tracer.count(f"tier_{name}", n)
    tracer.count("fused_chunks", engine.fused_chunks)
    tracer.count("fused_blocks", engine.fused_blocks)
    tracer.count("column_chunks", engine.column_chunks)
    tracer.report()
    return stats, table


def _open_output(cfg, table, reader, dbsnp, stats, out_fileobj,
                 out_threads):
    """Open the output (`out_fileobj`, else `cfg.output_file`, else
    stdout), write the header and build the writer and the emitters.
    Returns (out_fileobj, close_out, writer, emitter, vector_emitter)."""
    close_out = False
    if out_fileobj is None:
        if cfg.output_file:
            out_fileobj = open(cfg.output_file, "wb")
            close_out = True
        else:
            out_fileobj = sys.stdout.buffer
    # header lines must be built first: vcf_rid assignment happens here
    hdr_lines = build_header_lines(
        cfg,
        table,
        reader.header.text,
        dbsnp.header_line if dbsnp is not None else None,
    )
    if cfg.out_file_type in (C.FT_BCF, C.FT_BCF_GZ):
        from bs_call_tpu_torch.io.bcf import BcfWriter

        writer = BcfWriter(
            out_fileobj, hdr_lines, threads=out_threads,
            compressed=cfg.out_file_type == C.FT_BCF_GZ,
        )
    elif cfg.out_file_type == C.FT_VCF_GZ:
        from bs_call_tpu_torch.io.bgzf import BgzfWriter

        gz_writer = BgzfWriter(out_fileobj, threads=out_threads)
        writer = VcfTextWriter(gz_writer, table)
        writer.write_header(hdr_lines)
    else:
        writer = VcfTextWriter(out_fileobj, table)
        writer.write_header(hdr_lines)
    emitter = SiteEmitter(
        cfg, table, writer.write_site, stats=stats, dbsnp=dbsnp
    )
    from bs_call_tpu_torch.output.vector_site import VectorBlockEmitter

    vector_emitter = None
    if isinstance(writer, VcfTextWriter) and cfg.out_file_type in (
        C.FT_VCF,
        C.FT_UNKN,
    ):
        vector_emitter = VectorBlockEmitter(
            cfg, out_fileobj, emitter.lag, stats=stats, dbsnp=dbsnp
        )
    elif cfg.out_file_type == C.FT_VCF_GZ:
        vector_emitter = VectorBlockEmitter(
            cfg, gz_writer, emitter.lag, stats=stats, dbsnp=dbsnp
        )
    elif cfg.out_file_type in (C.FT_BCF, C.FT_BCF_GZ):
        from bs_call_tpu_torch.native import load as _native_load

        if _native_load() is not None:
            vector_emitter = VectorBlockEmitter(
                cfg, out_fileobj, emitter.lag, stats=stats, dbsnp=dbsnp,
                bcf_writer=writer,
            )
    emitter.vector = vector_emitter
    return out_fileobj, close_out, writer, emitter, vector_emitter


def _emit_block_soa(emitter, ctg, soa, ref_window, x, y, hold_back=0,
                    region=None):
    """Emit one block's already-called sites (no engine work) on the emit
    worker, in block order: the run's `LagState` carries the reference's
    2-position lag across blocks and emitters (print_vcf.c:529-594).
    ctg.curr_reg is owned by this (emit) stage — producer threads must not
    touch it."""
    ctg.curr_reg = region
    # NOTE: for blocks starting at x < 5 the reference's lag pipeline can
    # carry stale genotype slots from the previous contig into the first
    # pushes (print_vcf.c:563-570 shifts without clearing); that emits
    # degenerate rows (positions <= 0) in the reference. The vectorized
    # path assumes a clean lag state instead — a deliberate divergence.
    if y - x + 1 >= _MIN_VECTOR_POSITIONS and _vector_route(emitter,
                                                            ctg.regions):
        emitter.vector.emit_block(ctg, soa, ref_window, x, y,
                                  hold_back=hold_back)
        return
    assert hold_back == 0  # streaming only runs on the vector path
    calls = soa_to_calls(soa)
    for i, call in enumerate(calls):
        emitter.push(ctg, call, ref_window, x + i, x, skip=call is None)
    emitter.flush()


def _whole_contigs(regions) -> bool:
    """True when every -C region spans a full contig, or there is none —
    then region selection degenerates to contig selection, which the
    native pipeline and the vectorized emitter handle via tid_keep."""
    return all(r.start <= 1 and r.stop >= r.ctg.seq_len for r in regions)


def _vector_route(emitter, regions) -> bool:
    """Which emitter blocks take, decided here alone: the vector emitter
    when there is one and `regions` span whole contigs (it has no per-site
    region gate), else the scalar `SiteEmitter`. Over the table's regions
    this says whether the run streams (partial staging, chunked blocks);
    over a contig's, whether that contig's blocks of
    `_MIN_VECTOR_POSITIONS` or more take the vector emitter."""
    return emitter.vector is not None and _whole_contigs(regions)


def _pack_native_regions(cfg, table):
    """Packed int64 region table for the C++ indexed iterator (None when
    no usable .bai/.csi exists). One entry per -C region in processing
    order: 0-based query window, merged index chunks, and the previous
    same-contig regions whose records were already yielded — the exact
    replay of _indexed_region_records / the reference's per-region
    sam_itr_queryi loop (get_template_vector.c:69-101)."""
    try:
        if os.path.exists(cfg.input_file + ".bai"):
            from bs_call_tpu_torch.io.bai import BaiIndex

            idx = BaiIndex(cfg.input_file + ".bai")
        elif os.path.exists(cfg.input_file + ".csi"):
            from bs_call_tpu_torch.io.csi import CsiIndex

            idx = CsiIndex(cfg.input_file + ".csi")
        else:
            return None
    except (ValueError, OSError):
        return None
    out = [len(table.regions)]
    for reg in table.regions:
        tid = reg.ctg.bam_tid
        beg, end = reg.start - 1, reg.stop
        chunks = idx.chunks_for(tid, beg, end)
        prev = [
            (r.start, r.stop)
            for r in reg.ctg.regions
            if r.stop < reg.start
        ]
        out += [tid, beg, end, len(chunks), len(prev)]
        for cb, ce in chunks:
            out += [cb, ce]
        for lo, hi in prev:
            out += [lo, hi]
    return np.asarray(out, dtype=np.int64)


def _pack_stream_regions(table):
    """[n, (tid, start, stop) * n] int64, 1-based inclusive — the
    sequential -C filter table for bsp_set_stream_regions (the C++ twin
    of blocks.region_filtered_records)."""
    out = [len(table.regions)]
    for reg in table.regions:
        out += [reg.ctg.bam_tid, reg.start, reg.stop]
    return np.asarray(out, dtype=np.int64)


def _ensure_bam_index(path: str) -> None:
    """Build a .bai for the input BAM when none exists, so a run with
    partial -C regions seeks to them instead of scanning the whole file.
    Quietly skipped for non-BAM or unwritable inputs, which then take the
    sequential region filter."""
    if not path or path == "-":
        return
    if os.path.exists(path + ".bai") or os.path.exists(path + ".csi"):
        return
    try:
        from bs_call_tpu_torch.io.bgzf import is_gzip

        if not is_gzip(path):
            return
        import gzip

        with gzip.open(path, "rb") as f:
            if f.read(4) != b"BAM\x01":
                return
        from bs_call_tpu_torch.io.bai import write_bai

        # build-to-temp + rename: a crash mid-write must not leave a
        # truncated .bai that later runs would trust
        tmp = f"{path}.bai.tmp{os.getpid()}"
        write_bai(path, tmp)
        os.replace(tmp, path + ".bai")
    except Exception:
        pass  # unindexable/corrupt/read-only dir: linear scan still works


def _try_native(cfg, table, reader=None, collect_stats=False):
    """The C++ pipeline handles whole-file runs and every -C region
    kind: indexed BAMs replay regions through BAI/CSI chunk seeks
    (including the whole-contig shard pattern, where they also seek
    past other contigs' records); non-indexed BAMs get a .bai built on
    the fly when the directory is writable; everything else (read-only
    non-indexed BAM, CRAM, SAM, gz-SAM) runs the C++ sequential stream
    filter — the same record-overlap semantics, without seeks. BAM
    files stream through the C++ decoder directly; CRAM and SAM decode
    host-side and feed the same block builder through push mode; stdin
    BAM pipes forward their decompressed bytes verbatim (stdin with
    partial regions stays on the Python pre-filter path)."""
    if not cfg.input_file:
        return None
    partial_regions = not _whole_contigs(table.regions)
    regions_payload = None
    if table.regions and cfg.input_file != "-":
        regions_payload = _pack_native_regions(cfg, table)
        if regions_payload is None and partial_regions:
            # no .bai/.csi: build one beside the input when possible —
            # the indexed replay then seeks instead of scanning
            _ensure_bam_index(cfg.input_file)
            regions_payload = _pack_native_regions(cfg, table)
    stream_regions = None
    if partial_regions and regions_payload is None:
        stream_regions = _pack_stream_regions(table)
    try:
        from bs_call_tpu_torch.native.pipeline import (
            NativeBamStreamPipeline,
            NativePipeline,
            NativePushPipeline,
        )
    except (OSError, RuntimeError, ImportError):
        return None
    tid_keep = _tid_keep(table)
    from bs_call_tpu_torch.ops.genotype_native import _n_threads

    in_threads = min(cfg.input_threads or cfg.threads, _n_threads())

    def with_regions(p):
        # sequential -C filter for input kinds with no usable index
        if stream_regions is not None:
            p.set_stream_regions(stream_regions)
        return p

    if cfg.input_file == "-":
        # stdin: forward the already-positioned stream (past the header)
        # to the native parser — BAM bytes verbatim, SAM text via the
        # C++ sam_mode line parser; partial -C runs through the C++
        # stream region filter like any other unindexed input
        from bs_call_tpu_torch.io.bam import BamReader
        from bs_call_tpu_torch.io.sam import SamReader

        try:
            if isinstance(reader, BamReader):
                return with_regions(NativeBamStreamPipeline(
                    reader._f, reader.header, cfg, tid_keep,
                    collect_stats=collect_stats, threads=in_threads,
                ))
            if isinstance(reader, SamReader) and reader.header.ref_names:
                from bs_call_tpu_torch.native.pipeline import (
                    NativeSamStreamPipeline,
                )

                return with_regions(NativeSamStreamPipeline(
                    reader._f, reader._pending, reader.header, cfg,
                    tid_keep, collect_stats=collect_stats,
                    threads=in_threads,
                ))
        except (RuntimeError, ValueError, OSError):
            return None
        return None
    try:
        from bs_call_tpu_torch.io.bgzf import is_gzip

        with open(cfg.input_file, "rb") as f:
            magic = f.read(4)
    except OSError:
        return None
    is_bam = False
    if is_gzip(cfg.input_file):
        import gzip

        with gzip.open(cfg.input_file, "rb") as f:
            is_bam = f.read(4) == b"BAM\x01"
    try:
        if is_bam:
            return with_regions(NativePipeline(
                cfg.input_file, cfg, tid_keep,
                collect_stats=collect_stats, threads=in_threads,
                regions=regions_payload,
            ))
        if magic == b"CRAM":
            # fully native record path: C++ slice decoder -> C++ builder
            from bs_call_tpu_torch.native.pipeline import NativeCramPipeline

            windows = None
            if table.regions:
                # container/slice pruning for -C: skip decoding data
                # provably outside every window (record-level filtering
                # still runs in the C++ stream filter / tid_keep)
                windows = {}
                for reg in table.regions:
                    windows.setdefault(reg.ctg.bam_tid, []).append(
                        (reg.start, reg.stop)
                    )
            try:
                return with_regions(NativeCramPipeline(
                    cfg.input_file, cfg, tid_keep,
                    collect_stats=collect_stats, threads=in_threads,
                    reference=cfg.reference_file,
                    region_windows=windows,
                ))
            except Exception:
                pass  # unsupported layout: Python record decode below
        if magic != b"CRAM" and not is_bam and reader is not None:
            # SAM text (plain or gzip): fully native line parser
            from bs_call_tpu_torch.native.pipeline import NativeSamPipeline

            try:
                return with_regions(NativeSamPipeline(
                    cfg.input_file, reader.header, cfg, tid_keep,
                    collect_stats=collect_stats, threads=in_threads,
                ))
            except Exception:
                pass  # fall through to the Python record decode
        if magic == b"CRAM" or reader is not None:
            # push mode: host decode (CRAM/SAM/gz-SAM) -> C++ builder
            def factory():
                return open_alignment_file(
                    cfg.input_file, native=False, threads=in_threads,
                    reference=cfg.reference_file,
                )

            header = (reader or factory()).header
            return with_regions(NativePushPipeline(
                factory, header, cfg, tid_keep,
                collect_stats=collect_stats, threads=in_threads,
            ))
    except (RuntimeError, ValueError, OSError):
        return None
    return None


def _row_engine_gate(cfg, table, engine, dbsnp, collect_stats) -> bool:
    """Whether the host row engine (`native/rowengine.py`) may carry a
    `--device numpy` run on native ingest: text VCF or VCF.gz, whose
    vector emitter has no BCF writer; no dbSNP; exact mode; no -C, or
    only whole-contig -C (bsre_emit has no per-site region gate); a host
    engine on the native model (`BS_CALL_PY_MODEL` unset) that wants no
    reads; and, with a report, the native stats accumulator
    (`BS_CALL_PY_STATS` unset)."""
    return (
        cfg.out_file_type in (C.FT_VCF, C.FT_UNKN, C.FT_VCF_GZ)
        and dbsnp is None
        and cfg.exact
        and _whole_contigs(table.regions)
        and engine._model is not None
        and not engine.wants_reads()
        and not (collect_stats and os.environ.get("BS_CALL_PY_STATS"))
    )


def _make_row_engine(cfg, collect_stats):
    """(HostRowEngine, its NativeStatsAcc or None) for a run the gate let
    through; raises when either cannot be built."""
    from bs_call_tpu_torch.native.rowengine import HostRowEngine

    acc = None
    if collect_stats:
        from bs_call_tpu_torch.stats.native_acc import NativeStatsAcc

        acc = NativeStatsAcc.create(quirks=cfg.reference_quirks)
        if acc is None:
            raise RuntimeError("native stats accumulator unavailable")
    return HostRowEngine(cfg, stats_acc=acc), acc


def _tid_keep(table):
    """int8 mask over bam tids of contigs to process; with regions, only
    contigs that actually have a region are processed."""
    max_tid = max((c.bam_tid for c in table.contigs), default=-1)
    tid_keep = np.zeros(max_tid + 1, dtype=np.int8)
    for c in table.contigs:
        if table.regions and not c.regions:
            continue
        tid_keep[c.bam_tid] = 1
    return tid_keep


class _BlockPipeline:
    """The three threads of a job (the reference's reader, process and
    print threads, process.c:20-110), for both drivers. The producer
    `bs_call producer` runs `produce(self)`, a generator of block records,
    into a queue of 2; the caller iterates the pipeline for them (`ingest`
    while it waits) and queues emit work with `emit`; the emit worker
    `bs_call emit` runs that work in order from a queue of 4. The worker's
    first error is latched and raised on the caller at its next `emit` or
    `join`; the worker then drains the queue without running it. On exit,
    whatever happened: the producer is stopped and drained, the emit
    worker joined, then `close(emit_worker_alive)` runs."""

    def __init__(self, tracer, produce, close=None):
        self.tracer = tracer
        self._stop = threading.Event()
        self._blocks: "queue.Queue" = queue.Queue(maxsize=2)
        self._emits: "queue.Queue" = queue.Queue(maxsize=4)
        self._err: list = []
        self._close = close
        self._producer = threading.Thread(
            target=self._produce, args=(produce,), name="bs_call producer",
            daemon=True)
        self._worker = threading.Thread(
            target=self._emit_loop, name="bs_call emit", daemon=True)

    def __enter__(self):
        self._producer.start()
        self._worker.start()
        return self

    def __exit__(self, *exc):
        if self._worker.is_alive():
            self._emits.put(None)
        # the producer may be blocked on a put or inside the native
        # pipeline; closing that under it would free what it is using
        self._stop.set()
        while self._producer.is_alive():
            try:
                self._blocks.get_nowait()
            except queue.Empty:
                pass
            self._producer.join(0.05)
        self._worker.join(timeout=10)  # it writes to caller-owned files
        if self._close is not None:
            self._close(self._worker.is_alive())

    def wait(self, q):
        """`q.get()` for the producer, or None once the pipeline stops."""
        while not self._stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._blocks.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, produce):
        try:
            for blk in produce(self):
                if not self._put(blk):
                    return
            self._put(None)
        except Exception as e:  # surface errors on the caller's side
            self._put(e)

    def __iter__(self):
        while True:
            with self.tracer.stage("ingest"):
                blk = self._blocks.get()
            if isinstance(blk, Exception):
                raise blk
            if blk is None:
                return
            yield blk

    def _emit_loop(self):
        while (entries := self._emits.get()) is not None:
            for bid, emit, done in entries:
                if not self._err:
                    try:
                        with self.tracer.stage("emit", block=bid):
                            emit()
                    except Exception as e:
                        self._err.append(e)
                if done is not None:
                    done()

    def emit(self, entries):
        """Queue [(block id, emit, done)] for the emit worker: each
        `emit()` runs in order unless an error came first, `done()` (or
        None) after it either way. Raises the worker's error."""
        if self._err:
            raise self._err[0]
        # the caller waits here only when the emit worker sets the pace
        try:
            self._emits.put_nowait(entries)
        except queue.Full:
            with self.tracer.stage("emit.backlog"):
                self._emits.put(entries)

    def join(self):
        """Wait until the emit worker has run everything queued; raise its
        error."""
        with self.tracer.stage("emit.backlog"):
            self._emits.put(None)
            self._worker.join()
        if self._err:
            raise self._err[0]


class _BlockRouter:
    """The caller's side of the pipeline: each block record (a dict of
    `bid`, `ctg`, `seq`, `x`, `y`, `n_templates`, the pileup arrays, and
    where they apply `agg`, `reads`, `partial`, `region`, or `kind` "row"
    and its `slot`) takes one of four routes, each a `call` stage and emit
    work tagged with the block's id:

    - `_row`: the host row engine's model; the emit worker formats the
      slot and hands it back.
    - `_pack`: a whole block that needs no streaming and carries reads
      joins the pack, consecutive blocks of one contig called together in
      one fused call while they fit one chunk (`engine.call_blocks_soa`,
      `pack_offsets`); `flush` calls it when a block does not fit, when
      the contig changes, before any other route and at the end. The
      packs follow from the blocks alone, never from timing.
    - `_chunks`: where the run streams, a block wider than a chunk.
    - `_call`: one `engine.call_block_soa`.
    """

    def __init__(self, cfg, pipe, engine, emitter, tracer, streams,
                 rowe=None, slots=None, collect_stats=False):
        self.pipe, self.engine, self.emitter = pipe, engine, emitter
        self.tracer = tracer
        self.streams = streams
        self.chunk = max(cfg.batch_positions, 1024)
        self.rowe, self.slots = rowe, slots
        self.collect_stats = collect_stats
        self.seq = None
        # the pack's blocks with their reference windows, sizes and widest
        # read
        self.pack, self.pack_sizes, self.pack_width = [], [], 0

    def run(self):
        """Every block to its route, the last pack, then wait for the emit
        worker."""
        for blk in self.pipe:
            self.take(blk)
        self.flush()
        self.pipe.join()

    def take(self, blk):
        ctg = blk["ctg"]
        if self.seq is None or self.seq.name != ctg.name:
            self.flush()
            self.tracer.progress(f"Processing contig {ctg.name}")
            self.seq = blk["seq"]
            ctg.gc_start_pos = self.seq.start_pos
            if ctg.ctg_stats is not None:
                ctg.ctg_stats.gc = self.seq.gc_bins
        x, y = blk["x"], blk["y"]
        sz = y - x + 1
        self.tracer.count("blocks")
        self.tracer.count("templates", blk["n_templates"])
        self.tracer.count("positions", sz)
        if blk.get("kind") == "row":
            self.flush()
            self._row(blk)
            return
        refw = sequence_window(self.seq, x, sz + 2)
        if (blk.get("reads") and not blk.get("partial")
                and sz <= self.chunk + 16):
            self._pack(blk, refw, sz)
            return
        self.flush()
        if self.streams and sz > self.chunk + 16:
            self._chunks(blk, refw)
        else:
            # a partial staged range is a chunk of a still-open block: its
            # last rows stay held back (the next range re-supplies the
            # 4-row overlap, exactly like `_chunks`')
            self._call(blk, refw, x, y, 2 if blk.get("partial") else 0)

    def _row(self, blk):
        slot = blk["slot"]
        with self.tracer.stage("call", block=blk["bid"]):
            self.engine.tier_positions["oracle"] += self.rowe.model(slot)
        # the slot goes back even after an emit error, so the producer
        # never waits on one
        self.pipe.emit([(blk["bid"], partial(
            self.rowe.emit, slot, self.emitter.lag, blk["ctg"],
            2 if blk.get("partial") else 0, self.collect_stats,
            self.emitter.vector._f,
        ), partial(self.slots.put, slot))])

    def _pack(self, blk, refw, sz):
        width = blk["reads"]["rd"].shape[1]
        if self.pack and self.engine.pack_offsets(
                [*self.pack_sizes, sz], max(self.pack_width, width)) is None:
            self.flush()
        self.pack.append((blk, refw))
        self.pack_sizes.append(sz)
        self.pack_width = max(self.pack_width, width)

    def flush(self):
        if not self.pack:
            return
        args = [(b["counts2"], b["qual_sum"], b["mapq2_sum"], refw[:sz],
                 b.get("agg"), (b["reads"], 0))
                for (b, refw), sz in zip(self.pack, self.pack_sizes)]
        with self.tracer.stage("call", block=self.pack[0][0]["bid"]):
            soas = self.engine.call_blocks_soa(args)
        self.pipe.emit([
            (b["bid"], partial(_emit_block_soa, self.emitter, b["ctg"], soa,
                               refw, b["x"], b["y"]), None)
            for (b, refw), soa in zip(self.pack, soas)
        ])
        self.pack, self.pack_sizes, self.pack_width = [], [], 0

    def _chunks(self, blk, refw):
        """Stream a wide block through the emit worker in chunks, so the
        engine call for chunk j+1 overlaps the formatting of chunk j even
        when the whole contig is one semantic block (dense WGBS coverage
        rarely breaks blocks). Chunks overlap by 4 positions: 2 withheld
        lookahead rows + the 2-before context the next chunk re-supplies
        (see emit_block hold_back). -C regions that each span a whole
        contig (a shard worker's) stream as a run without regions does:
        unstreamed, a block wider than a chunk leaves the fused tier for
        the column tier."""
        s, y = blk["x"], blk["y"]
        while y - s + 1 > self.chunk + 16:
            e = s + self.chunk - 1
            self._call(blk, refw, s, e, 2)
            s = e - 3
        self._call(blk, refw, s, y, 2 if blk.get("partial") else 0)

    def _call(self, blk, refw, s, e, hold):
        """One `call_block_soa` over positions [s, e] of the block, emitted
        with its last `hold` rows held back."""
        x, bid, agg, reads = blk["x"], blk["bid"], blk.get("agg"), \
            blk.get("reads")
        sl = slice(s - x, e - x + 1)
        sub_agg = {k: v[sl] for k, v in agg.items()} if agg else None
        with self.tracer.stage("call", block=bid):
            soa = self.engine.call_block_soa(
                blk["counts2"][sl], blk["qual_sum"][sl],
                blk["mapq2_sum"][sl], refw[sl], agg=sub_agg,
                reads=(reads, s - x) if reads else None,
            )
        self.pipe.emit([(bid, partial(
            _emit_block_soa, self.emitter, blk["ctg"], soa,
            refw[s - x: e - x + 3], s, e, hold, blk.get("region"),
        ), None)])


def process_contig_blocks_native(
    cfg, npipe, table, fasta, engine, emitter, stats, tracer=None, rowe=None
):
    """Native-pipeline driver: C++ produces (x, y, pileup tensors) blocks;
    Python does reference windows, genotype batches and emission. With
    `rowe` (a HostRowEngine, which this call closes) every staged block of
    `_MIN_VECTOR_POSITIONS` or more runs load / model / emit natively; the
    others are collected and go through the engine. `_BlockRouter` takes
    each block to its route.

    The producer's stages: `ingest.native`, `ingest.contig`,
    `ingest.pileup`, `ingest.reads`, `meth_prof`, `ingest_load`. It
    numbers the blocks from 0 (`bid`); each block-level span carries its
    block's number."""
    # re-open with stats collection if needed (no-op when the pipeline
    # was already created with stats on, e.g. non-reopenable stdin pipes)
    if stats is not None and not npipe.stats_on:
        npipe = npipe.reopen(collect_stats=True)
    tracer = tracer or NULL_TRACER
    # settled-prefix partial staging where the run streams: -C regions
    # that each span a full contig (the shard-worker pattern) behave like
    # plain contig processing modulo the indexed seek, so they stage
    # partials too — otherwise a dense whole-contig region becomes ONE
    # giant block and the worker faults contig-sized buffers (hundreds of
    # MB of sys time per shard).
    streams = _vector_route(emitter, table.regions)
    if streams:
        npipe.set_partial(2 * max(cfg.batch_positions, 1024))
    # the row engine's slots: loaded by the producer, modelled by the
    # caller, emitted by the emit worker, which hands each one back
    slots: "queue.Queue" = queue.Queue()
    for s in range(rowe.N_SLOTS if rowe is not None else 0):
        slots.put(s)

    def produce(pipe):
        # the C++ pipeline releases the GIL, so block production overlaps
        # calling and emission. Contig loading and the meth profile live
        # here too: bsp_block_meth_profile references the pipeline's
        # *staged* block, which stays valid exactly until this thread's
        # next next_block call (the reference's mprof_thread,
        # process.c:20-41). The loaded contig rides the block record so
        # the caller never touches the FastaIndex.
        pseq = None
        for bid in itertools.count():
            with tracer.stage("ingest.native") as sp:
                b = npipe.next_block_meta()
                if b is not None:
                    sp.block = bid
            if b is None:
                return
            ctg = table.contigs[table.tid2id[b["tid"]]]
            if pseq is None or pseq.name != ctg.name:
                with tracer.stage("ingest.contig", block=bid):
                    pseq = fasta.load_contig(
                        ctg.name, calc_gc=stats is not None
                    )
            collected = "counts2" in b
            sz = b["y"] - b["x"] + 1
            if (rowe is not None and not collected
                    and sz >= _MIN_VECTOR_POSITIONS):
                slot = pipe.wait(slots)
                if slot is None:
                    return
                refw = sequence_window(pseq, b["x"], sz + 2)
                with tracer.stage("ingest_load", block=bid):
                    rowe.load(slot, npipe, b["x"], b["y"], refw)
                b["kind"] = "row"
                b["slot"] = slot
            elif not collected:
                with tracer.stage("ingest.pileup", block=bid):
                    b = npipe._collect_block()
            b.update(bid=bid, ctg=ctg, seq=pseq)
            # fused device tier: export the staged block's read batch
            # (valid only until the next next_block call, so it must be
            # copied out here)
            if engine.wants_reads() and b.get("kind") != "row":
                with tracer.stage("ingest.reads", block=bid):
                    b["reads"] = npipe.block_reads()
            if stats is not None:
                with tracer.stage("meth_prof", block=bid):
                    mx = b.get("meth_x", b["x"])
                    rw = sequence_window(pseq, mx, b["y"] - mx + 3)
                    stats.grow_meth_profile(b["max_pos"] + 1)
                    npipe.block_meth_profile(rw, stats.meth_profile)
            yield b

    def close(emit_alive):
        npipe.close()
        if rowe is not None:
            # an emit worker still alive may be inside bsre_emit, so its
            # handle is left to it, not freed
            if emit_alive:
                rowe.abandon()
            else:
                rowe.close()

    with _BlockPipeline(tracer, produce, close) as pipe:
        _BlockRouter(cfg, pipe, engine, emitter, tracer, streams, rowe,
                     slots, stats is not None).run()
        if stats is not None:
            fc, fb, bf = npipe.get_stats()
            stats.filter_cts += fc
            stats.filter_bases += fb
            stats.base_filter += bf


def _indexed_region_records(cfg, table):
    """Per-region record iteration through a .bai/.csi index (the
    reference's sam_itr_queryi path, get_template_vector.c:69-101).
    Returns None when no usable index exists. Records starting inside an
    earlier region of the same contig are skipped (they were already
    yielded there)."""
    if not cfg.input_file or not (
        os.path.exists(cfg.input_file + ".bai")
        or os.path.exists(cfg.input_file + ".csi")
    ):
        return None
    try:
        from bs_call_tpu_torch.io.bai import IndexedBamReader

        idx = IndexedBamReader(cfg.input_file)
    except (ValueError, OSError):
        return None

    def gen():
        try:
            for reg in table.regions:
                prev = [
                    r
                    for r in reg.ctg.regions
                    if r.stop < reg.start
                ]
                for rec in idx.query(
                    reg.ctg.bam_tid, reg.start - 1, reg.stop
                ):
                    if any(
                        p.start <= rec.pos + 1 <= p.stop for p in prev
                    ):
                        continue
                    rec.region = reg
                    yield rec
        finally:
            idx.close()

    return gen()


def process_contig_blocks(cfg, reader, table, fasta, engine, emitter, stats,
                          tracer=None):
    """Python-path driver (SAM/CRAM/stdin/partial regions): the native
    driver's three threads, with block building, template normalization
    (`normalize`) and the pileup (`pileup`) on the producer, which numbers
    the blocks from 0. The blocks carry no reads and the run does not
    stream, so each block takes one engine call."""
    tracer = tracer or NULL_TRACER
    records = iter(reader)
    prefiltered = False
    if table.regions:
        indexed = _indexed_region_records(cfg, table)
        if indexed is not None:
            records = indexed
            prefiltered = True

    def produce(_pipe):
        seq = None
        for bid, block in enumerate(read_blocks(
            records, table, cfg, stats=stats, prefiltered=prefiltered
        )):
            ctg = block.ctg
            if seq is None or seq.name != ctg.name:
                seq = fasta.load_contig(ctg.name, calc_gc=stats is not None)
            y = block.y
            first = block.align_list[0]
            x = first.forward_position or first.reverse_position
            assert 0 < x <= y
            x = x - 2 if x > 2 else 1
            ref_window = sequence_window(seq, x, y - x + 3)
            with tracer.stage("normalize", block=bid):
                for al in block.align_list:
                    orig_pos, max_pos = process_template(
                        al,
                        cfg.left_trim,
                        cfg.right_trim,
                        stats=stats,
                        min_qual=cfg.min_qual,
                    )
                    if stats is not None:
                        meth_profile(
                            al, x, orig_pos, max_pos, ref_window, stats,
                        )
            with tracer.stage("pileup", block=bid):
                counts2, qual_sum, mapq2_sum = build_pileup(
                    block.align_list, x, y, cfg.min_qual
                )
            yield {"bid": bid, "ctg": ctg, "seq": seq, "region": block.region,
                   "x": x, "y": y, "n_templates": len(block.align_list),
                   "counts2": counts2, "qual_sum": qual_sum,
                   "mapq2_sum": mapq2_sum}

    with _BlockPipeline(tracer, produce) as pipe:
        _BlockRouter(cfg, pipe, engine, emitter, tracer, False).run()
