"""End-to-end pipeline with the PyTorch engine.

Open input and reference, reconcile contigs, build the writer and the
emitters, drive the block pipeline (the native C++ one when the input
allows it, else the Python one), flush. The orchestration and the host
side it drives (ingest, emission, statistics) are this package's own
copy of `bs_call_tpu`'s, so both packages write the same bytes; the
engine is a `TorchCallEngine` on the caller's device.
"""

from __future__ import annotations

import os
import sys

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
    from bs_call_tpu_torch.utils.trace import Tracer

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
            cfg, out_fileobj, stats=stats, dbsnp=dbsnp
        )
    elif cfg.out_file_type == C.FT_VCF_GZ:
        vector_emitter = VectorBlockEmitter(
            cfg, gz_writer, stats=stats, dbsnp=dbsnp
        )
    elif cfg.out_file_type in (C.FT_BCF, C.FT_BCF_GZ):
        from bs_call_tpu_torch.native import load as _native_load

        if _native_load() is not None:
            vector_emitter = VectorBlockEmitter(
                cfg, out_fileobj, stats=stats, dbsnp=dbsnp,
                bcf_writer=writer,
            )
    emitter.vector = vector_emitter
    return out_fileobj, close_out, writer, emitter, vector_emitter


def _emit_block_soa(cfg, emitter, ctg, soa, ref_window, x, y,
                    hold_back=0, region=None):
    """Emit one block's already-called sites (no engine work). Sequential
    per emitter: carries the reference's 2-position lag state across
    blocks (print_vcf.c:529-594). ctg.curr_reg is owned by this (emit)
    stage — producer threads must not touch it."""
    ctg.curr_reg = region
    ve = getattr(emitter, "vector", None)
    sz = y - x + 1
    # NOTE: for blocks starting at x < 5 the reference's lag pipeline can
    # carry stale genotype slots from the previous contig into the first
    # pushes (print_vcf.c:563-570 shifts without clearing); that emits
    # degenerate rows (positions <= 0) in the reference. The vectorized
    # path assumes a clean lag state instead — a deliberate divergence.
    regions_ok = not getattr(ctg, "regions", None) or all(
        r.start <= 1 and r.stop >= ctg.seq_len for r in ctg.regions
    )
    if ve is not None and sz >= 9 and regions_ok:
        ve.old_ctg = emitter.old_ctg
        ve.old_x = emitter.old_x
        ve.prev_cpg_x = emitter.prev_cpg_x
        ve.prev_cpg_flt = emitter.prev_cpg_flt
        ve.emit_block(ctg, soa, ref_window, x, y, hold_back=hold_back)
        emitter.old_ctg = ve.old_ctg
        emitter.old_x = ve.old_x
        emitter.prev_cpg_x = ve.prev_cpg_x
        emitter.prev_cpg_flt = ve.prev_cpg_flt
        return
    assert hold_back == 0  # streaming only runs on the vector path
    calls = soa_to_calls(soa)
    for i, call in enumerate(calls):
        emitter.push(ctg, call, ref_window, x + i, x, skip=call is None)
    emitter.flush()


def _whole_contig_regions(table) -> bool:
    """True when every -C region spans a full contig — then region
    selection degenerates to contig selection, which the native pipeline
    and the vectorized emitter handle via tid_keep."""
    return bool(table.regions) and all(
        r.start <= 1 and r.stop >= r.ctg.seq_len for r in table.regions
    )


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
    partial = bool(table.regions) and not _whole_contig_regions(table)
    regions_payload = None
    if table.regions and cfg.input_file != "-":
        regions_payload = _pack_native_regions(cfg, table)
        if regions_payload is None and partial:
            # no .bai/.csi: build one beside the input when possible —
            # the indexed replay then seeks instead of scanning
            _ensure_bam_index(cfg.input_file)
            regions_payload = _pack_native_regions(cfg, table)
    stream_regions = None
    if partial and regions_payload is None:
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
        and (not table.regions or _whole_contig_regions(table))
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


def process_contig_blocks_native(
    cfg, npipe, table, fasta, engine, emitter, stats, tracer=None, rowe=None
):
    """Native-pipeline driver: C++ produces (x, y, pileup tensors) blocks;
    Python does reference windows, genotype batches and emission. With
    `rowe` (a HostRowEngine, which this call closes) every staged block of
    9 or more positions runs load / model / emit natively; the others are
    collected and go through `engine.call_block_soa`, in the same ordered
    emit worker. Consecutive whole blocks of a contig that need no
    streaming and carry reads are called together while they fit one
    fused chunk (`engine.call_blocks_soa`, `pack_offsets`): the packs
    follow from the blocks alone, never from timing.

    Three threads, each with its stages on `tracer`: the producer
    (`ingest.native`, `ingest.contig`, `ingest.pileup`, `ingest.reads`,
    `meth_prof`, `ingest_load`), this caller (`ingest`: waiting for the
    producer; `call`; `emit.backlog`: waiting for the emit worker) and
    the emit worker (`emit`). The producer numbers the blocks from 0
    (`bid`); each block-level span carries its block's number."""
    # re-open with stats collection if needed (no-op when the pipeline
    # was already created with stats on, e.g. non-reopenable stdin pipes)
    if stats is not None and not npipe.stats_on:
        npipe = npipe.reopen(collect_stats=True)
    import itertools
    import queue
    import threading

    from bs_call_tpu_torch.utils.trace import NULL_TRACER

    tracer = tracer or NULL_TRACER
    contig_seq = None
    whole_contigs = _whole_contig_regions(table)
    # settled-prefix partial staging: only with the vector emitter (the
    # hold_back streaming contract) and whole-contig processing. -C
    # regions that each span a full contig (the shard-worker pattern)
    # behave like plain contig processing modulo the indexed seek, so
    # they stage partials too — otherwise a dense whole-contig region
    # becomes ONE giant block and the worker faults contig-sized
    # buffers (hundreds of MB of sys time per shard).
    if (
        getattr(emitter, "vector", None) is not None
        and (not table.regions or whole_contigs)
        and hasattr(npipe, "set_partial")
    ):
        npipe.set_partial(2 * max(cfg.batch_positions, 1024))
    # background ingest: the C++ pipeline releases the GIL, so block
    # production overlaps with calling + emission (the reference's
    # reader-thread / process-thread split, process.c:43-72). Contig
    # loading and the meth profile also live here: bsp_block_meth_profile
    # references the pipeline's *staged* block, which stays valid exactly
    # until this thread's next next_block call (the reference's
    # mprof_thread, process.c:20-41). The loaded contig rides the block
    # dict so the consumer never touches the FastaIndex.
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()  # consumer error: producer must exit before
    # npipe.close() or bsp_next_block races the C++ teardown
    ve = getattr(emitter, "vector", None)

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # the row engine's slots: loaded by the producer, modelled by this
    # thread, emitted by the emit worker, which hands each one back
    free_slots: "queue.Queue" = queue.Queue()
    if rowe is not None:
        for _s in range(rowe.N_SLOTS):
            free_slots.put(_s)

    def _get_slot():
        while not stop.is_set():
            try:
                return free_slots.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def produce():
        pseq = None
        try:
            for bid in itertools.count():
                with tracer.stage("ingest.native") as sp:
                    if hasattr(npipe, "next_block_meta"):
                        b = npipe.next_block_meta()
                    else:
                        b = npipe.next_block()
                    if b is not None:
                        sp.block = bid
                if b is None:
                    _put(None)
                    return
                cname = table.contigs[table.tid2id[b["tid"]]].name
                if pseq is None or pseq.name != cname:
                    with tracer.stage("ingest.contig", block=bid):
                        pseq = fasta.load_contig(
                            cname, calc_gc=stats is not None
                        )
                collected = "counts2" in b
                sz = b["y"] - b["x"] + 1
                if rowe is not None and not collected and sz >= 9:
                    slot = _get_slot()
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
                b["bid"] = bid
                b["seq"] = pseq
                # fused device tier: export the staged block's read
                # batch (valid only until the next next_block call, so
                # it must be copied out here)
                if engine.wants_reads() and b.get("kind") != "row":
                    with tracer.stage("ingest.reads", block=bid):
                        b["reads"] = npipe.block_reads()
                if stats is not None:
                    with tracer.stage("meth_prof", block=bid):
                        mx = b.get("meth_x", b["x"])
                        rw = sequence_window(
                            pseq, mx, b["y"] - mx + 3
                        )
                        stats.grow_meth_profile(b["max_pos"] + 1)
                        npipe.block_meth_profile(rw, stats.meth_profile)
                if not _put(b):
                    return
        except Exception as e:  # surface errors on the consumer side
            _put(e)

    t = threading.Thread(target=produce, name="bs_call producer",
                         daemon=True)
    t.start()
    # emit stage runs on its own thread (the reference's print_thread,
    # process.c:74-110): formatting/writing block k overlaps the engine
    # call for block k+1. A single ordered worker keeps the 2-position
    # lag and CpG-pair state sequential, for row blocks (written by
    # bsre_emit straight into the vector emitter's file) and engine
    # blocks alike. Block arrays are host copies (native/pipeline.py
    # next_block), so no aliasing with the C++ side.
    emit_q: "queue.Queue" = queue.Queue(maxsize=4)
    emit_err: list = []

    def emit_worker():
        while True:
            item = emit_q.get()
            if item is None:
                return
            if item[0] == "row":
                # the slot goes back even after an error, so the
                # producer never waits on one
                _, bid, slot, ctg_r, partial_r = item
                if not emit_err:
                    try:
                        with tracer.stage("emit", block=bid):
                            rowe.emit(slot, emitter, ctg_r,
                                      2 if partial_r else 0,
                                      stats is not None, ve._f)
                    except Exception as e:
                        emit_err.append(e)
                free_slots.put(slot)
                continue
            # ("py", [(bid, _emit_block_soa's args)]): a pack's blocks
            # or one block's chunk
            for bid, args in item[1]:
                if emit_err:
                    break  # drain so the producer can't block
                try:
                    with tracer.stage("emit", block=bid):
                        _emit_block_soa(cfg, emitter, *args)
                except Exception as e:
                    emit_err.append(e)

    def emit_put(item):
        # the caller waits here only when the emit worker sets the pace
        try:
            emit_q.put_nowait(item)
        except queue.Full:
            with tracer.stage("emit.backlog"):
                emit_q.put(item)

    et = threading.Thread(target=emit_worker, name="bs_call emit",
                          daemon=True)
    et.start()
    CHUNK = max(cfg.batch_positions, 1024)
    # consecutive whole blocks called in one fused call
    # (`engine.call_blocks_soa`): [(bid, call args, emit args)], their
    # sizes and widest read
    pack, pack_sizes, pack_width = [], [], 0

    def flush():
        nonlocal pack_width
        if not pack:
            return
        with tracer.stage("call", block=pack[0][0]):
            soas = engine.call_blocks_soa([p[1] for p in pack])
        if emit_err:
            raise emit_err[0]
        emit_put(("py", [(bid, (ctg, soa, *rest))
                         for (bid, _, (ctg, *rest)), soa in zip(pack, soas)]))
        pack.clear()
        pack_sizes.clear()
        pack_width = 0

    try:
        while True:
            with tracer.stage("ingest"):
                blk = q.get()
            if isinstance(blk, Exception):
                raise blk
            if blk is None:
                flush()
                break
            ctg = table.contigs[table.tid2id[blk["tid"]]]
            if contig_seq is None or contig_seq.name != ctg.name:
                flush()
                tracer.progress(f"Processing contig {ctg.name}")
                contig_seq = blk["seq"]
                ctg.gc_start_pos = contig_seq.start_pos
                if ctg.ctg_stats is not None:
                    ctg.ctg_stats.gc = contig_seq.gc_bins
            x, y = blk["x"], blk["y"]
            sz = y - x + 1
            tracer.count("blocks")
            tracer.count("templates", blk["n_templates"])
            tracer.count("positions", sz)
            bid = blk["bid"]
            rd_blk = blk.get("reads")
            partial = blk.get("partial", False)
            if (blk.get("kind") != "row" and rd_blk and not partial
                    and sz <= CHUNK + 16):
                # a whole block that needs no streaming: packed with its
                # neighbours while the chunk has room
                width = max(pack_width, rd_blk["rd"].shape[1])
                if pack and engine.pack_offsets([*pack_sizes, sz],
                                                width) is None:
                    flush()
                    width = rd_blk["rd"].shape[1]
                ref_window = sequence_window(contig_seq, x, sz + 2)
                pack.append((bid, (
                    blk["counts2"], blk["qual_sum"], blk["mapq2_sum"],
                    ref_window[:sz], blk.get("agg"), (rd_blk, 0),
                ), (ctg, ref_window, x, y, 0)))
                pack_sizes.append(sz)
                pack_width = width
                continue
            flush()
            if blk.get("kind") == "row":
                with tracer.stage("call", block=bid):
                    engine.tier_positions["oracle"] += rowe.model(
                        blk["slot"])
                if emit_err:
                    raise emit_err[0]
                emit_put(("row", bid, blk["slot"], ctg,
                          blk.get("partial", False)))
                continue
            ref_window = sequence_window(contig_seq, x, sz + 2)
            # stream big blocks through the emit worker in chunks so the
            # engine batch for chunk j+1 overlaps the formatting of chunk
            # j even when the whole contig is one semantic block (dense
            # WGBS coverage rarely breaks blocks). Chunks overlap by 4
            # positions: 2 withheld lookahead rows + the 2-before context
            # the next chunk re-supplies (see emit_block hold_back). -C
            # regions that each span a whole contig (a shard worker's)
            # stream as a run without regions does: unstreamed, a block
            # wider than a chunk leaves the fused tier for the column tier.
            stream = (
                getattr(emitter, "vector", None) is not None
                and sz > CHUNK + 16
                and (not getattr(ctg, "regions", None) or whole_contigs)
            )
            agg = blk.get("agg")
            # a partial staged range is a chunk of a still-open block:
            # its last rows stay held back (the next range re-supplies
            # the 4-row overlap, exactly like the in-range chunks below)
            s = x
            while True:
                if stream and y - s + 1 > CHUNK + 16:
                    e = s + CHUNK - 1
                    hold = 2
                else:
                    e = y
                    hold = 2 if partial else 0
                sl = slice(s - x, e - x + 1)
                sub_agg = (
                    {k: v[sl] for k, v in agg.items()} if agg else None
                )
                with tracer.stage("call", block=bid):
                    soa = engine.call_block_soa(
                        blk["counts2"][sl], blk["qual_sum"][sl],
                        blk["mapq2_sum"][sl],
                        ref_window[s - x : e - x + 1], agg=sub_agg,
                        reads=(rd_blk, s - x) if rd_blk else None,
                    )
                if emit_err:
                    raise emit_err[0]
                emit_put(("py", [(
                    bid,
                    (ctg, soa, ref_window[s - x : e - x + 3], s, e, hold),
                )]))
                if e == y:
                    break
                s = e - 3
        with tracer.stage("emit.backlog"):
            emit_q.put(None)
            et.join()
        if emit_err:
            raise emit_err[0]
        if stats is not None:
            fc, fb, bf = npipe.get_stats()
            stats.filter_cts += fc
            stats.filter_bases += fb
            stats.base_filter += bf
    finally:
        if et.is_alive():
            emit_q.put(None)
        # the producer may be blocked on q.put or inside next_block;
        # closing npipe under it would free the C++ pipeline it is using
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(0.05)
        et.join(timeout=10)  # emitter writes to caller-owned fileobj
        npipe.close()
        if rowe is not None:
            # the producer has ended; an emit worker still alive may be
            # inside bsre_emit, so its handle is left to it, not freed
            if et.is_alive():
                rowe.abandon()
            else:
                rowe.close()


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
    """Python-path driver (SAM/CRAM/stdin/partial regions): same 3-stage
    thread pipeline as the native driver — block building + template
    normalization + pileup on a producer thread, engine batches on this
    thread, ordered emission on an emit worker."""
    import queue
    import threading

    from bs_call_tpu_torch.utils.trace import NULL_TRACER

    tracer = tracer or NULL_TRACER
    records = iter(reader)
    prefiltered = False
    if table.regions:
        indexed = _indexed_region_records(cfg, table)
        if indexed is not None:
            records = indexed
            prefiltered = True

    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        contig_seq = None
        try:
            for block in read_blocks(
                records, table, cfg, stats=stats, prefiltered=prefiltered
            ):
                ctg = block.ctg
                if contig_seq is None or contig_seq.name != ctg.name:
                    contig_seq = fasta.load_contig(
                        ctg.name, calc_gc=stats is not None
                    )
                    ctg.gc_start_pos = contig_seq.start_pos
                    if ctg.ctg_stats is not None:
                        ctg.ctg_stats.gc = contig_seq.gc_bins
                y = block.y
                first = block.align_list[0]
                x = first.forward_position or first.reverse_position
                assert 0 < x <= y
                x = x - 2 if x > 2 else 1
                sz = y - x + 1
                ref_window = sequence_window(contig_seq, x, sz + 2)
                with tracer.stage("normalize"):
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
                                al, x, orig_pos, max_pos, ref_window,
                                stats,
                            )
                with tracer.stage("pileup"):
                    counts2, qual_sum, mapq2_sum = build_pileup(
                        block.align_list, x, y, cfg.min_qual
                    )
                if not _put(
                    (ctg, block.region, counts2, qual_sum, mapq2_sum,
                     ref_window, x, y)
                ):
                    return
            _put(None)
        except Exception as e:
            _put(e)

    emit_q: "queue.Queue" = queue.Queue(maxsize=4)
    emit_err: list = []

    def emit_worker():
        while True:
            item = emit_q.get()
            if item is None:
                return
            if emit_err:
                continue
            try:
                with tracer.stage("emit"):
                    _emit_block_soa(cfg, emitter, *item)
            except Exception as e:
                emit_err.append(e)

    t = threading.Thread(target=produce, daemon=True)
    et = threading.Thread(target=emit_worker, daemon=True)
    t.start()
    et.start()
    try:
        while True:
            with tracer.stage("ingest"):
                blk = q.get()
            if isinstance(blk, Exception):
                raise blk
            if blk is None:
                break
            (ctg, region, counts2, qual_sum, mapq2_sum, ref_window,
             x, y) = blk
            sz = y - x + 1
            tracer.count("blocks")
            tracer.count("positions", sz)
            with tracer.stage("call"):
                soa = engine.call_block_soa(
                    counts2, qual_sum, mapq2_sum, ref_window[:sz]
                )
            if emit_err:
                raise emit_err[0]
            emit_q.put((ctg, soa, ref_window, x, y, 0, region))
        emit_q.put(None)
        et.join()
        if emit_err:
            raise emit_err[0]
    finally:
        if et.is_alive():
            emit_q.put(None)
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(0.05)
        et.join(timeout=10)
