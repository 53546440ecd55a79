"""End-to-end pipeline with the PyTorch engine.

The same orchestration as `bs_call_tpu.pipeline.runner.run_caller`
(open input and reference, reconcile contigs, build the writer and the
emitters, drive the native C++ block pipeline, flush), with a
`TorchCallEngine` on the caller's device in place of `CallEngine`. Block
production, emission and statistics are the JAX package's own functions,
imported, so both packages write the same bytes from the same host code.
"""

from __future__ import annotations

import sys

import torch

from bs_call_tpu import constants as C
from bs_call_tpu.config import CallerConfig
from bs_call_tpu.io.fasta import FastaIndex
from bs_call_tpu.io.sam import open_alignment_file
from bs_call_tpu.output.site import SiteEmitter
from bs_call_tpu.output.vcf_writer import VcfTextWriter, build_header_lines
from bs_call_tpu.pipeline.contigs import reconcile_contigs
from bs_call_tpu.pipeline.runner import (
    _try_native,
    process_contig_blocks,
    process_contig_blocks_native,
)
from bs_call_tpu_torch.pipeline.engine import TorchCallEngine


def run_caller(cfg: CallerConfig, device: torch.device, out_fileobj=None,
               stats=None, dbsnp=None, tracer=None):
    """Run the full pipeline with the engine on `device`. Returns
    (stats, contig_table). The tracer, when given, also receives the
    engine's per-tier position counts as `tier_<name>` counters."""
    from bs_call_tpu.ops.genotype_native import _n_threads
    from bs_call_tpu.utils.trace import Tracer

    cfg.sanitize()
    if tracer is None:
        tracer = Tracer(enabled=cfg.verbose)
    # -t calc,input,output shares, clamped to this process's CPU affinity
    # (see bs_call_tpu.pipeline.runner.run_caller)
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
        from bs_call_tpu.io.dbsnp import DbSnpIndex

        dbsnp = DbSnpIndex(cfg.dbsnp_file)

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
        from bs_call_tpu.io.bcf import BcfWriter

        writer = BcfWriter(
            out_fileobj, hdr_lines, threads=out_threads,
            compressed=cfg.out_file_type == C.FT_BCF_GZ,
        )
    elif cfg.out_file_type == C.FT_VCF_GZ:
        from bs_call_tpu.io.bgzf import BgzfWriter

        gz_writer = BgzfWriter(out_fileobj, threads=out_threads)
        writer = VcfTextWriter(gz_writer, table)
        writer.write_header(hdr_lines)
    else:
        writer = VcfTextWriter(out_fileobj, table)
        writer.write_header(hdr_lines)
    emitter = SiteEmitter(
        cfg, table, writer.write_site, stats=stats, dbsnp=dbsnp
    )
    from bs_call_tpu.output.vector_site import VectorBlockEmitter

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
        from bs_call_tpu.native import load as _native_load

        if _native_load() is not None:
            vector_emitter = VectorBlockEmitter(
                cfg, out_fileobj, stats=stats, dbsnp=dbsnp,
                bcf_writer=writer,
            )
    emitter.vector = vector_emitter
    engine = TorchCallEngine(cfg, device)
    engine.tracer = tracer
    native = _try_native(
        cfg, table, reader=reader, collect_stats=stats is not None
    )
    if native is not None:
        tracer.progress("using native C++ ingest pipeline")
        process_contig_blocks_native(
            cfg, native, table, fasta, engine, emitter, stats, tracer
        )
    else:
        process_contig_blocks(
            cfg, reader, table, fasta, engine, emitter, stats, tracer
        )
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
    tracer.report()
    return stats, table
