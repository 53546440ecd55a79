"""The plain reference caller: the Python record path, one thread.

Frozen copies of the port's host record path and oracles (`portbench/ref/`,
imports rewritten, nothing of the port, `bs_call_tpu` or `jax` imported):
record classification and pairing (`pipeline/blocks.py`), template
normalisation (`pipeline/template.py`), the pileup (`ops/pileup.py`), the
10-genotype model in NumPy (`ops/genotype_np.py`) with the C-style finish
and the scalar oracle on ties, the host Fisher test, the scalar site
emitter (`output/site.py`), the BCF writer and the JSON report. The
program under test runs none of these on its main path: its native C++
ingest builds the pileup, K12 runs the model, K3 the emit fields, and its
vector emitter and native formatter write the records.

`dtype` float32 is the control: the same reference with the model in the
precision below the float64 the configuration states (exact mode), and no
float64 oracle rescue."""

from __future__ import annotations

import io

import numpy as np

from portbench.ref.cli_args import args_to_config, build_parser
from portbench.ref.constants import LOG10
from portbench.ref.io.bcf import BcfWriter
from portbench.ref.io.fasta import FastaIndex, sequence_window
from portbench.ref.ops import oracle
from portbench.ref.ops.genotype_np import call_genotypes_np
from portbench.ref.ops.pileup import build_pileup
from portbench.ref.ops.postprocess import aggregate_pileup, fisher_strand
from portbench.ref.output.site import SiteCall, SiteEmitter
from portbench.ref.output.vcf_writer import build_header_lines
from portbench.ref.pipeline.blocks import read_blocks
from portbench.ref.pipeline.contigs import reconcile_contigs
from portbench.ref.pipeline.template import process_template
from portbench.ref.stats.collect import BsStats
from portbench.ref.stats.meth_profile import meth_profile
from portbench.ref.stats.report import write_report

TIE_MARGIN = 1e-9  # rows below go to the scalar oracle (exact mode)


def _call_block(cfg, counts2, qual_sum, mapq2_sum, ref_codes, dtype,
                want):
    """Per-position calls of one block (the host engine's call_block_soa),
    for the positions `want` (bool [sz]) marks."""
    agg = aggregate_pileup(counts2, qual_sum, mapq2_sum)
    sz = len(agg["n"])
    covered_mask = (agg["n"] > 0) & want
    covered = np.nonzero(covered_mask)[0]
    gt_prob_full = np.zeros((sz, 10), dtype=np.float64)
    max_gt_full = np.zeros(sz, dtype=np.int32)
    fs_full = np.zeros(sz, dtype=np.float64)
    if len(covered):
        counts = agg["counts"][covered].astype(np.int32)
        quals = agg["quals"][covered]
        ref = np.asarray(ref_codes, dtype=np.int32)[covered]
        gt_prob, max_gt, margin, off = call_genotypes_np(
            counts, quals, ref, cfg.under_conv, cfg.over_conv,
            cfg.ref_bias, dtype=dtype,
        )
        gt_prob = gt_prob.astype(np.float64)
        idx = np.arange(len(max_gt))
        gt_prob[idx, max_gt] = (
            -np.log(dtype(1.0) + off.astype(dtype)) / dtype(LOG10)
        )
        if cfg.exact and dtype == np.float64:
            for j in np.nonzero(margin < TIE_MARGIN)[0]:
                gt_prob[j], max_gt[j] = oracle.calc_gt_prob(
                    counts[j], quals[j], int(ref[j]), cfg.under_conv,
                    cfg.over_conv, cfg.ref_bias,
                )
        gt_prob_full[covered] = gt_prob
        max_gt_full[covered] = max_gt
        fs_full[covered] = fisher_strand(
            counts2[covered], max_gt, not cfg.reference_quirks
        )
    calls = [None] * sz
    for j in covered:
        calls[j] = SiteCall(
            counts=agg["counts"][j], quals=agg["quals"][j],
            gt_prob=gt_prob_full[j], fisher_strand=fs_full[j],
            mq=int(agg["mq"][j]), aq=int(agg["aq"][j]),
            max_gt=int(max_gt_full[j]),
        )
    return calls


def run_reference(argv, records, header, dtype=np.float64, spans=None):
    """Call `records` (sorted `portbench.ref.io.bam.BamRec`s under
    `header`, a `BamHeader`) as `bs_call_tpu_torch.cli` would with `argv`.
    Returns (bcf_bytes, report_text or None): the BCF uncompressed (`-O
    u`'s stream) and the JSON report when argv asks for one. With `spans`
    ([(tid, lo, hi)], 0-based, half-open) only the positions inside them
    are called and emitted (overlapping spans merged), each span as if a
    block ended after it, and
    no report is made: records near a span's ends differ from a whole
    run's."""
    cfg = args_to_config(build_parser().parse_args(argv))
    if spans is not None:
        cfg.report_file = None
        merged = []
        for t, lo, hi in sorted(spans):
            if merged and merged[-1][0] == t and lo <= merged[-1][2]:
                merged[-1][2] = max(merged[-1][2], hi)
            else:
                merged.append([t, lo, hi])
        spans = [tuple(m) for m in merged]
    fasta = FastaIndex(cfg.reference_file)
    stats = BsStats() if cfg.report_file else None
    table = reconcile_contigs(
        fasta, header, cfg.contig_bed, cfg.contig_sizes,
        make_stats=stats is not None,
    )
    dbsnp = None
    if cfg.dbsnp_file:
        from portbench.ref.io.dbsnp import DbSnpIndex

        dbsnp = DbSnpIndex(cfg.dbsnp_file)
    out = io.BytesIO()
    hdr_lines = build_header_lines(
        cfg, table, header.text,
        dbsnp.header_line if dbsnp is not None else None,
    )
    writer = BcfWriter(out, hdr_lines, compressed=False)
    emitter = SiteEmitter(cfg, table, writer.write_site, stats=stats,
                          dbsnp=dbsnp)
    contig_seq = None
    for block in read_blocks(iter(records), table, cfg, stats=stats):
        ctg = block.ctg
        if contig_seq is None or contig_seq.name != ctg.name:
            contig_seq = fasta.load_contig(ctg.name,
                                           calc_gc=stats is not None)
            ctg.gc_start_pos = contig_seq.start_pos
            if ctg.ctg_stats is not None:
                ctg.ctg_stats.gc = contig_seq.gc_bins
        first = block.align_list[0]
        x = first.forward_position or first.reverse_position
        x = x - 2 if x > 2 else 1
        y = block.y
        sz = y - x + 1
        ref_window = sequence_window(contig_seq, x, sz + 2)
        for al in block.align_list:
            orig_pos, max_pos = process_template(
                al, cfg.left_trim, cfg.right_trim, stats=stats,
                min_qual=cfg.min_qual,
            )
            if stats is not None:
                meth_profile(al, x, orig_pos, max_pos, ref_window, stats)
        counts2, qual_sum, mapq2_sum = build_pileup(
            block.align_list, x, y, cfg.min_qual
        )
        # 0-based [x - 1, y) of this block, cut into the spans
        runs = [(x - 1, y)]
        if spans is not None:
            runs = [(max(lo, x - 1), min(hi, y)) for t, lo, hi in spans
                    if t == ctg.bam_tid and lo < y and hi > x - 1]
        want = np.zeros(sz, dtype=bool)
        for lo, hi in runs:
            want[lo - x + 1:hi - x + 1] = True
        calls = _call_block(cfg, counts2, qual_sum, mapq2_sum,
                            ref_window[:sz], dtype, want)
        ctg.curr_reg = block.region
        for lo, hi in runs:
            for i in range(lo - x + 1, hi - x + 1):
                call = calls[i]
                emitter.push(ctg, call, ref_window, x + i, x,
                             skip=call is None)
            emitter.flush()
    emitter.flush()
    report = None
    if stats is not None:
        rep = io.StringIO()
        write_report(rep, cfg, stats, table, dbsnp=cfg.dbsnp_file)
        report = rep.getvalue()
    return out.getvalue(), report
