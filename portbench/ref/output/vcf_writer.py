"""VCF text output (header + records).

Header layout follows print_vcf_header (print_vcf.c:622-766): source line,
@RG-derived bs_call_sample_info lines (deduped by barcode), ##contig lines
restricted to the reconciled contig table, the 6 FILTERs, CX INFO and the
12 FORMAT declarations. --benchmark-mode omits date/version lines so output
is byte-comparable across runs (print_vcf.c:647-651).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from portbench.ref import constants as C
from portbench.ref.output.site import VcfSite

_FIXED_HEADER = [
    '##INFO=<ID=CX,Number=1,Type=String,Description="5 base sequence context (from position -2 to +2 on the positive strand) determined from the reference">',
    '##FILTER=<ID=fail,Description="No sample passed filters">',
    '##FILTER=<ID=q20,Description="Genotype Quality below 20">',
    '##FILTER=<ID=qd2,Description="Quality By Depth below 2">',
    '##FILTER=<ID=fs60,Description="Fisher Strand above 60">',
    '##FILTER=<ID=mq40,Description="RMS Mapping Quality below 40">',
    '##FILTER=<ID=mac1,Description="Minor allele count <= 1">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=FT,Number=1,Type=String,Description="Sample Genotype Filter">',
    '##FORMAT=<ID=GL,Number=G,Type=Float,Description="Genotype Likelihood">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Phred scaled conditional genotype quality">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth (non converted reads only)">',
    '##FORMAT=<ID=MQ,Number=1,Type=Integer,Description="RMS Mapping Quality">',
    '##FORMAT=<ID=QD,Number=1,Type=Integer,Description="Quality By Depth (Variant quality / read depth (non-converted reads only))">',
    '##FORMAT=<ID=MC8,Number=8,Type=Integer,Description="Base counts: non-informative for methylation (ACGT) followed by informative for methylation (ACGT)">',
    '##FORMAT=<ID=AMQ,Number=.,Type=Integer,Description="Average base quailty for where MC8 base count non-zero">',
    '##FORMAT=<ID=CS,Number=1,Type=String,Description="Strand of Cytosine relative to reference sequence (+/-/+-/NA)">',
    '##FORMAT=<ID=CG,Number=1,Type=String,Description="CpG Status (from genotype calls: Y/N/H/?)">',
    '##FORMAT=<ID=CX,Number=1,Type=String,Description="5 base sequence context (from position -2 to +2 on the positive strand) determined from genotype call">',
    '##FORMAT=<ID=FS,Number=1,Type=Integer,Description="Phred scaled log p-value from Fishers exact test of strand bias">',
]


def _scan_hdr_fields(line: str, keys):
    out = {k: None for k in keys}
    for fld in line.rstrip("\n").split("\t")[1:]:
        if len(fld) >= 3 and fld[2] == ":" and fld[:2] in out:
            out[fld[:2]] = fld[3:]
    return out


def build_header_lines(cfg, table, sam_header_text: str, dbsnp_header=None):
    lines = ["##fileformat=VCFv4.2"]
    if not cfg.benchmark_mode:
        tt = time.localtime()
        lines.append(
            "##fileDate(dd/mm/yyyy)=%02d/%02d/%04d"
            % (tt.tm_mday, tt.tm_mon, tt.tm_year)
        )
        lines.append(
            "##source=bs_call_v%s,under_conversion=%g,over_conversion=%g,"
            "mapq_thresh=%d,bq_thresh=%d"
            % (
                C.VERSION,
                cfg.under_conv,
                cfg.over_conv,
                cfg.mapq_thresh,
                cfg.min_qual,
            )
        )
        if dbsnp_header:
            lines.append(f"##dbsnp=<{dbsnp_header}>")
        seen_bc = set()
        for line in sam_header_text.splitlines():
            if line.startswith("@RG\t"):
                f = _scan_hdr_fields(line, ("BC", "SM", "DS"))
                bc = f["BC"]
                if bc is not None and bc not in seen_bc:
                    seen_bc.add(bc)
                    s = f'##bs_call_sample_info=<ID="{bc}"'
                    if f["SM"] is not None:
                        s += f',SM="{f["SM"]}"'
                    if f["DS"] is not None:
                        s += f',DS="{f["DS"]}"'
                    lines.append(s + ">")
    names_in_table = {c.name for c in table.contigs}
    rid = 0
    for line in sam_header_text.splitlines():
        if line.startswith("@SQ\t"):
            f = _scan_hdr_fields(line, ("SN", "LN", "AS", "M5", "SP"))
            if f["SN"] is None or f["LN"] is None:
                continue
            if table.contigs and f["SN"] not in names_in_table:
                continue
            s = f'##contig=<ID={f["SN"]},length={f["LN"]}'
            if f["AS"] is not None:
                s += f',assembly={f["AS"]}'
            if f["M5"] is not None:
                s += f',md5={f["M5"]}'
            if f["SP"] is not None:
                s += f',sp={f["SP"]}'
            lines.append(s + ">")
            if f["SN"] in names_in_table:
                table.by_name[f["SN"]].vcf_rid = rid
            rid += 1
    lines.extend(_FIXED_HEADER)
    sample = cfg.sample_name or "SAMPLE"
    lines.append(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + sample
    )
    return lines


def fmt_float(v: float) -> str:
    """Format a GL value the way htslib prints BCF float32 (%g on the
    float-rounded value)."""
    f = float(np.float32(v))
    return "%g" % f


class VcfTextWriter:
    def __init__(self, fileobj, table):
        self._f = fileobj
        self._table = table
        self._names = None  # built lazily; vcf_rid assigned at header time

    def write_header(self, lines: List[str]):
        for line in lines:
            self._f.write((line + "\n").encode())

    def write_site(self, s: VcfSite):
        if self._names is None:
            self._names = {
                c.vcf_rid: c.name for c in self._table.contigs
            }
        gt = "/".join(str((v >> 1) - 1) for v in s.gt_ints)
        fmt = "GT:FT:DP:MQ:GQ:QD:GL:MC8"
        vals = [
            gt,
            s.ft,
            str(s.dp),
            str(s.mq),
            str(s.gq),
            str(s.qd),
            ",".join(fmt_float(v) for v in s.gl),
            ",".join(str(v) for v in s.mc8),
        ]
        if s.amq:
            fmt += ":AMQ"
            vals.append(",".join(str(v) for v in s.amq))
        fmt += ":CS:CG:CX"
        vals += [s.cs, s.cg, s.cx_fmt]
        if s.fs is not None:
            fmt += ":FS"
            vals.append(str(s.fs))
        alt = ",".join(s.alts) if s.alts else "."
        cols = [
            self._names.get(s.rid, str(s.rid)),
            str(s.pos),
            s.rs_id,
            s.ref,
            alt,
            str(s.qual),
            ";".join(s.filters),
            "CX=" + s.cx_info,
            fmt,
            ":".join(vals),
        ]
        self._f.write(("\t".join(cols) + "\n").encode())

    def close(self):
        from portbench.ref.io.bgzf import BgzfWriter

        if isinstance(self._f, BgzfWriter):
            self._f.close()  # writes the BGZF EOF block
        else:
            self._f.flush()
