"""Contig/region reconciliation between reference, SAM header, optional
contig-bed (-C) and contig-sizes (-s) files.

Behavioral contract: process_sam_header.c:52-286. The inclusion logic
(reference ∩ SAM header, restricted/extended by -C/-s) preserves the
reference's uniform-header property so per-region output files can be
concatenated with `bcftools concat -n`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from portbench.ref.io.bam import BamHeader
from portbench.ref.io.fasta import FastaIndex


@dataclass
class Region:
    ctg: "Contig"
    start: int  # 1-based inclusive
    stop: int   # inclusive


@dataclass
class Contig:
    name: str
    bam_tid: int = -1
    fai_id: int = -1
    vcf_rid: int = -1
    seq_len: int = 0
    curr_reg: Optional[Region] = None
    ctg_stats: Optional[object] = None
    regions: List["Region"] = field(default_factory=list)


@dataclass
class ContigTable:
    contigs: List[Contig] = field(default_factory=list)
    tid2id: Dict[int, int] = field(default_factory=dict)
    regions: List[Region] = field(default_factory=list)
    by_name: Dict[str, Contig] = field(default_factory=dict)


def parse_contig_sizes(path: str) -> List[str]:
    names = []
    with open(path) as f:
        for line in f:
            if "\t" not in line:
                continue
            name = line.split("\t", 1)[0]
            if name:
                names.append(name)
    return names


def parse_contig_bed(path: str) -> List[tuple]:
    """Returns list of (name, start_1based, stop) tuples; malformed and
    overlapping-duplicate regions are dropped with the reference's rules
    (process_sam_header.c:108-169)."""
    out = []
    with open(path) as f:
        for line in f:
            fld = line.rstrip("\n").split("\t")
            if len(fld) < 3:
                continue
            name = fld[0]
            try:
                x = int(fld[1])
                y = int(fld[2])
            except ValueError:
                continue
            if x >= y or not name:
                continue
            # reject overlap with a previous region of the same contig
            clash = any(
                n == name and y >= s and x + 1 <= e for n, s, e in out
            )
            if clash:
                continue
            out.append((name, x + 1, y))
    return out


def reconcile_contigs(
    fasta: FastaIndex,
    header: BamHeader,
    contig_bed: Optional[str] = None,
    contig_sizes: Optional[str] = None,
    make_stats: bool = False,
) -> ContigTable:
    contigs: Dict[str, Contig] = {}
    order: List[str] = []
    coords: Dict[str, List[tuple]] = {}

    def add(name: str, with_coords: bool):
        if name not in contigs:
            contigs[name] = Contig(name=name)
            order.append(name)
            if with_coords:
                coords[name] = []

    if contig_sizes:
        for name in parse_contig_sizes(contig_sizes):
            add(name, True)
    if contig_bed:
        for name, x, y in parse_contig_bed(contig_bed):
            if name not in contigs:
                if contig_sizes:
                    continue  # warn: not in sizes file -> ignored
                add(name, True)
            coords.setdefault(name, []).append((x, y))
    for i, name in enumerate(fasta.names()):
        if name not in contigs:
            if contig_bed is None:
                add(name, False)
            else:
                continue
        c = contigs[name]
        c.fai_id = i
        c.seq_len = fasta.seq_len(name)
    for tid, name in enumerate(header.ref_names):
        if name not in contigs:
            if contig_bed is None:
                add(name, False)
            else:
                continue
        c = contigs[name]
        c.bam_tid = tid
        if c.fai_id < 0:
            c.seq_len = header.ref_lens[tid]

    table = ContigTable()
    for name in order:
        c = contigs[name]
        keep = c.fai_id >= 0 and c.bam_tid >= 0
        if contig_bed is not None and name not in coords:
            keep = False
        if not keep:
            continue
        if make_stats:
            from portbench.ref.stats.collect import CtgStats

            c.ctg_stats = CtgStats()
        table.tid2id[c.bam_tid] = len(table.contigs)
        table.contigs.append(c)
        table.by_name[name] = c
        for x, y in coords.get(name, []):
            reg = Region(ctg=c, start=x, stop=y)
            table.regions.append(reg)
            c.regions.append(reg)
    return table
