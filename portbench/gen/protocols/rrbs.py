"""Directional single-end reduced-representation bisulfite sequencing:
MspI-bounded fragments planted in the slab (`library.plant_rrbs`), reads
from their ends (`library.rrbs_reads`). No regions: RRBS is called over
the whole slab."""

from portbench.gen import library


def plant(rng, seqs, lib):
    return library.plant_rrbs(rng, seqs, lib)


def reads(rng, sample, planted, lib, contig_bp):
    return library.rrbs_reads(rng, planted, lib)


def regions(planted):
    return None
