"""Directional paired-end whole-genome bisulfite sequencing: fragments
uniformly over the slab at `coverage` (`library.wgbs_reads`). Nothing
planted, no regions."""

from portbench.gen import library


def plant(rng, seqs, lib):
    return None


def reads(rng, sample, planted, lib, contig_bp):
    return library.wgbs_reads(rng, sample, lib, contig_bp)


def regions(planted):
    return None
