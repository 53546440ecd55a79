"""A cell's inputs from its configuration and `--seed`: the reference
FASTA (+ .fai), the coordinate-sorted BAM and the dbSNP index, written
into one directory, and the arrays they were written from, which the
reference check and the kernel work counters read."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from portbench.gen import bamio, library

CHUNK_READS = 50_000


@dataclass
class Dataset:
    dir: str
    ref_path: str
    bam_path: str
    dbsnp_path: str
    names: list
    lengths: list
    header_text: str
    reads: dict  # sorted read specs (library.wgbs_reads / rrbs_reads)
    seq: np.ndarray  # [n, Lmax] uint8 ASCII, 0 past a read's end
    qual: np.ndarray  # [n, Lmax] uint8 raw phred
    sample: library.Sample
    dbsnp: list  # (contig name, 1-based positions, rs ids)

    @property
    def n_records(self) -> int:
        return len(self.reads["pos"])


def make_dataset(cfg: dict, seed: int, out_dir: str, threads: int = 8,
                 scale: float = 1.0) -> Dataset:
    """Write the inputs of configuration `cfg` for `seed` into `out_dir`.
    `scale` shrinks the slab (the warm-up job and the CPU tests use a
    small one of the same shapes)."""
    rng = np.random.default_rng(seed)
    g = dict(cfg["genome"])
    g["contig_bp"] = max(int(g["contig_bp"] * scale), 20_000)
    lib = cfg["library"]
    seqs = library.make_genome(rng, g)
    frags = None
    if lib["protocol"] == "rrbs":
        frags = library.plant_rrbs(rng, seqs, lib)
    sample = library.Sample(rng, seqs, cfg["sample"])
    names = [f"chr{i + 1}" for i in range(len(seqs))]
    lengths = [len(s) for s in seqs]
    if lib["protocol"] == "wgbs":
        specs = library.wgbs_reads(rng, sample, lib, lengths)
    elif lib["protocol"] == "rrbs":
        specs = library.rrbs_reads(rng, frags, lib)
    else:
        raise ValueError(f"unknown library protocol {lib['protocol']!r}")
    specs = library.sort_reads(specs)
    os.makedirs(out_dir, exist_ok=True)
    ref_path = os.path.join(out_dir, "ref.fa")
    bam_path = os.path.join(out_dir, "in.bam")
    dbsnp_path = os.path.join(out_dir, "dbsnp.idx")
    bamio.write_fasta(ref_path, names, seqs)
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(names, lengths))
    n = len(specs["pos"])
    lmax = int(specs["length"].max())
    seq = np.zeros((n, lmax), dtype=np.uint8)
    qual = np.zeros((n, lmax), dtype=np.uint8)

    def chunk(lo):
        # each chunk its own generator, so threads change no draw
        crng = np.random.default_rng([seed, 1, lo])
        hi = min(lo + CHUNK_READS, n)
        s, q = library.read_bases(crng, sample, specs, lib, lo, hi)
        seq[lo:hi, :s.shape[1]] = s
        qual[lo:hi, :q.shape[1]] = q
        part = {k: v[lo:hi] for k, v in specs.items()}
        part["seq"], part["qual"] = s, q
        return bamio.encode_records(part, library.cigar)

    with ThreadPoolExecutor(max_workers=threads) as gen, \
            ThreadPoolExecutor(max_workers=threads) as zpool:
        w = bamio.BgzfWriter(bam_path, zpool, level=cfg["bam_level"])
        w.write(bamio.bam_header_bytes(names, lengths, text))
        for data in gen.map(chunk, range(0, n, CHUNK_READS)):
            w.write(data)
        w.close()
    db = cfg["dbsnp"]
    contigs = []
    for t, (name, ln) in enumerate(zip(names, lengths)):
        n_rand = int(round(db["per_bp"] * ln))
        pos = rng.choice(np.arange(1, ln + 1), size=n_rand, replace=False)
        lo_, hi_ = sample.offsets[t], sample.offsets[t + 1]
        snv = sample.snv_pos[(sample.snv_pos >= lo_) & (sample.snv_pos < hi_)]
        known = snv[rng.random(len(snv)) < db["known_snv_share"]] - lo_ + 1
        pos = np.unique(np.concatenate([pos, known]))
        ids = rng.integers(1, 10 ** 9, len(pos))
        contigs.append((name, pos, ids))
    bamio.write_dbsnp_index(dbsnp_path, contigs,
                            "track name=portbench description=synthetic")
    return Dataset(out_dir, ref_path, bam_path, dbsnp_path, names, lengths,
                   text, specs, seq, qual, sample, contigs)
