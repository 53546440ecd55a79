"""A cell's inputs from its configuration and `--seed`: the reference
FASTA (+ .fai), the coordinate-sorted BAM and the dbSNP index, written
into one directory, and the arrays they were written from, which the
reference check and the kernel work counters read.

The library's protocol (`library.protocol`) is the module
`portbench/gen/protocols/<protocol>.py`, found by name. It gives three
functions: `plant(rng, seqs, lib)`, what it plants in the slab before
the sample is drawn (or None); `reads(rng, sample, planted, lib,
contig_bp)`, the read specs; `regions(planted)`, None or the regions the
job calls ([(tid, lo, hi)], 0-based, half-open). Regions are written as
`targets.bed`, which the job gets as `-C`, with the BAM's index
`in.bam.bai` beside the BAM, as a user's pipeline holds one after
`samtools index`."""

from __future__ import annotations

import importlib.util
import os
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from portbench.gen import bamio, library

CHUNK_READS = 50_000
PROTOCOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "protocols")


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
    bed_path: str = None  # the regions' BED, the job's -C
    regions: list = None  # [(tid, lo, hi)], 0-based, half-open, sorted

    @property
    def n_records(self) -> int:
        return len(self.reads["pos"])


def load_protocol(name: str):
    """The protocol module `protocols/<name>.py`."""
    path = os.path.join(PROTOCOLS, f"{name}.py")
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not os.path.isfile(path):
        raise ValueError(f"unknown library protocol {name!r}")
    spec = importlib.util.spec_from_file_location(
        "portbench_protocol_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_dataset(cfg: dict, seed: int, out_dir: str, threads: int = 8,
                 scale: float = 1.0) -> Dataset:
    """Write the inputs of configuration `cfg` for `seed` into `out_dir`.
    `scale` shrinks the slab (the warm-up job and the CPU tests use a
    small one of the same shapes)."""
    rng = np.random.default_rng(seed)
    g = dict(cfg["genome"])
    g["contig_bp"] = max(int(g["contig_bp"] * scale), 20_000)
    lib = cfg["library"]
    proto = load_protocol(lib["protocol"])
    seqs = library.make_genome(rng, g)
    planted = proto.plant(rng, seqs, lib)
    sample = library.Sample(rng, seqs, cfg["sample"])
    names = [f"chr{i + 1}" for i in range(len(seqs))]
    lengths = [len(s) for s in seqs]
    specs = library.sort_reads(proto.reads(rng, sample, planted, lib,
                                           lengths))
    regions = proto.regions(planted)
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

    head = bamio.bam_header_bytes(names, lengths, text)
    with ThreadPoolExecutor(max_workers=threads) as gen, \
            ThreadPoolExecutor(max_workers=threads) as zpool:
        w = bamio.BgzfWriter(bam_path, zpool, level=cfg["bam_level"])
        w.write(head)
        for data in gen.map(chunk, range(0, n, CHUNK_READS)):
            w.write(data)
        w.close()
    bed_path = None
    if regions is not None:
        regions = sorted(regions)
        for (t0, _lo0, hi0), (t1, lo1, _hi1) in zip(regions, regions[1:]):
            if t0 == t1 and lo1 < hi0:
                raise ValueError("the protocol's regions overlap")
        bed_path = os.path.join(out_dir, "targets.bed")
        bamio.write_bed(bed_path, names, regions)
        u_end = len(head) + np.cumsum(bamio.record_sizes(specs,
                                                         library.cigar))
        u_beg = np.concatenate([[len(head)], u_end[:-1]])
        bamio.write_bai(bam_path + ".bai", len(names), specs["tid"],
                        specs["pos"], specs["end"], specs["flag"],
                        bamio.virtual_offsets(u_beg, w.block_sizes),
                        bamio.virtual_offsets(u_end, w.block_sizes))
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
                   text, specs, seq, qual, sample, contigs, bed_path, regions)
