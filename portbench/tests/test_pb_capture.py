"""The `capture` protocol (`portbench/gen/protocols/capture.py`), on the
test-only configuration `portbench/tests/data/capture_test.json`: the
same seed gives the same bytes, the targets and fragments carry the
configuration's rates, the BED reads back through the port's parser, the
BAM index through the port's reader, and the pileup work counts equal
what the reference's block builder piles up."""

import json
import os

import numpy as np
import pytest

from portbench.gen import library
from portbench.gen.dataset import load_protocol, make_dataset
from portbench.harness import _job_argv
from portbench.work.inputs import pileup_input

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "capture_test.json")
FILES = ("ref.fa", "ref.fa.fai", "in.bam", "in.bam.bai", "dbsnp.idx",
         "targets.bed")


def _cfg():
    with open(CONFIG) as f:
        return json.load(f)


def _bytes(ds, f):
    with open(os.path.join(ds.dir, f), "rb") as fp:
        return fp.read()


def test_same_seed_same_bytes(tmp_path):
    cfg = _cfg()
    a = make_dataset(cfg, 2 ** 31 + 77, str(tmp_path / "a"), scale=0.05)
    b = make_dataset(cfg, 2 ** 31 + 77, str(tmp_path / "b"), scale=0.05)
    c = make_dataset(cfg, 2 ** 31 + 78, str(tmp_path / "c"), scale=0.05)
    assert sorted(os.listdir(a.dir)) == sorted(FILES)
    for f in FILES:
        assert _bytes(a, f) == _bytes(b, f), f
    assert _bytes(a, "targets.bed") != _bytes(c, "targets.bed")
    assert a.bed_path == os.path.join(a.dir, "targets.bed")
    assert a.regions == b.regions


def test_unknown_protocol_raises(tmp_path):
    cfg = _cfg()
    for name in ("wgs_nanopore", "../dataset", ""):
        cfg["library"]["protocol"] = name
        with pytest.raises(ValueError, match="unknown library protocol"):
            make_dataset(cfg, 1, str(tmp_path), scale=0.05)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_targets_at_full_size(seed):
    # counts a Mb exact; lengths clipped to [min, max] around the median
    # (the fixed multiset of 50 a contig reads 880 bp against 800);
    # gaps and edges hard limits
    lib = _cfg()["library"]
    g = _cfg()["genome"]
    rng = np.random.default_rng(seed)
    seqs = library.make_genome(rng, g)
    t = load_protocol("capture").plant(rng, seqs, lib)
    per = round(lib["targets_per_mb"] * g["contig_bp"] / 1e6)
    assert np.bincount(t[:, 0]).tolist() == [per] * g["contigs"]
    ln = t[:, 2] - t[:, 1]
    assert ln.min() >= lib["target_min"] and ln.max() <= lib["target_max"]
    assert abs(np.median(ln) / lib["target_median"] - 1) < 0.15
    same = t[1:, 0] == t[:-1, 0]
    assert (t[1:, 1][same] - t[:-1, 2][same]).min() >= lib["target_gap_min"]
    edge = lib["pad_bp"] + lib["insert_max"]
    assert t[:, 1].min() >= edge
    assert (t[:, 2] <= g["contig_bp"] - edge).all()
    # CpG-island-like interiors: CpGs at the rate of uniform bases
    cg = np.mean([((seqs[a][lo:hi - 1] == ord("C"))
                   & (seqs[a][lo + 1:hi] == ord("G"))).mean()
                  for a, lo, hi in t.tolist()])
    assert abs(cg - 1 / 16) < 0.01


def test_fragments_on_target_and_depth(tmp_path):
    # 20 targets at scale 0.2, ~10,400 fragments: the on-target share
    # within 0.02 (binomial sd ~0.0045) of the configured share plus the
    # off-target fragments that meet a padded target by chance; the
    # depth over the targets within 5% of target_coverage (the mean of
    # ~16,000 positions correlated over an insert: sd ~1.7%)
    cfg = _cfg()
    lib = cfg["library"]
    ds = make_dataset(cfg, 2 ** 31 + 21, str(tmp_path), scale=0.2)
    r = ds.reads
    pad = lib["pad_bp"]
    order = np.argsort(r["name"], kind="stable")
    first = np.unique(r["name"][order], return_index=True)[1]
    lo = np.minimum.reduceat(r["pos"][order], first)
    hi = np.maximum.reduceat(r["end"][order], first)
    tid = r["tid"][order][first]
    on = np.zeros(len(lo), dtype=bool)
    for t, a, b in ds.regions:
        on |= (tid == t) & (lo < b + pad) & (hi > a - pad)
    p_off = sum(b - a + 2 * pad + lib["insert_mean"] - 1
                for _t, a, b in ds.regions) / sum(ds.lengths)
    share = lib["on_target_share"]
    assert abs(on.mean() - (share + (1 - share) * p_off)) < 0.02
    dup = (r["flag"] & library.FDUP) != 0
    depth = n = 0
    for t, ln in enumerate(ds.lengths):
        d = np.zeros(ln + 1, dtype=np.int64)
        sel = (r["tid"] == t) & ~dup
        np.add.at(d, r["pos"][sel], 1)
        np.add.at(d, r["end"][sel], -1)
        cov = np.cumsum(d)[:ln]
        for u, a, b in ds.regions:
            if u == t:
                depth += int(cov[a:b].sum())
                n += b - a
    assert abs(depth / n / lib["target_coverage"] - 1) < 0.05
    # every other rate as WGBS draws it
    assert abs(dup.mean() - lib["duplicate_share"] / (
        1 + lib["duplicate_share"])) < 0.01
    assert (np.unique(r["length"]) == [lib["read_length"]]).all()


def test_bed_reads_back_through_the_ports_parser(tmp_path):
    from bs_call_tpu_torch.pipeline.contigs import parse_contig_bed

    ds = make_dataset(_cfg(), 2 ** 31 + 5, str(tmp_path), scale=0.3)
    assert ds.regions == sorted(ds.regions)
    for (t0, _a, b0), (t1, a1, _b) in zip(ds.regions, ds.regions[1:]):
        assert t0 != t1 or a1 >= b0
    with open(ds.bed_path) as f:
        lines = f.read().splitlines()
    assert len(lines) == len(ds.regions)
    assert parse_contig_bed(ds.bed_path) == [
        (ds.names[t], lo + 1, hi) for t, lo, hi in ds.regions]


def test_bai_chunks_cover_exactly_the_overlapping_records(tmp_path):
    from bs_call_tpu_torch.io.bai import BaiIndex, IndexedBamReader

    ds = make_dataset(_cfg(), 2 ** 31 + 6, str(tmp_path), scale=0.3)
    r = ds.reads
    rng = np.random.default_rng(6)
    n = 50
    t = rng.integers(0, len(ds.lengths), n)
    w = rng.integers(1, 20_000, n)
    lo = (rng.random(n) * (np.asarray(ds.lengths)[t] - w)).astype(int)
    windows = list(ds.regions) + list(zip(t.tolist(), lo.tolist(),
                                          (lo + w).tolist()))
    idx = BaiIndex(ds.bam_path + ".bai")
    rd = IndexedBamReader(ds.bam_path)
    try:
        for t, a, b in windows:
            assert idx.chunks_for(t, a, b)
            want = np.nonzero((r["tid"] == t) & (r["pos"] < b)
                              & (r["end"] > a))[0]
            got = [(rec.name, rec.pos, rec.flag) for rec in rd.query(t, a, b)]
            assert got == [("r%09d" % r["name"][i], r["pos"][i], r["flag"][i])
                           for i in want], (t, a, b)
    finally:
        rd.close()


@pytest.mark.parametrize("scale,seed", [(0.05, 2 ** 31 + 9), (0.3, 11)])
def test_pileup_counts_equal_the_reference_builder(tmp_path, scale, seed):
    # the covered positions exactly; records and bases up to the pairs
    # the builder drops as unmarked duplicates (both ends and the strand
    # shared), which the count leaves in (its docstring says so)
    from portbench.check import to_records
    from portbench.ref.cli_args import args_to_config, build_parser
    from portbench.ref.io.bam import BamHeader
    from portbench.ref.io.fasta import FastaIndex
    from portbench.ref.pipeline.blocks import read_blocks
    from portbench.ref.pipeline.contigs import reconcile_contigs
    from portbench.work.inputs import piled_in_regions

    cfg = _cfg()
    ds = make_dataset(cfg, seed, str(tmp_path), scale=scale)
    c = args_to_config(build_parser().parse_args(
        _job_argv(ds, cfg, str(tmp_path), "x", "cpu")))
    header = BamHeader(text=ds.header_text, ref_names=list(ds.names),
                       ref_lens=list(ds.lengths))
    table = reconcile_contigs(FastaIndex(c.reference_file), header,
                              c.contig_bed, c.contig_sizes)
    cov = [np.zeros(n, dtype=bool) for n in ds.lengths]
    records = bases = 0
    recs = to_records(ds, np.arange(ds.n_records))
    for blk in read_blocks(iter(recs), table, c):
        for al in blk.align_list:
            frag = set()
            for ix, st in ((0, al.forward_position), (1, al.reverse_position)):
                if al.read[ix] is not None and len(al.read[ix]):
                    span = range(st - 1, st - 1 + al.reference_span[ix])
                    cov[blk.ctg.bam_tid][span.start:span.stop] = True
                    frag.update(span)
                    records += 1
            bases += len(frag)
    got = pileup_input(ds, cfg)
    assert got["covered"] == sum(int(m.sum()) for m in cov)
    r = ds.reads
    used = ((r["mapq"] >= 20) & ((r["flag"] & library.FDUP) == 0)
            & ((r["flag"] & library.FMUNMAP) == 0))
    kept = piled_in_regions(r, used, ds.regions)
    fw = kept & ((r["flag"] & library.FREVERSE) == 0) & (r["pos"] < r["mpos"])
    _u, n_same = np.unique(np.stack([r[k][fw] for k in (
        "tid", "pos", "mpos", "xb")], axis=1), axis=0, return_counts=True)
    extra = int((n_same - 1).sum())
    L = cfg["library"]["read_length"]
    assert 0 <= got["records_used"] - records <= 2 * extra
    assert 0 <= got["bases"] - bases <= extra * 2 * (L + library.DEL)
