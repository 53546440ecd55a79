"""The generator: the same seed gives the same inputs, and the inputs
carry the rates their configuration states."""

import json
import os

import numpy as np
import pytest

from portbench.gen import library
from portbench.gen.dataset import make_dataset

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _cfg(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["wgbs_30x_pe150", "rrbs_mspi_se50"])
def test_same_seed_same_inputs(tmp_path, name):
    cfg = _cfg(name)
    a = make_dataset(cfg, 2 ** 31 + 77, str(tmp_path / "a"), scale=0.02)
    b = make_dataset(cfg, 2 ** 31 + 77, str(tmp_path / "b"), scale=0.02)
    c = make_dataset(cfg, 2 ** 31 + 78, str(tmp_path / "c"), scale=0.02)
    for f in ("ref.fa", "in.bam", "dbsnp.idx"):
        with open(os.path.join(a.dir, f), "rb") as x, \
                open(os.path.join(b.dir, f), "rb") as y:
            assert x.read() == y.read(), f
    assert not np.array_equal(a.reads["pos"], c.reads["pos"])
    if name == "wgbs_30x_pe150":
        # a fixed amount of work: the record count moves only by the
        # singletons' and no more
        assert a.n_records == c.n_records


def test_wgbs_rates(tmp_path):
    cfg = _cfg("wgbs_30x_pe150")
    ds = make_dataset(cfg, 12345, str(tmp_path), scale=0.05)
    r, lib, s = ds.reads, cfg["library"], cfg["sample"]
    bp = sum(ds.lengths)
    dup = (r["flag"] & library.FDUP) != 0
    assert abs(dup.mean() - lib["duplicate_share"] / (
        1 + lib["duplicate_share"])) < 0.01
    cov = (r["end"] - r["pos"])[~dup].sum() / bp
    assert abs(cov - lib["coverage"]) < 0.5
    assert (np.unique(r["length"]) == [lib["read_length"]]).all()
    ins = np.abs(r["tlen"][r["tlen"] != 0])
    assert abs(ins.mean() - lib["insert_mean"]) < 5
    assert abs(len(ds.sample.snv_pos) / bp - s["snv_per_bp"]) < 1e-4
    # non-CpG conversion on OT reads: C positions of the sample that are
    # not in a CpG read back as T about noncpg_conversion of the time
    top = np.nonzero((r["xb"] == ord("C")) & (r["kind"] == 0)
                     & (r["hap"] == 0))[0][:3000]
    g = (ds.sample.offsets[r["tid"][top]][:, None] + r["pos"][top][:, None]
         + np.arange(lib["read_length"]))
    hap = ds.sample.haps[0][g]
    cpg = ds.sample.cpg[0][0][g]
    q = ds.qual[top] >= 37
    c_sites = (hap == ord("C")) & ~cpg & q
    conv = (ds.seq[top] == ord("T"))[c_sites].mean()
    assert abs(conv - s["noncpg_conversion"]) < 0.003
    meth = (ds.seq[top] == ord("C"))[(hap == ord("C")) & cpg & q].mean()
    assert 0.6 < meth < 0.85


def test_rrbs_reads_start_at_mspi_sites(tmp_path):
    cfg = _cfg("rrbs_mspi_se50")
    ds = make_dataset(cfg, 99, str(tmp_path), scale=0.1)
    r = ds.reads
    ref = ds.sample.ref
    g = ds.sample.offsets[r["tid"]] + r["pos"]
    top = r["xb"] == ord("C")
    # OT reads start at CGG (after C^CGG), OB reads end before CGG
    assert (ref[g[top] - 1] == ord("C")).all()
    assert (ref[g[top]] == ord("C")).all() and (ref[g[top] + 1] == ord("G")).all()
    e = ds.sample.offsets[r["tid"]] + r["end"]
    assert (ref[e[~top] - 1] == ord("C")).all()
    assert (ref[e[~top]] == ord("C")).all()
    assert np.median(np.bincount(np.unique(g, return_inverse=True)[1])) > 5
