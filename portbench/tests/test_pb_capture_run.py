"""A whole run of a targeted-capture cell without the card: the test-only
configuration `portbench/tests/data/capture_test.json` under a cell that
only this test names, on the plain PyTorch kernels on the CPU. The job
gets the targets as `-C`, reads them through the generator's `.bai`
(writing none of its own), the check holds it, and each planted fault
turns `correct` false."""

import dataclasses
import io
import json
import os

import pytest

from portbench import harness
from portbench.check import pick_windows
from portbench.gen import dataset

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "capture_test.json")
CELL = "capture_test"
SCALE = 0.05
SEED = 2 ** 31 + 5


def _load_cell(name):
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(CONFIG) as f:
        cfg = json.load(f)
    with open(os.path.join(harness.BENCH, "traffic", "closed_jobs.json")) as f:
        traffic = json.load(f)
    cell = {"name": name, "config": cfg["name"], "traffic": "closed_jobs",
            "chips": 1, "why": "test-only"}
    return bench, cell, cfg, traffic


@pytest.fixture
def run(monkeypatch):
    """Run the capture cell; returns (result, what the run saw)."""
    from bs_call_tpu_torch import cli
    from bs_call_tpu_torch.io import bai

    monkeypatch.setattr(harness, "load_cell", _load_cell)
    seen = {"argv": [], "write_bai": 0}
    make, main, write_bai = dataset.make_dataset, cli.main, bai.write_bai

    def made(*a, **k):
        ds = make(*a, **k)
        seen["ds"] = ds
        with open(ds.bam_path + ".bai", "rb") as f:
            seen["bai"] = f.read()
        return ds

    def job(argv, **k):
        seen["argv"].append(list(argv))
        return main(argv, **k)

    def wrote_bai(*a, **k):
        seen["write_bai"] += 1
        return write_bai(*a, **k)

    monkeypatch.setattr(dataset, "make_dataset", made)
    monkeypatch.setattr(cli, "main", job)
    monkeypatch.setattr(bai, "write_bai", wrote_bai)

    def go():
        r = harness.run_cell(CELL, SEED, 0.5, False, device="cpu",
                             chips_checked=False, scale=SCALE,
                             log=io.StringIO())
        return r, seen

    return go


def test_sound_run_is_correct(run):
    r, seen = run()
    assert r["correct"], r["compared"]
    ds = seen["ds"]
    assert all(a[a.index("-C") + 1] == ds.bed_path for a in seen["argv"])
    with open(CONFIG) as f:
        min_sites = json.load(f)["check"]["min_sites"]
    assert r["compared"]["sites_compared"]["value"] >= int(min_sites * SCALE)
    assert r["compared"]["sites_differ"]["value"] == 0
    # the job found the generator's index and wrote none of its own
    assert seen["write_bai"] == 0
    with open(ds.bam_path + ".bai", "rb") as f:
        assert f.read() == seen["bai"]
    assert sorted(os.listdir(ds.dir)) == sorted(
        ["ref.fa", "ref.fa.fai", "in.bam", "in.bam.bai", "dbsnp.idx",
         "targets.bed"])


def _emit_past_targets(monkeypatch, ds):
    # the emitter's gate widened by 30 bp either side of each target; the
    # regions the job reads stay the targets
    from bs_call_tpu_torch.pipeline import runner

    orig = runner.reconcile_contigs

    def widened(*a, **k):
        table = orig(*a, **k)
        for c in table.contigs:
            c.regions = [dataclasses.replace(g, start=g.start - 30,
                                             stop=g.stop + 30)
                         for g in c.regions]
        return table

    monkeypatch.setattr(runner, "reconcile_contigs", widened)


def _drop_a_target(monkeypatch, ds):
    # one checked target's records left out of the job's input: its BAM
    # index query returns no chunk
    from bs_call_tpu_torch.io import bai

    with open(CONFIG) as f:
        chk = json.load(f)["check"]
    w = pick_windows(ds, chk, SEED)[0]
    t, lo, hi = next(g for g in ds.regions
                     if g[0] == w[0] and w[1] <= g[1] and g[2] <= w[2])
    orig = bai.BaiIndex.chunks_for

    def chunks_for(self, tid, beg, end):
        if (tid, beg, end) == (t, lo, hi):
            return []
        return orig(self, tid, beg, end)

    monkeypatch.setattr(bai.BaiIndex, "chunks_for", chunks_for)


@pytest.mark.parametrize("seed", [11, 12])
def test_windowed_check_meets_each_contig_where_the_job_does(tmp_path, seed):
    # 30 targets, 12 windows: on each contig the first target the check
    # reads is not the job's first, where the builder takes the first
    # record as forward-facing; the windowed reference still sides with
    # the job, as the whole reference does
    from bs_call_tpu_torch import cli
    from bs_call_tpu_torch.utils.trace import Tracer

    from portbench.check import compare

    _bench, _cell, cfg, _traffic = _load_cell(CELL)
    ds = dataset.make_dataset(cfg, seed, str(tmp_path / "in"), scale=0.3)
    checked = {g for g in ds.regions for w in pick_windows(
        ds, cfg["check"], seed) if w[0] == g[0] and w[1] <= g[1] <= w[2]}
    assert ds.regions[0] not in checked
    argv = harness._job_argv(ds, cfg, str(tmp_path), "pass", "cpu")
    assert cli.main(argv, tracer=Tracer()) == 0
    with open(tmp_path / "pass.bcf", "rb") as f:
        res = compare(ds, argv, f.read(), None, cfg["check"], seed)
    assert res["sites_differ"] == 0, res
    assert res["sites_compared"] >= cfg["check"]["min_sites"] * 0.3


@pytest.mark.parametrize("fault", [_emit_past_targets, _drop_a_target],
                         ids=["site_outside_targets", "target_left_out"])
def test_planted_fault_is_caught(monkeypatch, run, fault):
    make = dataset.make_dataset

    def made(*a, **k):
        ds = make(*a, **k)
        fault(monkeypatch, ds)
        return ds

    monkeypatch.setattr(dataset, "make_dataset", made)
    r, _seen = run()
    assert not r["correct"], r["compared"]
    assert r["compared"]["sites_differ"]["value"] > 0
