"""A whole run without the card (the plain PyTorch kernels on the CPU, a
small slab of each configuration): the output check holds the port, and
each fault planted under the timed path turns `correct` false."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness

ROOT = harness.ROOT
SCALE = {"wgbs30x": 0.03, "rrbs": 0.1}


def _run(cell, trace=False, seed=2 ** 31 + 5):
    return harness.run_cell(cell, seed, 0.5, trace, device="cpu",
                            chips_checked=False, scale=SCALE[cell],
                            log=io.StringIO())


@pytest.mark.parametrize("cell", ["wgbs30x", "rrbs"])
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["compared"]
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "compared"]
    bench = harness.load_cell(cell)[0]
    # no card: no device time, so only the host's clock's metrics
    assert set(r["metrics"]) == {
        m["name"] for m in bench["end_to_end"]
        if cell in m.get("workloads", [cell])
        and m["source"] == "host_clock"}
    assert "setup_s" in r["metrics"]
    assert r["compared"]["sites_differ"]["value"] == 0
    if cell == "rrbs":
        assert r["compared"]["report_differ"]["value"] == 0


def test_traced_run_line():
    r = _run("rrbs", trace=True)
    assert r["correct"]
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "breakdown", "compared"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert "engine.call_s_per_mread" in r["metrics"]
    # no card: no device time, so no roofline share is reported
    assert "k12_roofline" not in r["metrics"]
    assert len(r["breakdown"]["idle_gaps"]) <= 10


def _alter_answers(soa):
    cov = np.nonzero(soa["covered"])[0][::7]
    soa["max_gt"][cov] = (soa["max_gt"][cov] + 3) % 10
    soa.pop("dev_prep", None)
    return soa


def _drop_half(soa):
    n = len(soa["covered"])
    soa["covered"][n // 2:] = False
    return soa


FAULTS = {
    "answer_altered": ("bs_call_tpu_torch.pipeline.engine.TorchCallEngine",
                       "call_block_soa", _alter_answers),
    "half_left_out": ("bs_call_tpu_torch.pipeline.engine.TorchCallEngine",
                      "call_block_soa", _drop_half),
    "output_unchanged": (
        "bs_call_tpu_torch.output.vector_site.VectorBlockEmitter",
        "emit_block", None),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["wgbs30x", "rrbs"])
def test_planted_fault_is_caught(monkeypatch, cell, fault):
    import importlib

    path, attr, edit = FAULTS[fault]
    mod, cls = path.rsplit(".", 1)
    owner = getattr(importlib.import_module(mod), cls)
    orig = getattr(owner, attr)
    if edit is None:
        def broken(self, *a, **k):
            return None
    else:
        def broken(self, *a, **k):
            return edit(orig(self, *a, **k))
    monkeypatch.setattr(owner, attr, broken)
    r = _run(cell)
    assert not r["correct"], r["compared"]


def test_report_fault_is_caught(monkeypatch):
    from bs_call_tpu_torch.stats import report

    orig = report.write_report

    def broken(fp, cfg, stats, table, dbsnp=None):
        stats.snps[0] += 1
        return orig(fp, cfg, stats, table, dbsnp=dbsnp)

    monkeypatch.setattr(report, "write_report", broken)
    r = _run("rrbs")
    assert not r["correct"]
    assert r["compared"]["report_differ"]["value"] > 0


def test_import_guard(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bs_call_tpu_torch_x", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "bs_call_tpu.cli", object())
    assert harness.forbidden_modules() == ["bs_call_tpu", "jax"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "rrbs", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "cuda" in p.stderr


def test_sources_import_nothing_of_jax():
    import ast

    bad = []
    for dirpath, _d, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    if n.split(".")[0] in harness.FORBIDDEN:
                        bad.append((f, n))
                    if (dirpath.endswith(("ref", "io", "ops", "output",
                                          "stats", "pipeline"))
                            and "/ref" in dirpath
                            and n.split(".")[0] == "bs_call_tpu_torch"):
                        bad.append((f, n))
    assert bad == []
