"""The readers of the program's own stages and counters: a value from a
given context, None where the program has no such stage or counter (as
a program without them has not)."""

import pytest

from portbench.harness import _read_metric

STAGE_READERS = {
    "ingest.native_s_per_mread": "ingest.native",
    "ingest.pileup_s_per_mread": "ingest.pileup",
    "engine.prep_s_per_mread": "call.prep",
    "engine.h2d_s_per_mread": "call.h2d",
    "engine.d2h_s_per_mread": "call.d2h",
    "engine.finish_s_per_mread": "call.finish",
    "emit.stats_s_per_mread": "emit.stats",
    "emit.format_s_per_mread": "emit.format",
    "emit.backlog_s_per_mread": "emit.backlog",
}
COUNT_READERS = {
    "transfer.h2d_bytes_per_read": "h2d_bytes",
    "transfer.d2h_bytes_per_read": "d2h_bytes",
}


def _ctx(times=None, counts=None, mreads=2.0, passes=4):
    return {"times": dict(times or {}), "counts": dict(counts or {}),
            "mreads": mreads, "passes": passes}


@pytest.mark.parametrize("name,stage", sorted(STAGE_READERS.items()))
def test_stage_reader(name, stage):
    assert _read_metric(name, _ctx({stage: 3.0, "call": 9.0})) == 1.5
    assert _read_metric(name, _ctx({"call": 9.0, "emit": 1.0})) is None
    assert _read_metric(name, _ctx({stage: 3.0}, mreads=0)) is None


@pytest.mark.parametrize("name,counter", sorted(COUNT_READERS.items()))
def test_count_reader(name, counter):
    assert _read_metric(name, _ctx(counts={counter: 5_000_000})) == 2.5
    assert _read_metric(name, _ctx(counts={"fused_chunks": 3})) is None
    assert _read_metric(name, _ctx(counts={counter: 1}, mreads=0)) is None


def test_job_fixed_reader():
    name = "job.fixed_s_per_pass"
    t = {"job.open": 1.0, "job.close": 0.6, "job.report": 0.4, "call": 5.0}
    assert _read_metric(name, _ctx(t)) == 0.5
    # a job that writes no report has no job.report
    assert _read_metric(name, _ctx({"job.open": 1.0, "job.close": 1.0})
                        ) == 0.5
    assert _read_metric(name, _ctx({"call": 5.0})) is None
    assert _read_metric(name, _ctx(t, passes=0)) is None


def test_host_readers():
    ctx = dict(_ctx(), window_s=4.0, cpu_s=10.0)
    assert _read_metric("host.reads_per_s", ctx) == 500_000.0
    assert _read_metric("host.cpu_s_per_mread", ctx) == 5.0
    ctx["mreads"] = 0
    assert _read_metric("host.reads_per_s", ctx) is None
    assert _read_metric("host.cpu_s_per_mread", ctx) is None
