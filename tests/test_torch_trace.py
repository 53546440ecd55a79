"""The port's tracer (`bs_call_tpu_torch.utils.trace`) on a whole job: the
stages inside the producer, the engine's call, the emit worker and the
job's fixed cost; the spans, their nesting and block ids; the bytes each
call copies each way; `--trace-file`'s Chrome trace; and output bytes
that do not depend on the tracer. CPU, `--device cpu`, on the synthetic
WGBS fixture with a dbSNP index, BCF output and a report."""

import json

import numpy as np
import pytest
import torch

from bs_call_tpu_torch import cli
from bs_call_tpu_torch.config import CallerConfig
from bs_call_tpu_torch.native.pipeline import NativePipeline
from bs_call_tpu_torch.ops.kernels.emit_device import ROW_BYTES
from bs_call_tpu_torch.ops.kernels.pileup_device import TILE
from bs_call_tpu_torch.pipeline.engine import TorchCallEngine
from bs_call_tpu_torch.utils.synth import make_dbsnp_index, make_wgbs_fixture
from bs_call_tpu_torch.utils.trace import NULL_TRACER, Tracer

CPU = torch.device("cpu")
PRODUCER = ("ingest.native", "ingest.contig", "ingest.pileup",
            "ingest.reads")
CALL = ("call.prep", "call.h2d", "call.launch", "call.d2h", "call.finish")
EMIT = ("emit.prep", "emit.dbsnp", "emit.stats", "emit.format")
JOB = ("job.open", "job.close", "job.report")
STAGES = PRODUCER + CALL + EMIT + JOB + ("emit.backlog", "ingest", "call",
                                         "emit", "meth_prof")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """One job with `Tracer(spans=True)` and `--trace-file`, one with
    `Tracer()` and one with no tracer, over one fixture."""
    tmp = tmp_path_factory.mktemp("trace")
    ref, bam, _n = make_wgbs_fixture(str(tmp), 2500, 5000, seed=3,
                                     n_contigs=2)
    idx = make_dbsnp_index(str(tmp / "idx.bin"), ["chr1", "chr2"], 5000)
    argv = [bam, "-r", ref, "-D", idx, "-O", "b", "--benchmark-mode",
            "--device", "cpu", "-t", "2"]
    out = {}
    for tag, tracer in (("spans", Tracer(spans=True)), ("plain", Tracer()),
                        ("none", None)):
        extra = (["--trace-file", str(tmp / "trace.json")]
                 if tag == "spans" else [])
        rc = cli.main(argv + ["-o", str(tmp / f"{tag}.bcf"), "--report-file",
                              str(tmp / f"{tag}.json")] + extra,
                      tracer=tracer)
        assert rc == 0
        out[tag] = (tracer, (tmp / f"{tag}.bcf").read_bytes(),
                    (tmp / f"{tag}.json").read_text())
    out["trace_file"] = tmp / "trace.json"
    return out


def test_every_stage_appears(job):
    for tag in ("spans", "plain"):
        tr = job[tag][0]
        assert set(STAGES) <= set(tr.times), set(STAGES) - set(tr.times)
        assert tr.counts["h2d_bytes"] > 0 and tr.counts["d2h_bytes"] > 0


def test_inner_stages_sum_within_their_parent(job):
    """The engine's stages lie inside the runner's `call`, the vector
    emitter's inside the emit worker's `emit`, on one thread each."""
    for tag in ("spans", "plain"):
        t = job[tag][0].times
        assert 0 < sum(t[s] for s in CALL) <= t["call"]
        assert 0 < sum(t[s] for s in EMIT) <= t["emit"]


def test_spans_nest_on_their_own_thread(job):
    spans = job["spans"][0].spans
    assert len(spans) > 20
    by_parent = {}
    for n, tid, s, e, p, _b in spans:
        assert s <= e
        if p < 0:
            continue
        pn, ptid, ps, pe, _pp, _pb = spans[p]
        assert ptid == tid and ps <= s and e <= pe, (n, pn)
        by_parent.setdefault(p, []).append((s, e))
    for kids in by_parent.values():
        kids.sort()
        assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))
    parents = {n: spans[p][0] for n, _t, _s, _e, p, _b in spans if p >= 0}
    assert {parents[s] for s in CALL} == {"call"}
    assert {parents[s] for s in EMIT} == {"emit"}
    # the producer, the caller and the emit worker: three threads
    tids = {n: tid for n, tid, *_ in spans}
    assert len({tids["ingest.native"], tids["call"], tids["emit"]}) == 3
    assert tids["job.open"] == tids["call"] == tids["job.report"]


def test_block_ids_join_the_threads(job):
    spans = job["spans"][0].spans
    ids = {}
    for n, _tid, _s, _e, _p, b in spans:
        if b is not None:
            ids.setdefault(n, set()).add(b)
    emitted = ids["emit"]
    assert emitted and emitted <= ids["ingest.native"]
    assert emitted <= ids["call"] and emitted <= ids["ingest.pileup"]
    # the call's stages inherit the block of their `call`
    for n, _tid, _s, _e, p, b in spans:
        if n in CALL + EMIT:
            assert b is not None and b == spans[p][5]


def _first_block(tmp_path):
    ref, bam, _n = make_wgbs_fixture(str(tmp_path), 800, 3000, seed=5)
    cfg = CallerConfig()
    p = NativePipeline(bam, cfg, np.ones(1, np.int8))
    blk = p.next_block()
    reads = p.block_reads()
    p.close()
    return cfg, blk, reads


def test_fused_call_counts_the_bytes_it_copies(tmp_path, monkeypatch):
    """h2d_bytes and d2h_bytes of one fused call are the nbytes of its
    padded batch, reference, tile table and covered index in, and of the
    covered rows' five outputs and the packed emit fields out."""
    monkeypatch.delenv("BS_CALL_EMIT_TIER", raising=False)
    cfg, blk, reads = _first_block(tmp_path)
    agg = blk["agg"]
    sz = blk["y"] - blk["x"] + 1
    covered = np.nonzero(agg["n"] > 0)[0]
    ref_codes = np.random.default_rng(5).integers(0, 5, sz).astype(np.int32)
    eng = TorchCallEngine(cfg, CPU)
    eng.tracer = tr = Tracer()
    res = eng._call_fused(reads, 0, sz - 1, ref_codes, agg, covered)
    assert res is not None and res[4] is not None
    starts, lens = reads["starts"], reads["lens"]
    n_rows = int(((starts <= sz - 1) & (starts + lens - 1 >= 0)).sum())
    r_pad = eng._pow2(n_rows, 1024)
    l_cap = eng._pow2(reads["rd"].shape[1], 64)
    n_pos = max(cfg.batch_positions, 1024) + eng._FUSED_PAD
    n_cov = len(covered)
    h2d = (r_pad * l_cap           # rd, uint8
           + 4 * r_pad * 4         # starts, ori, strand, mapq, int32
           + 4 * n_pos             # ref, int32
           + 4 * 2 * -(-n_pos // TILE)  # the tile table, int32 pairs
           + 8 * n_cov)            # the covered index, int64
    d2h = (n_cov * (8 * 10 + 4 + 8 + 8 + 8)  # gt_prob, max_gt, margin,
           + n_pos * ROW_BYTES)               # off, quals; packed fields
    assert dict(tr.counts) == {"h2d_bytes": h2d, "d2h_bytes": d2h}
    assert set(tr.times) == set(CALL)


def test_column_tier_counts_the_bytes_it_copies(tmp_path):
    """Each column-tier chunk counts its slot's inputs in and its four
    outputs out, padded to batch_positions, on the CPU too."""
    cfg = CallerConfig(batch_positions=64)
    eng = TorchCallEngine(cfg, CPU)
    eng.tracer = tr = Tracer()
    n = 150
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 6, (n, 8)).astype(np.int32)
    quals = np.where(counts > 0, 30, 0).astype(np.int32)
    ref = rng.integers(1, 5, n).astype(np.int32)
    eng._call_batch(counts, quals, ref)
    chunks = -(-n // 64)
    assert eng.column_chunks == chunks
    assert tr.counts["h2d_bytes"] == chunks * 64 * (8 + 8 + 1) * 4
    # gt_prob [64, 10], max_gt (int32), margin, off_sum: f64 but max_gt
    assert tr.counts["d2h_bytes"] == chunks * 64 * (10 * 8 + 4 + 8 + 8)


def test_a_plain_tracer_keeps_no_spans(job):
    tr = job["plain"][0]
    assert tr.spans is None and tr._spans is None
    assert Tracer().spans is None
    assert Tracer(spans=True).spans == []


def test_output_bytes_do_not_depend_on_the_tracer(job):
    _tr, bcf, rep = job["spans"]
    assert len(bcf) > 1000 and '"totalStats"' in rep
    for tag in ("plain", "none"):
        assert job[tag][1] == bcf and job[tag][2] == rep


def test_trace_file_holds_the_spans(job):
    spans = job["spans"][0].spans
    with open(job["trace_file"]) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert len(xs) == len(spans)
    tid_of = {}
    for e, (n, tid, s, t1, p, b) in zip(xs, spans):
        assert e["name"] == n
        assert e["ts"] == pytest.approx(s / 1e3, abs=1e-3)
        assert e["dur"] == pytest.approx((t1 - s) / 1e3, abs=1e-3)
        assert e["args"] == {"block": b, "parent": p}
        assert tid_of.setdefault(tid, e["tid"]) == e["tid"]
    # one track a thread, each named
    assert len(set(tid_of.values())) == len(tid_of) == len(names)
    assert {"bs_call producer", "bs_call emit"} <= set(names.values())


def test_null_tracer_keeps_nothing():
    with NULL_TRACER.stage("call", block=3) as sp:
        sp.block = 4
    NULL_TRACER.count("h2d_bytes", 10)
    assert not NULL_TRACER.times and not NULL_TRACER.counts
    assert NULL_TRACER.spans is None


def test_spans_from_many_threads_are_all_kept():
    """Threads that open spans at once, with the interpreter switching
    threads every few microseconds, lose no span and no second: ids are
    unique, every span nests on its own thread, each name's sum is its
    own thread's."""
    import sys
    import threading

    tr = Tracer(spans=True)
    n_threads, n_iter = 12, 300

    def work(k):
        for i in range(n_iter):
            with tr.stage(f"outer{k}", block=i):
                with tr.stage(f"inner{k}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    spans = tr.spans
    assert len(spans) == 2 * n_threads * n_iter
    for n, tid, s, e, p, b in spans:
        if n.startswith("inner"):
            pn, ptid, ps, pe, _pp, pb = spans[p]
            assert pn == "outer" + n[5:] and ptid == tid and pb == b
            assert ps <= s <= e <= pe
    for k in range(n_threads):
        own = sum(e - s for n, _t, s, e, _p, _b in spans
                  if n == f"outer{k}") / 1e9
        assert tr.times[f"outer{k}"] == pytest.approx(own)
