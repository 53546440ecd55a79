"""The runner's block pipeline (`pipeline/runner.py` `_BlockPipeline`,
`_BlockRouter`) on both ingest paths: the native producer and the Python
record path (forced by `_try_native` returning None).

An error in the producer, in the emit worker or in the engine's call at
block k raises from `run_caller`, leaves no `bs_call producer` or
`bs_call emit` thread behind and closes the native pipeline once; the
record path tags its `call` and `emit` spans with its producer's block
ids; and the run's one `LagState` carries dedup and the CpG pair across
blocks that alternate between the vector emitter (9 positions or more)
and the scalar one (fewer), with the bytes and report of `bs_call_tpu`'s
CLI on the native and record paths and under the row engine.

The fixture: three contigs of clusters 2-5 uncovered bases apart, so
each is a block: a cluster of overlapping 30-base reads (a block of ~50
positions) alternating with one read of 3-5 bases (6-8 positions), CpGs
salted every 11 bases; chrA starts with a wide block and chrB with a
narrow one, so the contig switch crosses the emitters both ways. Blocks
never share a covered position, so only a block cut into ranges shows
the state crossing: on chrD, with chunks of 1,024 positions, the native
pipeline stages a settled range of 2,060 positions (the vector emitter,
or the row engine's, 2 rows held back) and then the block's last 8 (the
scalar emitter), whose first rows were emitted already (dedup) and whose
G at 2,067 pairs with the C at 2,066 of the range before (the CpG
pair)."""

import threading

import numpy as np
import pytest

from bs_call_tpu import cli as jax_cli
from bs_call_tpu.io.bam import FREVERSE, BamHeader, BamWriter, aux_tag
from bs_call_tpu_torch import cli
from bs_call_tpu_torch.native.pipeline import NativePipeline
from bs_call_tpu_torch.parity import strip_date
from bs_call_tpu_torch.pipeline import runner
from bs_call_tpu_torch.pipeline.engine import TorchCallEngine
from bs_call_tpu_torch.utils.trace import Tracer

NAMES = ("chrA", "chrB", "chrC", "chrD")
# chrD: 10-base reads every 5 bases, then a 2-base read that triggers a
# partial stage at 1-based 2,070 and ends the block (0-based starts)
TILED = [(p, 10) for p in range(10, 2061, 5)] + [(2069, 2)]
CTG_LEN = 3000
THREADS = ("bs_call producer", "bs_call emit")
K = 3  # the block that fails
# the record path on the host engine: the column tier's plain version on
# the CPU takes minutes for ~80 blocks
DEVICE = {"native": "cpu", "record": "numpy", "row_engine": "numpy"}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("block_pipeline")
    rng = np.random.default_rng(29)
    seqs = []
    with open(tmp / "ref.fa", "w") as f:
        for name in NAMES:
            seq = list(rng.choice(list("ACGT"), CTG_LEN))
            for p in range(20, CTG_LEN - 2, 11):
                seq[p], seq[p + 1] = "C", "G"
            seq[2065], seq[2066] = "C", "G"
            seqs.append("".join(seq))
            f.write(f">{name}\n")
            for i in range(0, CTG_LEN, 60):
                f.write(seqs[-1][i: i + 60] + "\n")
    hdr = BamHeader(
        text="@HD\tVN:1.6\tSO:coordinate\n"
        + "".join(f"@SQ\tSN:{n}\tLN:{CTG_LEN}\n" for n in NAMES),
        ref_names=list(NAMES), ref_lens=[CTG_LEN] * len(NAMES),
    )
    w = BamWriter(str(tmp / "in.bam"), hdr)
    n = 0
    for tid, seq in enumerate(seqs[:3]):
        pos, wide = 10, tid != 1
        while pos < CTG_LEN - 120:
            starts = [pos + 5 * i for i in range(4)] if wide else [pos]
            ln = 30 if wide else int(rng.integers(3, 6))
            for st in starts:
                conv = "CG"[int(rng.integers(2))]
                s = list(seq[st: st + ln])
                for i, b in enumerate(s):
                    if b == conv and rng.random() < 0.7:
                        s[i] = "T" if conv == "C" else "A"
                flag = FREVERSE if rng.random() < 0.5 else 0
                w.write(f"r{n}", flag, tid, st, 40, [(ln, 0)], -1, -1, 0,
                        "".join(s), rng.integers(20, 41, ln).astype(np.uint8),
                        aux_tag("XB", "A", conv))
                n += 1
            pos = starts[-1] + ln + int(rng.integers(2, 6))
            wide = not wide
    for st, ln in TILED:
        s = seqs[3][st: st + ln]
        w.write(f"r{n}", 0, 3, st, 40, [(ln, 0)], -1, -1, 0, s,
                rng.integers(20, 41, ln).astype(np.uint8),
                aux_tag("XB", "A", "C"))
        n += 1
    w.close()
    return tmp


def args(fixture, out, device):
    return [str(fixture / "in.bam"), "-r", str(fixture / "ref.fa"),
            "--benchmark-mode", "-o", str(fixture / out), "--device", device]


def pipeline_threads():
    return [t for t in threading.enumerate() if t.name in THREADS]


def fail_at_block(k, fn, blocks=lambda *a: 1):
    """`fn` that raises once it reaches the k-th block (0-based), counting
    `blocks(*its arguments)` blocks a call."""
    seen = [0]

    def wrapped(*a, **kw):
        seen[0] += blocks(*a)
        if seen[0] > k:
            raise RuntimeError(f"failed at block {k}")
        return fn(*a, **kw)

    return wrapped


@pytest.mark.parametrize("where", ["producer", "emit", "engine"])
@pytest.mark.parametrize("path", ["native", "record"])
def test_an_error_at_block_k_ends_the_pipeline(fixture, monkeypatch, path,
                                               where):
    closed = []
    real_close = NativePipeline.close

    def close(self):
        if self._h:
            closed.append(self)
        real_close(self)

    monkeypatch.setattr(NativePipeline, "close", close)
    if path == "record":
        monkeypatch.setattr(runner, "_try_native", lambda *a, **k: None)
    if where == "producer" and path == "native":
        monkeypatch.setattr(NativePipeline, "next_block_meta", fail_at_block(
            K, NativePipeline.next_block_meta))
    elif where == "producer":
        monkeypatch.setattr(runner, "build_pileup",
                            fail_at_block(K, runner.build_pileup))
    elif where == "emit":
        monkeypatch.setattr(runner, "_emit_block_soa",
                            fail_at_block(K, runner._emit_block_soa))
    else:
        monkeypatch.setattr(TorchCallEngine, "call_block_soa", fail_at_block(
            K, TorchCallEngine.call_block_soa))
        monkeypatch.setattr(TorchCallEngine, "call_blocks_soa", fail_at_block(
            K, TorchCallEngine.call_blocks_soa,
            lambda _self, blocks: len(blocks)))
    before = pipeline_threads()
    with pytest.raises(RuntimeError, match=f"failed at block {K}"):
        cli.main(args(fixture, f"fail_{path}_{where}.vcf", DEVICE[path]))
    assert pipeline_threads() == before == []
    assert len(closed) == (1 if path == "native" else 0)


def test_record_path_spans_carry_its_block_ids(fixture, monkeypatch):
    monkeypatch.setattr(runner, "_try_native", lambda *a, **k: None)
    tracer = Tracer(spans=True)
    assert cli.main(args(fixture, "spans.vcf", DEVICE["record"]),
                    tracer=tracer) == 0
    ids, tids = {}, {}
    for name, tid, _s, _e, _p, b in tracer.spans:
        tids.setdefault(name, set()).add(tid)
        if b is not None:
            ids.setdefault(name, set()).add(b)
    produced = ids["pileup"]
    assert len(produced) == tracer.counts["blocks"] > 40
    assert ids["normalize"] == ids["call"] == ids["emit"] == produced
    # the producer, the caller and the emit worker: three threads
    assert all(len(tids[n]) == 1 for n in ("pileup", "call", "emit"))
    assert len(tids["pileup"] | tids["call"] | tids["emit"]) == 3


@pytest.mark.parametrize("path", ["native", "record", "row_engine"])
def test_lag_state_crosses_the_emitters(fixture, monkeypatch, capsys, path):
    """Blocks alternate between the vector emitter (or the row engine's)
    and the scalar one, on one contig and across contigs; the port's VCF
    and report equal `bs_call_tpu`'s."""
    if path == "record":
        monkeypatch.setattr(runner, "_try_native", lambda *a, **k: None)
    sizes = []  # the blocks _emit_block_soa wrote (the row engine's not)
    real_emit = runner._emit_block_soa

    def emit(emitter, ctg, soa, ref_window, x, y, *a):
        sizes.append(y - x + 1)
        return real_emit(emitter, ctg, soa, ref_window, x, y, *a)

    monkeypatch.setattr(runner, "_emit_block_soa", emit)
    real_cfg = cli.args_to_config

    def small_chunks(a):
        cfg = real_cfg(a)
        cfg.batch_positions = 1024  # partial stages of 2,048 positions
        return cfg

    monkeypatch.setattr(cli, "args_to_config", small_chunks)
    extra = ["-A", "-O", "v", "--report-file"]
    tracer = Tracer(enabled=True)
    capsys.readouterr()
    assert cli.main([*args(fixture, f"lag_{path}.vcf", DEVICE[path]), *extra,
                     str(fixture / f"lag_{path}.json")], tracer=tracer) == 0
    err = capsys.readouterr().err
    assert ("using native row engine" in err) == (path == "row_engine")
    assert ("using native C++ ingest" in err) == (path != "record")
    assert jax_cli.main([*args(fixture, "lag_jax.vcf", "numpy"), *extra,
                         str(fixture / "lag_jax.json")]) == 0
    got = (fixture / f"lag_{path}.vcf").read_bytes()
    assert got == (fixture / "lag_jax.vcf").read_bytes() and len(got) > 1000
    assert strip_date((fixture / f"lag_{path}.json").read_text()) == \
        strip_date((fixture / "lag_jax.json").read_text())
    assert tracer.counts["blocks"] > 40
    assert min(sizes) < 9 and (max(sizes) >= 9) == (path != "row_engine")
