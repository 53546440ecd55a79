"""The PyTorch port end to end (`bs_call_tpu_torch.pipeline` and `.cli`)
on torch.device("cpu"), held to the JAX package's bytes: the golden
fixture, the synthetic WGBS fixture against `bs_call_tpu`'s own
run_caller in exact and `--no-exact` mode, the per-tier counters, the
two reroutes to the column tier, and the refusals (`--device cuda`
without a card, `--num-hosts` as `bs_call_tpu.cli` refuses it, any JAX
import)."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bs_call_tpu import constants as C
from bs_call_tpu.config import CallerConfig
from bs_call_tpu.native.pipeline import NativePipeline
from bs_call_tpu.ops import oracle
from bs_call_tpu.pipeline.runner import run_caller as jax_run_caller
from bs_call_tpu.stats.collect import BsStats
from bs_call_tpu.stats.report import write_report
from bs_call_tpu.utils.trace import Tracer as JaxTracer
from bs_call_tpu_torch import cli
from bs_call_tpu_torch.device import resolve_device
from bs_call_tpu_torch.parity import check_no_exact, strip_date
from bs_call_tpu_torch.pipeline.engine import TorchCallEngine
from bs_call_tpu_torch.pipeline.runner import run_caller
from bs_call_tpu_torch.utils.trace import Tracer

from __graft_entry__ import _make_fixture
from make_golden import GOLDEN_DIR, build_fixture
from test_native_pipeline import random_bam

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(runner, cfg, *args):
    out = io.BytesIO()
    # each package's runner takes its own package's tracer
    tracer = (Tracer if runner is run_caller else JaxTracer)()
    stats, table = runner(cfg, *args, out_fileobj=out, stats=BsStats(),
                          tracer=tracer)
    rep = io.StringIO()
    write_report(rep, cfg, stats, table, dbsnp=cfg.dbsnp_file)
    return out.getvalue(), strip_date(rep.getvalue()), tracer.counts


def golden_cfg(tmp, **kw):
    ref, bam, idx = build_fixture(str(tmp))
    return CallerConfig(
        input_file=bam, reference_file=ref, dbsnp_file=idx,
        benchmark_mode=True, left_trim=(2, 1), right_trim=(1, 0),
        sample_name="golden", **kw,
    )


def test_golden_fixture_bytes(tmp_path):
    vcf, report, counts = run(run_caller, golden_cfg(tmp_path), CPU)
    with open(os.path.join(GOLDEN_DIR, "golden.vcf"), "rb") as f:
        assert vcf == f.read()
    with open(os.path.join(GOLDEN_DIR, "golden_report.json")) as f:
        assert report == f.read()
    assert counts["tier_fused"] > 0 and counts["tier_column"] == 0


def test_golden_bcf_bytes(tmp_path):
    import gzip

    cfg = golden_cfg(tmp_path, out_file_type=C.FT_BCF_GZ)
    out = io.BytesIO()
    run_caller(cfg, CPU, out_fileobj=out)
    with open(os.path.join(GOLDEN_DIR, "golden.bcf.u"), "rb") as f:
        assert gzip.decompress(out.getvalue()) == f.read()


@pytest.fixture(scope="module")
def wgbs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("wgbs"))
    ref, bam, dbsnp = _make_fixture(tmp)
    return dict(input_file=bam, reference_file=ref, dbsnp_file=dbsnp,
                benchmark_mode=True, sample_name="port")


@pytest.fixture(scope="module")
def wgbs_want(wgbs):
    """bs_call_tpu's own run_caller (host engines) on the WGBS fixture."""
    return run(jax_run_caller, CallerConfig(device="cpu", **wgbs))[:2]


@pytest.fixture
def splice_hits(monkeypatch):
    """Counts the emitter's calls that used device emit fields."""
    import bs_call_tpu_torch.output.vector_site as vs

    hits = {"n": 0}
    orig = vs._splice_dev_prep

    def spy(*a, **k):
        r = orig(*a, **k)
        if r is not None:
            hits["n"] += 1
        return r

    monkeypatch.setattr(vs, "_splice_dev_prep", spy)
    return hits


def test_wgbs_exact_bytes_and_tiers(wgbs, wgbs_want, splice_hits):
    """(exact, emit tier on: the default) port bytes == bs_call_tpu
    run_caller bytes, the fused tier carried every called position, and
    the emitter used the device emit fields."""
    want_vcf, want_rep = wgbs_want
    vcf, rep, counts = run(run_caller, CallerConfig(device="cpu", **wgbs),
                           CPU)
    assert vcf == want_vcf
    assert rep == want_rep
    assert counts["tier_fused"] > 10_000
    assert counts["tier_column"] == 0
    assert counts["tier_shape_reroute"] == counts["tier_quals_reroute"] == 0
    assert counts["tier_emit"] == counts["tier_fused"]
    assert counts["tier_emit_risk"] <= counts["tier_emit"] // 50
    assert splice_hits["n"] > 0, "device emit fields never engaged"
    # one block a contig, wider than a pack's segments: no block packs
    assert counts["fused_blocks"] == counts["fused_chunks"] > 0


def test_rrbs_packed_blocks_bytes(tmp_path):
    """A small RRBS slab (the benchmark's rrbs_mspi_se50 at a tenth of its
    size): its hundreds of small blocks are called many to a fused call
    (`call_blocks_soa`), and the BCF bytes and the JSON report equal
    bs_call_tpu's on the same input."""
    import json

    from bs_call_tpu import cli as jax_cli
    from portbench.gen.dataset import make_dataset
    from portbench.harness import ROOT, _job_argv

    with open(os.path.join(ROOT, "portbench", "configs",
                           "rrbs_mspi_se50.json")) as f:
        bench_cfg = json.load(f)
    ds = make_dataset(bench_cfg, 2**31 + 23, str(tmp_path / "in"), scale=0.1)
    tracer = Tracer()
    got = _job_argv(ds, bench_cfg, str(tmp_path), "port", "cpu")
    assert cli.main(got, tracer=tracer) == 0
    want = _job_argv(ds, bench_cfg, str(tmp_path), "ref", "cpu")
    assert jax_cli.main(want) == 0
    out = {tag: ((tmp_path / f"{tag}.bcf").read_bytes(),
                 strip_date((tmp_path / f"{tag}.json").read_text()))
           for tag in ("port", "ref")}
    assert out["port"] == out["ref"]
    counts = tracer.counts
    assert counts["tier_column"] == 0 and counts["tier_fused"] > 1000
    assert counts["fused_blocks"] >= 20 * counts["fused_chunks"] > 0


def test_wgbs_emit_tier_off_bytes(wgbs, wgbs_want, splice_hits,
                                  monkeypatch):
    """BS_CALL_EMIT_TIER=0: the fused tier without device emit fields
    (host Fisher and emit prep for every row) writes the same bytes."""
    monkeypatch.setenv("BS_CALL_EMIT_TIER", "0")
    vcf, rep, counts = run(run_caller, CallerConfig(device="cpu", **wgbs),
                           CPU)
    assert (vcf, rep) == wgbs_want
    assert counts["tier_fused"] > 10_000
    assert counts["tier_emit"] == counts["tier_emit_risk"] == 0
    assert splice_hits["n"] == 0


def test_emit_tier_reference_with_N(tmp_path, splice_hits):
    """On an N-holed reference the emitter's context-truncated ref code
    (print_vcf.c:563-580) differs from K3's raw code after every N; those
    rows recompute on the host and the bytes stay equal to bs_call_tpu's
    (the case of tests/test_fused_engine.py)."""
    from bs_call_tpu.io.bam import BamHeader, BamWriter

    rng = np.random.default_rng(3)
    L = 4000
    seq = rng.choice(list("ACGT"), L)
    for p in range(50, L - 3, 37):
        seq[p] = "N"
    ref = tmp_path / "n.fa"
    ref.write_text(">chr1\n" + "\n".join(
        "".join(seq[i:i + 60]) for i in range(0, L, 60)) + "\n")
    hdr = BamHeader(
        text=f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:{L}\n",
        ref_names=["chr1"], ref_lens=[L],
    )
    bam = tmp_path / "n.bam"
    w = BamWriter(str(bam), hdr)
    for k, pos in enumerate(range(0, L - 80, 3)):
        rseq = ["A" if b == "N" else b for b in seq[pos:pos + 60]]
        for i in np.nonzero(rng.random(60) < 0.03)[0]:
            rseq[i] = "ACGT"[int(rng.integers(0, 4))]
        w.write(f"r{k:05d}", 0, 0, pos, 57, [(60, 0)], -1, -1, 0,
                "".join(rseq), rng.integers(20, 44, 60).astype(np.uint8))
    w.close()
    kw = dict(input_file=str(bam), reference_file=str(ref),
              benchmark_mode=True, device="cpu")
    want = run(jax_run_caller, CallerConfig(**kw))[:2]
    vcf, rep, counts = run(run_caller, CallerConfig(**kw), CPU)
    assert (vcf, rep) == want
    assert counts["tier_emit"] > 0 and splice_hits["n"] > 0


@pytest.fixture
def k2_calls(monkeypatch):
    """The row counts of the engine's calls of K2's entry point, one a
    column-tier chunk."""
    import bs_call_tpu_torch.pipeline.engine as engine_mod

    calls = []
    orig = engine_mod.call_genotypes

    def spy(counts, *args):
        calls.append(len(counts))
        return orig(counts, *args)

    monkeypatch.setattr(engine_mod, "call_genotypes", spy)
    return calls


def test_wgbs_no_exact_records(wgbs, k2_calls):
    """(--no-exact) the same records at the same positions; GL within its
    last printed digit, GQ free (the f32 contract of cli.py). The column
    tier carried every called position, and `column_chunks` counts its
    chunks: one call of K2's entry a chunk, each a fixed chunk of
    batch_positions rows (the tail zero-padded)."""
    kw = dict(wgbs, device="cpu", exact=False)
    want_vcf, _, _ = run(jax_run_caller, CallerConfig(**kw))
    vcf, _, counts = run(run_caller, CallerConfig(**kw), CPU)
    assert check_no_exact(want_vcf.decode(), vcf.decode()) > 10_000
    assert counts["tier_column"] > 0 and counts["tier_fused"] == 0
    assert counts["column_chunks"] == len(k2_calls) > 0
    bp = CallerConfig().batch_positions
    assert set(k2_calls) == {bp}
    assert counts["tier_column"] <= sum(k2_calls)


def test_no_exact_column_chunks(tmp_path, k2_calls):
    """--no-exact in chunks of 1,024 positions: blocks split into several
    column-tier chunks, `column_chunks` counts every one, each is
    batch_positions rows (the tail zero-padded), and the bytes equal a
    run in chunks of the default size."""
    ref, bam = random_bam(tmp_path, n_pairs=300, seed=5)
    kw = dict(input_file=bam, reference_file=ref, benchmark_mode=True,
              exact=False)
    want, _, _ = run(run_caller, CallerConfig(**kw), CPU)
    n_default = len(k2_calls)
    k2_calls.clear()
    vcf, _, counts = run(run_caller,
                         CallerConfig(batch_positions=1 << 10, **kw), CPU)
    assert vcf == want
    assert counts["column_chunks"] == len(k2_calls) > n_default
    assert set(k2_calls) == {1 << 10}
    assert counts["tier_column"] <= sum(k2_calls)


def test_no_exact_check_rejects_real_differences():
    head = "##fileformat=VCFv4.2\n#CHROM\n"
    rec = ("chr1\t5\t.\tC\t.\t8\tPASS\t.\tGT:GQ:GL:DP\t"
           "0/0:8:{gl}:{dp}\n")
    a = head + rec.format(gl="-0.0101269,-5.5", dp=4)
    assert check_no_exact(a, head + rec.format(gl="-0.010127,-5.5", dp=4))
    with pytest.raises(ValueError):
        check_no_exact(a, head + rec.format(gl="-0.0101169,-5.5", dp=4))
    with pytest.raises(ValueError):
        check_no_exact(a, head + rec.format(gl="-0.0101269,-5.5", dp=5))


def first_block(tmp_path, seed):
    ref, bam = random_bam(tmp_path, n_pairs=400, seed=seed)
    cfg = CallerConfig(device="cpu")
    p = NativePipeline(str(bam), cfg, np.ones(1, np.int8))
    blk = p.next_block()
    reads = p.block_reads()
    p.close()
    sz = blk["y"] - blk["x"] + 1
    covered = np.nonzero(blk["agg"]["n"] > 0)[0]
    ref_codes = np.random.default_rng(seed).integers(0, 5, sz).astype(
        np.int32
    )
    return cfg, blk, reads, sz, covered, ref_codes


def test_quals_mismatch_goes_to_oracle(tmp_path):
    """One row whose host quals differ from the device's is recomputed by
    the scalar oracle from the host inputs, and its device emit fields
    are flagged for the host."""
    cfg, blk, reads, sz, covered, ref_codes = first_block(tmp_path, 5)
    agg = blk["agg"]
    j = covered[len(covered) // 2]
    agg["quals"][j, int(np.argmax(agg["counts"][j]))] += 1
    eng = TorchCallEngine(cfg, CPU)
    res = eng._call_fused(reads, 0, sz - 1, ref_codes, agg, covered)
    assert res is not None and res[4] is not None
    assert len(res[4]["risk"]) == sz and res[4]["risk"][j]
    gt_prob, max_gt, margin, _off = eng._finish_exact(
        *res[:4], agg["counts"][covered].astype(np.int32),
        agg["quals"][covered], ref_codes[covered],
    )
    jj = int(np.nonzero(covered == j)[0][0])
    assert margin[jj] == 0.0
    want_prob, want_gt = oracle.calc_gt_prob(
        agg["counts"][j], agg["quals"][j], int(ref_codes[j]),
        cfg.under_conv, cfg.over_conv, cfg.ref_bias,
    )
    assert max_gt[jj] == want_gt
    np.testing.assert_array_equal(gt_prob[jj], want_prob)
    assert eng.tier_positions["fused"] == len(covered)
    assert eng.tier_positions["oracle"] >= 1


def test_reroutes_to_column_tier(tmp_path):
    """Reads longer than the fused tier takes, and a chunk whose device
    quals disagree with the host on more than 1% of rows, go to the
    column tier on the same device; each is counted."""
    cfg, blk, reads, sz, covered, ref_codes = first_block(tmp_path, 1)
    agg = blk["agg"]
    eng = TorchCallEngine(cfg, CPU)
    wide = dict(reads, rd=np.zeros((len(reads["starts"]), 4096), np.uint8))
    wide["rd"][:, : reads["rd"].shape[1]] = reads["rd"]
    assert eng._call_fused(wide, 0, sz - 1, ref_codes, agg, covered) is None
    assert eng.tier_positions["shape_reroute"] == len(covered)
    bad = dict(agg, quals=agg["quals"] + 1)
    assert eng._call_fused(reads, 0, sz - 1, ref_codes, bad, covered) is None
    assert eng.tier_positions["quals_reroute"] == len(covered)
    assert eng.tier_positions["fused"] == 0
    # the column tier takes the chunk in their place
    soa = eng.call_block_soa(
        blk["counts2"], blk["qual_sum"], blk["mapq2_sum"], ref_codes,
        agg=bad, reads=(wide, 0),
    )
    assert eng.tier_positions["column"] == len(covered)
    assert soa["covered"].sum() == len(covered)


def test_device_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    cfg = golden_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([cfg.input_file, "-r", cfg.reference_file,
                  "-o", str(tmp_path / "x.vcf"), "--device", "cuda"])
    assert not (tmp_path / "x.vcf").exists()


@pytest.mark.parametrize("flag, stdin, msg", [
    (["--num-hosts", "2", "--host-id", "0", "--shards", "2"], False,
     "mutually exclusive"),
    (["--num-hosts", "2"], False, "requires --host-id in [0, num-hosts)"),
    (["--num-hosts", "2", "--host-id", "0", "--no-output"], False,
     "requires -o"),
    (["--num-hosts", "2", "--host-id", "1"], True,
     "cannot run from stdin"),
])
def test_unported_paths_refused(tmp_path, capsys, flag, stdin, msg):
    """`--num-hosts` above 1 refuses what `bs_call_tpu.cli` refuses, with
    its exit code 1 and its message, before it opens a device or a
    process group: `--shards` beside it, a missing or out-of-range
    `--host-id`, a missing -o, and input from stdin."""
    from bs_call_tpu import cli as jax_cli

    cfg = golden_cfg(tmp_path)
    out = [] if "--no-output" in flag else ["-o", str(tmp_path / "x.vcf")]
    inp = [] if stdin else [cfg.input_file]
    argv = [*inp, "-r", cfg.reference_file, *out, "--device", "cpu",
            *(f for f in flag if f != "--no-output")]
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert msg in err
    assert jax_cli.main(argv) == 1
    assert capsys.readouterr().err == err
    assert not (tmp_path / "x.vcf").exists()


def test_cli_never_imports_jax(tmp_path):
    """The port's CLI, run in a fresh interpreter on the golden fixture,
    writes the golden bytes without importing JAX, and every module of
    the package imports without it."""
    ref, bam, idx = build_fixture(str(tmp_path))
    out = tmp_path / "port.vcf"
    code = (
        "import pkgutil, sys\n"
        "import bs_call_tpu_torch as P\n"
        "from bs_call_tpu_torch import cli\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        f"rc = cli.main([{bam!r}, '-r', {ref!r}, '-D', {idx!r},\n"
        f"    '-o', {str(out)!r}, '--benchmark-mode', '-n', 'golden',\n"
        "    '-L', '2,1', '-R', '1,0', '--device', 'cpu'])\n"
        "print('JAX_LOADED', 'jax' in sys.modules, rc)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX_LOADED False 0" in res.stdout
    with open(os.path.join(GOLDEN_DIR, "golden.vcf"), "rb") as f:
        assert out.read_bytes() == f.read()


@pytest.mark.cuda
def test_golden_fixture_bytes_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    vcf, report, counts = run(
        run_caller, golden_cfg(tmp_path, device="cuda"), resolve_device("cuda")
    )
    with open(os.path.join(GOLDEN_DIR, "golden.vcf"), "rb") as f:
        assert vcf == f.read()
    assert counts["tier_fused"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
def test_column_tier_on_card_matches_cpu(exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(9)
    n = 70_000  # three column chunks
    counts = rng.integers(0, 30, size=(n, 8)).astype(np.int32)
    counts[rng.random((n, 8)) < 0.5] = 0
    quals = np.where(counts > 0, rng.integers(20, 44, (n, 8)), 0).astype(
        np.int32
    )
    ref = rng.integers(0, 5, n).astype(np.int32)
    cfg = CallerConfig(exact=exact)
    got = TorchCallEngine(cfg, resolve_device("cuda"))._call_batch(
        counts, quals, ref
    )
    want = TorchCallEngine(cfg, CPU)._call_batch(counts, quals, ref)
    tol = 1e-12 if exact else 2e-5
    clear = want[2] > (1e-9 if exact else 1e-3)
    np.testing.assert_array_equal(got[1][clear], want[1][clear])
    np.testing.assert_allclose(got[0], want[0], rtol=tol, atol=tol)
