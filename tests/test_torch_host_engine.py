"""`--device numpy` in the port (`pipeline.engine.HostCallEngine`): the
Python record path and the host f64 model on every covered position,
held to `bs_call_tpu --device numpy`. The port's `genotype_np` gives the
JAX package's bits, its native model (`ops/genotype_native.py`) agrees
with `genotype_np` within `tests/test_native_model.py`'s tolerance, the
CLI writes the JAX CLI's VCF, BCF, VCF.gz and report bytes on the golden
fixture (exact and `--no-exact`, native model and BS_CALL_PY_MODEL=1),
`--shards 2` and two `--num-hosts` processes write the single process's
bytes, and a native library that does not load raises: nothing falls
back."""

import os
import subprocess
import sys

import numpy as np
import pytest

from bs_call_tpu import cli as jax_cli
from bs_call_tpu.ops import genotype_np as j_np
from bs_call_tpu_torch import cli
from bs_call_tpu_torch.config import CallerConfig
from bs_call_tpu_torch.ops import genotype_native
from bs_call_tpu_torch.ops import genotype_np as p_np
from bs_call_tpu_torch.parity import strip_date
from bs_call_tpu_torch.pipeline.engine import HostCallEngine

from make_golden import build_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = (0.01, 0.05, 2.0)


def batch(seed, n=20_000):
    """`tests/test_native_model.py`'s random batch: counts 0..29, half
    the categories empty, quals 0..43, every ref code."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, (n, 8)).astype(np.int32)
    counts[rng.random((n, 8)) < 0.5] = 0
    quals = np.where(counts > 0, rng.integers(0, 44, (n, 8)), 0).astype(
        np.int32)
    ref = rng.integers(0, 5, n).astype(np.int32)
    return counts, quals, ref


def test_genotype_np_equals_jax_package():
    counts, quals, ref = batch(3, 4000)
    got = p_np.call_genotypes_np(counts, quals, ref, *PARAMS)
    want = j_np.call_genotypes_np(counts, quals, ref, *PARAMS)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_native_model_matches_genotype_np(seed):
    model = genotype_native.native_model(*PARAMS)
    counts, quals, ref = batch(seed)
    gp, mx, mg, off = model.call(counts, quals, ref)
    gp2, mx2, mg2, off2 = p_np.call_genotypes_np(counts, quals, ref, *PARAMS)
    np.testing.assert_allclose(gp, gp2, rtol=0, atol=1e-10)
    np.testing.assert_allclose(mg, mg2, rtol=0, atol=1e-10)
    np.testing.assert_allclose(off, off2, rtol=0, atol=1e-10)
    # argmax may differ only at true ties (both are then oracle-rescued)
    assert (mg2[mx != mx2] < 1e-9).all()


def test_host_engine_calls_every_row_through_the_model(monkeypatch):
    """Exact or not, the host model carries the batch; under
    BS_CALL_PY_MODEL=1 it is `call_genotypes_np`."""
    counts, quals, ref = batch(2, 3000)
    for exact in (True, False):
        eng = HostCallEngine(CallerConfig(exact=exact))
        assert not eng.wants_reads() and eng.devices == []
        got = eng._call_batch(counts.copy(), quals, ref)
        want = genotype_native.native_model(*PARAMS).call(counts, quals, ref)
        np.testing.assert_array_equal(got[2], want[2])
        assert eng.column_chunks == eng.fused_chunks == 0
    monkeypatch.setenv("BS_CALL_PY_MODEL", "1")
    eng = HostCallEngine(CallerConfig(exact=False))
    got = eng._call_batch(counts, quals, ref)
    want = p_np.call_genotypes_np(counts, quals, ref, *PARAMS)
    np.testing.assert_array_equal(got[2], want[2])


def golden_args(tmp):
    ref, bam, idx = build_fixture(str(tmp))
    return [bam, "-r", ref, "-D", idx, "--benchmark-mode", "-n", "golden",
            "-L", "2,1", "-R", "1,0", "--device", "numpy"]


@pytest.mark.parametrize("model", ["native", "py"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "no_exact"])
@pytest.mark.parametrize("kind", ["vcf", "bcf", "vcf_gz", "report"])
def test_cli_bytes_equal_the_jax_cli(tmp_path, monkeypatch, kind, exact,
                                     model):
    if model == "py":
        monkeypatch.setenv("BS_CALL_PY_MODEL", "1")
    args = golden_args(tmp_path)
    if not exact:
        args.append("--no-exact")
    flags = {"vcf": ["-O", "v"], "bcf": ["-O", "b"], "vcf_gz": ["-O", "z"],
             "report": []}[kind]
    for pkg, main in (("port", cli.main), ("jax", jax_cli.main)):
        rep = ["--report-file", str(tmp_path / f"{pkg}.json")]
        assert main([*args, "-o", str(tmp_path / pkg), *flags,
                     *(rep if kind == "report" else [])]) == 0
    got = (tmp_path / "port").read_bytes()
    assert got == (tmp_path / "jax").read_bytes() and len(got) > 1000
    if kind == "report":
        assert strip_date((tmp_path / "port.json").read_text()) == \
            strip_date((tmp_path / "jax.json").read_text())


def test_runner_takes_the_python_record_path(tmp_path, monkeypatch):
    """`--device numpy` never asks for the native ingest pipeline, and
    builds no torch engine."""
    from bs_call_tpu_torch.pipeline import engine, runner

    def refuse(*a, **k):
        raise AssertionError("not on --device numpy")

    monkeypatch.setattr(runner, "_try_native", refuse)
    monkeypatch.setattr(engine.TorchCallEngine, "__init__", refuse)
    out = tmp_path / "x.vcf"
    assert cli.main([*golden_args(tmp_path), "-o", str(out)]) == 0
    assert out.stat().st_size > 1000


def test_cli_raises_without_the_native_library(tmp_path, monkeypatch):
    from bs_call_tpu_torch import native

    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.setattr(genotype_native, "_cache", {})
    out = tmp_path / "x.vcf"
    with pytest.raises(RuntimeError, match="native host library"):
        cli.main([*golden_args(tmp_path), "-o", str(out)])
    assert not out.exists()


# ---- --shards 2 and --num-hosts 2 ----

@pytest.fixture(scope="module")
def wgbs(tmp_path_factory):
    """`tests/test_torch_multihost.py`'s fixture: four contigs of 4 kb,
    600 read pairs each, a dbSNP index, the contig sizes."""
    from bs_call_tpu_torch.utils.synth import (
        make_dbsnp_index,
        make_wgbs_fixture,
    )

    tmp = tmp_path_factory.mktemp("numpy_mp")
    ref, bam, _n = make_wgbs_fixture(str(tmp), 600, 4000, seed=11,
                                     n_contigs=4)
    names = [f"chr{i + 1}" for i in range(4)]
    dbsnp = make_dbsnp_index(str(tmp / "dbsnp.bin"), names, 4000, every=101)
    sizes = tmp / "sizes.txt"
    sizes.write_text("".join(f"{n}\t4000\n" for n in names))
    common = [bam, "-r", ref, "-D", dbsnp, "-s", str(sizes),
              "--benchmark-mode", "--device", "numpy"]
    assert cli.main([*common, "-o", str(tmp / "single.vcf"),
                     "--report-file", str(tmp / "single.json")]) == 0
    return tmp, common


def env(**extra):
    e = {k: v for k, v in os.environ.items()
         if k not in ("PYTHONPATH", "BS_CALL_FORCE_SHARDS", "XLA_FLAGS")}
    e["PYTHONPATH"] = REPO
    e.update(extra)
    return e


def test_shards_equal_one_process(wgbs):
    tmp, common = wgbs
    res = subprocess.run(
        [sys.executable, "-m", "bs_call_tpu_torch.cli", *common,
         "-o", str(tmp / "sharded.vcf"), "--report-file",
         str(tmp / "sharded.json"), "--shards", "2"],
        env=env(BS_CALL_FORCE_SHARDS="1"), capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert (tmp / "sharded.vcf").read_bytes() == \
        (tmp / "single.vcf").read_bytes()
    assert strip_date((tmp / "sharded.json").read_text()) == \
        strip_date((tmp / "single.json").read_text())


def test_two_hosts_equal_one_process(wgbs):
    import socket

    tmp, common = wgbs
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bs_call_tpu_torch.cli", *common,
         "-o", str(tmp / f"host{h}.vcf"), "--report-file",
         str(tmp / f"host{h}.json"), "--num-hosts", "2", "--host-id", str(h),
         "--coordinator", f"127.0.0.1:{port}"],
        env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for h in range(2)]
    try:
        for p in procs:
            _out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    r = subprocess.run(
        [sys.executable, "-m", "bs_call_tpu_torch.concat",
         str(tmp / "host1.vcf"), str(tmp / "host0.vcf"), "-o",
         str(tmp / "cat.vcf")],
        env=env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-1500:]
    assert (tmp / "cat.vcf").read_bytes() == (tmp / "single.vcf").read_bytes()
    assert strip_date((tmp / "host0.json").read_text()) == \
        strip_date((tmp / "single.json").read_text())
    assert not (tmp / "host1.json").exists()
