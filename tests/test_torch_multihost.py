"""`--num-hosts` in the port end to end, as `tests/test_multihost.py`
drives the JAX package's: two CLI processes (`--device cpu`) meet at a
local coordinator, a gloo process group, each calls its contig assignment
and writes its own VCF, and host 0 writes the report merged over gloo.
The hosts' files, concatenated by `python -m bs_call_tpu_torch.concat`,
must be the bytes of the port's single-process run and of `bs_call_tpu`'s,
and host 0's report (date stripped) theirs. `bs_call_tpu_torch.concat`
writes the bytes of `bs_call_tpu.concat` on the same host files, VCF and
BCF, in any argument order."""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTG_LEN, N_CONTIGS = 4000, 4


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """`tests/test_multihost.py`'s WGBS fixture (the port's copy of the
    generator): 600 read pairs on each of four contigs, a dbSNP index, and
    the contig sizes a multi-host run puts in every host's header."""
    from bs_call_tpu_torch.utils.synth import (
        make_dbsnp_index,
        make_wgbs_fixture,
    )

    tmp = tmp_path_factory.mktemp("mh")
    ref, bam, _n = make_wgbs_fixture(str(tmp), 600, CTG_LEN, seed=11,
                                     n_contigs=N_CONTIGS)
    names = [f"chr{i + 1}" for i in range(N_CONTIGS)]
    dbsnp = make_dbsnp_index(str(tmp / "dbsnp.bin"), names, CTG_LEN,
                             every=101)
    sizes = tmp / "sizes.txt"
    sizes.write_text("".join(f"{n}\t{CTG_LEN}\n" for n in names))
    return tmp, ref, bam, dbsnp, str(sizes)


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, e.get("PYTHONPATH")) if p)
    e["JAX_PLATFORMS"] = "cpu"
    e.pop("XLA_FLAGS", None)
    return e


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli(pkg, *argv, device="cpu"):
    """Run `python -m <pkg>.cli` to its end; assert it succeeded."""
    r = subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli", *argv, "--benchmark-mode",
         "--device", device],
        env=env(), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]


def concat(pkg, *argv):
    r = subprocess.run([sys.executable, "-m", f"{pkg}.concat", *argv],
                       env=env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-1500:]


def strip_date(path):
    rep = json.loads(path.read_text())
    rep.pop("date", None)
    return rep


def test_two_hosts_over_gloo_equal_one_process(fixture):
    tmp, ref, bam, dbsnp, sizes = fixture
    common = [bam, "-r", ref, "-D", dbsnp]
    cli("bs_call_tpu_torch", *common, "-o", str(tmp / "port.vcf"),
        "--report-file", str(tmp / "port.json"), "-s", sizes)
    cli("bs_call_tpu", *common, "-o", str(tmp / "jax.vcf"),
        "--report-file", str(tmp / "jax.json"), "-s", sizes, device="numpy")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bs_call_tpu_torch.cli", *common,
         "-o", str(tmp / f"host{h}.vcf"),
         "--report-file", str(tmp / f"host{h}.json"), "--benchmark-mode",
         "--device", "cpu", "--num-hosts", "2", "--host-id", str(h),
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
    # host 1 first: the tool orders the files by their first contig
    concat("bs_call_tpu_torch", str(tmp / "host1.vcf"),
           str(tmp / "host0.vcf"), "-o", str(tmp / "cat.vcf"))
    cat = (tmp / "cat.vcf").read_bytes()
    assert cat == (tmp / "port.vcf").read_bytes()
    assert cat == (tmp / "jax.vcf").read_bytes()
    # each host called some contigs; host 0 alone wrote the merged report
    assert all(b"\nchr" in (tmp / f"host{h}.vcf").read_bytes()
               for h in range(2))
    rep0 = strip_date(tmp / "host0.json")
    assert rep0 == strip_date(tmp / "port.json")
    assert rep0 == strip_date(tmp / "jax.json")
    assert not (tmp / "host1.json").exists()


@pytest.mark.parametrize("ext, otype", [("vcf", "v"), ("bcf", "u")])
def test_concat_cli_equals_jax_tool(fixture, ext, otype):
    """`tests/test_multihost.py::test_concat_cli`: two hosts without a
    coordinator (each its own run), merged by the port's tool with the
    files in reverse order, give the single-process bytes and those of
    `bs_call_tpu.concat`."""
    tmp, ref, bam, _dbsnp, sizes = fixture
    single = tmp / f"single.{ext}"
    cli("bs_call_tpu_torch", bam, "-r", ref, "-o", str(single), "-O", otype,
        "-s", sizes)
    hosts = [str(tmp / f"h{h}.{ext}") for h in range(2)]
    for h, out in enumerate(hosts):
        cli("bs_call_tpu_torch", bam, "-r", ref, "-o", out, "-O", otype,
            "--num-hosts", "2", "--host-id", str(h))
    for pkg in ("bs_call_tpu_torch", "bs_call_tpu"):
        concat(pkg, hosts[1], hosts[0], "-o", str(tmp / f"{pkg}.{ext}"),
               "-O", otype)
    merged = (tmp / f"bs_call_tpu_torch.{ext}").read_bytes()
    assert merged == single.read_bytes()
    assert merged == (tmp / f"bs_call_tpu.{ext}").read_bytes()


def test_concat_refuses_mixed_kinds(fixture):
    tmp, ref, bam, _dbsnp, sizes = fixture
    for ext, otype in (("vcf", "v"), ("bcf", "u")):
        cli("bs_call_tpu_torch", bam, "-r", ref, "-o",
            str(tmp / f"mix.{ext}"), "-O", otype, "--num-hosts", "2",
            "--host-id", "0")
    r = subprocess.run(
        [sys.executable, "-m", "bs_call_tpu_torch.concat",
         str(tmp / "mix.vcf"), str(tmp / "mix.bcf"), "-o",
         str(tmp / "mixed.vcf")],
        env=env(), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 1
    assert "must all be VCF text" in r.stderr
