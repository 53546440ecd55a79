"""`--shards N` in the port (`bs_call_tpu_torch.parallel.shard_runner`,
the port's copy of `bs_call_tpu.parallel.shard_runner`) against the JAX
package: `partition_contigs` and `concat_vcfs` (text VCF, BGZF VCF, raw
and compressed BCF; the trusted fast path, its fallback and the record
merge) give the JAX package's bytes on the same inputs; the port's CLI
with `--shards 2` and BS_CALL_FORCE_SHARDS=1 writes the VCF and report
bytes of the port's single process and of `bs_call_tpu --shards 2`, with
`bs_call_tpu` and `jax` unimportable in the parent and in every worker;
below the core threshold it degrades to one process and says so; it
refuses -C, stdin and a missing -o as the reference does; a worker that
dies is retried; workers resolve `--device` themselves, so `cuda` raises
in a worker that sees no card. On the card (marked `cuda`) the workers
run the fused tier through K12 and K3."""

import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from bs_call_tpu import constants as JC
from bs_call_tpu.io.dbsnp_idx import DbSnpIndexBuilder
from bs_call_tpu.parallel import shard_runner as jax_sr
from bs_call_tpu_torch import cli
from bs_call_tpu_torch import constants as C
from bs_call_tpu_torch.config import CallerConfig
from bs_call_tpu_torch.parallel import shard_runner as SR
from bs_call_tpu_torch.parity import strip_date
from bs_call_tpu_torch.utils.trace import Tracer

from test_shard_runner import make_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("bs_call_tpu", "jax")


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7])
def test_partition_contigs_equals_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    names_lens = [(f"c{i}", int(rng.integers(1, 5)) * 1000)
                  for i in range(6)]  # ties in length
    assert SR.partition_contigs(names_lens, n_shards) == \
        jax_sr.partition_contigs(names_lens, n_shards)


# ---- concat_vcfs on shard files written here ----

HEADER = ("##fileformat=VCFv4.2\n"
          + "".join(f"##contig=<ID=chr{i}>\n" for i in (1, 2, 3))
          + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
ORDER = ["chr1", "chr2", "chr3"]


def text_shards(tmp, split):
    """Two text shards. Whole contigs (chr1 + chr3, chr2), or with chr1
    split across both (`split`), which the fast path must refuse."""
    def recs(ctg, lo, hi):
        return "".join(f"{ctg}\t{p}\t.\tA\tC\t30\tPASS\tDP={p % 7}\n"
                       for p in range(lo, hi, 3))
    parts = ([recs("chr1", 1, 60) + recs("chr3", 1, 40), recs("chr2", 5, 90)]
             if not split else
             [recs("chr1", 1, 30) + recs("chr3", 1, 40),
              recs("chr1", 31, 60) + recs("chr2", 5, 90)])
    paths = []
    for i, body in enumerate(parts):
        p = os.path.join(tmp, f"s{i}.vcf")
        with open(p, "w") as f:
            f.write(HEADER + body)
        paths.append(p)
    return paths


def bcf_shards(tmp):
    """Two raw-BCF shards (the second BGZF-compressed) whose records, by
    (rid, pos), interleave."""
    text = HEADER.encode() + b"\0"
    paths = []
    for i, recs in enumerate(([(0, 5), (0, 40), (2, 1)],
                              [(0, 20), (1, 3), (1, 9)])):
        body = b"BCF\x02\x02" + struct.pack("<I", len(text)) + text
        for rid, pos in recs:
            shared = struct.pack("<ii", rid, pos) + bytes([rid, pos % 256]) * 6
            indiv = bytes([7, rid, pos % 256])
            body += (struct.pack("<II", len(shared), len(indiv)) + shared
                     + indiv)
        p = os.path.join(tmp, f"s{i}.bcf")
        with open(p, "wb") as f:
            f.write(gzip.compress(body) if i else body)
        paths.append(p)
    return paths


@pytest.mark.parametrize("mode", ["fast", "split", "record", "no_order"])
@pytest.mark.parametrize("out", ["v", "z"])
def test_concat_text_equals_jax(tmp_path, mode, out):
    """The trusted fast path (whole contigs: byte-range copies), its
    fallback (a contig split across shards), the record merge (not
    trusted) and plain concatenation (no contig order)."""
    paths = text_shards(str(tmp_path), split=mode == "split")
    ft = {"v": C.FT_VCF, "z": C.FT_VCF_GZ}[out]
    assert ft == {"v": JC.FT_VCF, "z": JC.FT_VCF_GZ}[out]
    kw = dict(contig_order=None if mode == "no_order" else ORDER,
              out_file_type=ft, trusted=mode in ("fast", "split"))
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    SR.concat_vcfs(paths, got, **kw)
    jax_sr.concat_vcfs(paths, want, **kw)
    with open(got, "rb") as f, open(want, "rb") as g:
        a, b = f.read(), g.read()
    assert a == b and len(a) > len(HEADER)
    text = gzip.decompress(a) if out == "z" else a
    if mode != "no_order":
        ctgs = [ln.split(b"\t")[0] for ln in text.splitlines()
                if not ln.startswith(b"#")]
        assert ctgs == sorted(ctgs)  # chr1 < chr2 < chr3, contig order


@pytest.mark.parametrize("out", ["u", "b"])
def test_concat_bcf_equals_jax(tmp_path, out):
    paths = bcf_shards(str(tmp_path))
    ft = {"u": C.FT_BCF, "b": C.FT_BCF_GZ}[out]
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    SR.concat_vcfs(paths, got, contig_order=ORDER, out_file_type=ft)
    jax_sr.concat_vcfs(paths, want, contig_order=ORDER, out_file_type=ft)
    with open(got, "rb") as f, open(want, "rb") as g:
        a, b = f.read(), g.read()
    assert a == b
    raw = gzip.decompress(a) if out == "b" else a
    assert raw.startswith(b"BCF\x02\x02") and raw.count(b"\x07") >= 6


# ---- the CLI end to end ----

# the port's CLI with bs_call_tpu and jax unimportable; run from a file,
# so that every spawned worker (which imports the parent's main module)
# installs the block too before it unpickles its job
_BLOCKED_MAIN = f"""import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())

if __name__ == "__main__":
    from bs_call_tpu_torch import cli
    rc = cli.main(sys.argv[1:])
    print("LOADED", sorted(m for m in sys.modules
                           if m.split(".")[0] in {BLOCKED!r}), rc)
    sys.exit(rc)
"""


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """Three contigs of reads (`tests/test_shard_runner.py`'s) and a
    dbSNP index over all three."""
    tmp = tmp_path_factory.mktemp("shards")
    ref, bam = make_fixture(tmp)
    b = DbSnpIndexBuilder(header="track name=t")
    for ctg in ORDER:
        for pos in range(5, 1000, 37):
            b.add_snp(ctg, pos, f"rs{pos}")
    b.write(str(tmp / "idx.bin"))
    return tmp, [bam, "-r", ref, "-D", str(tmp / "idx.bin"),
                 "--benchmark-mode"]


def env_for(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "BS_CALL_FORCE_SHARDS")}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def outputs(tmp, tag):
    with open(tmp / f"{tag}.vcf", "rb") as f, open(tmp / f"{tag}.json") as g:
        return f.read(), strip_date(g.read())


@pytest.fixture(scope="module")
def single(fixture):
    """VCF and report of the port's single process, in this process."""
    tmp, args = fixture
    assert cli.main([*args, "-o", str(tmp / "single.vcf"), "--report-file",
                     str(tmp / "single.json"), "--device", "cpu"]) == 0
    return outputs(tmp, "single")


@pytest.fixture(scope="module")
def runs(fixture, single):
    """VCF and report of the port's --shards 2 (blocked imports, forced
    sharding, --device cpu), of the port's single process and of
    `bs_call_tpu --shards 2`."""
    tmp, args = fixture
    main = tmp / "run_blocked.py"
    main.write_text(_BLOCKED_MAIN)
    res = subprocess.run(
        [sys.executable, str(main), *args, "-o", str(tmp / "sharded.vcf"),
         "--report-file", str(tmp / "sharded.json"), "--device", "cpu",
         "--shards", "2"],
        env=env_for(BS_CALL_FORCE_SHARDS="1"), capture_output=True,
        text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    ref = subprocess.run(
        [sys.executable, "-m", "bs_call_tpu.cli", *args, "-o",
         str(tmp / "jax.vcf"), "--report-file", str(tmp / "jax.json"),
         "--device", "numpy", "--shards", "2"],
        env=env_for(BS_CALL_FORCE_SHARDS="1"), capture_output=True,
        text=True, timeout=600,
    )
    assert ref.returncode == 0, ref.stderr[-3000:]
    return {"sharded": outputs(tmp, "sharded"), "single": single,
            "jax": outputs(tmp, "jax")}, res.stdout


@pytest.mark.parametrize("other", ["single", "jax"])
@pytest.mark.parametrize("what", ["vcf", "report"])
def test_sharded_bytes_equal(runs, other, what):
    out, _stdout = runs
    i = ("vcf", "report").index(what)
    assert out["sharded"][i] == out[other][i]
    if what == "vcf":
        recs = [ln for ln in out["sharded"][0].splitlines()
                if not ln.startswith(b"#")]
        assert {ln.split(b"\t")[0] for ln in recs} == {b"chr1", b"chr2",
                                                       b"chr3"}
        assert b"\trs" in out["sharded"][0]  # the dbSNP names


def test_sharded_run_imports_neither_jax_nor_the_jax_package(runs):
    """The parent prints what it loaded; a worker that imported either
    would have failed twice, and the run with it."""
    _out, stdout = runs
    assert "LOADED [] 0" in stdout


def test_shards_degrade_below_the_core_threshold(fixture, single, capsys,
                                                 monkeypatch):
    tmp, args = fixture
    monkeypatch.delenv("BS_CALL_FORCE_SHARDS", raising=False)
    monkeypatch.setenv("BS_CALL_SHARD_MIN_CORES", "9999")
    assert cli.main([*args, "-o", str(tmp / "degraded.vcf"),
                     "--report-file", str(tmp / "degraded.json"),
                     "--device", "cpu", "--shards", "2"]) == 0
    assert "running single-process" in capsys.readouterr().err
    assert outputs(tmp, "degraded") == single


@pytest.mark.parametrize("case", ["contig_bed", "stdin", "no_output"])
def test_shards_refusals(fixture, capsys, monkeypatch, case):
    tmp, args = fixture
    monkeypatch.setenv("BS_CALL_FORCE_SHARDS", "1")
    bed = tmp / "r.bed"
    bed.write_text("chr1\t0\t500\n")
    argv = {"contig_bed": [*args, "-o", str(tmp / "x.vcf"), "-C", str(bed)],
            "stdin": [*args[1:], "-o", str(tmp / "x.vcf")],
            "no_output": list(args)}[case]
    assert cli.main([*argv, "--device", "cpu", "--shards", "2"]) == 1
    err = capsys.readouterr().err
    assert {"contig_bed": "cannot be combined with -C",
            "stdin": "cannot shard a stdin stream",
            "no_output": "--shards requires -o"}[case] in err
    assert not (tmp / "x.vcf").exists()


def sharded_cfg(fixture, **kw):
    tmp, args = fixture
    return CallerConfig(input_file=args[0], reference_file=args[2],
                        dbsnp_file=args[4], benchmark_mode=True, **kw)


def test_crashed_worker_is_retried(fixture, single, tmp_path, monkeypatch):
    """Each shard's first worker dies as an OOM-kill would
    (BS_CALL_TEST_SHARD_CRASH); the retry writes the single process's
    bytes, and the partial outputs are gone from the scratch directory
    (BS_CALL_SHARD_TMP) after the concat."""
    crash = tmp_path / "crash"
    scratch = tmp_path / "scratch"
    crash.mkdir()
    scratch.mkdir()
    monkeypatch.setenv("BS_CALL_TEST_SHARD_CRASH", str(crash))
    monkeypatch.setenv("BS_CALL_SHARD_TMP", str(scratch))
    out = tmp_path / "retried.vcf"
    tracer = Tracer()
    SR.run_sharded(sharded_cfg(fixture), "cpu", 2, str(out), tracer=tracer)
    assert len(list(crash.iterdir())) == 2
    assert out.read_bytes() == single[0]
    assert list(scratch.iterdir()) == []
    # the workers' counts, summed: the plain fused tier carried the calls
    assert tracer.counts["tier_fused"] > 0
    assert tracer.counts["launches_pileup_genotype"] == 0


def test_bcf_sharded_equals_single(fixture, tmp_path):
    """-O b: shards are raw BCF, compressed at the concat."""
    from bs_call_tpu_torch.pipeline.runner import run_caller

    single = tmp_path / "single.bcf"
    with open(single, "wb") as f:
        run_caller(sharded_cfg(fixture, out_file_type=C.FT_BCF_GZ),
                   torch.device("cpu"), out_fileobj=f)
    sharded = tmp_path / "sharded.bcf"
    SR.run_sharded(sharded_cfg(fixture, out_file_type=C.FT_BCF_GZ), "cpu", 2,
                   str(sharded))
    assert gzip.decompress(sharded.read_bytes()) == \
        gzip.decompress(single.read_bytes())


def test_workers_resolve_the_device(fixture, tmp_path):
    """The parent opens no device; a worker asked for `cuda` without a
    card raises resolve_device's error (twice: the retry), and nothing is
    written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "x.vcf"
    with pytest.raises(RuntimeError, match="failed after 2 attempts") as e:
        SR.run_sharded(sharded_cfg(fixture), "cuda", 2, str(out))
    assert "no CUDA device" in str(e.value.__cause__)
    assert not out.exists()


@pytest.mark.cuda
def test_sharded_on_card_equals_single(fixture, single, tmp_path):
    """--shards 2 --device cuda: the single process's bytes, and the
    workers' fused tier ran through K12 and K3 (their launch counts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _tmp, args = fixture
    tracer = Tracer()
    os.environ["BS_CALL_FORCE_SHARDS"] = "1"
    try:
        rc = cli.main([*args, "-o", str(tmp_path / "card.vcf"),
                       "--report-file", str(tmp_path / "card.json"),
                       "--device", "cuda", "--shards", "2"], tracer=tracer)
    finally:
        del os.environ["BS_CALL_FORCE_SHARDS"]
    assert rc == 0
    assert (tmp_path / "card.vcf").read_bytes() == single[0]
    assert strip_date((tmp_path / "card.json").read_text()) == single[1]
    chunks = tracer.counts["fused_chunks"]
    assert chunks > 0
    assert tracer.counts["launches_pileup_genotype"] == chunks
    assert tracer.counts["launches_emit_fields"] == chunks


def test_whole_contig_regions_keep_the_fused_tier(fixture, tmp_path):
    """A shard worker runs with -C regions that each span a whole contig.
    Its blocks must be cut into the fused tier's chunks as a run without
    regions cuts them, or every block wider than a chunk leaves the fused
    tier for the column tier ("shape" reroutes: 98% of the 600k fixture's
    positions in a sharded run on the card). Chunks of 1,024 positions
    here, so that this fixture's blocks are wider than one."""
    import io

    from bs_call_tpu_torch.pipeline.runner import run_caller

    tmp, _args = fixture
    bed = tmp_path / "whole.bed"
    bed.write_text("".join(f"{c}\t0\t{n}\n" for c, n in
                           zip(ORDER, (2000, 1500, 1000))))
    runs = {}
    for tag, extra in (("plain", {}), ("regions", {"contig_bed": str(bed)})):
        tracer, out = Tracer(), io.BytesIO()
        run_caller(sharded_cfg(fixture, batch_positions=1024, **extra),
                   torch.device("cpu"), out_fileobj=out, tracer=tracer)
        runs[tag] = out.getvalue(), dict(tracer.counts)
    (plain, c_plain), (regions, c_regions) = runs["plain"], runs["regions"]
    assert regions == plain
    assert c_plain["tier_fused"] > 1024 and c_plain["tier_shape_reroute"] == 0
    assert c_regions["tier_shape_reroute"] == 0
    assert c_regions["tier_fused"] == c_plain["tier_fused"]
