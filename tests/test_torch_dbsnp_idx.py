"""The dbSNP index builder's CLI in the port (`python -m
bs_call_tpu_torch.io.dbsnp_idx`, the port's copy of
`bs_call_tpu.io.dbsnp_idx`, the reference's second binary) against the
JAX package's: BED, VCF and NCBI refsnp JSON inputs, plain, gzip, bzip2
and xz, with `-t`, `-c`, `-s`, `-m` and `-d`, give the JAX `main`'s index
bytes; so do `-@ 2` over files on disjoint contigs (the workers' encoded
sections merged as they are) and over files that share a contig (the
serial re-merge); and the caller with `-D` on the port's index writes the
JAX caller's VCF."""

import bz2
import gzip
import json
import lzma
import os
import subprocess
import sys

import numpy as np
import pytest

from bs_call_tpu import cli as jax_cli
from bs_call_tpu.io import dbsnp_idx as J
from bs_call_tpu_torch import cli
from bs_call_tpu_torch.io import dbsnp_idx as P

from make_golden import build_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# contig names as a distribution writes them, and the alias file's map
ALIASES = {"1": "chr1", "2": "chr2", "MT": "chrM"}


def snps(seed, n=400):
    """(contig, 1-based pos, name, allele count, total count) rows: three
    contigs under their distribution names, three name prefixes,
    duplicate positions, MAFs on both sides of 0.2."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        ctg = ["1", "2", "MT"][int(rng.integers(0, 3))]
        pos = int(rng.integers(1, 20_000))
        pref = ["rs", "ss", "esv"][int(rng.integers(0, 3))]
        tc = int(rng.integers(0, 200))
        ac = int(rng.integers(0, tc + 1))
        rows.append((ctg, pos, f"{pref}{pos}", ac, tc))
    rows.append(rows[5][:2] + ("rs424242",) + rows[5][3:])  # duplicate pos
    return rows


def json_line(ctg, pos, name, ac, tc):
    spdi = {"seq_id": ctg, "position": pos, "deleted_sequence": "C",
            "inserted_sequence": "T"}
    freq = [{"study_name": "S", "allele_count": ac, "total_count": tc,
             "observation": {"deleted_sequence": "C",
                             "inserted_sequence": "T"}}] if tc else []
    return json.dumps({
        "refsnp_id": name[2:] if name.startswith("rs") else str(pos),
        "primary_snapshot_data": {
            "placements_with_allele": [
                {"is_ptlp": True, "alleles": [{"allele": {"spdi": spdi}}]},
                {"is_ptlp": False, "alleles": []},
            ],
            "allele_annotations": [{"frequency": freq}],
        },
    })


def text(fmt, rows):
    if fmt == "bed":
        return "track name=dbsnp_test\n" + "".join(
            f"{c}\t{p - 1}\t{p}\t{n}\t0\n" for c, p, n, _a, _t in rows
        ) + "1\t50\t52\tlong\t0\n"
    if fmt == "vcf":
        return ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\n" + "".join(
            f"{c}\t{p}\t{n}\tC\tT\n" for c, p, n, _a, _t in rows)
            + "1\t77\trsindel\tCT\tT\n")
    return "".join(json_line(*r) + "\n" for r in rows) + "{not json\n"


COMPRESS = {"plain": lambda b: b, "gz": gzip.compress, "bz2": bz2.compress,
            "xz": lzma.compress}


@pytest.fixture(scope="module")
def side_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dbsnp_side")
    alias = tmp / "alias.txt"
    alias.write_text("".join(f"{k}\t{v}\n" for k, v in ALIASES.items()))
    sel = tmp / "selected.txt"
    sel.write_text("".join(f"{n}\n" for _c, _p, n, _a, _t in snps(1)[::9]))
    return str(alias), str(sel)


def both(tmp, inputs, flags):
    """Index bytes of the port's main and the JAX package's on the same
    inputs and flags."""
    out = []
    for tag, main in (("port", P.main), ("jax", J.main)):
        path = str(tmp / f"{tag}.bin")
        assert main([*inputs, "-o", path, *flags]) == 0
        with open(path, "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("comp", list(COMPRESS))
@pytest.mark.parametrize("fmt", ["bed", "vcf", "json"])
def test_main_writes_the_jax_index(tmp_path, side_files, fmt, comp):
    alias, sel = side_files
    src = tmp_path / f"in.{fmt}.{comp}"
    src.write_bytes(COMPRESS[comp](text(fmt, snps(1)).encode()))
    runs = [
        [],
        ["-t", fmt.upper(), "-c", alias],
        ["-c", alias, "-s", sel, "-m", "0.2", "-d", "name=sel description"],
    ]
    for flags in runs:
        got, want = both(tmp_path, [str(src)], flags)
        assert got == want and len(got) > 64


def shard_files(tmp, shared):
    """Three BED files: on disjoint contigs, or with chr1 in all three
    (and one position in two of them)."""
    rng = np.random.default_rng(4)
    paths = []
    for fi in range(3):
        p = tmp / f"part{fi}.bed"
        with open(p, "w") as f:
            if fi == 0:
                f.write("track name=par\n")
            ctg0 = "chr1" if shared else f"chr{fi + 1}"
            # every file meets the name prefixes in one order, as the
            # merge of encoded sections requires
            for k, pref in enumerate(("rs", "ss", "esv")):
                f.write(f"{ctg0}\t{k}\t{k + 1}\t{pref}{fi}\t0\n")
            for _ in range(500):
                pos = int(rng.integers(1, 50_000))
                pref = ["rs", "ss", "esv"][int(rng.integers(0, 3))]
                ctg = "chr1" if shared else f"chr{fi + 1}"
                f.write(f"{ctg}\t{pos - 1}\t{pos}\t{pref}{pos}\t0\n")
            if shared:
                f.write(f"chr1\t99\t100\trs77{fi}\t0\n")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("shared", [False, True], ids=["disjoint", "shared"])
def test_parallel_build_writes_the_serial_bytes(tmp_path, shared):
    files = shard_files(tmp_path, shared)
    jobs = [(p, "auto", 1.0, [], None) for p in files]
    shards = [P._build_one_file(j) for j in jobs]
    # disjoint contigs: the workers' sections are merged as they are;
    # a shared contig sends the build to the serial re-merge
    assert P._merge_prebuilt(P.DbSnpIndexBuilder(), shards) is not shared
    _port, serial = both(tmp_path, files, [])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = tmp_path / "par.bin"
    r = subprocess.run(
        [sys.executable, "-m", "bs_call_tpu_torch.io.dbsnp_idx", *files,
         "-o", str(out), "-@", "2"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "Indexed" in r.stderr
    assert out.read_bytes() == serial


def test_caller_with_the_port_index_writes_the_jax_vcf(tmp_path):
    ref, bam, _idx = build_fixture(str(tmp_path))
    bed = tmp_path / "golden.bed"
    bed.write_text("".join(f"chr1\t{p - 1}\t{p}\trs{p}\t0\n"
                           for p in range(3, 4000, 7)))
    out = {}
    for tag, main, caller, dev in (("port", P.main, cli.main, "cpu"),
                                   ("jax", J.main, jax_cli.main, "cpu")):
        idx = str(tmp_path / f"{tag}.bin")
        assert main([str(bed), "-o", idx, "-d", "name=golden"]) == 0
        vcf = tmp_path / f"{tag}.vcf"
        assert caller([bam, "-r", ref, "-D", idx, "--benchmark-mode",
                       "-o", str(vcf), "--device", dev]) == 0
        out[tag] = vcf.read_bytes()
    assert out["port"] == out["jax"]
    assert out["port"].count(b"\trs") > 20
