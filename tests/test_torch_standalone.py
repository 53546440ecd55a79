"""`bs_call_tpu_torch` stands alone: no module of the port and nothing in
`chip_smoke.py` imports `bs_call_tpu` or JAX (an AST walk); with both
blocked at import time, every port module imports and the port's CLI
writes the golden VCF, BCF, VCF.gz and report bytes on the CPU; and the
port's copies of the host side's pure functions (scalar oracle, Fisher
test, pileup aggregates, phred scores, model tables, the numpy f64 model,
CSI binning, the CRAM codec helpers) give exactly the JAX package's
results on seeded inputs."""

import ast
import gzip
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from bs_call_tpu import cli as jax_cli
from bs_call_tpu.io import cram_codecs as j_codecs
from bs_call_tpu.io import csi as j_csi
from bs_call_tpu.ops import genotype_np as j_np
from bs_call_tpu.ops import oracle as j_oracle
from bs_call_tpu.ops import postprocess as j_post
from bs_call_tpu.ops import tables as j_tables
from bs_call_tpu_torch.io import cram_codecs as p_codecs
from bs_call_tpu_torch.io import csi as p_csi
from bs_call_tpu_torch.ops import genotype_np as p_np
from bs_call_tpu_torch.ops import oracle as p_oracle
from bs_call_tpu_torch.ops import postprocess as p_post
from bs_call_tpu_torch.ops import tables as p_tables

from make_golden import GOLDEN_DIR, build_fixture

REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("bs_call_tpu", "jax")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.lineno, node.module


def test_no_import_of_the_jax_package_or_jax():
    files = sorted((REPO / "bs_call_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 40
    bad = [
        f"{p.relative_to(REPO)}:{line} imports {mod}"
        for p in files for line, mod in _imports(p)
        if mod.split(".")[0] in BLOCKED
    ]
    assert not bad, bad


# a fresh interpreter with bs_call_tpu and jax unimportable, which imports
# every module of the port and runs its CLI with the golden flags
_BLOCKED_RUN = """
import pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import bs_call_tpu_torch as P
for m in pkgutil.walk_packages(P.__path__, P.__name__ + "."):
    __import__(m.name)
from bs_call_tpu_torch import cli
rc = cli.main(sys.argv[1:])
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in {blocked!r}), rc)
"""


def golden_args(tmp):
    ref, bam, idx = build_fixture(str(tmp))
    return [bam, "-r", ref, "-D", idx, "--benchmark-mode", "-n", "golden",
            "-L", "2,1", "-R", "1,0"]


def golden(name, mode="rb"):
    with open(os.path.join(GOLDEN_DIR, name), mode) as f:
        return f.read()


def strip_date(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith('\t"date"'))


@pytest.mark.parametrize("kind", ["vcf", "bcf", "vcf_gz", "report"])
def test_blocked_cli_writes_golden_bytes(tmp_path, kind):
    args = golden_args(tmp_path)
    out = str(tmp_path / "out")
    flags = {"vcf": ["-O", "v"], "bcf": ["-O", "b"], "vcf_gz": ["-O", "z"],
             "report": ["--report-file", str(tmp_path / "rep.json")]}[kind]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN.format(blocked=BLOCKED), *args,
         "-o", out, "--device", "cpu", *flags],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "LOADED [] 0" in res.stdout, res.stdout
    got = pathlib.Path(out).read_bytes()
    if kind == "vcf":
        assert got == golden("golden.vcf")
    elif kind == "bcf":
        assert gzip.decompress(got) == golden("golden.bcf.u")
    elif kind == "vcf_gz":
        # the BGZF bytes of the JAX package's host engine, same flags
        want = str(tmp_path / "want.vcf.gz")
        assert jax_cli.main([*args, "-o", want, "--device", "cpu",
                             *flags]) == 0
        assert got == pathlib.Path(want).read_bytes()
        assert gzip.decompress(got) == golden("golden.vcf")
    else:
        assert got == golden("golden.vcf")
        rep = (tmp_path / "rep.json").read_text()
        assert strip_date(rep) == golden("golden_report.json", "r")


def _counts2(rng, n):
    c = rng.integers(0, 12, size=(n, 2, 8)).astype(np.int32)
    c[rng.random((n, 2, 8)) < 0.4] = 0
    c[: n // 10] = 0  # uncovered rows
    return c


def _case_calc_gt_prob(mod, rng):
    out = []
    for _ in range(200):
        counts = rng.integers(0, 20, 8)
        counts[rng.random(8) < 0.4] = 0
        quals = np.where(counts > 0, rng.integers(10, 44, 8), 0)
        ref = int(rng.integers(0, 5))
        gp, gt = mod.calc_gt_prob(counts, quals, ref, 0.01, 0.05, 2.0)
        out.append((np.asarray(gp), gt))
    return out


def _case_fisher(mod, rng):
    return [mod.fisher(rng.integers(0, 40, 4)) for _ in range(300)]


def _case_aggregate_pileup(mod, rng):
    n = 500
    c2 = _counts2(rng, n)
    counts = c2.sum(axis=1)
    qual_sum = (counts * rng.integers(10, 44, (n, 8))
                + rng.integers(0, 3, (n, 8))).astype(np.float32)
    mapq2 = (counts.sum(axis=1) * rng.integers(0, 61, n) ** 2).astype(
        np.float32
    )
    return mod.aggregate_pileup(c2, qual_sum, mapq2)


def _case_fisher_strand(mod, rng):
    n = 500
    c2 = _counts2(rng, n)
    gt = rng.integers(0, 10, n).astype(np.int32)
    return [mod.fisher_strand(c2, gt, fix) for fix in (False, True)]


def _case_phred_scores(mod, rng):
    n = 300
    gp = -np.abs(rng.standard_normal((n, 10))) * 5
    gt = rng.integers(0, 10, n).astype(np.int32)
    gp[np.arange(n), gt] = -np.abs(rng.standard_normal(n)) * 1e-3
    return mod.phred_scores(gp, gt)


def _case_tables(mod, rng):
    qt = mod.qual_tables(np.float64)
    return [qt.k, qt.ln_k, qt.ln_k_half, qt.ln_k_one,
            mod.ref_prior_matrix(float(rng.uniform(1, 3))), mod.NONINF_SEL]


def _case_genotype_np(mod, rng):
    n = 2000
    counts = rng.integers(0, 30, (n, 8)).astype(np.int32)
    counts[rng.random((n, 8)) < 0.5] = 0
    quals = np.where(counts > 0, rng.integers(0, 44, (n, 8)), 0).astype(
        np.int32)
    ref = rng.integers(0, 5, n).astype(np.int32)
    return [mod.genotype_ll_np(counts, quals, ref, 0.01, 0.05, 2.0),
            mod.call_genotypes_np(counts, quals, ref, 0.02, 0.03, 2.5)]


def _case_reg2bin(mod, rng):
    out = []
    for shift, depth in ((14, 5), (12, 6)):
        beg = rng.integers(0, 1 << 28, 300)
        end = beg + rng.integers(1, 200_000, 300)
        out.append([mod.reg2bin(int(b), int(e), shift, depth)
                    for b, e in zip(beg, end)])
    return out


def _case_cram_codecs(mod, rng):
    vals = [*map(int, rng.integers(0, 1 << 31, 200)), 0, 127, 128, 16383,
            16384, (1 << 32) - 1]
    big = [*map(int, rng.integers(0, 1 << 62, 200)), 0, 255, 1 << 56]
    data = bytes(rng.integers(0, 6, 5000).astype(np.uint8))
    enc = [mod.write_itf8(v) for v in vals] + [mod.write_ltf8(v) for v in big]
    blob = b"".join(enc)
    dec, off = [], 0
    for _ in enc[:len(vals)]:
        v, off = mod.read_itf8(blob, off)
        dec.append(v)
    for _ in big:
        v, off = mod.read_ltf8(blob, off)
        dec.append(v)
    o0, o1 = mod.rans_encode_o0(data), mod.rans_encode_o1(data)
    return [np.frombuffer(blob, np.uint8), np.asarray(dec, np.int64),
            np.frombuffer(o0, np.uint8), np.frombuffer(o1, np.uint8),
            np.frombuffer(mod.rans_decode(o1), np.uint8)]


def _flatten(x):
    if isinstance(x, dict):
        return [(k, v) for k in sorted(x) for v in _flatten(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flatten(item)]
    return [np.asarray(x)]


@pytest.mark.parametrize("case, jax_mod, port_mod", [
    (_case_calc_gt_prob, j_oracle, p_oracle),
    (_case_fisher, j_oracle, p_oracle),
    (_case_aggregate_pileup, j_post, p_post),
    (_case_fisher_strand, j_post, p_post),
    (_case_phred_scores, j_post, p_post),
    (_case_tables, j_tables, p_tables),
    (_case_genotype_np, j_np, p_np),
    (_case_reg2bin, j_csi, p_csi),
    (_case_cram_codecs, j_codecs, p_codecs),
], ids=["calc_gt_prob", "fisher", "aggregate_pileup", "fisher_strand",
      "phred_scores", "tables", "genotype_np", "reg2bin", "cram_codecs"])
def test_copied_pure_functions_equal_the_jax_package(case, jax_mod,
                                                     port_mod):
    want = _flatten(case(jax_mod, np.random.default_rng(17)))
    got = _flatten(case(port_mod, np.random.default_rng(17)))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            assert a[0] == b[0]
            a, b = a[1], b[1]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()



def test_native_library_is_keyed_by_sources_flags_and_cpu(tmp_path,
                                                          monkeypatch):
    """The port's host library lives in bs_call_tpu_torch/build/<hash>/,
    the hash over its own sources, the g++ command and the host CPU: a
    library built from other sources, with other flags or on another CPU
    has another path and is never loaded."""
    import shutil

    from bs_call_tpu_torch import native

    lib = native.load()
    assert lib is not None
    path = native.lib_path()
    assert lib._name == path
    build, key, name = path.rsplit(os.sep, 2)
    assert build == os.path.join(str(REPO), "bs_call_tpu_torch", "build")
    assert name == "libbsc_ingest.so" and len(key) == 16
    assert all(os.path.dirname(p) == native._DIR for p in native._SRCS)

    monkeypatch.setattr(native, "_host_cpu", lambda: "another cpu")
    assert native.lib_path() != path
    monkeypatch.undo()
    cmd = native._compile_cmd
    monkeypatch.setattr(native, "_compile_cmd",
                        lambda out: [*cmd(out), "-DOTHER"])
    assert native.lib_path() != path
    monkeypatch.undo()
    srcs = []
    for p in native._SRCS:
        shutil.copy(p, tmp_path)
        srcs.append(str(tmp_path / os.path.basename(p)))
    with open(srcs[0], "a") as f:
        f.write("\n// another source\n")
    monkeypatch.setattr(native, "_SRCS", srcs)
    assert native.lib_path() != path
    monkeypatch.undo()
    assert native.lib_path() == path
