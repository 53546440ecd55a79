"""The port's index and CRAM writers against the JAX package's:
`io.csi.write_csi` writes `bs_call_tpu.io.csi.write_csi`'s
bytes at the default binning and at min_shift 12, depth 6, and the port's
native partial-region replay through that `.csi` writes its `.bai` run's
VCF; `io.cram_writer.CramWriter` writes the JAX writer's bytes for the
same records (at one gzip timestamp: a gzip block carries the time it was
written), and the port calling from that CRAM writes its BAM run's VCF."""

import functools
import gzip
import io
import shutil

import numpy as np
import pytest
import torch

from bs_call_tpu.io import csi as j_csi
from bs_call_tpu.io import cram_writer as j_cw
from bs_call_tpu_torch.config import CallerConfig
from bs_call_tpu_torch.io import csi as p_csi
from bs_call_tpu_torch.io import cram_writer as p_cw
from bs_call_tpu_torch.io.bai import write_bai
from bs_call_tpu_torch.io.bam import BamReader
from bs_call_tpu_torch.pipeline.runner import run_caller
from bs_call_tpu_torch.utils.synth import make_wgbs_fixture

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def wgbs(tmp_path_factory):
    """Two contigs of 30 kb of the synthetic WGBS generator."""
    tmp = tmp_path_factory.mktemp("writers")
    ref, bam, _n = make_wgbs_fixture(str(tmp), 1500, 30_000, seed=5,
                                     n_contigs=2)
    return tmp, ref, bam


def call(bam, ref, **kw):
    out = io.BytesIO()
    run_caller(CallerConfig(input_file=bam, reference_file=ref,
                            benchmark_mode=True, **kw), CPU,
               out_fileobj=out)
    return out.getvalue()


@pytest.mark.parametrize("binning", [{}, {"min_shift": 12, "depth": 6}],
                         ids=["default", "shift12_depth6"])
def test_write_csi_equals_jax(wgbs, tmp_path, binning):
    _tmp, _ref, bam = wgbs
    got = p_csi.write_csi(bam, str(tmp_path / "port.csi"), **binning)
    want = j_csi.write_csi(bam, str(tmp_path / "jax.csi"), **binning)
    with open(got, "rb") as f, open(want, "rb") as g:
        a = f.read()
        assert a == g.read() and len(a) > 28
    idx = p_csi.CsiIndex(got)
    assert (idx.min_shift, idx.depth) == (binning.get("min_shift", 14),
                                          binning.get("depth", 5))


def test_region_replay_through_csi_equals_bai(wgbs, tmp_path, monkeypatch):
    """The port's native pipeline replays partial -C regions through the
    index it finds: a `.csi` only, then a `.bai` only, the same VCF."""
    from bs_call_tpu_torch.pipeline import runner

    packed = []
    pack = runner._pack_native_regions
    monkeypatch.setattr(runner, "_pack_native_regions",
                        lambda *a: packed.append(pack(*a)) or packed[-1])
    _tmp, ref, bam = wgbs
    bed = tmp_path / "regions.bed"
    bed.write_text("chr1\t1000\t9000\nchr1\t20000\t26000\nchr2\t500\t4000\n")
    runs = {}
    for kind in ("csi", "bai"):
        d = tmp_path / kind
        d.mkdir()
        copy = str(d / "in.bam")
        shutil.copy(bam, copy)
        if kind == "csi":
            p_csi.write_csi(copy)
        else:
            write_bai(copy)
        runs[kind] = call(copy, ref, contig_bed=str(bed))
        assert packed.pop() is not None  # the indexed replay's table
        assert not (d / f"in.bam.{'bai' if kind == 'csi' else 'csi'}"
                    ).exists()
    assert runs["csi"] == runs["bai"]
    assert runs["csi"].count(b"\nchr2\t") > 100


def cram_records(bam):
    for rec in BamReader(bam):
        seq = "".join("NACGT"[c] for c in rec.seq_code)
        yield (rec.name, rec.flag, rec.tid, rec.pos, rec.mapq, rec.cigar,
               rec.mtid, rec.mpos, rec.isize, seq,
               np.asarray(rec.qual, np.uint8), rec.aux)


@pytest.mark.parametrize("multi_ref", [False, True])
def test_cram_writer_equals_jax_and_calls_as_bam(wgbs, tmp_path, monkeypatch,
                                                multi_ref):
    _tmp, ref, bam = wgbs
    monkeypatch.setattr(gzip, "compress",
                        functools.partial(gzip.compress, mtime=0))
    header = BamReader(bam).header
    paths = {}
    for tag, mod in (("port", p_cw), ("jax", j_cw)):
        paths[tag] = str(tmp_path / f"{tag}.cram")
        w = mod.CramWriter(paths[tag], header, reference=ref,
                           multi_ref=multi_ref)
        for r in cram_records(bam):
            w.write(*r)
        w.close()
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        got = f.read()
        assert got == g.read() and got[:4] == b"CRAM"
    if not multi_ref:
        vcf = call(paths["port"], ref)
        assert vcf == call(bam, ref) and vcf.count(b"\nchr") > 1000

