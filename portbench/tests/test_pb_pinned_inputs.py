"""The whole-slab cells' inputs are pinned: the generator's files, the
job's argv, the pileup work counts and the check's windows for
`wgbs_30x_pe150` and `rrbs_mspi_se50` equal those of the generator
before library protocols became modules found by name (sha256 and
numbers taken from that generator at scale 0.02)."""

import hashlib
import json
import os

import pytest

from portbench.check import pick_windows
from portbench.gen.dataset import make_dataset
from portbench.harness import ROOT, _job_argv
from portbench.work.inputs import pileup_input

FAI = "0c77ae4561009cd3b6574eb2cdb133097e632cddbf407322057ab26eaec1c1c5"
PINNED = {
    ("wgbs_30x_pe150", 7): dict(
        sha={"ref.fa": "c27dd716f9b61eb574d7c892e6cdfd81cf2b2ddc451c88f2d3a874acad20d613",
             "in.bam": "91c930ebdbc5541b0807bb47ab05d59abc97eb1c791d9ffc09ad3548ee0dae47",
             "dbsnp.idx": "5def3f71924105c88e639410cc8b51af29ebe5db44118f60ae580aad3810ec90"},
        pileup={"records_used": 14905, "bases": 2014947, "covered": 79938},
        windows=[(0, 26408, 29408), (0, 20608, 23608), (0, 25973, 28973),
                 (0, 29417, 32417), (0, 17265, 20265), (0, 29039, 32039),
                 (0, 24610, 27610), (1, 19911, 22911), (0, 8218, 11218),
                 (0, 9234, 12234), (0, 6128, 9128), (0, 19153, 22153)]),
    ("wgbs_30x_pe150", 2 ** 31 + 101): dict(
        sha={"ref.fa": "a2438c2c4f4004105c05fab11d2d9e61d8cc78d321607f2d8e242a86df575102",
             "in.bam": "897836db8418d917eccf59fa0e93065e2261b9cd5ed79e3f3c9344557e183c83",
             "dbsnp.idx": "440c03105a91c7fa2c8e5b5f0149f51e854b144171b8910e8ca56462d957a358"},
        pileup={"records_used": 14901, "bases": 2014144, "covered": 79963},
        windows=[(0, 33595, 36595), (0, 9364, 12364), (0, 29322, 32322),
                 (1, 27227, 30227), (0, 23294, 26294), (0, 31935, 34935),
                 (1, 28540, 31540), (1, 9316, 12316), (0, 17869, 20869),
                 (0, 25855, 28855), (0, 14290, 17290), (0, 5177, 8177)]),
    ("rrbs_mspi_se50", 7): dict(
        sha={"ref.fa": "379a1d2303f3f08634088c1ec25a775ea1fa1c374bfb67a17c7e4177f9a787ac",
             "in.bam": "79a7cb257a65c9eda8a1754c6434ccc5ac380aa66fae3f2b2fcd7d2fd22b2c21",
             "dbsnp.idx": "b9c68dacf98bcd34e30b1f2145225f8d0ea487001cc5b609bbe7fbe2fb3d62d7"},
        pileup={"records_used": 1376, "bases": 68198, "covered": 1754},
        windows=[]),
    ("rrbs_mspi_se50", 2 ** 31 + 101): dict(
        sha={"ref.fa": "cb16389f2601a846198b8f2224d11ee921d3393329b43b6b366bbfc386666464",
             "in.bam": "01375d165e742e3a9c82f8ae7df62c82854fbb4c55486d4964f3308b2b3eedee",
             "dbsnp.idx": "e115129cdec48ec674e8906ef998081f4d1d29e90fdde4046d5a2fee965fb832"},
        pileup={"records_used": 1376, "bases": 67995, "covered": 1756},
        windows=[]),
}


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_inputs_argv_work_and_windows_are_pinned(tmp_path, name, seed):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    want = PINNED[(name, seed)]
    ds = make_dataset(cfg, seed, str(tmp_path / "in"), scale=0.02)
    assert sorted(os.listdir(ds.dir)) == ["dbsnp.idx", "in.bam", "ref.fa",
                                         "ref.fa.fai"]
    sha = {}
    for f in sorted(os.listdir(ds.dir)):
        with open(os.path.join(ds.dir, f), "rb") as fp:
            sha[f] = hashlib.sha256(fp.read()).hexdigest()
    assert sha == dict(want["sha"], **{"ref.fa.fai": FAI})
    assert getattr(ds, "bed_path", None) is None
    assert getattr(ds, "regions", None) is None
    out = str(tmp_path / "out")
    assert _job_argv(ds, cfg, out, "pass3", "cuda") == [
        ds.bam_path, "-r", ds.ref_path, "-D", ds.dbsnp_path,
        "-o", os.path.join(out, "pass3.bcf"),
        "--report-file", os.path.join(out, "pass3.json"),
        "-t", str(cfg["threads"]), "--device", "cuda"] + cfg["flags"]
    assert pileup_input(ds, cfg) == want["pileup"]
    assert pick_windows(ds, cfg["check"], seed) == want["windows"]
