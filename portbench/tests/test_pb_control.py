"""The control: the plain reference with its model in float32, the
precision below the float64 the configurations state, put in the
program's place, fails the output check; the float64 reference passes.
On the CPU with the port's plain kernels; the `cuda` case on the card."""

import json
import os

import numpy as np
import pytest

from portbench import check
from portbench.gen.dataset import make_dataset
from portbench.harness import ROOT, _job_argv

CASES = [("wgbs_30x_pe150", 0.03), ("rrbs_mspi_se50", 0.1)]


def _control(tmp_path, name, scale, device):
    from bs_call_tpu_torch import cli
    from bs_call_tpu_torch.utils.trace import Tracer

    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    ds = make_dataset(cfg, 2 ** 31 + 11, str(tmp_path / "in"), scale=scale)
    argv = _job_argv(ds, cfg, str(tmp_path), "pass", device)
    assert cli.main(argv, tracer=Tracer()) == 0
    bcf = (tmp_path / "pass.bcf").read_bytes()
    rep = (tmp_path / "pass.json").read_text()
    good = check.compare(ds, argv, bcf, rep, cfg["check"], 7)
    ctl = check.compare(ds, argv, bcf, rep, cfg["check"], 7,
                        dtype=np.float32)
    return good, ctl


@pytest.mark.parametrize("name,scale", CASES)
def test_control_fails_reference_passes(tmp_path, name, scale):
    good, ctl = _control(tmp_path, name, scale, "cpu")
    assert good["sites_differ"] == 0 and good.get("report_differ", 0) == 0
    assert ctl["sites_differ"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,scale", CASES)
def test_control_fails_on_the_card(tmp_path, name, scale):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    good, ctl = _control(tmp_path, name, scale, "cuda")
    assert good["sites_differ"] == 0 and good.get("report_differ", 0) == 0
    assert ctl["sites_differ"] > 0
