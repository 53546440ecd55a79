"""Readings that set the output check's limits, at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--device cuda]

For each seed: the cell's inputs, one job through the port as a pass runs
it, then the check's numbers for the program against the float64
reference (the lower readings) and, on the control seeds, for the
control, the reference with its model in float32 put in the program's
place (the upper readings). One JSON line a seed; no timing."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    import numpy as np
    from bs_call_tpu_torch import cli
    from bs_call_tpu_torch.utils.trace import Tracer

    from portbench.check import compare
    from portbench.gen.dataset import make_dataset
    from portbench.harness import ROOT, _job_argv, load_cell

    _bench, _cell, cfg, _traffic = load_cell(a.workload)
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    for seed in [int(s) for s in a.seeds.split(",")]:
        ds = make_dataset(cfg, seed, os.path.join(
            ROOT, ".portbench", a.workload, "inputs"), threads=cfg["threads"])
        with tempfile.TemporaryDirectory(prefix="portbench-") as out:
            argv = _job_argv(ds, cfg, out, "pass", a.device)
            t = time.perf_counter()
            rc = cli.main(argv, tracer=Tracer())
            job_s = time.perf_counter() - t
            with open(os.path.join(out, "pass.bcf"), "rb") as f:
                bcf = f.read()
            with open(os.path.join(out, "pass.json")) as f:
                rep = f.read()
            row = {"seed": seed, "rc": rc, "job_s": job_s}
            t = time.perf_counter()
            row["program"] = compare(ds, argv, bcf, rep, cfg["check"], seed)
            row["reference_s"] = time.perf_counter() - t
            if seed in ctl:
                row["control"] = compare(ds, argv, bcf, rep, cfg["check"],
                                         seed, dtype=np.float32)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
