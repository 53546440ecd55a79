"""One run of one cell: set-up, the measured window of back-to-back
passes, the output check, the result line.

Everything a cell needs is found by name: the cell in `BENCHMARK.json`,
its configuration at the file that entry names, the configuration's
library protocol at `portbench/gen/protocols/<protocol>.py`, its traffic at
`portbench/traffic/<traffic>.json`, each per-layer metric's reader at
`portbench/metrics/<metric name>.py`. A pass is one whole job as a user
runs it: `bs_call_tpu_torch.cli.main(argv, tracer=Tracer())` over the
cell's BAM, reference and dbSNP index (and, where the library's protocol
gives regions, their BED as `-C`), writing a BCF and a JSON report under
TMPDIR. A cell whose end-to-end metrics take one from the device's
timeline has its untraced window profiled on the card alone."""

from __future__ import annotations

import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "bs_call_tpu")
WARMUP_PASSES = 2


class RunError(Exception):
    """A run that must print no result."""


def load_cell(name: str):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, cfg, traffic


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _read_metric(name: str, ctx: dict):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def _remove_outputs(out_dir: str, tag: str) -> None:
    for ext in (".bcf", ".json"):
        try:
            os.remove(os.path.join(out_dir, tag + ext))
        except FileNotFoundError:
            pass


def _job_argv(ds, cfg, out_dir, tag, device):
    argv = [ds.bam_path, "-r", ds.ref_path, "-D", ds.dbsnp_path,
            "-o", os.path.join(out_dir, f"{tag}.bcf"),
            "--report-file", os.path.join(out_dir, f"{tag}.json"),
            "-t", str(cfg["threads"]), "--device", device] + cfg["flags"]
    if ds.bed_path is not None:
        argv += ["-C", ds.bed_path]
    return argv


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", chips_checked: bool = True,
             scale: float = 1.0, log=sys.stderr) -> dict:
    """One run; returns the result dict. `device`, `chips_checked` and
    `scale` (of the slab) are for the harness's own CPU tests, which drive
    a small run without a card."""
    bench, cell, cfg, traffic = load_cell(workload)
    if (traffic["loop"], traffic["clients"]) != ("closed", 1):
        raise RunError("the harness drives one client in a closed loop")
    import torch

    if chips_checked:
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{torch.cuda.device_count()} cards visible, "
                           f"the cell asks for {cell['chips']}")
    from bs_call_tpu_torch import cli
    from bs_call_tpu_torch.utils.trace import Tracer

    from portbench.check import compare
    from portbench.gen.dataset import make_dataset
    from portbench.work.inputs import pileup_input

    print(f"portbench: {workload} seed {seed} usable cores "
          f"{len(os.sched_getaffinity(0))} -t {cfg['threads']}", file=log)
    g0 = time.perf_counter()
    ds = make_dataset(cfg, seed, os.path.join(ROOT, ".portbench", workload),
                      threads=cfg["threads"], scale=scale)
    print(f"portbench: inputs made in {time.perf_counter() - g0:.3f} s, "
          f"{ds.n_records} records", file=log)
    out_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        # the warm-up: whole passes over the cell's own inputs, so the
        # window's passes find every shape, buffer and page warm (on the
        # card the first two passes of a process run slower than the rest)
        for i in range(WARMUP_PASSES):
            w0 = time.perf_counter()
            rc = cli.main(_job_argv(ds, cfg, out_dir, "warmup", device),
                          tracer=Tracer())
            if rc != 0:
                raise RunError(f"warm-up pass exited {rc}")
            _remove_outputs(out_dir, "warmup")
            print(f"portbench: warm-up pass {i} "
                  f"{time.perf_counter() - w0:.3f} s", file=log)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        recorder = prof = anchor = None
        # an untraced run whose cell reports an end-to-end metric of the
        # device's timeline profiles the card alone over the window
        device_e2e = (not trace and device == "cuda" and any(
            m["source"] == "device_trace" for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])))
        if device_e2e:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        if trace:
            from portbench.spans import SpanRecorder
            from portbench.trace import Anchor

            recorder, anchor = SpanRecorder(), Anchor()
            recorder.install()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            anchor.mark()
        setup_s = _process_age_s()
        times, counts = defaultdict(float), defaultdict(int)
        passes = []  # (tag, ok)
        walls = []
        # the pass the check reads, drawn from the seed among the first
        # three; every other pass's output is deleted once the next pass
        # has ended, before it reaches the disk (the last stands in when
        # the window ends sooner)
        pick = int(np.random.default_rng([seed, 1]).integers(3))
        kept = None
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        while time.perf_counter() - t0 < seconds:
            tag = f"pass{len(passes)}"
            tr = Tracer()
            p0 = time.perf_counter()
            try:
                ok = cli.main(_job_argv(ds, cfg, out_dir, tag, device),
                              tracer=tr) == 0
            except Exception as e:  # a failed pass is counted, not fatal
                print(f"portbench: {tag} raised {e!r}", file=log)
                ok = False
            walls.append(time.perf_counter() - p0)
            if ok and (kept is None or kept != f"pass{pick}"):
                if kept is not None:
                    _remove_outputs(out_dir, kept)
                kept = tag
            elif tag != f"pass{pick}":
                _remove_outputs(out_dir, tag)
            passes.append((tag, ok))
            for k, v in tr.times.items():
                times[k] += v
            for k, v in tr.counts.items():
                counts[k] += v
        if device == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        t1_ns = time.perf_counter_ns()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        dtrace = None
        kernel_s = 0.0
        if trace:
            anchor.mark()
            prof.stop()
            recorder.uninstall()
        elif device_e2e:
            from portbench.trace import kernel_seconds

            prof.stop()
            kernel_s = kernel_seconds(prof)
            del prof
        window_s = t1 - t0
        done = sum(ok for _t, ok in passes)
        mreads = ds.n_records * done / 1e6
        cpu_s = ((ru1.ru_utime - ru0.ru_utime)
                 + (ru1.ru_stime - ru0.ru_stime))
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        kind = (torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu")
        metrics = {}
        device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                       "kind": kind, "count": cell["chips"],
                       "memory_peak_bytes": int(peak)}
        breakdown = None
        if trace:
            from portbench.trace import DeviceTrace

            dtrace = DeviceTrace(prof, anchor, recorder.spans, t0_ns, t1_ns)
            del prof
            with open(os.path.join(BENCH, "peaks.json")) as f:
                peaks = json.load(f)["devices"].get(kind)
            ctx = {
                "passes": done, "mreads": mreads, "times": dict(times),
                "counts": dict(counts), "trace": dtrace,
                "window_s": window_s, "cpu_s": cpu_s, "peaks": peaks,
                "pileup_input": pileup_input(ds, cfg),
            }
            for m in bench["per_layer"]:
                if workload not in m.get("workloads", [workload]):
                    continue
                v = _read_metric(m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            device_info["busy_s"] = dtrace.busy_s()
            device_info["window_s"] = dtrace.window_s
            breakdown = dtrace.breakdown()
        else:
            e2e = {
                "setup_s": (setup_s, "s"),
                "kernel_ms_per_mread": (
                    1e3 * kernel_s / mreads if kernel_s and mreads else None,
                    "ms/Mread"),
            }
            for m in bench["end_to_end"]:
                if workload not in m.get("workloads", [workload]):
                    continue
                v, unit = e2e[m["name"]]
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": unit}
        print(f"portbench: {done} of {len(passes)} passes in "
              f"{window_s:.3f} s, {ds.n_records} records a pass, set-up "
              f"{setup_s:.3f} s; pass walls "
              + json.dumps([round(w, 3) for w in walls]) + "; stages "
              + json.dumps({k: round(v, 3) for k, v in times.items()})
              + " counts " + json.dumps(dict(counts))
              + (f"; device kernels {kernel_s:.6f} s" if device_e2e else ""),
              file=log)
        # the output check: the kept pass against the reference
        checks = []
        if kept is not None:
            with open(os.path.join(out_dir, kept + ".bcf"), "rb") as f:
                bcf_bytes = f.read()
            with open(os.path.join(out_dir, kept + ".json")) as f:
                report = f.read()
            c0 = time.perf_counter()
            res = compare(ds, _job_argv(ds, cfg, out_dir, kept, device),
                          bcf_bytes, report, cfg["check"], seed)
            print(f"portbench: checked {kept} in "
                  f"{time.perf_counter() - c0:.3f} s: {res}", file=log)
            checks.append(("sites_differ", res["sites_differ"], "<=", 0))
            if "report_differ" in res:
                checks.append(("report_differ", res["report_differ"],
                               "<=", 0))
            checks.append(("sites_compared", res["sites_compared"], ">=",
                           int(cfg["check"]["min_sites"] * scale)))
        checks.append(("failed_passes", len(passes) - done, "<=", 0))
        correct = kept is not None and all(
            (v <= lim) if op == "<=" else (v >= lim)
            for _n, v, op, lim in checks)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        raise RunError("modules of JAX or the JAX package loaded: "
                       + ", ".join(found))
    result = {
        "correct": correct, "attempted": len(passes),
        "failed": len(passes) - done, "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {n: {"value": v, "limit": f"{op} {lim}"}
                          for n, v, op, lim in checks}
    for n, v, op, lim in checks:
        print(f"{n} {v} (limit {op} {lim})", file=log)
    return result

