#!/usr/bin/env python3
"""Smoke run of bs_call_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device, nvcc
and g++. Phases, each of which raises on failure (exit code 1):

1. print the card (`nvidia-smi` name and power limit), torch and CUDA;
2. build the CUDA kernels from `bs_call_tpu_torch/csrc` (timed);
3. K2, the genotype kernel, against its plain PyTorch version on the
   card at the fused tier's shape (32,832 positions), both entries, f64
   and f32, with kernel and plain times from CUDA events;
4. K1, the pileup scatter, against its plain version on the card at
   4,096 reads x 256 bases over 32,832 positions;
5. end to end on a 600k-read WGBS fixture (4 contigs x 1.25 Mbp, 150k
   reads each, seed 0, dbSNP every 503 bp): `bs_call_tpu_torch.cli
   --device cuda` in this process against `bs_call_tpu.cli --device cpu`
   (the native host engine) in a subprocess. VCF and report bytes must
   be equal, and the launch counts of K1 and K2, reset just before the
   port's run, must show that the run went through both kernels.

The line before the last is a JSON object with one entry per kernel of
the main path; the last is `{"ok": true, "device": {...}}`. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_POS = (1 << 15) + 64  # engine batch_positions + _FUSED_PAD
TIMED_ITERS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, torch) -> float:
    """Mean milliseconds per call over TIMED_ITERS calls, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(TIMED_ITERS):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / TIMED_ITERS


def genotype_inputs(np, n, seed):
    """Pileup columns at realistic depth: counts 0..29 per category,
    half the categories empty, integer quality sums with some averages
    on a .5 rounding boundary, every ref code."""
    rng = np.random.default_rng(seed)
    counts2 = rng.integers(0, 15, size=(n, 2, 8)).astype(np.int32)
    counts2[rng.random((n, 2, 8)) < 0.5] = 0
    counts = counts2.sum(axis=1)
    q = rng.integers(20, 44, size=(n, 8))
    qual_sum = (counts * q + rng.integers(0, np.maximum(counts, 1))).astype(
        np.float32
    )
    half = (rng.random((n, 8)) < 0.1) & (counts % 2 == 0)
    qual_sum[half] = (counts * q + counts // 2)[half]
    quals = np.where(counts > 0, q, 0).astype(np.int32)
    ref = rng.integers(0, 5, size=n).astype(np.int32)
    return counts2, qual_sum, counts.astype(np.int32), quals, ref


def check_k2(torch, np, dev):
    from bs_call_tpu_torch.ops import genotype as G
    from bs_call_tpu_torch.ops.kernels import genotype_cuda as K2
    from bs_call_tpu_torch.ops.params import ModelParams, model_tables

    counts2, qual_sum, counts, quals, ref = (
        torch.from_numpy(a).to(dev) for a in genotype_inputs(np, N_POS, 0)
    )
    results = {}
    for dtype, tol, tie in ((torch.float64, 1e-12, 1e-9),
                            (torch.float32, 2e-5, 1e-3)):
        tables = model_tables(ModelParams(), dtype, dev)
        for entry, kern, plain, args in (
            ("column", K2.genotype_column, G.call_genotypes_plain,
             (counts, quals, ref)),
            ("pileup", K2.genotype_pileup, G.call_genotypes_pileup_plain,
             (counts2, qual_sum, ref)),
        ):
            got = kern(*args, tables)
            want = plain(*args, tables)
            torch.cuda.synchronize()
            gp, mx, mg, off = got[:4]
            w_gp, w_mx, w_mg, w_off = want[:4]
            clear = w_mg > tie
            if not torch.equal(mx[clear], w_mx[clear]):
                raise AssertionError(f"K2 {entry} {dtype}: max_gt differs")
            torch.testing.assert_close(gp, w_gp, rtol=tol, atol=tol)
            torch.testing.assert_close(
                off, w_off, rtol=tol if dtype == torch.float64 else 1e-4,
                atol=1e-30,
            )
            # margin is a difference of two log-likelihoods of up to
            # ~10^3: in f32 its rounding is one ulp of those, 6e-5
            torch.testing.assert_close(
                mg, w_mg, rtol=tol, atol=tol if dtype == torch.float64 else 2e-4
            )
            if entry == "pileup" and not torch.equal(got[4], want[4]):
                raise AssertionError(f"K2 pileup {dtype}: quals differ")
            err = (gp - w_gp).abs().max().item()
            ms = time_ms(lambda: kern(*args, tables), torch)
            plain_ms = time_ms(lambda: plain(*args, tables), torch)
            name = f"genotype_{entry}_{'f64' if dtype == torch.float64 else 'f32'}"
            results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            log(f"K2 {name}: N={N_POS} max|d gt_prob|={err:.3e} "
                f"(tol {tol:g}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return results


def read_batch(np, R, L, n_pos, seed):
    """R reads of 100..L bases at sorted starts over [-200, n_pos), with
    q 0..43, some masked (FLT_QUAL) and zero-padded tails."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(100, L + 1, R)
    q = rng.integers(0, 44, size=(R, L))
    q[rng.random((R, L)) < 0.02] = 63
    rd = ((q << 2) | rng.integers(0, 4, size=(R, L))).astype(np.uint8)
    rd[np.arange(L)[None, :] >= lens[:, None]] = 0
    starts = np.sort(rng.integers(-200, n_pos, R)).astype(np.int32)
    ori = rng.integers(0, 2, R).astype(np.int32)
    strand = rng.integers(0, 3, R).astype(np.int32)
    mapq = rng.integers(0, 61, R).astype(np.int32)
    return rd, starts, ori, strand, mapq


def check_k1(torch, np, dev):
    from bs_call_tpu_torch.ops.kernels import pileup_device as PD

    args = [torch.from_numpy(a).to(dev)
            for a in read_batch(np, 4096, 256, N_POS, 1)]
    got = PD.pileup_scatter(*args, N_POS, 20)
    want = PD.device_pileup_plain(*args, N_POS, 20)
    torch.cuda.synchronize()
    for name, a, b in zip(("counts2", "qual_sum", "mapq2_sum"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"K1 {name} differs from the plain version")
    if int(got[0].sum()) == 0:
        raise AssertionError("K1 counted no base")
    ms = time_ms(lambda: PD.pileup_scatter(*args, N_POS, 20), torch)
    plain_ms = time_ms(lambda: PD.device_pileup_plain(*args, N_POS, 20),
                       torch)
    log(f"K1 pileup_scatter: R=4096 L=256 n_pos={N_POS} exact match, "
        f"{int(got[0].sum())} bases; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


def end_to_end(torch, card):
    from bs_call_tpu.utils.synth import make_dbsnp_index, make_wgbs_fixture
    from bs_call_tpu.utils.trace import Tracer
    from bs_call_tpu_torch import cli
    from bs_call_tpu_torch.ops.kernels import genotype_cuda as K2
    from bs_call_tpu_torch.ops.kernels import pileup_device as PD
    from bs_call_tpu_torch.parity import strip_date

    tmp = tempfile.mkdtemp(prefix="bsct_smoke_")
    try:
        t0 = time.perf_counter()
        n_ctg, n_reads, ctg_len = 4, 150_000, 1_250_000
        ref, bam, n_recs = make_wgbs_fixture(
            tmp, n_reads, ctg_len, seed=0, n_contigs=n_ctg
        )
        dbsnp = make_dbsnp_index(
            os.path.join(tmp, "dbsnp.bin"),
            [f"chr{i + 1}" for i in range(n_ctg)], ctg_len, every=503,
        )
        log(f"fixture: {n_recs} records, {n_ctg} x {ctg_len} bp, "
            f"{time.perf_counter() - t0:.1f} s")
        # the native host library (ingest, pileup, emit) both runs use
        # builds once here, outside either run's time
        from bs_call_tpu.native import load as native_load

        t0 = time.perf_counter()
        if native_load() is None:
            raise AssertionError("the native host library did not build")
        log(f"native host library built/loaded in "
            f"{time.perf_counter() - t0:.1f} s")
        common = [bam, "-r", ref, "-D", dbsnp, "--benchmark-mode"]
        out = {k: os.path.join(tmp, k) for k in (
            "host.vcf", "host.json", "port.vcf", "port.json")}

        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [HERE] + [p for p in [env.get("PYTHONPATH")] if p]
        )
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "bs_call_tpu.cli", *common,
             "-o", out["host.vcf"], "--report-file", out["host.json"],
             "--device", "cpu"],
            cwd=HERE, env=env, check=True,
        )
        host_s = time.perf_counter() - t0

        tracer = Tracer()
        PD.pileup_scatter.launches = 0
        K2.genotype_pileup.launches = 0
        K2.genotype_column.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(
            [*common, "-o", out["port.vcf"], "--report-file",
             out["port.json"], "--device", "cuda"],
            tracer=tracer,
        )
        torch.cuda.synchronize()
        port_s = time.perf_counter() - t0
        launches = {
            "pileup_scatter": PD.pileup_scatter.launches,
            "genotype_pileup_f64": K2.genotype_pileup.launches,
            "genotype_column": K2.genotype_column.launches,
        }
        if rc != 0:
            raise AssertionError(f"port CLI exited {rc}")

        def read(k):
            with open(out[k]) as f:
                return f.read()

        n_rec = sum(1 for ln in read("port.vcf").splitlines()
                    if not ln.startswith("#"))
        tiers = {k[5:]: v for k, v in tracer.counts.items()
                 if k.startswith("tier_")}
        total = n_ctg * n_reads
        log(f"e2e [{card}]: {total} reads, {n_rec} VCF records, comparing")
        log(f"e2e [{card}]: port --device cuda in this process "
            f"{port_s:.2f} s ({total / port_s:.0f} reads/s); host "
            f"bs_call_tpu --device cpu as a subprocess {host_s:.2f} s "
            f"({total / host_s:.0f} reads/s)")
        log(f"e2e [{card}]: tier positions {json.dumps(tiers)}; "
            f"launches {json.dumps(launches)}; positions "
            f"{tracer.counts.get('positions', 0)}")
        log(f"e2e [{card}]: port stage seconds " + json.dumps(
            {k: round(v, 3) for k, v in sorted(tracer.times.items())}))
        if read("port.vcf") != read("host.vcf"):
            raise AssertionError("VCF bytes differ from bs_call_tpu --device cpu")
        if strip_date(read("port.json")) != strip_date(read("host.json")):
            raise AssertionError("report differs from bs_call_tpu --device cpu")
        if not (launches["pileup_scatter"] > 0
                and launches["genotype_pileup_f64"] > 0):
            raise AssertionError(f"main path skipped a kernel: {launches}")
        if tiers.get("fused", 0) == 0:
            raise AssertionError(f"fused tier carried nothing: {tiers}")
        log(f"e2e [{card}]: VCF and report bytes equal")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "bs_call_tpu_torch")) or not (
        os.path.isdir(os.path.join(HERE, "bs_call_tpu"))
    ):
        print("chip_smoke: run from the root of a bs_call_tpu checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from bs_call_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"kernels built/loaded in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    k2 = check_k2(torch, np, dev)
    k1 = check_k1(torch, np, dev)
    launches = end_to_end(torch, card)
    if "jax" in sys.modules:
        raise AssertionError("the port's run imported jax")

    src = "bs_call_tpu_torch/csrc/"
    kernels = [
        {"name": "pileup_scatter", "route": "cuda",
         "source": src + "pileup.cu",
         "replaces": "bs_call_tpu/ops/kernels/pileup_device.py:37",
         "launches": launches["pileup_scatter"], **k1},
        {"name": "genotype_pileup_f64", "route": "cuda",
         "source": src + "genotype.cu",
         "replaces": "bs_call_tpu/ops/kernels/genotype_pallas.py:48",
         "launches": launches["genotype_pileup_f64"],
         **k2["genotype_pileup_f64"]},
    ]
    print(f"[{card}] " + "; ".join(
        f"{k} kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} ms"
        for k, v in k2.items()), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
