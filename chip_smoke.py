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
5. K3, the emit-fields kernel, against its plain version on the card at
   32,832 positions: K2's pileup-entry outputs on phase 3's inputs plus
   a mapq2 sum, a few rows of it at or above 2^24 (which both must
   flag). Every field must be equal on the rows neither flags; the
   number of rows whose risk bit differs is printed, with kernel and
   plain times from CUDA events;
6. end to end on a 600k-read WGBS fixture (4 contigs x 1.25 Mbp, 150k
   reads each, seed 0, dbSNP every 503 bp): `bs_call_tpu.cli --device
   cpu` (the native host engine) in a subprocess, then
   `bs_call_tpu_torch.cli --device cuda` twice in this process, with the
   emit tier on (the default: K1 -> K2 -> K3) and with
   `BS_CALL_EMIT_TIER=0` (K1 -> K2, host emit prep). VCF and report bytes
   of both must equal the host's. The launch counts, reset just before
   each port run, must show that the tier-on run went through K1, K2 and
   K3 (K3 once per K1 launch) and the tier-off run through no K3; the
   tier-on run's risk-flagged share of the covered positions it carried
   (`tier_emit_risk` / `tier_emit`) must stay at or below 2%. The three
   walls are printed beside the card.

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


def check_k3(torch, np, dev):
    from bs_call_tpu_torch.ops.emit_tables import emit_tables
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
    from bs_call_tpu_torch.ops.kernels import emit_device as E
    from bs_call_tpu_torch.ops.kernels import genotype_cuda as K2
    from bs_call_tpu_torch.ops.params import ModelParams, model_tables

    counts2, qual_sum, counts, _quals, ref = genotype_inputs(np, N_POS, 0)
    rng = np.random.default_rng(2)
    mq = rng.integers(0, 61, N_POS)
    mapq2 = (counts.sum(axis=1) * mq * mq).astype(np.float32)
    deep = rng.choice(N_POS, 8, replace=False)
    mapq2[deep] = np.float32(2.0**24) + 512 * np.arange(8)
    c2, qs, m2, r = (torch.from_numpy(a).to(dev)
                     for a in (counts2, qual_sum, mapq2, ref))
    tables = model_tables(ModelParams(), torch.float64, dev)
    et = emit_tables(dev)
    k2 = K2.genotype_pileup(c2, qs, r, tables)[:4]
    args = (*k2, c2, m2, r, et)
    got = K3.emit_fields_cuda(*args)
    want = E.pack_fields(E.emit_fields_plain(*args))
    torch.cuda.synchronize()
    g = E.unpack_fields(got.cpu().numpy(), N_POS)
    w = E.unpack_fields(want.cpu().numpy(), N_POS)
    ok = ~(g["risk"] | w["risk"])
    for name, a in g.items():
        if name not in ("risk", "fs_hi") and not np.array_equal(
            a[ok].view(np.uint8), w[name][ok].view(np.uint8)
        ):
            raise AssertionError(f"K3 {name} differs from the plain version")
    # the Fisher log10 p, an f64 value beside its integer fs_int: the same
    # libdevice exp/log on both sides, tolerance 1e-12 relative
    err = float(np.abs(g["fs_hi"][ok] - w["fs_hi"][ok]).max())
    np.testing.assert_allclose(g["fs_hi"][ok], w["fs_hi"][ok], rtol=1e-12,
                               atol=1e-15)
    cov = g["covered"][deep]
    if not (g["risk"][deep][cov].all() and w["risk"][deep][cov].all()):
        raise AssertionError("K3: a mapq2 sum past 2^24 was not flagged")
    if ok.sum() < N_POS // 2:
        raise AssertionError(f"K3: only {ok.sum()} rows unflagged")
    n_diff = int((g["risk"] != w["risk"]).sum())
    ms = time_ms(lambda: K3.emit_fields_cuda(*args), torch)
    plain_ms = time_ms(lambda: E.pack_fields(E.emit_fields_plain(*args)),
                       torch)
    log(f"K3 emit_fields_f64: N={N_POS} every field equal on {ok.sum()} "
        f"rows neither flags (max|d fs|={err:.3e}, tol 1e-12 relative); "
        f"risk bits differ on {n_diff} rows "
        f"(kernel {int(g['risk'].sum())}, plain {int(w['risk'].sum())} "
        f"flagged); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
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
            "host.vcf", "host.json", "port.vcf", "port.json",
            "port_off.vcf", "port_off.json")}

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

        def read(k):
            with open(out[k]) as f:
                return f.read()

        def port_run(tag, emit_tier):
            """One port run in this process, the launch counts reset just
            before it; BS_CALL_EMIT_TIER is read when the engine is built,
            so it is set around cli.main."""
            tracer = Tracer()
            for fn in (PD.pileup_scatter, K2.genotype_pileup,
                       K2.genotype_column, K3.emit_fields_cuda):
                fn.launches = 0
            before = os.environ.get("BS_CALL_EMIT_TIER")
            os.environ["BS_CALL_EMIT_TIER"] = "1" if emit_tier else "0"
            try:
                t0 = time.perf_counter()
                rc = cli.main(
                    [*common, "-o", out[f"{tag}.vcf"], "--report-file",
                     out[f"{tag}.json"], "--device", "cuda"],
                    tracer=tracer,
                )
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                if before is None:
                    del os.environ["BS_CALL_EMIT_TIER"]
                else:
                    os.environ["BS_CALL_EMIT_TIER"] = before
            if rc != 0:
                raise AssertionError(f"port CLI ({tag}) exited {rc}")
            launches = {
                "pileup_scatter": PD.pileup_scatter.launches,
                "genotype_pileup_f64": K2.genotype_pileup.launches,
                "genotype_column": K2.genotype_column.launches,
                "emit_fields_f64": K3.emit_fields_cuda.launches,
            }
            tiers = {k[5:]: v for k, v in tracer.counts.items()
                     if k.startswith("tier_")}
            log(f"e2e [{card}]: {tag}: tier positions {json.dumps(tiers)}; "
                f"launches {json.dumps(launches)}; positions "
                f"{tracer.counts.get('positions', 0)}")
            log(f"e2e [{card}]: {tag}: stage seconds " + json.dumps(
                {k: round(v, 3) for k, v in sorted(tracer.times.items())}))
            if read(f"{tag}.vcf") != read("host.vcf"):
                raise AssertionError(
                    f"{tag}: VCF bytes differ from bs_call_tpu --device cpu"
                )
            if strip_date(read(f"{tag}.json")) != strip_date(
                read("host.json")
            ):
                raise AssertionError(
                    f"{tag}: report differs from bs_call_tpu --device cpu"
                )
            if not (launches["pileup_scatter"] > 0
                    and launches["genotype_pileup_f64"] > 0):
                raise AssertionError(f"{tag} skipped a kernel: {launches}")
            if tiers.get("fused", 0) == 0:
                raise AssertionError(f"{tag}: fused tier carried nothing")
            return wall, launches, tiers

        total = n_ctg * n_reads
        on_s, launches, tiers = port_run("port", emit_tier=True)
        if not (0 < launches["emit_fields_f64"]
                == launches["pileup_scatter"]):
            raise AssertionError(f"K3 not once per K1 launch: {launches}")
        risky = tiers.get("emit_risk", 0) / max(tiers.get("emit", 0), 1)
        if tiers.get("emit", 0) == 0 or risky > 0.02:
            raise AssertionError(f"emit tier: {tiers}")
        off_s, off_launches, off_tiers = port_run("port_off", emit_tier=False)
        if off_launches["emit_fields_f64"] or off_tiers.get("emit", 0):
            raise AssertionError("BS_CALL_EMIT_TIER=0 still ran K3")
        n_rec = sum(1 for ln in read("port.vcf").splitlines()
                    if not ln.startswith("#"))
        log(f"e2e [{card}]: {total} reads, {n_rec} VCF records; VCF and "
            f"report bytes of both port runs equal the host's; "
            f"tier_emit {tiers['emit']}, tier_emit_risk "
            f"{tiers.get('emit_risk', 0)} ({100 * risky:.3f}% of them)")
        log(f"e2e [{card}]: walls: port --device cuda, emit tier on, in "
            f"this process {on_s:.3f} s ({total / on_s:.0f} reads/s); "
            f"emit tier off {off_s:.3f} s ({total / off_s:.0f} reads/s); "
            f"host bs_call_tpu --device cpu as a subprocess {host_s:.3f} s "
            f"({total / host_s:.0f} reads/s)")
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
    k3 = check_k3(torch, np, dev)
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
        {"name": "emit_fields_f64", "route": "cuda",
         "source": src + "emit.cu",
         "replaces": "bs_call_tpu/ops/kernels/emit_device.py:256",
         "launches": launches["emit_fields_f64"], **k3},
    ]
    print(f"[{card}] " + "; ".join(
        f"{k} kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} ms"
        for k, v in {**k2, "pileup_scatter": k1,
                     "emit_fields_f64": k3}.items()), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
