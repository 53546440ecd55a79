#!/usr/bin/env python3
"""Smoke run of bs_call_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device, nvcc
and g++. Phases, each of which raises on failure (exit code 1):

1. print the card (`nvidia-smi` name and power limit), torch and CUDA;
2. build the CUDA kernels from `bs_call_tpu_torch/csrc` (timed);
3. K2's column entry (the column tier, `--no-exact`) against its plain
   PyTorch version on the card, f64 and f32, on two batches of 32,832
   positions (`column_inputs`: (a) het-rich, (b) the column tier's WGBS
   rows), each timed (device, eager, plain), then on ragged sizes (1, 2,
   63, 64, 65, 127, 128, 129 and 4,097 rows), rows one element into their
   storage (K2's 4-byte staging path), all-zero rows and out-of-range
   quals and ref;
3b. the column tier's chunk pipeline (`check_column_pipeline`): 180,000
   WGBS rows through `TorchCallEngine._pipe_chunks` (six chunks of
   32,768, up to three in flight, pinned slots, one stream), f32 and f64,
   bit-equal to K2 a chunk at a time with a blocking copy out, within
   K2's tolerances of the plain version, one K2 launch a chunk; timed in
   turns with it and with the H2D on a copy stream (two streams), as host
   wall ms a call;
4. K3, the emit-fields kernel, against its plain version on the card at
   32,832 positions, with no ctx and with ctx known (the genotype codes
   just outside the chunk, as a position-sharded slab gets them from its
   neighbours), on two batches through the plain model on the card:
   (a) phase 3's inputs plus a mapq2 sum, a few rows of it at or above
   2^24 (which both must flag), and (b) a WGBS-like batch at depth 18
   (`wgbs_inputs`); then on ragged sizes (1, 2, 127, 129 and 4,097
   rows, and 129 rows one element into their storage) and on a batch
   whose rows on the 128-row tile seams are het. Every field must be equal on
   the rows neither flags, the codes no libm reaches on every row; the
   het share, both risk counts and the number of rows whose risk bit
   differs are printed, with kernel and plain times of both batches
   (the kernel's with and without ctx);
5. K12, the pileup and the genotype model per position tile, against its
   plain version (`device_pileup_plain` then
   `call_genotypes_pileup_plain`) on the card, in f64 and f32, on
   `k12_batches` at 32,832 positions: (a) 4,096 random reads x 256
   bases, (b) `wgbs_reads` at depth 18 padded to L = 160, (b256) the
   same as the engine pads them (L = 256), and a hot position (5,000
   reads of mapq 59 over one position, which takes `mapq2_sum` past
   2^24; f64 only); then on `K12_EDGE_CASES` (L = 64 and 2,048, tiles
   with no row, a tile whose rows fill many stages, n_pos not a multiple
   of 128 with rows before 0 and past n_pos, min_qual 0): integers
   exact, f64 within K2's tolerances; K12 f64 timed on (a) and (b);
6. `fused_pileup_call` (any read batch -> K12 in f32 or f64) against its
   plain version on the card, on the fused tier's chunk (4,096 x 256)
   and on a batch that needs the wrapper's preparation (100-byte rows out
   of order, padding rows with starts < 0, rows past the chunk): one K12
   launch a call, integers exact, floats as phase 5; device and eager
   times, K12's own and the preparation's;
7. `fused_emit_chunk` (K12 -> K3 -> compaction) against its plain
   version on the card on the read-batch counterparts of K3's batches
   (a) and (b), and with a cap below n_emit (the overflow must be
   reported): n_emit and positions equal, every field as phase 4; its
   device time and the share of it spent in compaction;
8. the position-sharded programs (`check_mesh`) over `[cuda:0] * 2`,
   `[cuda:0] * 4` and every card when there are several: on phase 7's
   batches, `sharded_fused_ll_emit` and `sharded_fused_ll_f64` equal
   `fused_ll_emit` / `fused_ll_f64` on one device exactly, every output,
   risk bits included, with one K12 (and K3) launch a slab; then
   `sharded_call_genotypes` (f32, f64), `sharded_ll_f64` and
   `sharded_full_step` over `[cuda:0] * 4` equal K2 on one device, with
   the histograms its sums; eager times;
9. end to end on a 600k-read WGBS fixture (4 contigs x 1.25 Mbp, 150k
   reads each, seed 0, dbSNP every 503 bp): `bs_call_tpu.cli --device
   cpu` (the native host engine, the reference) in a subprocess, then
   `bs_call_tpu_torch.cli --device cuda` in this process with the emit
   tier on (the default: K12 -> K3), with `BS_CALL_EMIT_TIER=0` (K12,
   host emit prep), and with `--shards 2` (BS_CALL_FORCE_SHARDS=1: two
   worker processes, each on the card). VCF and report bytes of all
   three must equal the reference's. The launch counts, reset just before
   each port run, must show that the single-process runs launched K12
   once per chunk the fused tier carried, the tier-on run K3 once per K12
   launch, the tier-off run no K3, and that the sharded run's workers
   (their counts come back with their stats) launched K12 and K3 once
   per chunk while the parent launched nothing. The tier-on run's
   risk-flagged share of the covered positions it carried
   (`tier_emit_risk` / `tier_emit`) must stay at or below 2%. Then the
   engine over `[cuda:0] * 2` (each chunk in two slabs: K12 and K3
   twice per fused chunk, risk share at most 2%), and `--num-hosts 2
   --coordinator` as two processes on the card (gloo), whose VCFs, joined
   by `bs_call_tpu_torch.concat`, and host 0's report must be the
   reference's bytes, each host having launched K12 and K3. Last,
   `--no-exact`: `bs_call_tpu.cli --no-exact --device cpu` as a
   subprocess with JAX_PLATFORMS=cpu (the reference's f32 model on
   XLA:CPU), then `bs_call_tpu_torch.cli --no-exact --device cuda` in this
   process, whose VCF must pass `parity.check_no_exact` against it, with
   the column tier carrying every position (`tier_fused` 0) and K2
   launched in f32 once per column chunk (`column_chunks`), never in
   f64. Then partial `-C` regions (one of 40,000 positions a contig,
   each a block wider than the fused tier takes, two column chunks), the
   fixture linked into a directory of its own with its `.bai` (which a
   partial `-C` run builds), the reference's two runs beside the
   port's: `--device cuda -C` against `bs_call_tpu -C --device cpu`, VCF
   and report bytes equal, with shape reroutes and K2 launched in f64
   once per column chunk; `--no-exact -C` against `bs_call_tpu -C
   --no-exact` with `check_no_exact`, K2 in f32 once per column chunk.
   The walls are printed beside the card; they carry no multi-GPU claim.
10. the host row engine (`row_engine_phase`), on the same fixture without
   `-D`, where the row-engine gate holds: `bs_call_tpu.cli --device cpu
   -v` as a subprocess (its own native ingest and row engine: its stderr
   must say `using native row engine`) against `bs_call_tpu_torch.cli
   --device numpy -v` in this process, which must say the same, launch
   none of K2, K12 and K3, and write the reference's VCF and report
   bytes; both walls and their ingest, call and emit stage seconds are
   printed beside the card.

The line before the last is a JSON object with one entry per kernel
(`bound_ms` from this run's inputs: bytes over 3.35 TB/s, FP64
operations over 34 TFLOP/s, the larger; `launches` from the main path's
run of each: the 600k tier-on run for K12 f64 and K3, phase 6's drive
for K12 f32, the partial `-C` exact run for K2 f64 and the 600k
`--no-exact` run for K2 f32 (`path`; `launches_partial` that of the
partial `-C --no-exact` run), each counted by its dtype; for K12 f64 and
K3 also
`launches_mesh`, of the engine over two slabs, and `launches_num_hosts`,
both hosts' summed; K3's `ms_ctx` with ctx known; K2's, K3's and K12
f64's `*_wgbs` times and bounds on their batch (b)); the last is `{"ok": true,
"device": {...}}`. Imports nothing of JAX and nothing of `bs_call_tpu`,
which it runs only as the reference subprocess.
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
# the partial -C region of each contig of the 600k fixture, 0-based
# half-open: two chunks of the column tier each, the second ragged (a
# partial region takes the scalar emitter, 50-80 us a position on the
# host, so the regions are cut to keep the script's time)
REGION = (100_000, 140_000)
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
    """Mean milliseconds per call over TIMED_ITERS eager calls, CUDA
    events: the host's enqueue cost (allocation, checks, the ctypes call)
    is in it, and bounds it when it exceeds the device's work."""
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


HBM_BYTES_S = 3.35e12  # H100 SXM device memory
FP64_FLOP_S = 34e12    # H100 SXM FP64 outside the tensor cores
# a libdevice f64 log or exp is counted as 20 FMA, 40 FLOP
TRANSCENDENTAL_FLOP = 40


def bound(nbytes, flops=0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FP64 operations over the FP64 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP64_FLOP_S
    if t_ops > t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def model_flops(np, counts):
    """FP64 operations of the genotype model and finish on these counts
    [N,8]: ten FMA for each category with reads, get_Z twice (~30 FLOP
    each), three logs for each methylation category with reads, nine exp,
    one log1p and the ten posteriors."""
    live = counts > 0
    return float(
        2 * 10 * live.sum() + len(counts) * (60 + 10 * TRANSCENDENTAL_FLOP + 30)
        + 3 * TRANSCENDENTAL_FLOP * live[:, 4:].sum()
    )


# bytes of one position's pileup planes and model outputs (f64)
PILEUP_BYTES = 64 + 32 + 4          # counts2 i32, qual_sum f32, mapq2 f32
MODEL_OUT_BYTES = 80 + 4 + 8 + 8 + 8  # gt_prob, max_gt, margin, off, quals


def close_ratio(got, want, rtol, atol) -> float:
    """assert_close's own measure: the largest |got - want| / (atol +
    rtol |want|), at most 1 where the check passes."""
    d = (got - want).abs().double()
    return (d / (atol + rtol * want.abs().double())).max().item()


def device_ms(fn, torch, reps=20) -> float:
    """Device milliseconds per call: `reps` calls captured in one CUDA
    graph, the graph replayed 5 times between CUDA events, so the host's
    enqueue cost is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(5):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (5 * reps)


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


# the port's copy of constants.BASE_TAB_ST: the category of a base on the
# non-converted, C2T and G2A strands
_BASE_TAB_ST = ((0, 1, 2, 3), (0, 5, 2, 7), (4, 1, 6, 3))


def wgbs_inputs(np, n, seed, depth=18):
    """Accumulators drawn from genotypes as a WGBS pileup has them, as
    `tests/test_torch_emit.py` `called_pileup` draws them, vectorised:
    94% hom-ref, 4% het, 2% hom-alt; reads on both bisulfite strands with
    per-site methylation and 3% base errors; Poisson depth around `depth`
    (the 600k fixture's 18) with 2% of positions at 6x it; 10% uncovered.
    Returns counts2 [n,2,8] i32, qual_sum [n,8] f32, mapq2_sum [n] f32,
    ref [n] i32."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(1, 5, n).astype(np.int32)
    ref[rng.random(n) < 0.02] = 0
    rb = np.maximum(ref - 1, 0)
    u = rng.random(n)
    other, hom_alt = rng.integers(0, 4, n), rng.integers(0, 4, n)
    alleles = (np.where(u < 0.98, rb, hom_alt),
               np.where(u < 0.94, rb, np.where(u < 0.98, other, hom_alt)))
    d = rng.poisson(depth * np.where(rng.random(n) < 0.02, 6, 1))
    d[rng.random(n) < 0.1] = 0
    meth = rng.random(n)
    tab = np.array(_BASE_TAB_ST)
    rows = np.arange(n)
    p = np.zeros((n, 8))
    for b in alleles:
        for s in (1, 2):
            for bb, pb in ((b, 0.97), (rng.integers(0, 4, n), 0.03)):
                w = 0.25 * pb
                # C on C2T, G on G2A: unmethylated, it reads as T or A
                meth_site = bb == s
                np.add.at(p, (rows[meth_site], tab[s][3 if s == 1 else 0]),
                          w * (1 - meth[meth_site]))
                np.add.at(p, (rows, tab[s][bb]),
                          np.where(meth_site, w * meth, w))
    # both orientations carry the same probabilities
    pv = np.repeat(p[:, None, :], 2, axis=1).reshape(n, 16)
    counts2 = rng.multinomial(d, pv / pv.sum(axis=1, keepdims=True)).reshape(
        n, 2, 8).astype(np.int32)
    counts = counts2.sum(axis=1)
    qual_sum = np.floor(counts * rng.uniform(25.0, 40.0, (n, 8))).astype(
        np.float32
    )
    mq = np.where(rng.random(n) < 0.9, 60, rng.integers(0, 60, n))
    mapq2 = (counts.sum(axis=1) * mq * mq).astype(np.float32)
    return counts2, qual_sum, mapq2, ref


def column_inputs(np, kind, n=N_POS):
    """K2's inputs, counts [n,8], quals [n,8] and ref [n], int32. kind
    "a": `genotype_inputs` (het-rich, half the categories empty); kind
    "b": the column tier's counterpart of `wgbs_inputs`, as the engine's
    `_call_batch` receives it: counts2 summed over orientation, quals by
    the f32 rounding rule (`agg_quals_f32`), the first n covered rows."""
    if kind == "a":
        return genotype_inputs(np, n, 0)[2:]
    counts2, qual_sum, _mapq2, ref = wgbs_inputs(np, n + n // 4, 0)
    counts = counts2.sum(axis=1)
    live = counts > 0
    avg = qual_sum / np.where(live, counts, 1).astype(np.float32)
    quals = np.where(live, np.floor(np.float32(0.5) + avg), 0)
    cov = np.nonzero(live.any(axis=1))[0][:n]
    if len(cov) != n:
        raise AssertionError(f"column_inputs: {len(cov)} covered rows")
    return (counts[cov].astype(np.int32), quals[cov].astype(np.int32),
            ref[cov])


def k3_batch(torch, np, dev, kind, n=N_POS):
    """K3's inputs on the card: the plain f64 model's outputs on a batch
    of pileup planes (`call_genotypes_pileup_plain`, on the card) plus
    its counts2, mapq2_sum and ref, and the emit tables. kind "a":
    `genotype_inputs` (a het-rich random mix) with a mapq2 sum, 8 rows of
    it at or above 2^24; kind "b": `wgbs_inputs` at depth 18. Returns
    (args of `emit_fields_cuda`, the rows past 2^24)."""
    from bs_call_tpu_torch.ops.emit_tables import emit_tables
    from bs_call_tpu_torch.ops.genotype import call_genotypes_pileup_plain
    from bs_call_tpu_torch.ops.params import ModelParams, model_tables

    if kind == "a":
        counts2, qual_sum, counts, _quals, ref = genotype_inputs(np, n, 0)
        rng = np.random.default_rng(2)
        mq = rng.integers(0, 61, n)
        mapq2 = (counts.sum(axis=1) * mq * mq).astype(np.float32)
        deep = rng.choice(n, min(8, n), replace=False)
        mapq2[deep] = np.float32(2.0**24) + 512 * np.arange(len(deep))
    else:
        counts2, qual_sum, mapq2, ref = wgbs_inputs(np, n, 0)
        deep = np.nonzero(mapq2 >= 2.0**24)[0]
    c2, qs, m2, r = (torch.from_numpy(a).to(dev)
                     for a in (counts2, qual_sum, mapq2, ref))
    tables = model_tables(ModelParams(), torch.float64, dev)
    model = call_genotypes_pileup_plain(c2, qs, r, tables)[:4]
    return (*model, c2, m2, r, emit_tables(dev)), deep


def compare_model(torch, tag, got, want, dtype):
    """The model's outputs (gt_prob, max_gt, margin, off_sum) against the
    plain version's: max_gt equal on the rows clear of a tie, gt_prob
    within rtol = atol = 1e-12 (f64) or 2e-5 (f32), margin and off_sum as
    set out below. Returns (max|d gt_prob|, its share of assert_close's
    limit)."""
    f64 = dtype == torch.float64
    tol, tie = (1e-12, 1e-9) if f64 else (2e-5, 1e-3)
    gp, mx, mg, off = got
    w_gp, w_mx, w_mg, w_off = want
    if not torch.equal(mx[w_mg > tie], w_mx[w_mg > tie]):
        raise AssertionError(f"{tag}: max_gt differs")
    torch.testing.assert_close(gp, w_gp, rtol=tol, atol=tol)
    torch.testing.assert_close(off, w_off, rtol=tol if f64 else 1e-4,
                               atol=1e-30)
    # margin is a difference of two log-likelihoods of up to ~10^3: in f32
    # its rounding is one ulp of those, 6e-5
    torch.testing.assert_close(mg, w_mg, rtol=tol, atol=tol if f64 else 2e-4)
    if gp.numel() == 0:
        return 0.0, 0.0
    return (gp - w_gp).abs().max().item(), close_ratio(gp, w_gp, tol, tol)


def one_element_in(x):
    """A copy of x that starts one element into its storage: contiguous,
    not 16-byte aligned."""
    out = x.new_empty(x.numel() + 1)[1:].view(x.shape)
    out.copy_(x)
    return out


def k2_cases(torch, np, dev, cols):
    """K2's edge cases from batch (b)'s columns: ragged sizes about its
    32-position tiles, rows one element into their storage (the 4-byte
    staging path), all-zero rows, and quals and ref outside their tables
    (clamped by K2 and its plain version alike)."""
    cases = [(f"n={m}", tuple(x[:m] for x in cols))
             for m in (1, 2, 63, 64, 65, 127, 128, 129, 4097)]
    for m in (129, 4097):
        cases.append((f"n={m} unaligned",
                      tuple(one_element_in(x[:m]) for x in cols)))
    counts, quals, ref = (x[:4097].clone() for x in cols)
    cases.append(("all-zero rows", (torch.zeros_like(counts),
                                    torch.zeros_like(quals), ref)))
    rng = np.random.default_rng(3)
    bad = torch.from_numpy(rng.random(tuple(quals.shape)) < 0.3).to(dev)
    wild = torch.from_numpy(
        rng.choice([-7, -1, 44, 63, 1000], tuple(quals.shape)).astype(
            np.int32)).to(dev)
    ref[::3] = torch.from_numpy(rng.choice(
        [-2, -1, 5, 9], len(ref[::3])).astype(np.int32)).to(dev)
    cases.append(("out-of-range quals and ref",
                  (counts, torch.where(bad, wild, quals), ref)))
    return cases


def check_k2(torch, np, dev):
    """K2's column entry, f64 and f32, against its plain version on the
    two batches of `column_inputs` (each timed) and on `k2_cases`."""
    from bs_call_tpu_torch.ops import genotype as G
    from bs_call_tpu_torch.ops.kernels import genotype_cuda as K2
    from bs_call_tpu_torch.ops.params import ModelParams, model_tables

    batches = {kind: tuple(torch.from_numpy(a).to(dev)
                           for a in column_inputs(np, kind))
               for kind in "ab"}
    results = {}
    for dtype in (torch.float64, torch.float32):
        sfx = "f64" if dtype == torch.float64 else "f32"
        isz = 8 if dtype == torch.float64 else 4
        tables = model_tables(ModelParams(), dtype, dev)
        res, errs = {}, []
        for kind, args in batches.items():
            got = K2.genotype_column(*args, tables)
            want = G.call_genotypes_plain(*args, tables)
            torch.cuda.synchronize()
            err, ratio = compare_model(torch, f"K2 column {sfx} batch {kind}",
                                       got, want, dtype)
            errs.append(err)
            ms = device_ms(lambda: K2.genotype_column(*args, tables), torch)
            eager_ms = time_ms(lambda: K2.genotype_column(*args, tables),
                               torch)
            plain_ms = time_ms(lambda: G.call_genotypes_plain(*args, tables),
                               torch)
            n_in = (64 + 4) * N_POS
            n_out = (10 * isz + 4 + 2 * isz) * N_POS
            flops = (model_flops(np, args[0].cpu().numpy())
                     if dtype == torch.float64 else 0.0)
            b_ms, b_by = bound(n_in + n_out, flops)
            key = "" if kind == "a" else "_wgbs"
            res.update({"ms" + key: ms, "eager_ms" + key: eager_ms,
                        "plain_ms" + key: plain_ms, "bound_ms" + key: b_ms})
            res["bound_by"] = b_by
            log(f"K2 genotype_column_{sfx} batch {kind}: N={N_POS} max|d "
                f"gt_prob|={err:.3e}; assert_close at {ratio:.3f} of its "
                f"limit; kernel {ms:.4f} ms (eager "
                f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")
        for tag, args in k2_cases(torch, np, dev, batches["b"]):
            got = K2.genotype_column(*args, tables)
            want = G.call_genotypes_plain(*args, tables)
            torch.cuda.synchronize()
            err, ratio = compare_model(torch, f"K2 column {sfx} {tag}", got,
                                       want, dtype)
            errs.append(err)
            log(f"K2 genotype_column_{sfx} {tag}: max|d gt_prob|={err:.3e}, "
                f"assert_close at {ratio:.3f} of its limit")
        results[f"genotype_column_{sfx}"] = {
            "max_abs_err": max(errs), **res, "library_ms": None}
    return results


def check_column_pipeline(torch, np, dev, card):
    """The column tier's chunk pipeline (`TorchCallEngine._pipe_chunks`)
    on the card, f32 and f64: 180,000 of `column_inputs`' WGBS rows at
    batch_positions 32,768 (five chunks and a ragged sixth), pipelined,
    against a sequential run of K2 a chunk at a time with a blocking copy
    out (each chunk zero-padded as the pipeline pads it), bit for bit, and
    against the plain version within `check_k2`'s tolerances; K2's
    launches by dtype equal the chunks and `column_chunks`. Both paths,
    and the driver with each chunk's H2D on a copy stream of its own (two
    streams, the design the engine did not keep), are timed in turns, five
    samples each, as host wall ms a call."""
    from bs_call_tpu_torch.config import CallerConfig
    from bs_call_tpu_torch.ops import genotype as G
    from bs_call_tpu_torch.ops.kernels import genotype_cuda as K2
    from bs_call_tpu_torch.pipeline.engine import TorchCallEngine

    n = 180_000
    cols = column_inputs(np, "b", n)
    for dtype in (torch.float32, torch.float64):
        sfx = "f64" if dtype == torch.float64 else "f32"
        eng = TorchCallEngine(CallerConfig(exact=dtype == torch.float64),
                              dev)
        bp = eng.cfg.batch_positions
        tables = eng._tables[0]

        def pipelined():
            return eng._pipe_chunks(*cols, *eng._column_fns())

        def sequential():
            outs = [[], [], [], []]
            for s in range(0, n, bp):
                m = min(bp, n - s)
                args = []
                for a in cols:
                    pad = np.zeros((bp, *a.shape[1:]), np.int32)
                    pad[:m] = a[s:s + m]
                    args.append(torch.from_numpy(pad).to(dev))
                for acc, t in zip(outs, K2.genotype_column(*args, tables)):
                    acc.append(t.cpu().numpy()[:m])
            return [np.concatenate(o) for o in outs]

        K2.genotype_column.launches_f32 = K2.genotype_column.launches_f64 = 0
        got = pipelined()
        launches = getattr(K2.genotype_column, f"launches_{sfx}")
        chunks = -(-n // bp)
        if not launches == eng.column_chunks == chunks:
            raise AssertionError(
                f"column pipeline {sfx}: {launches} K2 launches, "
                f"{eng.column_chunks} column chunks, {chunks} chunks")
        want = sequential()
        for name, g, w in zip(("gt_prob", "max_gt", "margin", "off_sum"),
                              got, want):
            if not np.array_equal(g, w.astype(g.dtype)):
                raise AssertionError(f"column pipeline {sfx}: {name} differs "
                                     "from the sequential run")
        plain = G.call_genotypes_plain(
            *(torch.from_numpy(a).to(dev) for a in cols), tables)
        err, ratio = compare_model(
            torch, f"column pipeline {sfx}",
            [torch.from_numpy(g).to(dev, t.dtype) for g, t in zip(got, plain)],
            plain, dtype)
        # the two-stream design, for the record: the same driver with each
        # chunk's H2D on a copy stream and K2 and the D2H on the current
        # stream after the H2D's event (the engine queues all three on the
        # current stream)
        two = TorchCallEngine(CallerConfig(exact=dtype == torch.float64),
                              dev)
        copy = torch.cuda.Stream(dev)
        copied = {}  # id(slot) -> the event of its H2D

        def two_dispatch(slot):
            compute = torch.cuda.current_stream(dev)
            ev = copied.setdefault(id(slot), torch.cuda.Event())
            with torch.cuda.stream(copy):
                for d, h in zip(slot.dev_in, slot.host_in):
                    d.copy_(h, non_blocking=True)
                ev.record(copy)
            compute.wait_event(ev)
            for h, t in zip(slot.host_out,
                            G.call_genotypes(*slot.dev_in, two._tables[0])):
                h.copy_(t, non_blocking=True)
            slot.done.record(compute)
            return slot

        two_finish = two._column_fns()[1]

        def two_streams():
            return two._pipe_chunks(*cols, two_dispatch, two_finish)

        if not all(np.array_equal(a, b) for a, b in zip(two_streams(), got)):
            raise AssertionError(f"column pipeline {sfx}: two streams differ")
        fns = {"sequential": sequential, "pipelined": pipelined,
               "two_streams": two_streams}
        times = {tag: [] for tag in fns}
        tags = list(fns)
        for i in range(5):
            for tag in tags[i % 3:] + tags[:i % 3]:
                t0 = time.perf_counter()
                fns[tag]()
                times[tag].append(1e3 * (time.perf_counter() - t0))
        log(f"[{card}] column pipeline {sfx}: {n} rows in {chunks} chunks of "
            f"{bp}: bit-equal to K2 a chunk at a time, {launches} K2 "
            f"launches = column_chunks; max|d gt_prob| against the plain "
            f"version {err:.3e} (assert_close at {ratio:.3f} of its limit); "
            f"host wall ms a call, in turns: pipelined (one stream) "
            f"{[round(t, 3) for t in times['pipelined']]}, two streams (H2D "
            f"on a copy stream) {[round(t, 3) for t in times['two_streams']]}"
            f", sequential {[round(t, 3) for t in times['sequential']]}")


# K3's fields that no libm reaches: equal to the plain version's on every
# row, flagged or not (the host reads gt1 of flagged rows as neighbours)
K3_EXACT_EVERYWHERE = ("covered", "gt1", "max_gt", "ref5", "dp1", "gl_len",
                       "cg_code", "cond_cg", "het")


def compare_k3(torch, np, tag, args, ctx=None):
    """K3 against its plain version on the same inputs and ctx: every
    field equal on the rows neither flags (fs_hi, the Fisher log10 p
    beside its integer fs_int, within 1e-12 relative: the same libdevice
    exp/log on both sides), the fields of K3_EXACT_EVERYWHERE on every
    row; with no ctx both chunk edges flagged. Returns the unpacked fields
    (kernel, plain), the rows neither flags and the largest fs_hi
    difference there."""
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
    from bs_call_tpu_torch.ops.kernels import emit_device as E

    n = args[0].shape[0]
    got = K3.emit_fields_cuda(*args, True, ctx)
    want = E.pack_fields(E.emit_fields_plain(*args, True, ctx))
    torch.cuda.synchronize()
    g = E.unpack_fields(got.cpu().numpy(), n)
    w = E.unpack_fields(want.cpu().numpy(), n)
    ok = ~(g["risk"] | w["risk"])
    for name, a in g.items():
        rows = slice(None) if name in K3_EXACT_EVERYWHERE else ok
        if name not in ("risk", "fs_hi") and not np.array_equal(
            a[rows].view(np.uint8), w[name][rows].view(np.uint8)
        ):
            raise AssertionError(f"K3 {tag}: {name} differs from the plain "
                                 f"version")
    err = float(np.abs(g["fs_hi"][ok] - w["fs_hi"][ok]).max(initial=0.0))
    np.testing.assert_allclose(g["fs_hi"][ok], w["fs_hi"][ok], rtol=1e-12,
                               atol=1e-15)
    if ctx is None and not (g["risk"][[0, -1]].all()
                            and w["risk"][[0, -1]].all()):
        raise AssertionError(f"K3 {tag}: the chunk's edges not flagged")
    return g, w, ok, err


# K3's ctx in the checks and times: a CpG pair's halves (CC, code 5; GG,
# code 8) just before and just after the chunk
K3_CTX = (5, 8)


def check_k3(torch, np, dev):
    """K3 on the two batches of `k3_batch` at N_POS, with no ctx and with
    K3_CTX, then on ragged sizes and on a batch whose het rows sit on the
    128-row tile seams; both batches timed with and without ctx."""
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
    from bs_call_tpu_torch.ops.kernels import emit_device as E

    result, batches, errs = {}, {}, []
    ctx = torch.tensor(K3_CTX, dtype=torch.int32, device=dev)
    for kind in "ab":
        args, deep = k3_batch(torch, np, dev, kind)
        batches[kind] = args
        g, w, ok, err = compare_k3(torch, np, f"batch {kind}", args)
        errs.append(err)
        cov = g["covered"][deep]
        if not (g["risk"][deep][cov].all() and w["risk"][deep][cov].all()):
            raise AssertionError("K3: a mapq2 sum past 2^24 was not flagged")
        if ok.sum() < N_POS // 2:
            raise AssertionError(f"K3: only {ok.sum()} rows unflagged")
        n_diff = int((g["risk"] != w["risk"]).sum())
        # ctx known: the edges get their CG context, flagged only for
        # their own reasons
        gc, wc, okc, err = compare_k3(torch, np, f"batch {kind}, ctx", args,
                                      ctx)
        errs.append(err)
        edges = [(int(a["cg_code"][r]), bool(a["risk"][r])) for a in (g, gc)
                 for r in (0, -1)]
        if int(gc["risk"].sum()) > int(g["risk"].sum()):
            raise AssertionError(f"K3 batch {kind}: ctx flagged more rows")
        ms = device_ms(lambda: K3.emit_fields_cuda(*args), torch)
        ms_ctx = device_ms(lambda: K3.emit_fields_cuda(*args, True, ctx),
                           torch)
        eager_ms = time_ms(lambda: K3.emit_fields_cuda(*args), torch)
        plain_ms = time_ms(
            lambda: E.pack_fields(E.emit_fields_plain(*args)), torch)
        log(f"K3 emit_fields_f64 batch {kind}: N={N_POS}, het share "
            f"{g['het'].mean():.4f}; every field equal on {ok.sum()} rows "
            f"neither flags (max|d fs|={err:.3e}, tol 1e-12 relative); risk "
            f"bits differ on {n_diff} rows (kernel {int(g['risk'].sum())}, "
            f"plain {int(w['risk'].sum())} flagged); kernel {ms:.4f} ms "
            f"(eager {eager_ms:.4f} ms), plain {plain_ms:.4f} ms")
        log(f"K3 emit_fields_f64 batch {kind}, ctx {list(K3_CTX)}: every "
            f"field equal on {okc.sum()} rows neither flags, risk bits "
            f"differ on {int((gc['risk'] != wc['risk']).sum())} rows (kernel "
            f"{int(gc['risk'].sum())} flagged); edges (cg code, risk) "
            f"without ctx {edges[:2]}, with {edges[2:]}; kernel "
            f"{ms_ctx:.4f} ms")
        sfx = "" if kind == "a" else "_wgbs"
        result.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                       "ms_ctx" + sfx: ms_ctx,
                       "eager_ms" + sfx: eager_ms,
                       "risk_diff_rows" + sfx: n_diff})
    # ragged sizes (the last tile short, chunks of one or two rows), a
    # chunk whose tensors start one element into their storage (not
    # 16-byte aligned: K3 copies them with 4-byte copies, not bulk
    # copies), and tile seams
    a, b = batches["a"], batches["b"]
    cases = [(f"n={m}", tuple(x[:m] for x in b[:7]) + b[7:])
             for m in (1, 2, 127, 129, 4097)]

    cases.append(("n=129 unaligned",
                  tuple(one_element_in(x[:129]) for x in b[:7]) + b[7:]))
    seam = torch.zeros(N_POS, dtype=torch.bool, device=dev)
    seam[0::128] = True
    seam[127::128] = True
    cases.append(("het rows on the seams", tuple(
        torch.where(seam.view(-1, *[1] * (x.dim() - 1)), y, x)
        for x, y in zip(b[:7], a[:7])) + b[7:]))
    for tag, args in cases:
        g, w, ok, err = compare_k3(torch, np, tag, args)
        errs.append(err)
        log(f"K3 {tag}: equal on {ok.sum()} rows neither flags, het "
            f"{int(g['het'].sum())}, risk bits differ on "
            f"{int((g['risk'] != w['risk']).sum())} rows")
    if not g["het"][seam.cpu().numpy()].mean() > 0.9:
        raise AssertionError("K3 seams: the seam rows are not het")
    # reads gt_prob, max_gt, margin, off_sum, counts2, mapq2_sum, ref;
    # writes the packed row; its f64 work is far below its bytes
    b_ms, b_by = bound((80 + 4 + 8 + 8 + 64 + 4 + 4 + E.ROW_BYTES) * N_POS)
    log(f"K3 emit_fields_f64: bound {b_ms:.4f} ms ({b_by}) at N={N_POS}")
    return {"max_abs_err": max(errs), **result, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


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


def hot_batch(np, n_pos, seed):
    """5,000 reads of mapq 59, 150 bases each, over one position (2,000),
    which takes its mapq2 sum past 2^24, plus a trimmed-out row and rows
    that straddle tile edges and start before 0."""
    rng = np.random.default_rng(seed)
    R, L = 5000, 160
    starts = np.sort(2000 - rng.integers(0, 150, R)).astype(np.int32)
    starts[:40] = rng.integers(-150, 0, 40)
    starts.sort()
    q = rng.integers(20, 44, size=(R, L))
    rd = ((q << 2) | rng.integers(0, 4, size=(R, L))).astype(np.uint8)
    rd[:, 150:] = 0
    rd[R // 2] = 63 << 2  # every byte masked: the row is trimmed away
    ori = rng.integers(0, 2, R).astype(np.int32)
    strand = rng.integers(0, 3, R).astype(np.int32)
    mapq = np.full(R, 59, np.int32)
    return rd, starts, ori, strand, mapq


def k12_batches(torch, np, dev):
    """K12's timed batches on the card, each (rows [rd, starts, ori,
    strand, mapq], tiles, ref) at N_POS: "a", `read_batch(4096, 256)`,
    random reads; "b", `wgbs_reads` at depth 18, sorted and padded to
    L = 160 with its tile table (`prepare_batch`); "b256", the same reads
    as the engine pads them (`pad_read_batch` to a power-of-two row count
    and L = 256, `tile_rows`); "hot", `hot_batch`."""
    from bs_call_tpu_torch.ops.kernels import pileup_device as PD

    ref_a = np.random.default_rng(4).integers(0, 5, N_POS).astype(np.int32)
    out = {}
    for kind, batch in (("a", read_batch(np, 4096, 256, N_POS, 1)),
                        ("hot", hot_batch(np, N_POS, 5))):
        R, L = batch[0].shape
        out[kind] = ([torch.from_numpy(a).to(dev) for a in batch],
                     torch.from_numpy(PD.tile_rows(batch[1], R, N_POS,
                                                   L)).to(dev),
                     torch.from_numpy(ref_a).to(dev))
    wb, wref = wgbs_reads(np, N_POS, 0)
    rows, tiles = PD.prepare_batch(
        *[torch.from_numpy(a).to(dev) for a in wb], N_POS)
    out["b"] = (list(rows), tiles, torch.from_numpy(wref).to(dev))
    L = wb[0].shape[1]
    reads = dict(zip(("rd", "starts", "ori", "strand", "mapq"), wb))
    reads["lens"] = np.full(len(wb[1]), L, np.int32)
    n_rows = int(((wb[1] <= N_POS - 1) & (wb[1] + L - 1 >= 0)).sum())
    r_pad = 1 << max(10, (n_rows - 1).bit_length())
    padded = PD.pad_read_batch(reads, 0, N_POS - 1, r_pad, 256)
    out["b256"] = ([torch.from_numpy(a).to(dev) for a in padded],
                   torch.from_numpy(PD.tile_rows(padded[1], n_rows, N_POS,
                                                 256)).to(dev),
                   out["b"][2])
    return out


def k12_edge_batch(np, case, seed):
    """((rd, starts, ori, strand, mapq), n_pos, min_qual) of one of K12's
    edge cases, the rows sorted by start: "L64" and "L2048", the narrowest
    and widest rows; "sparse", tiles with no row; "deep", 600 rows of 256
    bytes over 100 positions (a tile's rows far past one stage); "ragged",
    n_pos not a multiple of 128, rows starting before 0 and running past
    n_pos; "minq0", min_qual 0, where the trim decides (q = 0 bytes count
    inside a row's live span and not outside it)."""
    rng = np.random.default_rng(seed)
    n_pos, R, L, lo_len, min_qual = 8192, 1500, 256, 100, 20
    if case == "L64":
        R, L, lo_len = 3000, 64, 30
    elif case == "L2048":
        n_pos, R, L, lo_len = 16384, 400, 2048, 1000
    elif case == "ragged":
        n_pos = 8192 + 77
    elif case == "minq0":
        min_qual = 0
    lens = rng.integers(lo_len, L + 1, R)
    starts = rng.integers(-L, n_pos + 40, R)
    if case == "sparse":
        starts = np.where(rng.random(R) < 0.5, rng.integers(-50, 2000, R),
                          rng.integers(6000, n_pos, R))
    elif case == "deep":
        starts[:600] = rng.integers(1000 - 100, 1100, 600)
    q = rng.integers(0, 44, size=(R, L))
    q[rng.random((R, L)) < 0.02] = 63
    rd = ((q << 2) | rng.integers(0, 4, size=(R, L))).astype(np.uint8)
    rd[np.arange(L)[None, :] >= lens[:, None]] = 0
    if case == "minq0":
        rd[::5, :8] = rng.integers(0, 4, size=(len(rd[::5]), 8))  # q = 0
        rd[::9] = 63 << 2  # every byte masked: the row is trimmed away
    order = np.argsort(starts, kind="stable")
    return (rd[order], starts[order].astype(np.int32),
            rng.integers(0, 2, R).astype(np.int32),
            rng.integers(0, 3, R).astype(np.int32),
            rng.integers(0, 61, R).astype(np.int32)), n_pos, min_qual


K12_EDGE_CASES = ("L64", "L2048", "sparse", "deep", "ragged", "minq0")


def check_k12_case(torch, G, PD, K12, tag, args, tiles, ref, n_pos,
                   min_qual, tables):
    """K12 against its plain version on one batch: the planes and quals
    exact, the model as `compare_model`. Returns (K12's outputs, the plain
    version's, max|d gt_prob|, its share of assert_close's limit)."""
    got = K12.pileup_genotype(*args, tiles, ref, n_pos, min_qual, tables)
    c2, qs, m2 = PD.device_pileup_plain(*args, n_pos, min_qual)
    want = (c2, qs, m2, *G.call_genotypes_pileup_plain(c2, qs, ref, tables))
    torch.cuda.synchronize()
    for name, a, b in zip(("counts2", "qual_sum", "mapq2_sum"), got[:3],
                          want[:3]):
        if not torch.equal(a, b):
            raise AssertionError(f"K12 {tag}: {name} differs")
    if not torch.equal(got[7], want[7]):
        raise AssertionError(f"K12 {tag}: quals differ")
    err, ratio = compare_model(torch, f"K12 {tag}", got[3:7], want[3:7],
                               tables.dtype)
    return got, want, err, ratio


def check_k12(torch, np, dev):
    """K12 against its plain version, f64 and f32, on `k12_batches` and on
    `K12_EDGE_CASES` (the hot batch and "deep" in f64 only); K12 f64
    timed on batches (a) and (b)."""
    from bs_call_tpu_torch.ops import genotype as G
    from bs_call_tpu_torch.ops.kernels import pileup_device as PD
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12
    from bs_call_tpu_torch.ops.params import ModelParams, model_tables

    # f32 (off the main path) not at the hot position, where K2's f32
    # tolerances do not hold: at depth 5,000 an f32 log-likelihood of ~1e4
    # carries ~1e-3 of rounding
    dtypes = ((torch.float64, 1e-12), (torch.float32, 2e-5))
    result, errs = {}, []
    for kind, (args, tiles, ref) in k12_batches(torch, np, dev).items():
        R, L = args[0].shape
        for dtype, tol in dtypes[: 1 if kind == "hot" else 2]:
            tables = model_tables(ModelParams(), dtype, dev)
            tag = f"batch {kind} {'f64' if dtype == torch.float64 else 'f32'}"
            got, want, err, ratio = check_k12_case(
                torch, G, PD, K12, tag, args, tiles, ref, N_POS, 20, tables)
            errs.append(err)
            hot = int((got[2] >= 2.0**24).sum())
            log(f"K12 {tag}: R={R} L={L} n_pos={N_POS} integers exact, "
                f"{int(got[0].sum())} bases, {hot} positions with mapq2_sum "
                f">= 2^24; max|d gt_prob|={err:.3e}, assert_close(rtol="
                f"{tol:g}, atol={tol:g}) at {ratio:.3f} of its limit")
            if kind == "hot" and hot == 0:
                raise AssertionError("K12 hot: mapq2_sum never passed 2^24")
            if kind not in ("a", "b") or dtype != torch.float64:
                continue

            def k12(a=args, tl=tiles, r=ref, t=tables):
                return K12.pileup_genotype(*a, tl, r, N_POS, 20, t)

            def plain(a=args, r=ref, t=tables):
                c2, qs, _ = PD.device_pileup_plain(*a, N_POS, 20)
                return G.call_genotypes_pileup_plain(c2, qs, r, t)

            ms_a, ms_b = device_ms(k12, torch), device_ms(k12, torch)
            ms = (ms_a + ms_b) / 2
            eager_ms = time_ms(k12, torch)
            plain_ms = time_ms(plain, torch)
            n_in = (args[0].numel() + 16 * R + 8 * tiles.shape[0]
                    + 4 * N_POS)
            n_out = (PILEUP_BYTES + MODEL_OUT_BYTES) * N_POS
            b_ms, b_by = bound(n_in + n_out,
                               model_flops(np, want[0].sum(1).cpu().numpy()))
            log(f"K12 pileup_genotype_f64 batch {kind}: kernel {ms:.4f} ms "
                f"({ms_a:.4f}, {ms_b:.4f}; eager {eager_ms:.4f} ms); plain "
                f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
            sfx = "" if kind == "a" else "_wgbs"
            result.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                           "bound_ms" + sfx: b_ms, "bound_by" + sfx: b_by,
                           "eager_ms" + sfx: eager_ms})
    for i, case in enumerate(K12_EDGE_CASES):
        batch, n_pos, min_qual = k12_edge_batch(np, case, 30 + i)
        R, L = batch[0].shape
        args = [torch.from_numpy(a).to(dev) for a in batch]
        tiles = torch.from_numpy(PD.tile_rows(batch[1], R, n_pos, L)).to(dev)
        ref = torch.from_numpy(np.random.default_rng(i).integers(
            0, 5, n_pos).astype(np.int32)).to(dev)
        empty = int((tiles[:, 1] <= tiles[:, 0]).sum())
        deepest = int((tiles[:, 1] - tiles[:, 0]).max())
        # f32 not on "deep" (depth ~600), for the hot batch's reason
        for dtype, _tol in dtypes[: 1 if case == "deep" else 2]:
            tables = model_tables(ModelParams(), dtype, dev)
            tag = f"{case} {'f64' if dtype == torch.float64 else 'f32'}"
            got, _, err, ratio = check_k12_case(
                torch, G, PD, K12, tag, args, tiles, ref, n_pos, min_qual,
                tables)
            errs.append(err)
            log(f"K12 {tag}: R={R} L={L} n_pos={n_pos} min_qual={min_qual}"
                f", {empty} tiles with no row, at most {deepest} rows a tile "
                f"({deepest * L} B); integers exact, {int(got[0].sum())} "
                f"bases; max|d gt_prob|={err:.3e}, assert_close at "
                f"{ratio:.3f} of its limit")
        if case == "sparse" and not empty:
            raise AssertionError("K12 sparse: every tile has rows")
    return {"max_abs_err": max(errs), **result, "library_ms": None}


def prep_batch(np, n_pos, seed):
    """A batch K12 cannot take as it is: 3,000 reads of 100-byte rows in
    no order, 200 all-zero padding rows at start -1 (the JAX package's
    padding), 100 live rows wholly before 0 and 100 past the chunk."""
    rng = np.random.default_rng(seed)
    R, L = 3000, 100
    lens = rng.integers(40, L + 1, R)
    q = rng.integers(0, 44, size=(R, L))
    q[rng.random((R, L)) < 0.02] = 63
    rd = ((q << 2) | rng.integers(0, 4, size=(R, L))).astype(np.uint8)
    rd[np.arange(L)[None, :] >= lens[:, None]] = 0
    starts = rng.integers(-L // 2, n_pos, R)
    rd[:200] = 0
    starts[:200] = -1
    starts[200:300] = -L - rng.integers(0, 1000, 100)
    starts[300:400] = n_pos + rng.integers(0, 1000, 100)
    perm = rng.permutation(R)
    return (rd[perm], starts[perm].astype(np.int32),
            rng.integers(0, 2, R).astype(np.int32),
            rng.integers(0, 3, R).astype(np.int32),
            rng.integers(0, 61, R).astype(np.int32))


def check_pileup_model(torch, tag, got, want, dtype):
    """K12's outputs (gt_prob, max_gt, margin, off_sum, counts2,
    qual_sum, mapq2_sum) against the plain version's: the planes equal,
    the model as `compare_model`. Returns (max|d gt_prob|, its share of
    assert_close's limit)."""
    for name, a, b in zip(("counts2", "qual_sum", "mapq2_sum"), got[4:],
                          want[4:]):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: {name} differs")
    return compare_model(torch, tag, got[:4], want[:4], dtype)


def check_fused_pileup_call(torch, np, dev):
    """`fused_pileup_call` on the card, f32 and f64, on the fused tier's
    chunk and on `prep_batch`, against the plain pileup and model on the
    unsorted batch. The launch counts are read around the driving calls,
    one dtype at a time; the timed calls come after."""
    from bs_call_tpu_torch.ops import genotype as G
    from bs_call_tpu_torch.ops.kernels import pileup_device as PD
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12
    from bs_call_tpu_torch.ops.params import ModelParams, model_tables

    rng = np.random.default_rng(6)
    ref = torch.from_numpy(rng.integers(0, 5, N_POS).astype(np.int32)).to(dev)
    batches = {
        "chunk": [torch.from_numpy(a).to(dev)
                  for a in read_batch(np, 4096, 256, N_POS, 1)],
        "prep": [torch.from_numpy(a).to(dev)
                 for a in prep_batch(np, N_POS, 7)],
    }
    result, launches = {}, {}
    for dtype in (torch.float64, torch.float32):
        sfx = "f64" if dtype == torch.float64 else "f32"
        tables = model_tables(ModelParams(), dtype, dev)
        K12.pileup_genotype.launches = 0
        got = {case: PD.fused_pileup_call(*args, ref, N_POS, 20, tables)
               for case, args in batches.items()}
        launches[sfx] = K12.pileup_genotype.launches
        if launches[sfx] != len(batches):
            raise AssertionError(f"fused_pileup_call {sfx}: {launches[sfx]} "
                                 f"K12 launches for {len(batches)} calls")
        errs = []
        for case, args in batches.items():
            c2, qs, m2 = PD.device_pileup_plain(*args, N_POS, 20)
            want = (*G.call_genotypes_pileup_plain(c2, qs, ref, tables)[:4],
                    c2, qs, m2)
            torch.cuda.synchronize()
            err, ratio = check_pileup_model(
                torch, f"fused_pileup_call {case} {sfx}", got[case], want,
                dtype)
            errs.append(err)
            R, L = args[0].shape
            log(f"fused_pileup_call {case} {sfx}: R={R} L={L} n_pos={N_POS}, "
                f"one K12 launch a call, integers exact, "
                f"{int(want[4].sum())} bases; max|d gt_prob|={err:.3e}, "
                f"assert_close at {ratio:.3f} of its limit")
        args = batches["chunk"]
        (rows, *cols), tiles = PD.prepare_batch(*args, N_POS)

        def fused():
            return PD.fused_pileup_call(*args, ref, N_POS, 20, tables)

        def k12():
            return K12.pileup_genotype(rows, *cols, tiles, ref, N_POS, 20,
                                       tables)

        def plain():
            c2, qs, m2 = PD.device_pileup_plain(*args, N_POS, 20)
            return G.call_genotypes_pileup_plain(c2, qs, ref, tables)

        fused_ms, ms = device_ms(fused, torch), device_ms(k12, torch)
        prep_ms = device_ms(lambda: PD.prepare_batch(*args, N_POS), torch)
        eager_ms, plain_ms = time_ms(fused, torch), time_ms(plain, torch)
        isz = 8 if dtype == torch.float64 else 4
        n_in = (rows.numel() + 16 * rows.shape[0] + 8 * tiles.shape[0]
                + 4 * N_POS)
        n_out = (PILEUP_BYTES + 10 * isz + 4 + 2 * isz + 8) * N_POS
        flops = (model_flops(np, plain_counts(torch, PD, args))
                 if dtype == torch.float64 else 0.0)
        b_ms, b_by = bound(n_in + n_out, flops)
        log(f"fused_pileup_call {sfx} on the chunk: device {fused_ms:.4f} ms "
            f"(K12 {ms:.4f} ms, the preparation alone {prep_ms:.4f} ms), "
            f"eager {eager_ms:.4f} ms; plain {plain_ms:.4f} ms; K12 bound "
            f"{b_ms:.4f} ms ({b_by}: {n_in} B in, {n_out // N_POS} B a "
            f"position out)")
        result[sfx] = {"max_abs_err": max(errs), "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": None,
                       "fused_ms": fused_ms, "prep_ms": prep_ms,
                       "eager_ms": eager_ms}
    return result, launches


def plain_counts(torch, PD, args):
    """counts [N,8] of a batch's plain pileup, on the host."""
    return PD.device_pileup_plain(*args, N_POS, 20)[0].sum(1).cpu().numpy()


def wgbs_reads(np, n_pos, seed, depth=18, L=150):
    """Reads drawn as `wgbs_inputs` draws pileups: a reference, genotypes
    (94% hom-ref, 4% het, 2% hom-alt) and per-site methylation; reads of
    L bases at uniform starts to `depth`, each from one allele, on the C2T
    or G2A strand (an unmethylated C reads as T on C2T, an unmethylated G
    as A on G2A), with 3% base errors, q 25-40, mapq 60 for 90%; no read
    covers 10% of the positions (runs of 100). Returns the read batch
    (sorted by nothing) and ref [n_pos]."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(1, 5, n_pos).astype(np.int32)
    rb = ref - 1
    u = rng.random(n_pos)
    other, hom_alt = rng.integers(0, 4, n_pos), rng.integers(0, 4, n_pos)
    alleles = np.stack([np.where(u < 0.98, rb, hom_alt),
                        np.where(u < 0.94, rb,
                                 np.where(u < 0.98, other, hom_alt))])
    meth = rng.random(n_pos)
    R = depth * n_pos // L
    starts = rng.integers(-L // 2, n_pos, R)
    pos = starts[:, None] + np.arange(L)[None, :]
    inside = (pos >= 0) & (pos < n_pos)
    p = np.clip(pos, 0, n_pos - 1)
    base = alleles[rng.integers(0, 2, R)[:, None], p]
    strand = rng.integers(1, 3, R)
    conv = rng.random((R, L)) >= meth[p]
    c2t = (strand[:, None] == 1) & (base == 1) & conv
    g2a = (strand[:, None] == 2) & (base == 2) & conv
    base = np.where(c2t, 3, np.where(g2a, 0, base))
    err = rng.random((R, L)) < 0.03
    base = np.where(err, rng.integers(0, 4, (R, L)), base)
    q = rng.integers(25, 41, (R, L))
    gap = np.repeat(rng.random(-(-n_pos // 100)) < 0.1, 100)[:n_pos]
    rd = np.where(inside & ~gap[p], (q << 2) | base, 0).astype(np.uint8)
    mapq = np.where(rng.random(R) < 0.9, 60, rng.integers(0, 60, R))
    return (rd, starts.astype(np.int32),
            rng.integers(0, 2, R).astype(np.int32), strand.astype(np.int32),
            mapq.astype(np.int32)), ref


def check_fused_emit_chunk(torch, np, dev):
    """`fused_emit_chunk` on the card against its plain version (plain
    pileup, model, emit fields and compaction, on the card) on the read
    batches of K3's two kinds: (a) `read_batch`'s random bases (a
    het-rich mix) and (b) `wgbs_reads` at depth 18; then with cap below
    n_emit. Timed whole and its compaction alone."""
    from bs_call_tpu_torch.ops import genotype as G
    from bs_call_tpu_torch.ops.emit_tables import emit_tables
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
    from bs_call_tpu_torch.ops.kernels import emit_device as E
    from bs_call_tpu_torch.ops.kernels import pileup_device as PD
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12
    from bs_call_tpu_torch.ops.params import ModelParams, model_tables

    mt = model_tables(ModelParams(), torch.float64, dev)
    et = emit_tables(dev)
    rng = np.random.default_rng(8)
    wb, wref = wgbs_reads(np, N_POS, 0)
    batches = {"a": (read_batch(np, 4096, 256, N_POS, 1),
                     rng.integers(0, 5, N_POS).astype(np.int32)),
               "b": (wb, wref)}
    result = {}
    for kind, (b, ref) in batches.items():
        args = [torch.from_numpy(a).to(dev) for a in (*b, ref)]
        K12.pileup_genotype.launches = K3.emit_fields_cuda.launches = 0
        n_emit, pos, packed = E.fused_emit_chunk(*args, N_POS, 20, mt, et,
                                                 N_POS)
        counts = (K12.pileup_genotype.launches, K3.emit_fields_cuda.launches)
        if counts != (1, 1):
            raise AssertionError(f"fused_emit_chunk ({kind}): K12, K3 "
                                 f"launches {counts}, not one each")
        c2, qs, m2 = PD.device_pileup_plain(*args[:5], N_POS, 20)
        model = G.call_genotypes_pileup_plain(c2, qs, args[5], mt)[:4]
        w_n, w_pos, w_packed = E.compact_emitted(E.pack_fields(
            E.emit_fields_plain(*model, c2, m2, args[5], et)), N_POS, N_POS)
        n = int(n_emit)
        if n != int(w_n) or not torch.equal(pos, w_pos) or n == 0:
            raise AssertionError(f"fused_emit_chunk ({kind}): n_emit {n} or "
                                 f"positions differ from the plain version")
        g = E.unpack_fields(packed.cpu().numpy(), N_POS, n)
        w = E.unpack_fields(w_packed.cpu().numpy(), N_POS, n)
        ok = ~(g["risk"] | w["risk"])
        for name, a in g.items():
            rows = slice(None) if name in K3_EXACT_EVERYWHERE else ok
            if name not in ("risk", "fs_hi") and not np.array_equal(
                    a[rows].view(np.uint8), w[name][rows].view(np.uint8)):
                raise AssertionError(f"fused_emit_chunk ({kind}): {name} "
                                     f"differs from the plain version")
        np.testing.assert_allclose(g["fs_hi"][ok], w["fs_hi"][ok],
                                   rtol=1e-12, atol=1e-15)
        if ok.sum() < n // 2:
            raise AssertionError(f"fused_emit_chunk ({kind}): only "
                                 f"{ok.sum()} of {n} rows unflagged")
        n_diff = int((g["risk"] != w["risk"]).sum())
        cap = n - 100
        over, o_pos, o_packed = E.fused_emit_chunk(*args, N_POS, 20, mt, et,
                                                   cap)
        kept = E.unpack_fields(o_packed.cpu().numpy(), cap)
        if int(over) != n or not torch.equal(o_pos, pos[:cap]) or any(
                not np.array_equal(v.view(np.uint8), g[k][:cap].view(
                    np.uint8)) for k, v in kept.items()):
            raise AssertionError(f"fused_emit_chunk ({kind}): cap {cap} "
                                 f"below n_emit {n} not reported as such")

        def whole():
            return E.fused_emit_chunk(*args, N_POS, 20, mt, et, N_POS)

        ms = device_ms(whole, torch)
        compact_ms = device_ms(
            lambda: E.compact_emitted(packed, N_POS, N_POS), torch)
        eager_ms = time_ms(whole, torch)
        # compaction reads the packed rows and writes n_emit rows + pos
        c_ms, c_by = bound(E.ROW_BYTES * N_POS + (E.ROW_BYTES + 4) * N_POS)
        log(f"fused_emit_chunk ({kind}): R={b[0].shape[0]} L="
            f"{b[0].shape[1]} n_pos={N_POS}: n_emit {n}, het share "
            f"{g['het'].mean():.4f}; every field equal on {ok.sum()} rows "
            f"neither flags, risk bits differ on {n_diff} rows; cap {cap} "
            f"reports n_emit {int(over)}; device {ms:.4f} ms, of it "
            f"compaction {compact_ms:.4f} ms ({100 * compact_ms / ms:.1f}%, "
            f"bound {c_ms:.4f} ms, {c_by}); eager {eager_ms:.4f} ms")
        result[kind] = {"ms": ms, "compact_ms": compact_ms,
                        "compact_bound_ms": c_ms, "eager_ms": eager_ms,
                        "n_emit": n, "risk_diff_rows": n_diff}
    return result


def slab_kernel_ms(torch, devs, args, mts, ets):
    """Device ms of K12 on each slab's batch (`slab_batches`) and of K3 on
    its outputs with its ctx, each summed over the slabs: the kernels'
    share of a sharded call, CUDA graph replay. One device is one slab."""
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
    from bs_call_tpu_torch.ops.kernels import emit_device as E
    from bs_call_tpu_torch.ops.kernels import pileup_device as PD
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12

    batches = PD.slab_batches(devs, *args, N_POS)

    def k12(b, mt):
        rows, ref, n, tiles = b
        return K12.pileup_genotype(*rows, tiles, ref, n, 20, mt)

    outs = [k12(b, mt) for b, mt in zip(batches, mts)]
    ctx = E._gt1_halo([(E._ends(o[4]), E._ends(o[0])) for o in outs])
    k12_ms = sum(device_ms(lambda b=b, mt=mt: k12(b, mt), torch)
                 for b, mt in zip(batches, mts))
    k3_ms = sum(device_ms(lambda o=o, r=b[1], et=et, c=c: K3.emit_fields_cuda(
        *o[3:7], o[0], o[2], r, et, True, c), torch)
        for o, b, et, c in zip(outs, batches, ets, ctx))
    return k12_ms, k3_ms


# the outputs of `fused_ll_emit`, in order
FUSED_OUTPUTS = ("gt_prob", "max_gt", "margin", "off_sum", "quals_u8",
                 "packed")


def check_mesh(torch, np, dev):
    """The position-sharded programs (`parallel/sharding.py`) over device
    lists: `[dev] * 2` and `[dev] * 4` (slabs of whole tiles that share
    one card) and, with more than one card, every card. On the fused
    tier's chunk and on `wgbs_reads`, `sharded_fused_ll_emit` and
    `sharded_fused_ll_f64` must equal `fused_ll_emit` / `fused_ll_f64` on
    one device exactly, every output on every row, risk bits included,
    with one K12 launch a slab (and one K3 a slab with the emit fields).
    Then `sharded_call_genotypes` (f32, f64) and `sharded_full_step` over
    `[dev] * 4`: equal to K2 on one device, one K2 launch a slab, and the
    histograms equal to their single-device sums. The calls are timed
    eager (CUDA events around them, the host's enqueue, the slabs' copies
    and a host sync for the tile table in them), the kernels' device time
    by `slab_kernel_ms`."""
    from bs_call_tpu_torch.ops.emit_tables import emit_tables
    from bs_call_tpu_torch.ops.genotype import call_genotypes
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
    from bs_call_tpu_torch.ops.kernels import emit_device as E
    from bs_call_tpu_torch.ops.kernels import genotype_cuda as K2
    from bs_call_tpu_torch.ops.kernels import pileup_device as PD
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12
    from bs_call_tpu_torch.ops.params import ModelParams, model_tables
    from bs_call_tpu_torch.parallel import sharding as SH

    meshes = {"[cuda:0] * 2": [dev] * 2, "[cuda:0] * 4": [dev] * 4}
    if torch.cuda.device_count() > 1:
        meshes[f"{torch.cuda.device_count()} cards"] = SH.make_mesh(dev)

    def launches():
        return K12.pileup_genotype.launches, K3.emit_fields_cuda.launches

    def reset():
        K12.pileup_genotype.launches = K3.emit_fields_cuda.launches = 0

    mt = model_tables(ModelParams(), torch.float64, dev)
    et = emit_tables(dev)
    rng = np.random.default_rng(8)
    batches = {"chunk": (read_batch(np, 4096, 256, N_POS, 1),
                         rng.integers(0, 5, N_POS).astype(np.int32)),
               "wgbs": wgbs_reads(np, N_POS, 0)}
    result = {}
    for kind, (b, ref) in batches.items():
        args = [torch.from_numpy(a).to(dev) for a in (*b, ref)]
        want = PD.fused_ll_emit(*args, N_POS, 20, mt, et)
        want64 = PD.fused_ll_f64(*args, N_POS, 20, mt)
        torch.cuda.synchronize()
        n_risk = int(E.unpack_fields(want[5].cpu().numpy(), N_POS)[
            "risk"].sum())
        one_ms = time_ms(lambda: PD.fused_ll_emit(*args, N_POS, 20, mt, et),
                         torch)
        one_k12, one_k3 = slab_kernel_ms(torch, [dev], args, [mt], [et])
        for tag, devs in meshes.items():
            k = len(SH.slabs(N_POS, len(devs)))
            mts = SH.per_device(
                devs, lambda d: model_tables(ModelParams(), torch.float64, d))
            ets = SH.per_device(devs, emit_tables)

            def emit():
                return E.sharded_fused_ll_emit(devs, *args, N_POS, 20, mts,
                                               ets)

            def model():
                return PD.sharded_fused_ll_f64(devs, *args, N_POS, 20, mts)

            reset()
            got = emit()
            n_emit = launches()
            reset()
            got64 = model()
            n_model = launches()
            torch.cuda.synchronize()
            if n_emit != (k, k) or n_model != (k, 0):
                raise AssertionError(
                    f"mesh {tag} {kind}: (K12, K3) launches {n_emit} with "
                    f"the emit fields, {n_model} without, for {k} slabs")
            for name, g, w in (*zip(FUSED_OUTPUTS, got, want),
                               *zip(FUSED_OUTPUTS, got64, want64)):
                if g.device != dev or not torch.equal(g, w):
                    raise AssertionError(f"mesh {tag} {kind}: {name} "
                                         f"differs from one device's")
            ms, ms64 = time_ms(emit, torch), time_ms(model, torch)
            k12_ms, k3_ms = slab_kernel_ms(torch, devs, args, mts, ets)
            log(f"mesh {tag} ({kind}): {k} slabs of "
                f"{[hi - lo for lo, hi in SH.slabs(N_POS, len(devs))]} "
                f"positions; (K12, K3) launches a call {n_emit} with the "
                f"emit fields, {n_model} without; every output equal to one "
                f"device's on all {N_POS} rows ({n_risk} risk-flagged on "
                f"both); eager sharded_fused_ll_emit {ms:.4f} ms, "
                f"sharded_fused_ll_f64 {ms64:.4f} ms; one device's "
                f"fused_ll_emit {one_ms:.4f} ms; device: K12 {k12_ms:.4f} ms "
                f"and K3 (with ctx) {k3_ms:.4f} ms summed over the slabs, "
                f"one device's {one_k12:.4f} and {one_k3:.4f} ms")
            result[f"{tag} {kind}"] = {"slabs": k, "ms": ms, "f64_ms": ms64,
                                       "one_device_ms": one_ms,
                                       "k12_ms": k12_ms, "k3_ms": k3_ms}
    # the column tier and the calling step over four slabs
    _c2, _qs, counts, quals, ref = (
        torch.from_numpy(a).to(dev) for a in genotype_inputs(np, N_POS, 0))
    cols = (counts, quals, ref)
    devs = [dev] * 4
    for dtype in (torch.float32, torch.float64):
        tables = model_tables(ModelParams(), dtype, dev)
        want = call_genotypes(*cols, tables)
        K2.genotype_column.launches = 0
        got = SH.sharded_call_genotypes(devs, *cols, [tables] * 4)
        if K2.genotype_column.launches != 4:
            raise AssertionError("sharded_call_genotypes: "
                                 f"{K2.genotype_column.launches} K2 launches")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"sharded_call_genotypes {dtype}: differs "
                                 "from K2 on one device")
        if dtype == torch.float64:
            f64 = SH.sharded_ll_f64(devs, *cols, [tables] * 4)
            if not all(torch.equal(g, w) for g, w in zip(f64, want)):
                raise AssertionError("sharded_ll_f64 differs from K2")
        full = SH.sharded_full_step(devs, *cols, [tables] * 4)
        one = SH.sharded_full_step([dev], *cols, [tables])
        for name, v in full.items():
            if not torch.equal(v, one[name]):
                raise AssertionError(f"sharded_full_step {dtype}: {name} "
                                     "differs from one device's")
        covered = counts.sum(dim=1) > 0
        hist = torch.bincount(want[1][covered].long(), minlength=10)
        if not torch.equal(full["gt_hist"].long(), hist) or int(
                full["cov_hist"].sum()) != int(covered.sum()):
            raise AssertionError(f"sharded_full_step {dtype}: histograms "
                                 "differ from the single device's sums")
        ms = time_ms(lambda: SH.sharded_call_genotypes(devs, *cols,
                                                       [tables] * 4), torch)
        log(f"mesh [cuda:0] * 4: sharded_call_genotypes "
            f"{str(dtype)[6:]} and sharded_full_step equal K2 on one device, "
            f"4 K2 launches a call, gt_hist {full['gt_hist'].tolist()}; "
            f"eager {ms:.4f} ms")
    return result


# a host of a `--num-hosts` run: the CLI in its own process, its kernel
# launches printed as the last line
HOST_MAIN = """
import json, sys
from bs_call_tpu_torch import cli
from bs_call_tpu_torch.ops.kernels import emit_cuda, pileup_genotype_cuda
rc = cli.main(sys.argv[1:])
print(json.dumps({"pileup_genotype": pileup_genotype_cuda.pileup_genotype
                  .launches, "emit_fields": emit_cuda.emit_fields_cuda
                  .launches}))
sys.exit(rc)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stage_seconds(report: str) -> dict:
    """Stage seconds from a `-v` timings report (`Tracer.report`)."""
    out, on = {}, False
    for line in report.splitlines():
        if line.startswith("--- ") and "timings" in line:
            on = True
            continue
        parts = line.split()
        if on and len(parts) == 3 and parts[1].endswith("s"):
            out[parts[0]] = float(parts[1][:-1])
    return out


def row_engine_phase(card, tmp, bam, ref, env):
    """Phase 10: the port's `--device numpy` on native ingest and the host
    row engine against `bs_call_tpu --device cpu` on its own, on the
    600k fixture without -D. Returns the walls."""
    import contextlib
    import io

    from bs_call_tpu_torch import cli
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
    from bs_call_tpu_torch.ops.kernels import genotype_cuda as K2
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12
    from bs_call_tpu_torch.parity import strip_date
    from bs_call_tpu_torch.utils.trace import Tracer

    common = [bam, "-r", ref, "--benchmark-mode", "-v"]
    f = {k: os.path.join(tmp, k) for k in ("row_host.vcf", "row_host.json",
                                           "row_port.vcf", "row_port.json")}
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "bs_call_tpu.cli", *common, "-o",
         f["row_host.vcf"], "--report-file", f["row_host.json"],
         "--device", "cpu"],
        cwd=HERE, env=env, capture_output=True, text=True,
    )
    host_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"bs_call_tpu --device cpu exited "
                             f"{res.returncode}: {res.stderr[-1500:]}")
    if "using native row engine" not in res.stderr:
        raise AssertionError("bs_call_tpu --device cpu did not engage its "
                             "row engine: " + res.stderr[-1500:])
    for fn in (K2.genotype_column, K3.emit_fields_cuda, K12.pileup_genotype):
        fn.launches = 0
    tracer = Tracer(enabled=True)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main([*common, "-o", f["row_port.vcf"], "--report-file",
                       f["row_port.json"], "--device", "numpy"],
                      tracer=tracer)
    port_s = time.perf_counter() - t0
    launches = {"genotype_column": K2.genotype_column.launches,
                "emit_fields": K3.emit_fields_cuda.launches,
                "pileup_genotype": K12.pileup_genotype.launches}
    if rc != 0:
        raise AssertionError(f"port --device numpy exited {rc}")
    if "using native row engine" not in err.getvalue():
        raise AssertionError("port --device numpy did not engage the row "
                             "engine: " + err.getvalue()[-1500:])
    if any(launches.values()):
        raise AssertionError(f"port --device numpy launched {launches}")
    for k, what, norm in (("vcf", "VCF", str), ("json", "report",
                                                 strip_date)):
        with open(f[f"row_port.{k}"]) as a, open(f[f"row_host.{k}"]) as b:
            if norm(a.read()) != norm(b.read()):
                raise AssertionError(f"port --device numpy: {what} bytes "
                                     "differ from bs_call_tpu --device cpu")
    keep = ("ingest", "ingest_load", "call", "emit", "meth_prof")
    host_st = {k: v for k, v in stage_seconds(res.stderr).items()
               if k in keep}
    port_st = {k: round(tracer.times[k], 3) for k in keep
               if k in tracer.times}
    log(f"e2e [{card}]: row engine, no -D: VCF and report bytes of the port's "
        f"--device numpy equal bs_call_tpu --device cpu's, both on native "
        f"ingest and the row engine; K2, K12, K3 launches {launches}")
    log(f"e2e [{card}]: walls, row engine: port --device numpy in this "
        f"process {port_s:.3f} s, stages {json.dumps(port_st)}; reference "
        f"bs_call_tpu --device cpu as a subprocess {host_s:.3f} s, stages "
        f"{json.dumps(host_st)}")
    return port_s, host_s


def end_to_end(torch, card):
    from bs_call_tpu_torch import cli
    from bs_call_tpu_torch import concat as concat_tool
    from bs_call_tpu_torch.io.bai import write_bai
    from bs_call_tpu_torch.native import load as native_load
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
    from bs_call_tpu_torch.ops.kernels import genotype_cuda as K2
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12
    from bs_call_tpu_torch.parity import check_no_exact, strip_date
    from bs_call_tpu_torch.pipeline import engine as engine_mod
    from bs_call_tpu_torch.utils.synth import (
        make_dbsnp_index,
        make_wgbs_fixture,
    )
    from bs_call_tpu_torch.utils.trace import Tracer

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    # the reference's own native library builds in a process of its own,
    # beside the fixture and the port's build, outside the reference's
    # timed run
    ref_build = subprocess.Popen(
        [sys.executable, "-c", "import sys; from bs_call_tpu.native import "
         "load; sys.exit(load() is None)"], cwd=HERE, env=env,
    )
    # the reference's partial -C runs, started beside the port's (see the
    # partial runs below): tag -> (process, start), and their walls
    pending, host_partial_s = {}, {}
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
        # the port's native host library (ingest, pileup, emit) builds
        # once here, outside the port runs' time
        t0 = time.perf_counter()
        if native_load() is None:
            raise AssertionError("the native host library did not build")
        if ref_build.wait() != 0:
            raise AssertionError("the reference's native library did not "
                                 "build")
        log(f"native host libraries (port, reference) built/loaded in "
            f"{time.perf_counter() - t0:.1f} s")
        common = [bam, "-r", ref, "-D", dbsnp, "--benchmark-mode"]
        out = {k: os.path.join(tmp, k) for k in (
            "host.vcf", "host.json", "port.vcf", "port.json",
            "port_off.vcf", "port_off.json", "port_shards.vcf",
            "port_shards.json", "port_mesh.vcf", "port_mesh.json",
            "host0.vcf", "host1.vcf", "host0.json", "host1.json",
            "hosts.vcf", "host_noexact.vcf", "host_noexact.json",
            "port_noexact.vcf", "port_noexact.json", "host_partial.vcf",
            "host_partial.json", "host_partial_noexact.vcf",
            "host_partial_noexact.json", "port_partial.vcf",
            "port_partial.json", "port_partial_noexact.vcf",
            "port_partial_noexact.json")}
        # partial -C regions, one a contig, each a block wider than the
        # fused tier takes: the column tier's pipeline and K2 in f64. The
        # runs read the fixture through links in a directory of their own,
        # where a single-process partial -C run writes its .bai
        part = os.path.join(tmp, "partial")
        os.mkdir(part)
        for name in (bam, ref, ref + ".fai"):
            if os.path.exists(name):
                os.link(name, os.path.join(part, os.path.basename(name)))
        bed = os.path.join(part, "regions.bed")
        with open(bed, "w") as f:
            for i in range(n_ctg):
                f.write(f"chr{i + 1}\t{REGION[0]}\t{REGION[1]}\n")
        partial = [os.path.join(part, os.path.basename(bam)), "-r",
                   os.path.join(part, os.path.basename(ref)), "-D", dbsnp,
                   "--benchmark-mode", "-C", bed]

        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "bs_call_tpu.cli", *common,
             "-o", out["host.vcf"], "--report-file", out["host.json"],
             "--device", "cpu"],
            cwd=HERE, env=env, check=True,
        )
        host_s = time.perf_counter() - t0
        # --no-exact: the reference's f32 model on XLA:CPU, never the card
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "bs_call_tpu.cli", *common, "--no-exact",
             "-o", out["host_noexact.vcf"], "--report-file",
             out["host_noexact.json"], "--device", "cpu"],
            cwd=HERE, env={**env, "JAX_PLATFORMS": "cpu"}, check=True,
        )
        host_noexact_s = time.perf_counter() - t0
        def reference(tag):
            """Wait for the reference run `tag` if it is still pending."""
            if tag in pending:
                p, t0 = pending.pop(tag)
                if p.wait() != 0:
                    raise AssertionError(f"bs_call_tpu ({tag}) exited "
                                         f"{p.returncode}")
                host_partial_s[tag] = time.perf_counter() - t0

        def read(k):
            with open(out[k]) as f:
                return f.read()

        def port_run(tag, env, flags=(), devices=None, exact=True,
                     args=common, want="host"):
            """One port run in this process on `args`, the launch counts
            reset just before it; the environment (BS_CALL_EMIT_TIER, read
            when the engine is built; BS_CALL_FORCE_SHARDS) is set around
            cli.main, and with `devices` the engine's device list (the
            mesh `engine_devices` would give on that many cards). Exact
            runs must write the bytes of the reference's run `want`, one
            K12 launch a fused chunk and slab, through the fused tier on
            the whole contigs, and on partial regions also through the
            column tier (shape reroutes, one K2 f64 launch a column
            chunk); a --no-exact run (`exact` false) must pass
            `check_no_exact` against `want`'s VCF through the column tier
            alone, one K2 f32 launch a column chunk."""
            tracer = Tracer()
            for fn in (K2.genotype_column, K3.emit_fields_cuda,
                       K12.pileup_genotype):
                fn.launches = 0
            K2.genotype_column.launches_f64 = 0
            K2.genotype_column.launches_f32 = 0
            before = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            engine_devices = engine_mod.engine_devices
            if devices:
                engine_mod.engine_devices = lambda device: list(devices)
            try:
                t0 = time.perf_counter()
                rc = cli.main(
                    [*args, "-o", out[f"{tag}.vcf"], "--report-file",
                     out[f"{tag}.json"], "--device", "cuda", *flags],
                    tracer=tracer,
                )
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                engine_mod.engine_devices = engine_devices
                for k, v in before.items():
                    if v is None:
                        del os.environ[k]
                    else:
                        os.environ[k] = v
            if rc != 0:
                raise AssertionError(f"port CLI ({tag}) exited {rc}")
            launches = {
                "pileup_genotype_f64": K12.pileup_genotype.launches,
                "genotype_column": K2.genotype_column.launches,
                "genotype_column_f64": K2.genotype_column.launches_f64,
                "genotype_column_f32": K2.genotype_column.launches_f32,
                "emit_fields_f64": K3.emit_fields_cuda.launches,
            }
            workers = {k[9:]: v for k, v in tracer.counts.items()
                       if k.startswith("launches_")}
            tiers = {k[5:]: v for k, v in tracer.counts.items()
                     if k.startswith("tier_")}
            log(f"e2e [{card}]: {tag}: tier positions {json.dumps(tiers)}; "
                f"launches {json.dumps(launches)}"
                + (f", in the workers {json.dumps(workers)}" if workers
                   else "")
                + f"; positions {tracer.counts.get('positions', 0)}")
            log(f"e2e [{card}]: {tag}: stage seconds " + json.dumps(
                {k: round(v, 3) for k, v in sorted(tracer.times.items())}))
            reference(want)
            if not exact:
                n_rec = check_no_exact(read(f"{want}.vcf"),
                                       read(f"{tag}.vcf"))
                chunks = tracer.counts.get("column_chunks", 0)
                if (tiers.get("column", 0) == 0 or tiers.get("fused", 0)
                        or chunks == 0 or launches["genotype_column"] != chunks
                        or launches["genotype_column_f32"] != chunks
                        or launches["genotype_column_f64"]
                        or launches["pileup_genotype_f64"]
                        or launches["emit_fields_f64"]):
                    raise AssertionError(
                        f"{tag}: tiers {tiers}, {chunks} column chunks, "
                        f"launches {launches}: not the column tier alone, "
                        "one K2 f32 launch a chunk")
                log(f"e2e [{card}]: {tag}: {n_rec} VCF records pass "
                    f"check_no_exact against bs_call_tpu --no-exact --device "
                    f"cpu; K2 launched once per column chunk ({chunks}): "
                    f"f32 {launches['genotype_column_f32']}, f64 "
                    f"{launches['genotype_column_f64']}")
                return wall, launches, tiers, workers
            if read(f"{tag}.vcf") != read(f"{want}.vcf"):
                raise AssertionError(
                    f"{tag}: VCF bytes differ from bs_call_tpu --device cpu"
                )
            if strip_date(read(f"{tag}.json")) != strip_date(
                read(f"{want}.json")
            ):
                raise AssertionError(
                    f"{tag}: report differs from bs_call_tpu --device cpu"
                )
            chunks = tracer.counts.get("fused_chunks", 0)
            if args is not common:
                col = tracer.counts.get("column_chunks", 0)
                if (tiers.get("shape_reroute", 0) == 0 or col == 0
                        or launches["genotype_column_f64"] != col
                        or launches["genotype_column_f32"]):
                    raise AssertionError(
                        f"{tag}: tiers {tiers}, {col} column chunks, "
                        f"launches {launches}: not one K2 f64 launch a "
                        "column chunk on the rerouted regions")
                log(f"e2e [{card}]: {tag}: VCF and report bytes equal "
                    f"bs_call_tpu -C --device cpu; K2 f64 launched once per "
                    f"column chunk ({col}), K12 {chunks} fused chunks")
            elif tiers.get("fused", 0) == 0 or chunks == 0:
                raise AssertionError(f"{tag}: fused tier carried nothing")
            k12 = (workers.get("pileup_genotype", 0) if workers
                   else launches["pileup_genotype_f64"])
            slabs = len(devices) if devices else 1
            if k12 != slabs * chunks:
                raise AssertionError(
                    f"{tag}: K12 not {slabs} times per fused chunk "
                    f"({chunks}): {launches} {workers}")
            return wall, launches, tiers, workers

        def two_hosts(common, out, env):
            """`--num-hosts 2 --coordinator` on the card: two CLI
            processes, a gloo process group between them, each writing
            its host{i}.vcf, host 0 the merged report. Returns the wall
            from their start to both exits and each host's launches."""
            port = free_port()
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-c", HOST_MAIN, *common,
                 "-o", out[f"host{h}.vcf"], "--report-file",
                 out[f"host{h}.json"], "--device", "cuda", "--num-hosts",
                 "2", "--host-id", str(h), "--coordinator",
                 f"127.0.0.1:{port}"],
                cwd=HERE, env=env, stdout=subprocess.PIPE, text=True,
            ) for h in range(2)]
            try:
                outs = [p.communicate(timeout=600)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            wall = time.perf_counter() - t0
            if any(p.returncode for p in procs):
                raise AssertionError("--num-hosts 2: exit codes "
                                     f"{[p.returncode for p in procs]}")
            return wall, [json.loads(o.strip().splitlines()[-1])
                          for o in outs]

        total = n_ctg * n_reads
        on_s, launches, tiers, _w = port_run("port",
                                             {"BS_CALL_EMIT_TIER": "1"})
        if not (0 < launches["emit_fields_f64"]
                == launches["pileup_genotype_f64"]):
            raise AssertionError(f"K3 not once per K12 launch: {launches}")
        risky = tiers.get("emit_risk", 0) / max(tiers.get("emit", 0), 1)
        if tiers.get("emit", 0) == 0 or risky > 0.02:
            raise AssertionError(f"emit tier: {tiers}")
        off_s, off_launches, off_tiers, _w = port_run(
            "port_off", {"BS_CALL_EMIT_TIER": "0"})
        if off_launches["emit_fields_f64"] or off_tiers.get("emit", 0):
            raise AssertionError("BS_CALL_EMIT_TIER=0 still ran K3")
        # --shards 2: two spawned workers, each with its own context on
        # the card; the parent launches nothing, the workers' counts come
        # back with their stats
        sh_s, sh_launches, _tiers, workers = port_run(
            "port_shards", {"BS_CALL_FORCE_SHARDS": "1",
                            "BS_CALL_EMIT_TIER": "1"}, ("--shards", "2"))
        if any(sh_launches.values()) or not (
                0 < workers.get("emit_fields", 0)
                == workers.get("pileup_genotype", 0)):
            raise AssertionError(f"--shards 2: the parent launched "
                                 f"{sh_launches}, the workers {workers}")
        # the engine over [cuda:0] * 2: each chunk in two slabs of whole
        # tiles, K12 then K3 on each, the border codes crossing as ctx
        mesh_s, mesh_launches, mesh_tiers, _w = port_run(
            "port_mesh", {"BS_CALL_EMIT_TIER": "1"},
            devices=[torch.device("cuda", 0)] * 2)
        mesh_risky = mesh_tiers.get("emit_risk", 0) / max(
            mesh_tiers.get("emit", 0), 1)
        if (mesh_launches["emit_fields_f64"]
                != mesh_launches["pileup_genotype_f64"]
                or mesh_launches["pileup_genotype_f64"]
                != 2 * launches["pileup_genotype_f64"]
                or mesh_risky > 0.02):
            raise AssertionError(f"mesh run: launches {mesh_launches}, "
                                 f"tiers {mesh_tiers}")
        hosts_s, host_launches = two_hosts(common, out, env)
        concat_tool.main([out["host1.vcf"], out["host0.vcf"], "-o",
                          out["hosts.vcf"]])
        if read("hosts.vcf") != read("host.vcf"):
            raise AssertionError("--num-hosts 2: the concatenated VCF "
                                 "differs from bs_call_tpu --device cpu")
        if strip_date(read("host0.json")) != strip_date(read("host.json")):
            raise AssertionError("--num-hosts 2: host 0's report differs "
                                 "from bs_call_tpu --device cpu")
        if os.path.exists(out["host1.json"]) or not all(
                h["pileup_genotype"] > 0 and h["emit_fields"] > 0
                for h in host_launches):
            raise AssertionError(f"--num-hosts 2: launches {host_launches}, "
                                 "or host 1 wrote a report")
        log(f"e2e [{card}]: port_mesh: engine over [cuda:0] * 2, K12 and K3 "
            f"twice per fused chunk, risk share {100 * mesh_risky:.3f}%; "
            f"--num-hosts 2 over gloo (two processes on the card): (K12, K3) "
            f"launches per host {[tuple(h.values()) for h in host_launches]}"
            f"; the hosts' VCFs concatenated and host 0's report equal the "
            f"reference's bytes")
        # --no-exact: the column tier, K2 in f32, on every covered position
        ne_s, ne_launches, _tiers, _w = port_run(
            "port_noexact", {}, ("--no-exact",), exact=False,
            want="host_noexact")
        # partial -C regions: the column tier's pipeline, K2 in f64 on the
        # exact run and in f32 on the --no-exact run. The reference's two
        # runs start first, on the .bai a partial -C run would build
        # beside its input, and run beside the port's (their scalar
        # emitters take ~30 s each on one core); each is timed from its
        # start to its exit, as the port's runs are
        write_bai(partial[0])
        for tag, flags, penv in (
                ("host_partial", (), env),
                ("host_partial_noexact", ("--no-exact",),
                 {**env, "JAX_PLATFORMS": "cpu"})):
            pending[tag] = (subprocess.Popen(
                [sys.executable, "-m", "bs_call_tpu.cli", *partial, *flags,
                 "-o", out[f"{tag}.vcf"], "--report-file",
                 out[f"{tag}.json"], "--device", "cpu"],
                cwd=HERE, env=penv), time.perf_counter())
        pc_s, pc_launches, pc_tiers, _w = port_run(
            "port_partial", {"BS_CALL_EMIT_TIER": "1"}, args=partial,
            want="host_partial")
        pne_s, pne_launches, pne_tiers, _w = port_run(
            "port_partial_noexact", {}, ("--no-exact",), exact=False,
            args=partial, want="host_partial_noexact")
        n_pos = n_ctg * (REGION[1] - REGION[0])
        log(f"e2e [{card}]: walls, partial -C ({n_ctg} regions of "
            f"{REGION[1] - REGION[0]} positions, {n_pos} in all): port "
            f"--device cuda in this process {pc_s:.3f} s, --no-exact "
            f"{pne_s:.3f} s; reference bs_call_tpu -C --device cpu as a "
            f"subprocess {host_partial_s['host_partial']:.3f} s, --no-exact "
            f"(JAX f32 on XLA:CPU) "
            f"{host_partial_s['host_partial_noexact']:.3f} s (both beside "
            f"the port's runs); tiers "
            f"{json.dumps(pc_tiers)} and {json.dumps(pne_tiers)}")
        n_rec = sum(1 for ln in read("port.vcf").splitlines()
                    if not ln.startswith("#"))
        log(f"e2e [{card}]: {total} reads, {n_rec} VCF records; VCF and "
            f"report bytes of the four port runs equal the host's; "
            f"tier_emit {tiers['emit']}, tier_emit_risk "
            f"{tiers.get('emit_risk', 0)} ({100 * risky:.3f}% of them)")
        log(f"e2e [{card}]: walls: port --device cuda, emit tier on, in "
            f"this process {on_s:.3f} s ({total / on_s:.0f} reads/s); "
            f"emit tier off {off_s:.3f} s ({total / off_s:.0f} reads/s); "
            f"--shards 2 (two workers, emit tier on) {sh_s:.3f} s "
            f"({total / sh_s:.0f} reads/s); engine over [cuda:0] * 2 "
            f"{mesh_s:.3f} s ({total / mesh_s:.0f} reads/s); --num-hosts 2 "
            f"(two processes, from start to both exits) {hosts_s:.3f} s "
            f"({total / hosts_s:.0f} reads/s); "
            f"host bs_call_tpu --device cpu as a subprocess {host_s:.3f} s "
            f"({total / host_s:.0f} reads/s)")
        log(f"e2e [{card}]: walls, --no-exact: port --device cuda in this "
            f"process {ne_s:.3f} s ({total / ne_s:.0f} reads/s); reference "
            f"bs_call_tpu --no-exact --device cpu (JAX f32 on XLA:CPU) as a "
            f"subprocess {host_noexact_s:.3f} s "
            f"({total / host_noexact_s:.0f} reads/s)")
        # this slice's paths: the engine over two slabs, the two hosts
        for name, key in (("pileup_genotype_f64", "pileup_genotype"),
                          ("emit_fields_f64", "emit_fields")):
            launches[f"{name}_mesh"] = mesh_launches[name]
            launches[f"{name}_num_hosts"] = sum(h[key]
                                                for h in host_launches)
        # K2 on its paths: f64 on the exact partial -C run's column tier,
        # f32 on the --no-exact run's (whole contigs, and partial -C)
        launches["genotype_column_f64"] = pc_launches["genotype_column_f64"]
        launches["genotype_column_f32"] = ne_launches["genotype_column_f32"]
        launches["genotype_column_f32_partial"] = pne_launches[
            "genotype_column_f32"]
        row_engine_phase(card, tmp, bam, ref, env)
        return launches
    finally:
        for p in [ref_build, *(p for p, _t0 in pending.values())]:
            if p.poll() is None:
                p.kill()
                p.wait()
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
    check_column_pipeline(torch, np, dev, card)
    k3 = check_k3(torch, np, dev)
    k12 = check_k12(torch, np, dev)
    fpc, fpc_launches = check_fused_pileup_call(torch, np, dev)
    check_fused_emit_chunk(torch, np, dev)
    check_mesh(torch, np, dev)
    launches = end_to_end(torch, card)
    for mod in ("jax", "bs_call_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"the port's run imported {mod}")

    src = "bs_call_tpu_torch/csrc/"
    pallas = "bs_call_tpu/ops/kernels/genotype_pallas.py:48"
    kernels = [
        {"name": "pileup_genotype_f64", "route": "cuda",
         "source": src + "pileup_genotype.cu", "replaces": pallas,
         "launches": launches["pileup_genotype_f64"],
         "launches_mesh": launches["pileup_genotype_f64_mesh"],
         "launches_num_hosts": launches["pileup_genotype_f64_num_hosts"],
         **k12},
        {"name": "pileup_genotype_f32", "route": "cuda",
         "source": src + "pileup_genotype.cu", "replaces": pallas,
         "launches": fpc_launches["f32"], "path": "fused_pileup_call",
         **fpc["f32"]},
        {"name": "genotype_column_f64", "route": "cuda",
         "source": src + "genotype.cu", "replaces": pallas,
         "launches": launches["genotype_column_f64"],
         "path": "-C partial regions, exact", **k2["genotype_column_f64"]},
        {"name": "genotype_column_f32", "route": "cuda",
         "source": src + "genotype.cu", "replaces": pallas,
         "launches": launches["genotype_column_f32"], "path": "--no-exact",
         "launches_partial": launches["genotype_column_f32_partial"],
         **k2["genotype_column_f32"]},
        {"name": "emit_fields_f64", "route": "cuda",
         "source": src + "emit.cu",
         "replaces": "bs_call_tpu/ops/kernels/emit_device.py:256",
         "launches": launches["emit_fields_f64"],
         "launches_mesh": launches["emit_fields_f64_mesh"],
         "launches_num_hosts": launches["emit_fields_f64_num_hosts"], **k3},
    ]
    print(f"[{card}] " + "; ".join(
        f"{k['name']} kernel {k['ms']:.4f} ms plain {k['plain_ms']:.4f} ms "
        f"bound {k['bound_ms']:.4f} ms" for k in kernels), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
