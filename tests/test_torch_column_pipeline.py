"""The column tier's chunk pipeline (`TorchCallEngine._pipe_chunks`, the
port of the JAX engine's driver): fixed chunks of `batch_positions`, the
tail zero-padded, up to three in flight in slots the engine keeps,
drained in order. On the CPU, on one device and on `[cpu] * 2`, it equals
a one-chunk-at-a-time loop of `call_genotypes` bit for bit and the JAX
package's `call_genotypes` (XLA:CPU) within `test_torch_genotype.py`'s
tolerances; stub dispatches hold its window, drain order, padding, slot
reuse and error path; end to end, a partial `-C` region wider than the
fused tier's chunk goes to the column tier in several chunks and writes
`bs_call_tpu -C`'s bytes (and `--no-exact` its records). On the card
(marked `cuda`) the pipelined result equals a sequential run of K2."""

import io
import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bs_call_tpu.config import CallerConfig as JaxConfig
from bs_call_tpu.ops.genotype import ModelParams as JaxParams
from bs_call_tpu.ops.genotype import call_genotypes as jax_call
from bs_call_tpu.pipeline.runner import run_caller as jax_run_caller
from bs_call_tpu_torch.config import CallerConfig
from bs_call_tpu_torch.ops.genotype import call_genotypes
from bs_call_tpu_torch.parity import check_no_exact
from bs_call_tpu_torch.pipeline.engine import TorchCallEngine
from bs_call_tpu_torch.pipeline.runner import run_caller
from bs_call_tpu_torch.utils.synth import make_wgbs_fixture
from bs_call_tpu_torch.utils.trace import Tracer

CPU = torch.device("cpu")
BP, N = 1000, 4517


def columns(seed, n=N):
    """Pileup columns with distinct rows in every chunk, an all-zero row,
    and every ref code."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, size=(n, 8)).astype(np.int32)
    counts[rng.random((n, 8)) < 0.5] = 0
    counts[n // 2] = 0
    quals = np.where(counts > 0, rng.integers(20, 44, (n, 8)), 0).astype(
        np.int32)
    ref = rng.integers(0, 5, n).astype(np.int32)
    return counts, quals, ref


def sequential(eng, counts, quals, ref):
    """One chunk at a time: each chunk zero-padded to batch_positions, K2's
    entry on it, its rows copied out before the next."""
    bp = eng.cfg.batch_positions
    outs = [[], [], [], []]
    for s in range(0, len(ref), bp):
        m = min(bp, len(ref) - s)
        args = []
        for a in (counts, quals, ref):
            pad = np.zeros((bp, *a.shape[1:]), np.int32)
            pad[:m] = a[s:s + m]
            args.append(torch.from_numpy(pad).to(eng.device))
        res = call_genotypes(*args, eng._tables[0])
        for acc, t in zip(outs, res):
            acc.append(t.cpu().numpy()[:m])
    return [np.concatenate(o) for o in outs]


def engine(exact, devices=None, bp=BP):
    return TorchCallEngine(CallerConfig(exact=exact, batch_positions=bp),
                           CPU, devices=devices)


@pytest.mark.parametrize("exact", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("devices", [None, [CPU] * 2], ids=["cpu", "cpu2"])
def test_pipelined_equals_sequential_and_jax(exact, devices):
    counts, quals, ref = columns(0)
    eng = engine(exact, devices)
    got = eng._pipe_chunks(counts, quals, ref, *eng._column_fns())
    assert eng.column_chunks == math.ceil(N / BP) == 5
    want = sequential(engine(exact), counts, quals, ref)
    for g, w in zip(got, want):
        assert g.shape[0] == N
        np.testing.assert_array_equal(g, w.astype(g.dtype))
    gp_j, mx_j, mg_j, off_j = (np.asarray(a) for a in jax_call(
        counts, quals, ref, JaxParams(),
        dtype=jnp.float64 if exact else jnp.float32))
    gp, mx, mg, off = got
    clear = mg_j > (1e-9 if exact else 1e-3)
    np.testing.assert_array_equal(mx[clear], mx_j[clear])
    tol = 1e-12 if exact else 2e-5
    np.testing.assert_allclose(gp, gp_j, rtol=tol, atol=tol)
    np.testing.assert_allclose(off, off_j, rtol=1e-12 if exact else 1e-4,
                               atol=1e-300 if exact else 1e-30)


def test_call_batch_runs_the_pipeline():
    """`_call_batch` is `_pipe_chunks` then `_finish_exact`: the column
    tier's counters and the C-style max entry."""
    counts, quals, ref = columns(1)
    eng = engine(True)
    gp, mx, mg, off = eng._call_batch(counts, quals, ref)
    assert eng.column_chunks == 5 and eng.tier_positions["column"] == N
    want = engine(True)._pipe_chunks(counts, quals, ref,
                                     *engine(True)._column_fns())
    clear = want[2] >= 1e-9
    np.testing.assert_array_equal(mx[clear], want[1][clear])
    rows = np.arange(N)[clear]
    np.testing.assert_array_equal(
        gp[rows, mx[clear]], -np.log(1.0 + off[clear]) / np.log(10))


class Stub:
    """A dispatch/finish pair that records what the driver does: chunk k's
    outputs are k * 10_000 + its row in the chunk, its padded rows -1;
    finish checks that the slot's inputs are still those it was
    dispatched with (a slot staged again too early would show)."""

    def __init__(self, bp, fail_at=None):
        self.bp, self.fail_at = bp, fail_at
        self.submitted, self.drained = [], []
        self.in_flight = self.max_in_flight = 0

    def dispatch(self, slot):
        k = len(self.submitted)
        if k == self.fail_at:
            raise RuntimeError(f"chunk {k} failed")
        counts = slot.inputs[0]
        snap = [a.copy() for a in slot.inputs]
        rows = np.arange(self.bp)
        # the driver's tail padding: the stub marks rows that are zero in
        # every input, and the inputs put a nonzero count in every real row
        live = counts.sum(axis=1) > 0
        out = np.where(live, k * 10_000 + rows, -1).astype(np.float64)
        self.submitted.append(k)
        self.in_flight += 1
        self.max_in_flight = max(self.max_in_flight, self.in_flight)
        return k, slot, snap, out

    def finish(self, token):
        k, slot, snap, out = token
        assert all(np.array_equal(a, b) for a, b in zip(slot.inputs, snap)), \
            f"slot of chunk {k} staged again before it was drained"
        self.in_flight -= 1
        self.drained.append(k)
        return (np.repeat(out[:, None], 10, axis=1), out.astype(np.int32),
                out, out)


def stub_inputs(n):
    rng = np.random.default_rng(n)
    counts = rng.integers(1, 30, size=(n, 8)).astype(np.int32)
    quals = rng.integers(20, 44, size=(n, 8)).astype(np.int32)
    ref = rng.integers(0, 5, n).astype(np.int32)
    return counts, quals, ref


@pytest.mark.parametrize("n", [1, BP - 1, BP, 4 * BP + 517, 11 * BP + 3])
def test_window_order_and_padding(n):
    """At most three chunks in flight, drained in the order they were
    submitted, a slot never staged again before its chunk was drained,
    the tail zero-padded to batch_positions and its padded rows in no
    output, and one `column_chunks` a chunk."""
    eng = engine(True)
    stub = Stub(BP)
    counts, quals, ref = stub_inputs(n)
    gp, mx, mg, off = eng._pipe_chunks(counts, quals, ref, stub.dispatch,
                                       stub.finish)
    n_chunks = math.ceil(n / BP)
    assert eng.column_chunks == n_chunks
    assert stub.submitted == stub.drained == list(range(n_chunks))
    assert stub.max_in_flight == min(3, n_chunks) and stub.in_flight == 0
    want = (np.arange(n) // BP) * 10_000 + np.arange(n) % BP
    for a in (mg, off, gp[:, 9]):
        np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(mx, want)
    # the slots' inputs after the run: the last chunk's rows, zeros after
    last = eng._slots[(n_chunks - 1) % 3].inputs
    m = n - (n_chunks - 1) * BP
    np.testing.assert_array_equal(last[0][:m], counts[-m:])
    assert not last[0][m:].any() and not last[2][m:].any()


def test_error_drains_and_propagates():
    """An exception in chunk 2 of 5 propagates after chunks 0 and 1 were
    drained; no thread is left and the engine's slots serve the next
    call."""
    eng = engine(False)
    counts, quals, ref = stub_inputs(5 * BP)
    threads = threading.active_count()
    stub = Stub(BP, fail_at=2)
    with pytest.raises(RuntimeError, match="chunk 2 failed"):
        eng._pipe_chunks(counts, quals, ref, stub.dispatch, stub.finish)
    assert stub.submitted == stub.drained == [0, 1]
    assert stub.in_flight == 0
    assert threading.active_count() == threads
    got = eng._pipe_chunks(counts, quals, ref, *eng._column_fns())
    want = sequential(engine(False), counts, quals, ref)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


# ---- a partial -C region end to end ----

@pytest.fixture(scope="module")
def region_run(tmp_path_factory):
    """One contig of 20 kb at ~18x and a region of 15 kb inside it: with
    chunks of 2,048 positions the region's block is wider than the fused
    tier takes, so the column tier carries it in several chunks."""
    tmp = tmp_path_factory.mktemp("region")
    ref, bam, _n = make_wgbs_fixture(str(tmp), 1200, 20_000, seed=3)
    bed = tmp / "region.bed"
    bed.write_text("chr1\t2000\t17000\n")
    return dict(input_file=bam, reference_file=ref, contig_bed=str(bed),
                benchmark_mode=True)


def run_bytes(runner, cfg, *args):
    out = io.BytesIO()
    tracer = Tracer()
    runner(cfg, *args, out_fileobj=out, tracer=tracer)
    return out.getvalue(), tracer.counts


def test_partial_region_column_tier_bytes(region_run):
    want, _ = run_bytes(jax_run_caller, JaxConfig(device="cpu", **region_run))
    got, counts = run_bytes(
        run_caller, CallerConfig(batch_positions=2048, **region_run), CPU)
    assert got == want and got.count(b"\nchr1\t") > 1000
    assert counts["tier_shape_reroute"] > 0
    assert counts["tier_column"] == counts["tier_shape_reroute"]
    assert counts["column_chunks"] >= 6


def test_partial_region_no_exact_records(region_run):
    want, _ = run_bytes(jax_run_caller,
                        JaxConfig(device="cpu", exact=False, **region_run))
    got, counts = run_bytes(
        run_caller,
        CallerConfig(batch_positions=2048, exact=False, **region_run), CPU)
    assert check_no_exact(want.decode(), got.decode()) > 1000
    assert counts["tier_fused"] == 0 and counts["column_chunks"] >= 6


# ---- on the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("slabs", [1, 2])
def test_pipelined_equals_sequential_on_card(exact, slabs):
    """Many chunks of distinct data, bit for bit against K2 a chunk at a
    time with a blocking copy out, one K2 launch a chunk and slab."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bs_call_tpu_torch.ops.kernels import genotype_cuda as K2

    dev = torch.device("cuda", 0)
    bp = 4096
    counts, quals, ref = columns(5, n=23 * bp + 77)
    eng = TorchCallEngine(CallerConfig(exact=exact, batch_positions=bp), dev,
                          devices=[dev] * slabs)
    K2.genotype_column.launches = 0
    got = eng._pipe_chunks(counts, quals, ref, *eng._column_fns())
    assert eng.column_chunks == 24
    assert K2.genotype_column.launches == 24 * slabs
    seq = TorchCallEngine(CallerConfig(exact=exact, batch_positions=bp), dev)
    want = sequential(seq, counts, quals, ref)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))
