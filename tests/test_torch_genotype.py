"""Genotype model of the PyTorch port (`bs_call_tpu_torch.ops.genotype`,
the plain version of K2) against the JAX package: the jnp model in f32
and f64, the Pallas kernel in interpret mode, the numpy f64 model, and
the scalar oracle behind the exact tier's tie rescue. The CUDA kernel
itself is compared with this plain version on the card (marked `cuda`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bs_call_tpu.config import CallerConfig
from bs_call_tpu.ops import oracle
from bs_call_tpu.ops.genotype import ModelParams as JaxParams
from bs_call_tpu.ops.genotype import call_genotypes as jax_call
from bs_call_tpu.ops.genotype_np import call_genotypes_np, genotype_ll_np
from bs_call_tpu.ops.kernels.genotype_pallas import TILE, call_genotypes_pallas
from bs_call_tpu.ops.kernels.pileup_device import _agg_quals_f32
from bs_call_tpu_torch.ops import genotype as G
from bs_call_tpu_torch.ops.kernels import genotype_cuda
from bs_call_tpu_torch.ops.params import ModelParams, model_tables
from bs_call_tpu_torch.pipeline.engine import TorchCallEngine

CPU = torch.device("cpu")
UC, OC, RB = 0.01, 0.05, 2.0


def make_inputs(seed, n=TILE * 4):
    """Random pileup columns shaped like test_pallas_kernel's, with an
    all-zero row, exact-tie rows and every ref code 0..4 in the tail."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, size=(n, 8)).astype(np.int32)
    counts[rng.random((n, 8)) < 0.5] = 0
    quals = np.where(
        counts > 0, rng.integers(20, 44, size=(n, 8)), 0
    ).astype(np.int32)
    ref = rng.integers(0, 5, size=n).astype(np.int32)
    tail = []
    for r in range(5):
        tail.append((np.zeros(8), np.zeros(8), r))  # nothing observed
        # informative-only pileups whose two best genotypes tie exactly
        # (the clipped get_Z maxima coincide) on some reference bases
        tail.append(([0, 0, 0, 0, 23, 0, 9, 0], [0, 0, 0, 0, 25, 0, 23, 0],
                     r))
        tail.append(([0, 0, 0, 0, 0, 9, 0, 23], [0, 0, 0, 0, 0, 23, 0, 25],
                     r))
    for i, (c, q, r) in enumerate(tail):
        counts[n - 1 - i] = c
        quals[n - 1 - i] = q
        ref[n - 1 - i] = r
    return counts, quals, ref


def torch_call(counts, quals, ref, dtype):
    tables = model_tables(ModelParams(UC, OC, RB), dtype, CPU)
    out = G.call_genotypes(
        torch.from_numpy(counts), torch.from_numpy(quals),
        torch.from_numpy(ref), tables,
    )
    return [t.numpy() for t in out]


@pytest.mark.parametrize("which", ["jnp", "pallas"])
@pytest.mark.parametrize("seed", [0, 3])
def test_f32_matches_jax(which, seed):
    counts, quals, ref = make_inputs(seed)
    if which == "jnp":
        want = jax_call(counts, quals, ref, JaxParams(), dtype=jnp.float32)
    else:
        want = call_genotypes_pallas(
            counts, quals, ref, JaxParams(), interpret=True
        )
    gp_j, mx_j, mg_j, off_j = (np.asarray(a) for a in want)
    gp, mx, mg, off = torch_call(counts, quals, ref, torch.float32)
    assert gp.dtype == np.float32 and off.dtype == np.float32
    # rows whose two best genotypes tie within f32 rounding may resolve
    # either way; everywhere else the winner is the same
    clear = mg_j > 1e-3
    assert clear.sum() > 0.9 * len(ref)
    np.testing.assert_array_equal(mx[clear], mx_j[clear])
    np.testing.assert_allclose(gp, gp_j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(off, off_j, rtol=1e-4, atol=1e-30)


def test_f64_matches_jax():
    counts, quals, ref = make_inputs(1)
    want = jax_call(counts, quals, ref, JaxParams(), dtype=jnp.float64)
    gp_j, mx_j, mg_j, off_j = (np.asarray(a) for a in want)
    gp, mx, mg, off = torch_call(counts, quals, ref, torch.float64)
    clear = mg > 1e-9
    np.testing.assert_array_equal(mx[clear], mx_j[clear])
    np.testing.assert_allclose(gp, gp_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(off, off_j, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("seed", [0, 2])
def test_f64_matches_numpy(seed):
    counts, quals, ref = make_inputs(seed)
    tables = model_tables(ModelParams(UC, OC, RB), torch.float64, CPU)
    ll = G.genotype_log_likelihoods(
        torch.from_numpy(counts), torch.from_numpy(quals),
        torch.from_numpy(ref), tables,
    ).numpy()
    np.testing.assert_allclose(
        ll, genotype_ll_np(counts, quals, ref, UC, OC, RB),
        rtol=1e-12, atol=0,
    )
    gp_n, mx_n, mg_n, off_n = call_genotypes_np(
        counts, quals, ref, UC, OC, RB
    )
    gp, mx, mg, off = torch_call(counts, quals, ref, torch.float64)
    assert gp.dtype == np.float64
    np.testing.assert_allclose(gp, gp_n, rtol=1e-12, atol=1e-300)
    clear = mg > 1e-9
    np.testing.assert_array_equal(mx[clear], mx_n[clear])
    np.testing.assert_allclose(off, off_n, rtol=1e-12, atol=1e-300)
    # the tail's constructed ties are exact ties
    assert (mg[-15:] < 1e-9).sum() >= 6


def test_finish_exact_rescues_ties_to_oracle():
    """The column tier's output after _finish_exact: tie rows are the
    scalar oracle's, bit for bit, and every row picks the oracle's
    genotype."""
    counts, quals, ref = make_inputs(4, n=512)
    eng = TorchCallEngine(CallerConfig(), CPU)
    gp, mx, mg, _off = eng._call_batch(counts, quals, ref)
    ties = np.nonzero(mg < 1e-9)[0]
    assert len(ties) >= 5
    assert eng.tier_positions["oracle"] == len(ties)
    assert eng.tier_positions["column"] == len(ref)
    for j in range(len(ref)):
        want_gp, want_gt = oracle.calc_gt_prob(
            counts[j], quals[j], int(ref[j]), UC, OC, RB
        )
        assert mx[j] == want_gt
        if j in ties:
            np.testing.assert_array_equal(gp[j], want_gp)
        else:
            np.testing.assert_allclose(gp[j], want_gp, rtol=1e-9, atol=1e-12)


def pileup_inputs(seed, n=2048):
    """counts2 [n,2,8] and f32 qual sums of integer qualities, with some
    averages exactly on a .5 rounding boundary."""
    rng = np.random.default_rng(seed)
    counts2 = rng.integers(0, 20, size=(n, 2, 8)).astype(np.int32)
    counts2[rng.random((n, 2, 8)) < 0.4] = 0
    counts = counts2.sum(axis=1)
    q = rng.integers(20, 44, size=(n, 8))
    extra = rng.integers(0, np.maximum(counts, 1))
    qual_sum = (counts * q + extra).astype(np.float32)
    half = (rng.random((n, 8)) < 0.2) & (counts % 2 == 0)
    qual_sum[half] = (counts * q + counts // 2)[half]
    ref = rng.integers(0, 5, size=n).astype(np.int32)
    return counts2, qual_sum, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pileup_entry_quals_bit_equal(dtype):
    counts2, qual_sum, ref = pileup_inputs(5)
    want_q = np.asarray(
        _agg_quals_f32(jnp.asarray(counts2.sum(axis=1)), qual_sum)
    )
    tables = model_tables(ModelParams(UC, OC, RB), dtype, CPU)
    out = G.call_genotypes_pileup(
        torch.from_numpy(counts2), torch.from_numpy(qual_sum),
        torch.from_numpy(ref), tables,
    )
    quals_u8 = out[4].numpy()
    assert quals_u8.dtype == np.uint8
    np.testing.assert_array_equal(quals_u8, want_q.astype(np.uint8))
    # the model half equals the column entry on the same quals
    col = G.call_genotypes(
        torch.from_numpy(counts2.sum(axis=1).astype(np.int32)),
        torch.from_numpy(want_q.astype(np.int32)), torch.from_numpy(ref),
        tables,
    )
    for a, b in zip(out[:4], col):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrappers_refuse_other_devices():
    counts, quals, ref = make_inputs(0, n=256)
    cpu_tables = model_tables(ModelParams(), torch.float64, CPU)
    args = [torch.from_numpy(a) for a in (counts, quals, ref)]
    # the kernel launcher takes CUDA tensors only
    with pytest.raises(ValueError):
        genotype_cuda.genotype_column(*args, cpu_tables)
    # tensors and tables on different devices
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        G.call_genotypes(*meta, cpu_tables)
    with pytest.raises(ValueError):
        model_tables(ModelParams(), torch.float16, CPU)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    tables = model_tables(ModelParams(), dtype, dev)
    counts, quals, ref = make_inputs(6)
    args = [torch.from_numpy(a).to(dev) for a in (counts, quals, ref)]
    n0 = genotype_cuda.genotype_column.launches
    got = G.call_genotypes(*args, tables)
    assert genotype_cuda.genotype_column.launches == n0 + 1
    want = G.call_genotypes_plain(*args, tables)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    clear = want[2] > (1e-3 if dtype == torch.float32 else 1e-9)
    assert torch.equal(got[1][clear], want[1][clear])
    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
    torch.testing.assert_close(got[3], want[3], rtol=100 * tol, atol=1e-30)
    counts2, qual_sum, ref2 = pileup_inputs(7)
    args2 = [torch.from_numpy(a).to(dev) for a in (counts2, qual_sum, ref2)]
    got = G.call_genotypes_pileup(*args2, tables)
    want = G.call_genotypes_pileup_plain(*args2, tables)
    assert torch.equal(got[4], want[4])
    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
