"""Pileup of the PyTorch port (`bs_call_tpu_torch.ops.kernels.
pileup_device`, the plain version of K1, and the fused exact tier)
against the JAX package's `device_pileup` / `fused_ll_dd` and the host
`build_pileup`. The CUDA kernel itself is compared with this plain
version on the card (marked `cuda`)."""

import numpy as np
import pytest
import torch

from bs_call_tpu.config import CallerConfig
from bs_call_tpu.native.pipeline import NativePipeline
from bs_call_tpu.ops.genotype import ModelParams as JaxParams
from bs_call_tpu.ops.genotype_dd import dd_finish
from bs_call_tpu.ops.kernels import pileup_device as jax_pd
from bs_call_tpu.ops.pileup import build_pileup
from bs_call_tpu_torch.ops import genotype as G
from bs_call_tpu_torch.ops.kernels import pileup_device as PD
from bs_call_tpu_torch.ops.params import ModelParams, model_tables

from test_native_pipeline import random_bam
from test_pileup_device import blocks_of

CPU = torch.device("cpu")


def as_torch(*arrays, device=CPU):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_plain_pileup_matches_jax_and_host(tmp_path, seed):
    ref, bam = random_bam(tmp_path, n_pairs=250, seed=seed)
    cfg = CallerConfig(left_trim=(1, 0), right_trim=(0, 1))
    n_blocks = 0
    for block, x, y in blocks_of(ref, bam, cfg):
        sz = y - x + 1
        want_c2, want_qs, want_m2 = build_pileup(
            block.align_list, x, y, cfg.min_qual
        )
        batch = jax_pd.pack_reads(block.align_list, x)
        j_c2, j_qs, j_m2 = (
            np.asarray(a)
            for a in jax_pd.device_pileup(*batch, sz, cfg.min_qual)
        )
        c2, qs, m2 = (
            t.numpy()
            for t in PD.device_pileup(*as_torch(*batch), sz, cfg.min_qual)
        )
        assert c2.dtype == np.int32 and qs.dtype == np.float32
        assert m2.dtype == np.float32
        for got, jax_want, host_want in (
            (c2, j_c2, want_c2), (qs, j_qs, want_qs), (m2, j_m2, want_m2),
        ):
            np.testing.assert_array_equal(got, jax_want)
            np.testing.assert_array_equal(got, host_want)
        n_blocks += 1
    assert n_blocks > 0


def native_blocks(bam, cfg):
    """(block, read batch) pairs from the C++ pipeline, as the engine's
    fused tier receives them."""
    p = NativePipeline(str(bam), cfg, np.ones(1, np.int8))
    try:
        while True:
            blk = p.next_block()
            if blk is None:
                return
            yield blk, p.block_reads()
    finally:
        p.close()


def test_fused_ll_f64_matches_fused_ll_dd(tmp_path):
    """K1 -> K2 (plain, f64) against the JAX df32 fused tier on every
    block of one fixture, padded to one shape as the engine pads."""
    ref, bam = random_bam(tmp_path, n_pairs=400, seed=3)
    cfg = CallerConfig()
    n_pos, r_pad, l_cap = 8192, 1024, 256
    tables = model_tables(ModelParams(), torch.float64, CPU)
    rng = np.random.default_rng(3)
    checked = 0
    for blk, reads in native_blocks(bam, cfg):
        sz = blk["y"] - blk["x"] + 1
        assert sz <= n_pos
        batch = PD.pad_read_batch(reads, 0, sz - 1, r_pad, l_cap)
        assert batch is not None
        ref_codes = np.zeros(n_pos, np.int32)
        ref_codes[:sz] = rng.integers(0, 5, sz)
        hi, lo, j_q = jax_pd.fused_ll_dd(
            *batch, ref_codes, n_pos=n_pos, min_qual=cfg.min_qual,
            params=JaxParams(),
        )
        gp, mx, mg, off, q = (
            t.numpy() for t in PD.fused_ll_f64(
                *as_torch(*batch, ref_codes), n_pos=n_pos,
                min_qual=cfg.min_qual, tables=tables,
            )
        )
        j_q = np.asarray(j_q)
        np.testing.assert_array_equal(q, j_q)
        np.testing.assert_array_equal(q[:sz], blk["agg"]["quals"])
        # the f64 likelihoods against the df32 planes (hi + lo)
        counts = blk["counts2"].sum(axis=1)
        ll = G.genotype_log_likelihoods(
            *as_torch(counts, j_q[:sz].astype(np.int32), ref_codes[:sz]),
            tables,
        ).numpy()
        dd = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        np.testing.assert_allclose(ll, dd[:sz], rtol=1e-9, atol=1e-9)
        # and the finish against dd_finish's host f64 finish
        w_gp, w_mx, w_mg, w_off = dd_finish(hi, lo)
        np.testing.assert_allclose(gp, w_gp, rtol=1e-9, atol=1e-9)
        clear = mg > 1e-9
        np.testing.assert_array_equal(mx[clear], w_mx[clear])
        np.testing.assert_allclose(off, w_off, rtol=1e-9, atol=1e-300)
        checked += 1
    assert checked > 0


def test_pad_read_batch_matches_jax():
    rng = np.random.default_rng(11)
    R, L = 300, 90
    reads = {
        "rd": rng.integers(0, 256, size=(R, L)).astype(np.uint8),
        "starts": np.sort(rng.integers(-50, 4000, R)).astype(np.int32),
        "lens": rng.integers(30, L + 1, R).astype(np.int32),
        "ori": rng.integers(0, 2, R).astype(np.int32),
        "strand": rng.integers(0, 3, R).astype(np.int32),
        "mapq": rng.integers(0, 61, R).astype(np.int32),
    }
    for lo, hi, r_pad, l_cap in ((0, 999, 1024, 128), (500, 2500, 256, 90),
                                 (-100, 5000, 1024, 128), (0, 4000, 64, 128),
                                 (0, 100, 1024, 64)):
        got = PD.pad_read_batch(reads, lo, hi, r_pad, l_cap)
        want = jax_pd.pad_read_batch(reads, lo, hi, r_pad, l_cap)
        if want is None:
            assert got is None
            continue
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_pileup_refuses_other_devices():
    batch = as_torch(
        np.zeros((4, 8), np.uint8), *(np.zeros(4, np.int32),) * 4
    )
    with pytest.raises(ValueError):
        PD.pileup_scatter(*batch, 16, 20)  # the launcher is CUDA-only
    with pytest.raises(ValueError):
        PD.device_pileup(*(t.to("meta") for t in batch), 16, 20)
    tables = model_tables(ModelParams(), torch.float32, CPU)
    with pytest.raises(ValueError):
        PD.fused_ll_f64(*batch, torch.zeros(16, dtype=torch.int32),
                        n_pos=16, min_qual=20, tables=tables)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    ref, bam = random_bam(tmp_path, n_pairs=400, seed=3)
    for blk, reads in native_blocks(bam, CallerConfig()):
        sz = blk["y"] - blk["x"] + 1
        batch = as_torch(
            *PD.pad_read_batch(reads, 0, sz - 1, 1024, 256), device=dev
        )
        n0 = PD.pileup_scatter.launches
        got = PD.device_pileup(*batch, sz, 20)
        assert PD.pileup_scatter.launches == n0 + 1
        want = PD.device_pileup_plain(*batch, sz, 20)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
