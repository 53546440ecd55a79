"""Pileup of the PyTorch port (`bs_call_tpu_torch.ops.kernels.
pileup_device`: the plain version of K12's pileup, and the fused exact
tier with K12's sorted batch and tile table) against the JAX package's
`device_pileup` / `fused_ll_dd` and the host `build_pileup`. K12 itself
is compared with these plain versions on the card (marked `cuda`)."""

import numpy as np
import pytest
import torch

from bs_call_tpu.config import CallerConfig
from bs_call_tpu.native.pipeline import NativePipeline
from bs_call_tpu.ops.genotype import ModelParams as JaxParams
from bs_call_tpu.ops.genotype_dd import dd_finish
from bs_call_tpu.ops.kernels import pileup_device as jax_pd
from bs_call_tpu.ops.pileup import build_pileup
from bs_call_tpu_torch.constants import BASE_TAB_ST, FLT_QUAL
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
            for t in PD.device_pileup_plain(*as_torch(*batch), sz,
                                            cfg.min_qual)
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
    """K12's plain version (f64) against the JAX df32 fused tier on every
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
    from bs_call_tpu_torch.ops.kernels.pileup_genotype_cuda import (
        pileup_genotype,
    )

    batch = as_torch(
        np.zeros((4, 64), np.uint8), *(np.zeros(4, np.int32),) * 4
    )
    ref = torch.zeros(16, dtype=torch.int32)
    tables64 = model_tables(ModelParams(), torch.float64, CPU)
    with pytest.raises(ValueError):  # the launcher is CUDA-only
        pileup_genotype(*batch, torch.zeros((1, 2), dtype=torch.int32), ref,
                        16, 20, tables64)
    with pytest.raises(ValueError):
        PD.fused_pileup_call(*(t.to("meta") for t in (*batch, ref)), 16, 20,
                             tables64)
    tables = model_tables(ModelParams(), torch.float32, CPU)
    with pytest.raises(ValueError):
        PD.fused_ll_f64(*batch, torch.zeros(16, dtype=torch.int32),
                        n_pos=16, min_qual=20, tables=tables)


# ---- K12: the pileup and the model per tile of positions ----

def k12_reads(case, seed=0):
    """(reads dict as the engine receives it, n_pos) for one K12 case:
    reads that straddle tile edges and start before 0 ("edges"), 5,000
    reads of mapq 59 over one position, which takes its mapq2 sum past
    2^24 ("hot"), rows whose every byte is trimmed ("trimmed"), reads
    of up to 2,048 bases ("long"), rows of 64 bytes, K12's narrowest
    ("short"), tiles that no row meets ("sparse"), n_pos not a multiple of
    the tile, with rows before 0 and past n_pos ("ragged"), and min_qual 0
    (`k12_min_qual`), where the trim decides whether a q = 0 byte counts
    ("minq0")."""
    rng = np.random.default_rng(seed)
    n_pos, L, R = 4096, 256, 600
    if case == "long":
        n_pos, L, R = 8192, 2048, 300
    if case == "hot":
        R, L = 5000, 160
    if case == "short":
        L, R = 64, 2000
    if case == "ragged":
        n_pos = 4096 + 77
    lens = rng.integers(L // 2, L + 1, R)
    if case == "hot":
        lens[:] = 150
        starts = 2000 - rng.integers(0, 150, R)
        starts[:40] = rng.integers(-150, 0, 40)
    elif case in ("sparse", "ragged"):
        starts = rng.integers(-L, n_pos + 40, R)
        if case == "sparse":  # nothing meets [1200, 2900)
            starts = np.where(starts < 2048, starts % (1200 - L) - L // 2,
                              2900 + starts % (n_pos - 2900))
    else:
        edge = PD.TILE * rng.integers(0, n_pos // PD.TILE + 1, R)
        starts = edge + rng.integers(-3, 4, R) - lens * (rng.random(R) < 0.5)
        starts[:20] = rng.integers(-L, 0, 20)
    q = rng.integers(0, 44, size=(R, L))
    q[rng.random((R, L)) < 0.02] = 63
    if case == "hot":
        q = rng.integers(20, 44, size=(R, L))
    rd = ((q << 2) | rng.integers(0, 4, size=(R, L))).astype(np.uint8)
    rd[np.arange(L)[None, :] >= lens[:, None]] = 0
    if case in ("trimmed", "minq0"):
        rd[::7] = 63 << 2
        rd[3::7] = 0
    if case == "minq0":  # q = 0 bytes at the head of every fifth row
        rd[1::5, :8] = rng.integers(0, 4, size=(len(rd[1::5]), 8))
    mapq = (np.full(R, 59) if case == "hot"
            else rng.integers(0, 61, R)).astype(np.int32)
    reads = {"rd": rd, "starts": starts.astype(np.int32),
             "lens": lens.astype(np.int32),
             "ori": rng.integers(0, 2, R).astype(np.int32),
             "strand": rng.integers(0, 3, R).astype(np.int32),
             "mapq": mapq}
    return reads, n_pos


def k12_min_qual(case):
    return 0 if case == "minq0" else 20


def k12_batch(reads, n_pos):
    """The engine's padding and tile table for one chunk [0, n_pos)."""
    starts, lens = reads["starts"], reads["lens"]
    n_rows = int(((starts <= n_pos - 1) & (starts + lens - 1 >= 0)).sum())
    r_pad = max(1024, 1 << (n_rows - 1).bit_length())
    l_cap = max(64, 1 << (reads["rd"].shape[1] - 1).bit_length())
    batch = PD.pad_read_batch(reads, 0, n_pos - 1, r_pad, l_cap)
    return batch, PD.tile_rows(batch[1], n_rows, n_pos, l_cap)


def tiled_pileup(batch, tiles, n_pos, min_qual):
    """K12's walk in numpy: each tile adds, from its rows of the tile
    table only, the bytes of each (whole-row trimmed) read that fall in
    the tile."""
    rd, starts, ori, strand, mapq = batch
    counts2 = np.zeros((n_pos, 2, 8), np.int64)
    qual_sum = np.zeros((n_pos, 8), np.int64)
    mapq2 = np.zeros(n_pos, np.int64)
    tab = np.asarray(BASE_TAB_ST)
    for t, (r0, r1) in enumerate(tiles):
        t0, t1 = t * PD.TILE, min((t + 1) * PD.TILE, n_pos)
        for r in range(r0, r1):
            q = rd[r] >> 2
            live = np.nonzero((q > 0) & (q != FLT_QUAL))[0]
            if not len(live):
                continue
            j = np.arange(live[0], live[-1] + 1)
            pos = starts[r] + j
            ok = ((pos >= t0) & (pos < t1) & (q[j] >= min_qual)
                  & (q[j] != FLT_QUAL))
            j, pos = j[ok], pos[ok]
            cat = tab[min(max(strand[r], 0), 2), rd[r, j] & 3]
            np.add.at(counts2, (pos, int(ori[r] != 0), cat), 1)
            np.add.at(qual_sum, (pos, cat), q[j])
            np.add.at(mapq2, pos, int(mapq[r]) ** 2)
    return counts2, qual_sum, mapq2


K12_CASES = ["edges", "hot", "trimmed", "long", "short", "sparse",
             "ragged", "minq0"]


@pytest.mark.parametrize("case", K12_CASES)
def test_k12_tiles_cover_the_plain_pileup(case):
    """pad_read_batch's sort plus the tile table lose no read: K12's
    tiled walk gives the plain pileup of the unsorted batch, exactly (and
    the plain pileup of the sorted batch is the same)."""
    reads, n_pos = k12_reads(case, seed=K12_CASES.index(case))
    batch, tiles = k12_batch(reads, n_pos)
    assert (np.diff(batch[1][: tiles[:, 1].max()]) >= 0).all()
    starts, lens = reads["starts"], reads["lens"]
    keep = (starts <= n_pos - 1) & (starts + lens - 1 >= 0)
    shuffled = np.random.default_rng(1).permutation(np.nonzero(keep)[0])
    L = batch[0].shape[1]
    raw = np.zeros((len(shuffled), L), np.uint8)
    raw[:, : reads["rd"].shape[1]] = reads["rd"][shuffled]
    unsorted = [raw] + [reads[k][shuffled] for k in
                        ("starts", "ori", "strand", "mapq")]
    want = [t.numpy() for t in PD.device_pileup_plain(
        *as_torch(*unsorted), n_pos, k12_min_qual(case))]
    got_sorted = [t.numpy() for t in PD.device_pileup_plain(
        *as_torch(*batch), n_pos, k12_min_qual(case))]
    c2, qs, m2 = tiled_pileup(batch, tiles, n_pos, k12_min_qual(case))
    for a, b in zip(got_sorted, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(c2, want[0])
    np.testing.assert_array_equal(qs.astype(np.float32), want[1])
    np.testing.assert_array_equal(m2.astype(np.float32), want[2])
    assert want[0].sum() > 0
    if case == "hot":
        assert (m2 >= 2**24).sum() > 0  # past f32's exact integers
    if case == "sparse":
        assert (tiles[:, 1] <= tiles[:, 0]).any()
    if case == "ragged":
        assert n_pos % PD.TILE and (starts < 0).any()
        assert (starts + lens > n_pos).any()


@pytest.mark.parametrize("case", K12_CASES)
def test_k12_plain_matches_fused_ll_dd(case):
    """K12's plain version (`fused_ll_f64` on the CPU: the plain pileup,
    then the plain model on its planes) against the JAX df32 fused tier on the
    same sorted, padded batch: quals exact, log10 posteriors and off-sum
    within 1e-9 (df32 carries ~1e-10 relative), max_gt equal where the
    margin clears the oracle's tie threshold."""
    reads, n_pos = k12_reads(case, seed=10 + K12_CASES.index(case))
    batch, tiles = k12_batch(reads, n_pos)
    ref_codes = np.random.default_rng(2).integers(0, 5, n_pos).astype(
        np.int32
    )
    tables = model_tables(ModelParams(), torch.float64, CPU)
    gp, mx, mg, off, q = (t.numpy() for t in PD.fused_ll_f64(
        *as_torch(*batch, ref_codes), n_pos=n_pos,
        min_qual=k12_min_qual(case), tables=tables, tiles=torch.from_numpy(tiles),
    ))
    hi, lo, j_q = jax_pd.fused_ll_dd(
        *batch, ref_codes, n_pos=n_pos, min_qual=k12_min_qual(case),
        params=JaxParams(),
    )
    np.testing.assert_array_equal(q, np.asarray(j_q))
    w_gp, w_mx, w_mg, w_off = dd_finish(hi, lo)
    np.testing.assert_allclose(gp, w_gp, rtol=1e-9, atol=1e-9)
    clear = mg > 1e-9
    np.testing.assert_array_equal(mx[clear], w_mx[clear])
    np.testing.assert_allclose(off, w_off, rtol=1e-9, atol=1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("case, dtype", [
    *((c, torch.float64) for c in K12_CASES),
    # f32 (off the main path) where K2's f32 tolerances hold: at depth
    # 5,000 ("hot") an f32 log-likelihood of ~1e4 carries ~1e-3 rounding
    *((c, torch.float32) for c in K12_CASES if c != "hot"),
])
def test_k12_matches_plain_on_card(case, dtype):
    """K12 on the card against its plain version on the card: the
    pileup planes and quals exact; f64 within K2's tolerances (1e-12,
    ties 1e-9), f32 within 2e-5 (ties 1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12

    dev = torch.device("cuda")
    reads, n_pos = k12_reads(case, seed=20 + K12_CASES.index(case))
    batch, tiles = k12_batch(reads, n_pos)
    args = as_torch(*batch, device=dev)
    ref = torch.from_numpy(np.random.default_rng(3).integers(
        0, 5, n_pos).astype(np.int32)).to(dev)
    tables = model_tables(ModelParams(), dtype, dev)
    n0 = K12.pileup_genotype.launches
    got = K12.pileup_genotype(*args, torch.from_numpy(tiles).to(dev), ref,
                              n_pos, k12_min_qual(case), tables)
    assert K12.pileup_genotype.launches == n0 + 1
    c2, qs, m2 = PD.device_pileup_plain(*args, n_pos, k12_min_qual(case))
    want = (c2, qs, m2, *G.call_genotypes_pileup_plain(c2, qs, ref, tables))
    for i in (0, 1, 2, 7):
        assert torch.equal(got[i], want[i])
    tol, tie = (1e-12, 1e-9) if dtype == torch.float64 else (2e-5, 1e-3)
    clear = want[5] > tie
    assert torch.equal(got[4][clear], want[4][clear])
    torch.testing.assert_close(got[3], want[3], rtol=tol, atol=tol)
    torch.testing.assert_close(
        got[6], want[6], rtol=tol if dtype == torch.float64 else 1e-4,
        atol=1e-30,
    )
