"""The port's fused programs on any read batch against the JAX package's:
`pileup_device.prepare_batch` (K12's batch made on the device) against
the host's `pad_read_batch` plus `tile_rows`, `fused_pileup_call`
against `bs_call_tpu`'s `fused_pileup_call` in f32 and f64, and
`emit_device.compact_emitted` against `bs_call_tpu`'s `compact_emitted`,
on the same seed-made inputs. The batches are the JAX tests' (32-byte
rows) and harder ones: rows out of order, padding rows with starts < 0,
rows before 0 and past the chunk, widths that are no multiple of 16. On
the card (marked `cuda`), `fused_pileup_call` and `fused_emit_chunk` are
held against their plain versions and their K12 and K3 launches counted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bs_call_tpu.ops.genotype import ModelParams as JaxParams
from bs_call_tpu.ops.kernels import emit_device as jax_ed
from bs_call_tpu.ops.kernels import pileup_device as jax_pd
from bs_call_tpu_torch.ops.emit_tables import emit_tables
from bs_call_tpu_torch.ops.genotype import call_genotypes_pileup_plain
from bs_call_tpu_torch.ops.kernels import emit_device as E
from bs_call_tpu_torch.ops.kernels import pileup_device as PD
from bs_call_tpu_torch.ops.params import ModelParams, model_tables

from test_torch_emit import called_pileup, random_pileup

CPU = torch.device("cpu")
MIN_QUAL = 13


def as_torch(*arrays, device=CPU):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def read_batch(case, seed=0):
    """(rd, starts, ori, strand, mapq, ref, n_pos) for one case.

    "jax": `tests/test_emit_device.py`'s batch (64 rows of 10-32 bases,
    q 5-43, starts in [0, n_pos - 32)). "unsorted": 96 rows of 32 bytes in
    no order over a chunk of 300 positions (a short last tile), with
    masked bytes, 8 all-zero padding rows at start -1 (the JAX package's
    padding), 8 live rows wholly before 0, 8 past the chunk and rows that
    start before 0 and reach into it. "l100": 100-byte rows, unsorted.
    "l64": 64-byte rows already sorted, the width K12 takes as it is.
    "deep": 4,000 reads of mapq 60 over one position, a mapq2 sum of
    14.4M, below 2^24 where the JAX package's ordered f32 sum is exact."""
    rng = np.random.default_rng(seed)
    n_pos, R, L = {"jax": (256, 64, 32), "unsorted": (300, 96, 32),
                   "l100": (700, 200, 100), "l64": (512, 150, 64),
                   "deep": (256, 4000, 32)}[case]
    lens = rng.integers(10, L + 1, R)
    q = rng.integers(5, 44, size=(R, L))
    if case != "jax":
        q[rng.random((R, L)) < 0.03] = 63
        q[rng.random((R, L)) < 0.02] = 0
    rd = ((q << 2) | rng.integers(0, 4, size=(R, L))).astype(np.uint8)
    rd[np.arange(L)[None, :] >= lens[:, None]] = 0
    starts = rng.integers(0, n_pos - L, R)
    if case in ("unsorted", "l100"):
        starts = rng.integers(-L // 2, n_pos, R)
    if case == "unsorted":
        rd[:8] = 0
        starts[:8] = -1
        starts[8:16] = -L - rng.integers(0, 50, 8)
        starts[16:24] = n_pos + rng.integers(0, 50, 8)
        perm = rng.permutation(R)
        rd, starts = rd[perm], starts[perm]
    if case == "l64":
        starts = np.sort(starts)
    if case == "deep":
        starts = 100 - rng.integers(0, 20, R)
        rd[:, :20] = (40 << 2) | 1
    ori = rng.integers(0, 2, R).astype(np.int32)
    strand = rng.integers(0, 3, R).astype(np.int32)
    mapq = (np.full(R, 60) if case == "deep"
            else rng.integers(10, 61, R)).astype(np.int32)
    ref = rng.integers(0, 5, n_pos).astype(np.int32)
    return rd, starts.astype(np.int32), ori, strand, mapq, ref, n_pos


CASES = ["jax", "unsorted", "l100", "l64", "deep"]


@pytest.mark.parametrize("case", CASES)
def test_prepare_batch_equals_pad_read_batch_and_tile_rows(case):
    """The device-side sort, padding and tile table are the host's:
    `pad_read_batch` (rows of width L meeting [0, n_pos), sorted by start,
    stable) then `tile_rows`; rows outside the chunk follow the live
    ones and land in no tile; the padded rows are a fresh contiguous
    allocation of a width K12 takes."""
    *batch, ref, n_pos = read_batch(case, seed=CASES.index(case))
    rd, starts = batch[0], batch[1]
    R, L = rd.shape
    (rows, *cols), tiles = PD.prepare_batch(*as_torch(*batch), n_pos)
    l_cap = rows.shape[1]
    assert l_cap == max(64, -(-L // 16) * 16) and l_cap % 16 == 0
    assert rows.is_contiguous() and rows.dtype == torch.uint8
    assert rows.untyped_storage().data_ptr() != torch.from_numpy(
        rd).untyped_storage().data_ptr()
    reads = {"rd": rd, "starts": starts, "lens": np.full(R, L, np.int32),
             "ori": batch[2], "strand": batch[3], "mapq": batch[4]}
    want = PD.pad_read_batch(reads, 0, n_pos - 1, R, l_cap)
    n_live = int(((starts <= n_pos - 1) & (starts + L - 1 >= 0)).sum())
    for got, exp in zip([rows, *cols], want):
        assert got.dtype == torch.from_numpy(exp).dtype
        np.testing.assert_array_equal(got.numpy()[:n_live], exp[:n_live])
    np.testing.assert_array_equal(
        tiles.numpy(), PD.tile_rows(want[1], n_live, n_pos, l_cap))
    assert tiles.dtype == torch.int32 and int(tiles[:, 1].max()) <= n_live
    assert not rows[:, L:].any()
    if case == "unsorted":
        assert n_live < R  # some rows lie outside the chunk
        out = cols[0].numpy()[n_live:]
        assert ((out > n_pos - 1) | (out + L - 1 < 0)).all()


def jax_fused_pileup_call(batch, ref, n_pos, dtype):
    out = jax_pd.fused_pileup_call(
        *batch, ref, n_pos=n_pos, min_qual=MIN_QUAL, params=JaxParams(),
        dtype=jnp.float32 if dtype == torch.float32 else jnp.float64,
    )
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("case, dtype", [
    *((c, torch.float64) for c in CASES),
    # f32 where K2's f32 tolerances hold: at depth 4,000 ("deep") an f32
    # log-likelihood of ~1e4 carries ~1e-3 of rounding
    *((c, torch.float32) for c in CASES if c != "deep"),
])
def test_fused_pileup_call_matches_jax(case, dtype):
    """Integers exact (counts2, the f32 qual sums of integers, mapq2_sum
    below 2^24); f64 posteriors and off-sum within 1e-12, margin within
    1e-9 absolute (a difference of log-likelihoods of ~1e2), winners
    equal where the margin clears the oracle's 1e-9; f32 as
    `tests/test_torch_genotype.py`: posteriors within 2e-5, off-sum 1e-4
    relative, winners equal where the margin is above 1e-3."""
    *batch, ref, n_pos = read_batch(case, seed=10 + CASES.index(case))
    tables = model_tables(ModelParams(), dtype, CPU)
    got = [t.numpy() for t in PD.fused_pileup_call(
        *as_torch(*batch, ref), n_pos, MIN_QUAL, tables)]
    want = jax_fused_pileup_call(batch, ref, n_pos, dtype)
    gp, mx, mg, off, c2, qs, m2 = got
    w_gp, w_mx, w_mg, w_off, w_c2, w_qs, w_m2 = want
    np.testing.assert_array_equal(c2, w_c2)
    np.testing.assert_array_equal(qs, w_qs)
    assert w_m2.max() < 2**24
    np.testing.assert_array_equal(m2, w_m2)
    assert c2.sum() > 0 and gp.dtype == np.dtype(str(dtype)[6:])
    if case == "deep":
        assert m2.max() == 4000 * 3600
    if dtype == torch.float64:
        clear = w_mg > 1e-9
        np.testing.assert_allclose(gp, w_gp, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(off, w_off, rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(mg, w_mg, rtol=1e-12, atol=1e-9)
    else:
        clear = w_mg > 1e-3
        np.testing.assert_allclose(gp, w_gp, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(off, w_off, rtol=1e-4, atol=1e-30)
    covered = c2.sum(axis=(1, 2)) > 0
    assert clear[covered].mean() > 0.9
    np.testing.assert_array_equal(mx[clear], w_mx[clear])


@pytest.fixture(scope="module")
def packed_chunk():
    """The plain emit fields of a 300-position chunk (half drawn from
    genotypes, half the het-rich random mix, 15% and 10% uncovered),
    packed as K3 packs them."""
    rng = np.random.default_rng(41)
    counts2, qual_sum, mapq2, ref = (
        np.concatenate(ab) for ab in zip(
            called_pileup(rng, 150, depth=18), random_pileup(rng, 150)
        )
    )
    c2, qs, m2, r = as_torch(counts2, qual_sum, mapq2, ref)
    mt = model_tables(ModelParams(), torch.float64, CPU)
    out = call_genotypes_pileup_plain(c2, qs, r, mt)[:4]
    fields = E.emit_fields_plain(*out, c2, m2, r, emit_tables(CPU))
    return E.pack_fields(fields), len(ref)


@pytest.mark.parametrize("room", ["roomy", "exact", "whole", "overflow",
                                  "zero"])
def test_compact_emitted_matches_jax(packed_chunk, room):
    """n_emit, pos and every field of the covered rows equal JAX's
    `compact_emitted` on the same fields, the rows past n_emit zero in
    both; with cap below n_emit both report n_emit (the overflow) and
    keep the first cap rows."""
    packed, n = packed_chunk
    fields = E.unpack_fields(packed.numpy(), n)
    n_cov = int(fields["covered"].sum())
    assert 0 < n_cov < n
    cap = {"roomy": n_cov + 4, "exact": n_cov, "whole": n,
           "overflow": n_cov - 2, "zero": 0}[room]
    n_emit, pos, out = E.compact_emitted(packed, n, cap)
    assert n_emit.dtype == torch.int32 and n_emit.dim() == 0
    j_n, j_out = jax_ed.compact_emitted(
        {k: jnp.asarray(v) for k, v in fields.items()}, cap)
    assert int(n_emit) == int(j_n) == n_cov
    assert pos.dtype == torch.int32 and pos.shape == (cap,)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_out["pos"]))
    kept = min(n_cov, cap)
    np.testing.assert_array_equal(pos.numpy()[:kept],
                                  np.nonzero(fields["covered"])[0][:kept])
    got = E.unpack_fields(out.numpy(), cap)
    assert got["covered"][:kept].all() and not got["covered"][kept:].any()
    for name, a in got.items():
        if name == "covered":
            continue
        b = np.asarray(j_out[name]).astype(a.dtype)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)


def test_compact_emitted_refuses_a_short_buffer(packed_chunk):
    packed, n = packed_chunk
    with pytest.raises(ValueError):
        E.compact_emitted(packed[:-1], n, n)


# ---- on the card: the fused programs against their plain versions ----

EXACT_EVERYWHERE = ("covered", "gt1", "max_gt", "ref5", "dp1", "gl_len",
                    "cg_code", "cond_cg", "het")


def plain_on(dev, batch, ref, n_pos, tables):
    """The plain pileup and model on the unsorted batch, on `dev`."""
    args = as_torch(*batch, device=dev)
    r = torch.from_numpy(ref).to(dev)
    c2, qs, m2 = PD.device_pileup_plain(*args, n_pos, MIN_QUAL)
    return c2, qs, m2, r, call_genotypes_pileup_plain(c2, qs, r, tables)


@pytest.mark.cuda
@pytest.mark.parametrize("case, dtype", [
    *((c, torch.float64) for c in CASES),
    *((c, torch.float32) for c in CASES if c != "deep"),
])
def test_fused_pileup_call_matches_plain_on_card(case, dtype):
    """One K12 launch a call; integers exact, f64 within K2's 1e-12
    (winners where the margin is above 1e-9), f32 within 2e-5 (1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12

    dev = torch.device("cuda")
    *batch, ref, n_pos = read_batch(case, seed=20 + CASES.index(case))
    tables = model_tables(ModelParams(), dtype, dev)
    n0 = K12.pileup_genotype.launches
    got = PD.fused_pileup_call(*as_torch(*batch, ref, device=dev), n_pos,
                               MIN_QUAL, tables)
    assert K12.pileup_genotype.launches == n0 + 1
    c2, qs, m2, _r, (gp, mx, mg, off, _q) = plain_on(dev, batch, ref, n_pos,
                                                    tables)
    for a, b in zip(got[4:], (c2, qs, m2)):
        assert torch.equal(a, b)
    tol, tie = (1e-12, 1e-9) if dtype == torch.float64 else (2e-5, 1e-3)
    clear = mg > tie
    assert torch.equal(got[1][clear], mx[clear])
    torch.testing.assert_close(got[0], gp, rtol=tol, atol=tol)
    torch.testing.assert_close(
        got[3], off, rtol=tol if dtype == torch.float64 else 1e-4,
        atol=1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_fused_emit_chunk_matches_plain_on_card(case):
    """One K12 and one K3 launch a call; n_emit and pos equal the plain
    version's; every field equal on the rows neither flags (fs_hi within
    1e-12 relative), the codes no libm reaches on every row; with cap
    below n_emit the overflow is reported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12

    dev = torch.device("cuda")
    *batch, ref, n_pos = read_batch(case, seed=30 + CASES.index(case))
    mt = model_tables(ModelParams(), torch.float64, dev)
    et = emit_tables(dev)
    args = as_torch(*batch, ref, device=dev)
    n12, n3 = K12.pileup_genotype.launches, K3.emit_fields_cuda.launches
    n_emit, pos, packed = E.fused_emit_chunk(*args, n_pos, MIN_QUAL, mt, et,
                                             n_pos)
    assert K12.pileup_genotype.launches == n12 + 1
    assert K3.emit_fields_cuda.launches == n3 + 1
    c2, _qs, m2, r, out = plain_on(dev, batch, ref, n_pos, mt)
    w_n, w_pos, w_packed = E.compact_emitted(
        E.pack_fields(E.emit_fields_plain(*out[:4], c2, m2, r, et)), n_pos,
        n_pos)
    assert int(n_emit) == int(w_n) > 0
    assert torch.equal(pos, w_pos)
    g = E.unpack_fields(packed.cpu().numpy(), n_pos, int(n_emit))
    w = E.unpack_fields(w_packed.cpu().numpy(), n_pos, int(n_emit))
    ok = ~(g["risk"] | w["risk"])
    assert ok.mean() > 0.5
    for name, a in g.items():
        rows = slice(None) if name in EXACT_EVERYWHERE else ok
        if name == "fs_hi":
            np.testing.assert_allclose(a[ok], w[name][ok], rtol=1e-12,
                                       atol=1e-15)
        elif name != "risk":
            np.testing.assert_array_equal(
                a[rows].view(np.uint8), w[name][rows].view(np.uint8),
                err_msg=name)
    over, _pos, _p = E.fused_emit_chunk(*args, n_pos, MIN_QUAL, mt, et,
                                        int(n_emit) - 1)
    assert int(over) == int(n_emit)
