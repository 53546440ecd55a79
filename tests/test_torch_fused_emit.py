"""The port's `fused_emit_chunk` (any read batch -> K12's pileup and f64
model -> K3's emit fields -> compaction; their plain versions on the
CPU) against `bs_call_tpu`'s `fused_emit_chunk` (df32 model, the TPU's
het compaction) on the same seed-made batches: `tests/test_emit_device.
py`'s, and one of the same shape with its rows out of order, JAX-style
padding rows (zero bytes, start -1) and rows before 0 and past the chunk.

Contract: n_emit and the emitted positions exact; on the rows neither
flags `risk`, every integer field exact, the Fisher log10 p within 1e-12
relative of JAX's fs_hi + fs_lo (1e-12 absolute near p = 1, where df32
carries ~1e-14 absolute), and GL bit for bit but in the winner's
slot, which is within 1e-7: the JAX tier rebuilds it as -log1p(off)/ln 10
where the host prints -log(1 + off)/ln 10 (a known divergence of the
reference, ROADMAP Queue 3; `tests/test_torch_emit.py::
test_plain_gl_matches_jax`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bs_call_tpu.ops.genotype import ModelParams as JaxParams
from bs_call_tpu.ops.kernels import emit_device as jax_ed
from bs_call_tpu_torch.ops.emit_tables import emit_tables
from bs_call_tpu_torch.ops.kernels import emit_device as E
from bs_call_tpu_torch.ops.params import ModelParams, model_tables

CPU = torch.device("cpu")
N_POS, R, L, MIN_QUAL = 256, 64, 32, 13
INT_FIELDS = ("max_gt", "mq", "phred", "dp1", "qd", "fs_int", "flt", "mac1",
              "gl_len", "cg_code", "cond_cg", "het", "gt1", "ref5")


def batch(kind):
    """(rd, starts, ori, strand, mapq, ref): `test_fused_emit_chunk_end_to_
    end`'s batch ("jax"), or the same rows out of order with 8 rows made
    padding (zero bytes at start -1), 8 moved wholly before 0 and 8 past
    the chunk ("unsorted")."""
    rng = np.random.default_rng(21)
    rd = np.zeros((R, L), np.uint8)
    for i in range(R):
        ln = rng.integers(10, L + 1)
        base = rng.integers(0, 4, size=ln).astype(np.uint8)
        qual = rng.integers(5, 44, size=ln).astype(np.uint8)
        rd[i, :ln] = base | (qual << 2)
    starts = rng.integers(0, N_POS - L, size=R).astype(np.int32)
    ori = rng.integers(0, 2, size=R).astype(np.int32)
    strand = rng.integers(0, 3, size=R).astype(np.int32)
    mapq = rng.integers(10, 61, size=R).astype(np.int32)
    ref = rng.integers(0, 5, size=N_POS).astype(np.int32)
    if kind == "unsorted":
        rd[:8] = 0
        starts[:8] = -1
        starts[8:16] = -L - rng.integers(0, 40, 8)
        starts[16:24] = N_POS + rng.integers(0, 40, 8)
        starts[24:32] = -rng.integers(1, L, 8)  # reaching into the chunk
        perm = rng.permutation(R)
        rd, starts, ori, strand, mapq = (
            a[perm] for a in (rd, starts, ori, strand, mapq))
    return rd, starts, ori, strand, mapq, ref


@pytest.fixture(scope="module", params=["jax", "unsorted"])
def both(request):
    """(JAX's compacted fields, the port's, n_emit) for one batch."""
    b = batch(request.param)
    n_emit, out = jax_ed.fused_emit_chunk(
        *(jnp.asarray(a) for a in b), n_pos=N_POS, min_qual=MIN_QUAL,
        params=JaxParams(), cap=N_POS,
    )
    j = {k: np.asarray(v) for k, v in out.items()}
    p_n, p_pos, packed = E.fused_emit_chunk(
        *(torch.from_numpy(a) for a in b), N_POS, MIN_QUAL,
        model_tables(ModelParams(), torch.float64, CPU), emit_tables(CPU),
        N_POS,
    )
    p = E.unpack_fields(packed.numpy(), N_POS)
    p["pos"] = p_pos.numpy()
    assert int(p_n) == int(n_emit)
    return j, p, int(n_emit)


def test_n_emit_and_positions_exact(both):
    j, p, n = both
    assert 0 < n < N_POS
    np.testing.assert_array_equal(p["pos"], j["pos"])
    assert p["covered"][:n].all() and not p["covered"][n:].any()


def test_integer_fields_exact(both):
    j, p, n = both
    ok = ~(j["risk"][:n] | p["risk"][:n])
    assert ok.sum() > n // 3  # a shallow chunk: many low-margin rows
    for name in INT_FIELDS:
        np.testing.assert_array_equal(
            p[name][:n][ok], j[name][:n][ok].astype(p[name].dtype),
            err_msg=name)


def test_fisher_within_1e12(both):
    j, p, n = both
    ok = ~(j["risk"][:n] | p["risk"][:n])
    assert (ok & p["het"][:n]).sum() > 5
    jfs = j["fs_hi"][:n].astype(np.float64) + j["fs_lo"][:n].astype(
        np.float64)
    np.testing.assert_allclose(p["fs_hi"][:n][ok], jfs[ok], rtol=1e-12,
                               atol=1e-12)


def test_gl_bits_and_the_winner_within_1e7(both):
    j, p, n = both
    ok = ~(j["risk"][:n] | p["risk"][:n])
    gidx = emit_tables(CPU).gl_idx.numpy()[p["max_gt"][:n] * 5
                                           + p["ref5"][:n]]
    win = np.maximum(gidx, 0) == p["max_gt"][:n, None]
    got, want = p["gl_vals"][:n], j["gl_vals"][:n].astype(np.float32)
    rest = ok[:, None] & ~win
    np.testing.assert_array_equal(got[rest].view(np.uint32),
                                  want[rest].view(np.uint32))
    w = ok[:, None] & win
    np.testing.assert_allclose(got[w], want[w], rtol=2.0**-22, atol=1e-7)


def test_overflow_is_reported_and_bounded():
    """cap below n_emit: n_emit still counts every covered row (the
    caller reruns the chunk), and the cap rows kept are the first ones of
    the roomy run."""
    b = [torch.from_numpy(a) for a in batch("unsorted")]
    tables = (model_tables(ModelParams(), torch.float64, CPU),
              emit_tables(CPU))
    n, pos, packed = E.fused_emit_chunk(*b, N_POS, MIN_QUAL, *tables, N_POS)
    cap = int(n) - 3
    o_n, o_pos, o_packed = E.fused_emit_chunk(*b, N_POS, MIN_QUAL, *tables,
                                              cap)
    assert int(o_n) == int(n) > cap
    assert torch.equal(o_pos, pos[:cap])
    assert o_packed.numel() == cap * E.ROW_BYTES
    full = E.unpack_fields(packed.numpy(), N_POS)
    kept = E.unpack_fields(o_packed.numpy(), cap)
    for name, a in kept.items():
        np.testing.assert_array_equal(a.view(np.uint8),
                                      full[name][:cap].view(np.uint8))
