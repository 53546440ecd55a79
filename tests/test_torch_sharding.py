"""Position sharding in the port (`bs_call_tpu_torch.parallel.sharding`,
`emit_device.sharded_emit_fields` / `sharded_fused_ll_emit`,
`pileup_device.sharded_fused_ll_f64`, and the engine over a device list)
on lists of CPU devices, against the port's single device and against the
JAX package's sharded programs on its 8 virtual CPU devices.

Contract: over `[cpu] * 2` and `[cpu] * 4` every output equals the
single device's bit for bit, the emit fields' risk bits included (slabs
are whole tiles, the pileup sums are integers and every other output is a
per-position function of them and of the neighbours' genotype codes,
which cross a slab border through the halo). Against JAX: the model
within `tests/test_torch_genotype.py`'s tolerances (f32 2e-5, f64 1e-12;
1e-9 against the df32 planes, as `tests/test_torch_pileup.py`), the
integer stats exact, and the emit fields as `tests/test_torch_fused_emit.
py` compares them (rows neither flags: integers exact but GQ and QD
where off < 1e-10, Fisher within 1e-11, GL bit for bit but the winner's
slot within 1e-7). The engine with
`[cpu] * 4` writes the bytes of the engine with one device and the golden
bytes. On the card (marked `cuda`) the same checks run over `[cuda:0] *
k`, with one K12 and one K3 launch a slab."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bs_call_tpu.ops.genotype import ModelParams as JaxParams
from bs_call_tpu.ops.genotype_dd import dd_finish
from bs_call_tpu.ops.kernels import emit_device as jax_ed
from bs_call_tpu.parallel import sharding as jax_sh
from bs_call_tpu_torch.config import CallerConfig
from bs_call_tpu_torch.ops.emit_tables import emit_tables
from bs_call_tpu_torch.ops.genotype import (
    call_genotypes,
    call_genotypes_pileup_plain,
)
from bs_call_tpu_torch.ops.kernels import emit_device as E
from bs_call_tpu_torch.ops.kernels import pileup_device as PD
from bs_call_tpu_torch.ops.params import ModelParams, model_tables
from bs_call_tpu_torch.parallel import sharding as S
from bs_call_tpu_torch.pipeline.engine import TorchCallEngine, engine_devices
from bs_call_tpu_torch.pipeline.runner import run_caller
from bs_call_tpu_torch.utils.trace import Tracer

CPU = torch.device("cpu")
N_POS, R, L, MIN_QUAL = 1024, 512, 64, 13
INT_FIELDS = ("max_gt", "mq", "phred", "dp1", "qd", "fs_int", "flt", "mac1",
              "gl_len", "cg_code", "cond_cg", "het", "gt1", "ref5")
MT = model_tables(ModelParams(), torch.float64, CPU)
ET = emit_tables(CPU)


def as_torch(*arrays, device=CPU):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def read_batch(seed):
    """R reads of 20..L random bases (a het-rich mix) at starts over
    [-L/2, N_POS), in no order, 8 of them padding (zero bytes at start
    -1, as the JAX package pads) and 8 past the chunk; ref [N_POS]."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, L + 1, R)
    rd = ((rng.integers(5, 44, (R, L)) << 2)
          | rng.integers(0, 4, (R, L))).astype(np.uint8)
    rd[np.arange(L)[None, :] >= lens[:, None]] = 0
    starts = rng.integers(-L // 2, N_POS, R).astype(np.int32)
    rd[:8] = 0
    starts[:8] = -1
    starts[8:16] = N_POS + rng.integers(0, 40, 8)
    return (rd, starts, rng.integers(0, 2, R).astype(np.int32),
            rng.integers(0, 3, R).astype(np.int32),
            rng.integers(10, 61, R).astype(np.int32),
            rng.integers(0, 5, N_POS).astype(np.int32))


def columns(seed, n):
    """Pileup columns as `tests/test_mesh_engine.py` draws them."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, size=(n, 8)).astype(np.int32)
    counts[rng.random((n, 8)) < 0.5] = 0
    quals = np.where(counts > 0, rng.integers(20, 44, size=(n, 8)),
                     0).astype(np.int32)
    return counts, quals, rng.integers(0, 5, size=n).astype(np.int32)


# ---- the mesh and its slabs ----

@pytest.mark.parametrize("cards", [0, 1, 2, 3, 8])
def test_engine_devices_are_every_visible_card(monkeypatch, cards):
    """With two or more visible cards the engine meshes over all of them,
    cuda:0 ... cuda:k-1 (no even split needed: slabs are whole tiles);
    with one it keeps the device it was given. Only the count is asked
    of the CUDA runtime."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    cuda = torch.device("cuda")
    mesh = [torch.device("cuda", i) for i in range(cards)]
    assert S.make_mesh(cuda) == mesh
    assert engine_devices(cuda) == (mesh if cards > 1 else [cuda])


def test_mesh_of_the_cpu_and_engine_devices():
    assert S.make_mesh(CPU) == [CPU]
    assert engine_devices(CPU) == [CPU]
    eng = TorchCallEngine(CallerConfig(), CPU, [CPU] * 4)
    assert eng.devices == [CPU] * 4 and len(eng._tables) == 4
    assert eng._tables[0] is eng._tables[3]  # built once a device


@pytest.mark.parametrize("n, k", [(1024, 4), (32832, 2), (32832, 4),
                                  (300, 4), (1, 3), (129, 2)])
def test_slabs_are_runs_of_whole_tiles(n, k):
    got = S.slabs(n, k)
    n_tiles = -(-n // S.TILE)
    assert len(got) == min(k, n_tiles)
    assert got[0][0] == 0 and got[-1][1] == n
    for (lo, hi), (lo2, _) in zip(got, got[1:]):
        assert hi == lo2 and hi % S.TILE == 0
    sizes = [-(-(hi - lo) // S.TILE) for lo, hi in got]
    assert max(sizes) - min(sizes) <= 1


# ---- the column tier and the calling step ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [2, 4])
def test_sharded_call_genotypes_bitwise(dtype, k):
    counts, quals, ref = columns(11, 1 << 12)
    tables = model_tables(ModelParams(), dtype, CPU)
    args = as_torch(counts, quals, ref)
    want = call_genotypes(*args, tables)
    got = S.sharded_call_genotypes([CPU] * k, *args, [tables] * k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_call_genotypes_matches_jax(dtype):
    counts, quals, ref = columns(11, 1 << 12)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    mesh = jax_sh.make_mesh(8)
    j_gp, j_mx, j_mg, j_off = (np.asarray(a) for a in jax_sh.
                               sharded_call_genotypes(mesh, JaxParams(), jdt)(
                                   *jax_sh.shard_positions(mesh, counts,
                                                           quals, ref)))
    tables = model_tables(ModelParams(), dtype, CPU)
    gp, mx, mg, off = (t.numpy() for t in S.sharded_call_genotypes(
        [CPU] * 4, *as_torch(counts, quals, ref), [tables] * 4))
    tol, tie = (1e-12, 1e-9) if dtype == torch.float64 else (2e-5, 1e-3)
    clear = j_mg > tie
    np.testing.assert_array_equal(mx[clear], j_mx[clear])
    np.testing.assert_allclose(gp, j_gp, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        off, j_off, rtol=tol if dtype == torch.float64 else 1e-4,
        atol=1e-300 if dtype == torch.float64 else 1e-30)


def test_sharded_ll_f64_bitwise_and_against_jax_df32():
    counts, quals, ref = columns(12, 1 << 10)
    args = as_torch(counts, quals, ref)
    want = call_genotypes(*args, MT)
    got = S.sharded_ll_f64([CPU] * 4, *args, [MT] * 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    mesh = jax_sh.make_mesh(8)
    hi, lo = jax_sh.sharded_ll_dd(mesh, JaxParams())(
        *jax_sh.shard_positions(mesh, counts, quals, ref))
    w_gp, w_mx, _w_mg, w_off = dd_finish(np.asarray(hi), np.asarray(lo))
    gp, mx, mg, off = (t.numpy() for t in got)
    np.testing.assert_allclose(gp, w_gp, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(mx[mg > 1e-9], w_mx[mg > 1e-9])
    np.testing.assert_allclose(off, w_off, rtol=1e-9, atol=1e-300)
    f32 = model_tables(ModelParams(), torch.float32, CPU)
    with pytest.raises(ValueError, match="float64"):
        S.sharded_ll_f64([CPU] * 2, *args, [f32] * 2)


def test_full_step_matches_jax_and_one_device():
    """`tests/test_sharding.py::test_full_step_emitter_grade_halo`'s
    batch: the halo'd neighbour codes and skip bits, the CG mask and the
    histograms equal JAX's 8-device step; over 2 and 4 slabs the port's
    outputs are each other's and one device's bit for bit."""
    counts, quals, ref = columns(9, 128 * 8)
    mesh = jax_sh.make_mesh(8)
    want = {k: np.asarray(v) for k, v in jax_sh.sharded_full_step(
        mesh, JaxParams(), dtype=jnp.float64)(
            *jax_sh.shard_positions(mesh, counts, quals, ref)).items()}
    args = as_torch(counts, quals, ref)
    one = S.sharded_full_step([CPU], *args, [MT])
    for k in (2, 4):
        got = S.sharded_full_step([CPU] * k, *args, [MT] * k)
        assert sorted(got) == sorted(want)
        for name, v in got.items():
            assert torch.equal(v, one[name]), name
    got = {k: v.numpy() for k, v in got.items()}
    for name in ("max_gt", "covered", "gt1", "prev_gt", "next_gt",
                 "prev_skip", "next_skip", "cg_mask", "gt_hist", "cov_hist"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["gt_hist"].dtype == got["cov_hist"].dtype == np.int32
    np.testing.assert_array_equal(got["margin"] > 1e-9,
                                  want["margin"] > 1e-9)
    np.testing.assert_allclose(got["gt_prob"], want["gt_prob"], rtol=1e-12,
                               atol=1e-12)
    covered = counts.sum(axis=1) > 0
    np.testing.assert_array_equal(
        got["gt_hist"], np.bincount(got["max_gt"][covered], minlength=10))


def test_halo_finds_a_cg_pair_across_a_slab_border():
    """`tests/test_sharding.py::test_halo_exchange_cg_detection`: a CC
    call at 127, the last row of slab 0, and a GG call at 128, the first
    of slab 1; and the same through `sharded_call_step`."""
    counts = np.zeros((128 * 8, 8), np.int32)
    quals = np.zeros((128 * 8, 8), np.int32)
    ref = np.zeros(128 * 8, np.int32)
    counts[127, 1], quals[127, 1], ref[127] = 20, 40, 2
    counts[128, 2], quals[128, 2], ref[128] = 20, 40, 3
    f32 = model_tables(ModelParams(), torch.float32, CPU)
    _gp, _mx, cg, gt_hist, _cov = S.sharded_call_step(
        [CPU] * 8, *as_torch(counts, quals, ref), [f32] * 8)
    mesh = jax_sh.make_mesh(8)
    j_cg = np.asarray(jax_sh.sharded_call_step(mesh, JaxParams())(
        *jax_sh.shard_positions(mesh, counts, quals, ref))[2])
    np.testing.assert_array_equal(cg.numpy(), j_cg)
    assert cg[127] and cg[128] and int(cg.sum()) == 2
    assert int(gt_hist.sum()) == 2


# ---- the emit fields: K3's context, and the fused tier over slabs ----

def cg_pileup(n):
    """`n + 2` rows of pileup planes (tests/test_torch_emit.py's random
    mix) whose first two and last two rows are a CC call then a GG call,
    so that the inner n rows' first and last rows are half of a CpG pair
    whose other half lies just outside them."""
    from test_torch_emit import random_pileup

    counts2, qual_sum, mapq2, ref = random_pileup(
        np.random.default_rng(4), n + 2)
    for i, cat, r in ((0, 1, 2), (1, 2, 3), (n, 1, 2), (n + 1, 2, 3)):
        counts2[i] = 0
        counts2[i, 0, cat] = 20
        qual_sum[i] = 0
        qual_sum[i, cat] = 20 * 40
        mapq2[i] = 20 * 60 * 60
        ref[i] = r
    c2, qs, m2, rf = as_torch(counts2, qual_sum, mapq2, ref)
    return (*call_genotypes_pileup_plain(c2, qs, rf, MT)[:4], c2, m2, rf)


def test_ctx_gives_the_border_rows_their_neighbours():
    """K3's plain version on the inner rows with ctx = the outer rows'
    codes equals it on all rows, at every inner row and field: the border
    rows get their CG context and are flagged only for their own
    reasons. An unknown ctx (-1) is no ctx: the borders flagged, their
    neighbours uncalled."""
    n = 256
    full = cg_pileup(n)
    whole = E.emit_fields_plain(*full, ET)
    inner = tuple(t[1:-1] for t in full)
    ctx = E._winner_codes(E._ends(full[1]), E._ends(full[4]))
    assert ctx.tolist() == [5, 8]
    known = E.emit_fields_plain(*inner, ET, ctx=ctx)
    for name, v in known.items():
        assert torch.equal(v, whole[name][1:-1]), name
    assert known["cg_code"][0] == ord("G") and known["cond_cg"][-1]
    none = E.emit_fields_plain(*inner, ET)
    unknown = E.emit_fields_plain(*inner, ET,
                                  ctx=torch.tensor([-1, -1], dtype=torch.int32))
    for name, v in none.items():
        assert torch.equal(v, unknown[name]), name
    assert none["risk"][0] and none["risk"][-1]
    assert not none["cond_cg"][0] and not none["cond_cg"][-1]


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_emit_fields_equal_one_device(k):
    args = cg_pileup(N_POS - 2)
    want = E.emit_fields(*args, ET)
    got = E.sharded_emit_fields([CPU] * k, *args, [ET] * k)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_sharded_fused_tier_equals_one_device(k):
    """`sharded_fused_ll_emit` and `sharded_fused_ll_f64` over k slabs,
    from any batch (prepared on its device) and from the engine's host
    batch with its host tile table: every output, risk bits included, is
    `fused_ll_emit`'s on one device."""
    b = read_batch(0)
    args = as_torch(*b)
    want = PD.fused_ll_emit(*args, N_POS, MIN_QUAL, MT, ET)
    got = E.sharded_fused_ll_emit([CPU] * k, *args, N_POS, MIN_QUAL,
                                  [MT] * k, [ET] * k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    f64 = PD.sharded_fused_ll_f64([CPU] * k, *args, N_POS, MIN_QUAL,
                                  [MT] * k)
    for g, w in zip(f64, want[:5]):
        assert torch.equal(g, w)
    starts = b[1]
    keep = (starts <= N_POS - 1) & (starts + L - 1 >= 0)
    reads = {"rd": b[0], "starts": starts, "lens": np.full(R, L),
             "ori": b[2], "strand": b[3], "mapq": b[4]}
    padded = PD.pad_read_batch(reads, 0, N_POS - 1, 1024, 64)
    tiles = PD.tile_rows(padded[1], int(keep.sum()), N_POS, 64)
    host = E.sharded_fused_ll_emit([CPU] * k, *as_torch(*padded, b[5]),
                                   N_POS, MIN_QUAL, [MT] * k, [ET] * k,
                                   tiles=tiles)
    for g, w in zip(host, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's 4-device `sharded_fused_ll_emit` (reads data-parallel, psum
    of the pileup, df32 model, halo'd emit fields) on `read_batch(0)`."""
    b = read_batch(0)
    mesh = Mesh(np.array(jax.devices()[:4]), ("pos",))
    fn = jax_ed.sharded_fused_ll_emit(mesh, JaxParams(), N_POS, MIN_QUAL)
    hi, lo, q, fields = fn(*(jnp.asarray(a) for a in b))
    return (np.asarray(hi), np.asarray(lo), np.asarray(q),
            {k: np.asarray(v) for k, v in fields.items()})


def test_sharded_fused_tier_matches_jax(jax_sharded):
    hi, lo, j_q, j = jax_sharded
    args = as_torch(*read_batch(0))
    gp, mx, mg, off, q, packed = E.sharded_fused_ll_emit(
        [CPU] * 4, *args, N_POS, MIN_QUAL, [MT] * 4, [ET] * 4)
    np.testing.assert_array_equal(q.numpy(), j_q)
    w_gp, w_mx, _w_mg, w_off = dd_finish(hi, lo)
    np.testing.assert_allclose(gp.numpy(), w_gp, rtol=1e-9, atol=1e-9)
    clear = mg.numpy() > 1e-9
    np.testing.assert_array_equal(mx.numpy()[clear], w_mx[clear])
    p = E.unpack_fields(packed.numpy(), N_POS)
    ok = ~(j["risk"] | p["risk"]) & p["covered"]
    # every row of this mix is het, and JAX flags three in four of them
    assert ok.sum() > N_POS // 5
    # GQ and QD (GQ over depth) where off is below 1e-10: the port prints
    # the host's -log(1 + off) (1 + off rounds to 1 below 2^-53: GQ 255),
    # JAX's tier log1p(off), the divergence of the winner's GL slot below
    # (ROADMAP Queue 3)
    tiny = off.numpy() < 1e-10
    assert 0 < (ok & tiny).sum() < ok.sum()
    for name in INT_FIELDS:
        rows = ok & ~tiny if name in ("phred", "qd") else ok
        np.testing.assert_array_equal(
            p[name][rows], j[name][rows].astype(p[name].dtype), err_msg=name)
    het = ok & p["het"]
    assert het.sum() > 5
    # 1e-11: these tables are deeper than test_torch_fused_emit.py's, and
    # JAX's df32 log-factorials (up to ~60 here) carry ~2^-44 of their
    # size into log p; the port's walk is the host's f64 one
    jfs = j["fs_hi"].astype(np.float64) + j["fs_lo"].astype(np.float64)
    np.testing.assert_allclose(p["fs_hi"][het], jfs[het], rtol=1e-11,
                               atol=1e-11)
    gidx = ET.gl_idx.numpy()[p["max_gt"] * 5 + p["ref5"]]
    win = np.maximum(gidx, 0) == p["max_gt"][:, None]
    got, want = p["gl_vals"], j["gl_vals"].astype(np.float32)
    rest = ok[:, None] & ~win
    np.testing.assert_array_equal(got[rest].view(np.uint32),
                                  want[rest].view(np.uint32))
    np.testing.assert_allclose(got[ok[:, None] & win],
                               want[ok[:, None] & win], rtol=2.0**-22,
                               atol=1e-7)


def test_border_rows_with_ctx_match_jax(jax_sharded):
    """At each of JAX's interior slab borders (every 256 positions), the
    port's plain K3 on that slab alone, given the codes of the rows just
    outside it as ctx, codes the CG context of its first and last rows as
    JAX's `emit_fields_dd(prev_ctx=..., next_ctx=...)` does."""
    _hi, _lo, _q, j = jax_sharded
    args = as_torch(*read_batch(0))
    gp, mx, mg, off, counts2, _qs, mapq2 = PD.fused_pileup_call(
        *args, N_POS, MIN_QUAL, MT)
    codes = E._winner_codes(mx, counts2)
    slab = N_POS // 4
    clear = mg > 1e-9
    checked = 0
    for lo in range(slab, N_POS - slab + 1, slab):
        hi = lo + slab
        rows = slice(lo, hi)
        ctx = torch.stack([codes[lo - 1], codes[hi % N_POS]])
        if hi == N_POS:
            ctx[1] = -1
        f = E.emit_fields_plain(gp[rows], mx[rows], mg[rows], off[rows],
                                counts2[rows], mapq2[rows], args[5][rows],
                                ET, ctx=ctx)
        for r, g in ((0, lo), (-1, hi - 1)):
            near = slice(max(g - 1, 0), g + 2)
            if not bool(clear[near].all()):
                continue  # a tie near the border: JAX's winner may differ
            for name in ("gt1", "cg_code", "cond_cg"):
                assert int(f[name][r]) == int(j[name][g]), (name, g)
            checked += 1
    assert checked >= 3


# ---- the engine over a device list ----

def test_engine_mesh_vs_single_column_tier():
    """`tests/test_mesh_engine.py::test_engine_mesh_vs_single`: the
    column tier over [cpu] * 4 in chunks of 1,024 positions."""
    counts, quals, ref = columns(11, 1 << 12)
    cfg = CallerConfig(batch_positions=1 << 10)
    got = TorchCallEngine(cfg, CPU, [CPU] * 4)._call_batch(counts, quals,
                                                          ref)
    want = TorchCallEngine(cfg, CPU)._call_batch(counts, quals, ref)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def golden_cfg(tmp, **kw):
    from make_golden import build_fixture

    ref, bam, idx = build_fixture(str(tmp))
    return CallerConfig(
        input_file=bam, reference_file=ref, dbsnp_file=idx,
        benchmark_mode=True, left_trim=(2, 1), right_trim=(1, 0),
        sample_name="golden", **kw,
    )


def run(cfg, devices):
    from bs_call_tpu_torch.stats.collect import BsStats
    from bs_call_tpu_torch.stats.report import write_report

    out, tracer, rep = io.BytesIO(), Tracer(), io.StringIO()
    stats, table = run_caller(cfg, CPU, out_fileobj=out, stats=BsStats(),
                              tracer=tracer, devices=devices)
    write_report(rep, cfg, stats, table, dbsnp=cfg.dbsnp_file)
    return out.getvalue(), rep.getvalue(), dict(tracer.counts)


@pytest.mark.parametrize("tier", ["fused", "fused_no_emit", "column"])
def test_engine_mesh_vs_single_bytes(tmp_path, monkeypatch, tier):
    """The whole pipeline with the engine over [cpu] * 4 and over one CPU
    device, chunks of 1,024 positions: the fused tier with and without the
    emit tier, and the column tier (--no-exact)."""
    from test_native_pipeline import random_bam

    if tier == "fused_no_emit":
        monkeypatch.setenv("BS_CALL_EMIT_TIER", "0")
    ref, bam = random_bam(tmp_path, n_pairs=300, seed=5)
    cfg = CallerConfig(input_file=bam, reference_file=ref,
                       benchmark_mode=True, batch_positions=1 << 10,
                       exact=tier != "column")
    mesh = run(cfg, [CPU] * 4)
    one = run(cfg, None)
    assert mesh[:2] == one[:2]
    counts = mesh[2]
    assert counts == one[2]
    assert counts[f"tier_{tier.split('_')[0]}"] > 1024
    assert (counts["tier_emit"] > 0) == (tier == "fused")


def test_golden_through_mesh(tmp_path):
    """`tests/test_mesh_engine.py::test_golden_through_mesh`: the golden
    fixture through the engine over [cpu] * 4 writes the golden bytes."""
    from make_golden import GOLDEN_DIR

    from bs_call_tpu_torch.parity import strip_date

    vcf, report, counts = run(golden_cfg(tmp_path), [CPU] * 4)
    assert counts["tier_fused"] > 0
    with open(os.path.join(GOLDEN_DIR, "golden.vcf"), "rb") as f:
        assert vcf == f.read()
    with open(os.path.join(GOLDEN_DIR, "golden_report.json")) as f:
        assert strip_date(report) == f.read()


def test_a_failing_device_is_not_fallen_back_from():
    """A slab on a device without a kernel raises: the engine does not
    retry the chunk on one device or on the CPU."""
    counts, quals, ref = columns(3, 1 << 11)
    eng = TorchCallEngine(CallerConfig(batch_positions=1 << 10), CPU,
                          [CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="no genotype kernel"):
        eng._call_batch(counts, quals, ref)


# ---- on the card ----

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_sharded_fused_tier_on_card_equals_one_device(k):
    from bs_call_tpu_torch.ops.kernels import emit_cuda as K3
    from bs_call_tpu_torch.ops.kernels import pileup_genotype_cuda as K12

    dev = card()
    mt = model_tables(ModelParams(), torch.float64, dev)
    et = emit_tables(dev)
    args = as_torch(*read_batch(0), device=dev)
    want = PD.fused_ll_emit(*args, N_POS, MIN_QUAL, mt, et)
    n12, n3 = K12.pileup_genotype.launches, K3.emit_fields_cuda.launches
    got = E.sharded_fused_ll_emit([dev] * k, *args, N_POS, MIN_QUAL,
                                  [mt] * k, [et] * k)
    assert K12.pileup_genotype.launches == n12 + k
    assert K3.emit_fields_cuda.launches == n3 + k
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    f64 = PD.sharded_fused_ll_f64([dev] * k, *args, N_POS, MIN_QUAL,
                                  [mt] * k)
    for g, w in zip(f64, want[:5]):
        assert torch.equal(g, w)
    packed = E.sharded_emit_fields([dev] * k, *want[:4], *PD.fused_pileup_call(
        *args, N_POS, MIN_QUAL, mt)[4::2], args[5], [et] * k)
    assert torch.equal(packed, want[5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_column_tier_on_card_equals_one_device(dtype):
    dev = card()
    tables = model_tables(ModelParams(), dtype, dev)
    args = as_torch(*columns(11, 1 << 12), device=dev)
    want = call_genotypes(*args, tables)
    got = S.sharded_call_genotypes([dev] * 4, *args, [tables] * 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    one = S.sharded_full_step([dev], *args, [tables])
    four = S.sharded_full_step([dev] * 4, *args, [tables] * 4)
    for name, v in four.items():
        assert torch.equal(v, one[name]), name
