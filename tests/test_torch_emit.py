"""The emit tier of the PyTorch port (`bs_call_tpu_torch.ops.kernels.
emit_device`, the plain version of K3, and `fused_ll_emit`) against the
scalar Fisher oracle, the host emit prep (`bsc_emit.cpp` via
`_native_emit_prep`, with `fisher_strand`) and the JAX package's
`emit_fields_jit`, on the same seed-made inputs.

Contract: on every row that the port does not flag `risk`, each emit
field is bit-identical to the host's (and to the JAX tier's where that
does not flag the row either); the Fisher test is within 1e-12 relative
of the oracle. The CUDA kernel itself is compared with the plain version
on the card (marked `cuda`)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bs_call_tpu.constants import BASE_TAB_ST, LOG10, lfact_store
from bs_call_tpu.ops import oracle
from bs_call_tpu.ops.genotype import ModelParams as JaxParams
from bs_call_tpu.ops.genotype_dd import genotype_ll_dd
from bs_call_tpu.ops.kernels.emit_device import emit_fields_jit
from bs_call_tpu.ops.postprocess import aggregate_pileup, fisher_strand
from bs_call_tpu.output.vector_site import _native_emit_prep
from bs_call_tpu_torch.ops.emit_tables import PACKED_ORDER, emit_tables
from bs_call_tpu_torch.ops.genotype import call_genotypes_pileup
from bs_call_tpu_torch.ops.kernels import emit_cuda
from bs_call_tpu_torch.ops.kernels import emit_device as E
from bs_call_tpu_torch.ops.kernels import pileup_device as PD
from bs_call_tpu_torch.ops.params import ModelParams, model_tables

CPU = torch.device("cpu")
PREP_FIELDS = ("phred", "dp1", "qd", "fs_int", "flt", "mac1", "gl_vals",
               "gl_len", "cg_code", "cond_cg", "het")


@pytest.fixture(scope="module")
def tables():
    return (model_tables(ModelParams(), torch.float64, CPU),
            emit_tables(CPU))


def as_torch(*arrays, device=CPU):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def oracle_log10(tab):
    """bsc_fisher_batch on one table, through the scalar oracle."""
    if not sum(tab):
        return 0.0
    return math.log(max(oracle.fisher([int(v) for v in tab]), 1e-20)) / LOG10


def random_pileup(rng, n):
    """Accumulators shaped like test_emit_device's `_random_pileup`: 1-3
    categories per position at 0-29 reads, some positions uncovered (a
    het-rich, low-confidence mix)."""
    counts2 = rng.integers(0, 30, size=(n, 2, 8)).astype(np.int32)
    counts2 *= rng.random((n, 2, 8)) < 0.35
    counts2[rng.random(n) < 0.15] = 0
    counts = counts2.sum(axis=1)
    qual_sum = np.floor(counts * rng.uniform(10.0, 43.0, (n, 8))).astype(
        np.float32
    )
    mq = rng.integers(10, 61, n)
    mapq2 = (counts.sum(axis=1) * mq * mq).astype(np.float32)
    ref = rng.integers(0, 5, size=n).astype(np.int32)
    return counts2, qual_sum, mapq2, ref


def called_pileup(rng, n, depth):
    """Accumulators drawn from genotypes as a WGBS pileup has them: 94%
    hom-ref, 4% het, 2% hom-alt; reads on both bisulfite strands and
    orientations with per-site methylation and 3% base errors; Poisson
    depth around `depth` with a few positions at 6x it; 10% uncovered."""
    counts2 = np.zeros((n, 2, 8), np.int32)
    ref = rng.integers(1, 5, n).astype(np.int32)
    ref[rng.random(n) < 0.02] = 0
    for i in range(n):
        rb = max(int(ref[i]) - 1, 0)
        u = rng.random()
        if u < 0.94:
            alleles = (rb, rb)
        elif u < 0.98:
            alleles = (rb, int(rng.integers(0, 4)))
        else:
            alleles = (int(rng.integers(0, 4)),) * 2
        d = rng.poisson(depth * (6 if rng.random() < 0.02 else 1))
        if rng.random() < 0.1:
            d = 0
        meth = rng.random()
        p = np.zeros((2, 8))
        for b in alleles:
            for s in (1, 2):
                for bb, pb in ((b, 0.97), (int(rng.integers(0, 4)), 0.03)):
                    w = 0.25 * pb
                    if (s, bb) in ((1, 1), (2, 2)):  # C on C2T, G on G2A
                        conv = 3 if s == 1 else 0
                        p[:, BASE_TAB_ST[s][conv]] += w * (1 - meth)
                        p[:, BASE_TAB_ST[s][bb]] += w * meth
                    else:
                        p[:, BASE_TAB_ST[s][bb]] += w
        counts2[i] = rng.multinomial(d, (p / p.sum()).reshape(-1)).reshape(
            2, 8
        )
    counts = counts2.sum(axis=1)
    qual_sum = np.floor(counts * rng.uniform(25.0, 40.0, (n, 8))).astype(
        np.float32
    )
    mq = np.where(rng.random(n) < 0.9, 60, rng.integers(0, 60, n))
    mapq2 = (counts.sum(axis=1) * mq * mq).astype(np.float32)
    return counts2, qual_sum, mapq2, ref


def port_fields(counts2, qual_sum, mapq2, ref, tables, quirk=True):
    """K2's plain f64 pileup entry, then the plain emit fields, through
    the packed layout (numpy views, as the engine reads them)."""
    mt, et = tables
    c2, qs, m2, r = as_torch(counts2, qual_sum, mapq2, ref)
    gp, mx, mg, off, _q = call_genotypes_pileup(c2, qs, r, mt)
    fields = E.emit_fields_plain(gp, mx, mg, off, c2, m2, r, et, quirk)
    packed = E.pack_fields(fields).numpy()
    assert packed.nbytes == len(ref) * emit_cuda.ROW_BYTES
    return (gp.numpy(), mx.numpy(), off.numpy()), E.unpack_fields(
        packed, len(ref)
    )


def host_prep(counts2, qual_sum, mapq2, ref, k2, quirk=True):
    """The host path on K2's f64 outputs: _finish_exact's winner rewrite,
    the native Fisher test, the C++ aggregate and bsc_emit prep."""
    gp, mx, off = (a.copy() for a in k2)
    gp[np.arange(len(mx)), mx] = -np.log(1.0 + off) / LOG10
    agg = aggregate_pileup(counts2, qual_sum, mapq2)
    fs = fisher_strand(counts2, mx, not quirk)
    covered = agg["n"] > 0
    gt1 = np.where(covered, mx + 1, 0).astype(np.int32)
    g1 = np.concatenate([[0], gt1[:-1]]).astype(np.int32)
    g3 = np.concatenate([gt1[1:], [0]]).astype(np.int32)
    prep = _native_emit_prep(
        len(mx), agg["counts"].astype(np.int32), gp, mx, np.clip(ref, 0, 4),
        agg["mq"], fs, g1, gt1, g3,
    )
    assert prep is not None, "the native host library did not build"
    return dict(zip(PREP_FIELDS, prep)), agg, fs


def test_emit_tables_are_the_jax_package_tables():
    et = emit_tables(CPU)
    # the serial log accumulation, bit for bit (not np.log / torch.log)
    assert et.lfact.dtype == torch.float64
    np.testing.assert_array_equal(et.lfact.numpy(), lfact_store())
    o = 0
    for name, size in PACKED_ORDER:
        np.testing.assert_array_equal(
            et.packed[o:o + size].numpy(),
            getattr(et, name).reshape(-1).to(torch.int32).numpy(),
        )
        o += size
    assert o == et.packed.numel() == 660


def test_fisher_plain_matches_oracle(tables):
    rng = np.random.default_rng(7)
    tabs = [rng.integers(0, 40, size=4) for _ in range(300)]
    tabs += [rng.integers(0, 300, size=4) for _ in range(100)]
    tabs += [
        [0, 0, 0, 0], [1, 0, 0, 0], [0, 5, 7, 0], [100, 1, 1, 100],
        [3, 3, 3, 3], [0, 0, 50, 50], [1, 1, 0, 0],
        # walks longer than FISHER_IMAX steps
        [900, 600, 600, 900], [5, 600, 20, 5],
    ]
    tabs = np.array(tabs, dtype=np.int64)
    fs, risk = (t.numpy() for t in E.fisher_plain(
        torch.from_numpy(tabs), tables[1].lfact
    ))
    want = np.array([oracle_log10(t) for t in tabs])
    ok = ~risk
    np.testing.assert_allclose(fs[ok], want[ok], rtol=1e-12, atol=1e-15)
    n = tabs.sum(axis=1)
    # lgamma (table total >= 256) and long walks are flagged, nothing else
    np.testing.assert_array_equal(risk, n >= E.LFACT_N)
    assert risk[-2:].all()
    assert ok.sum() > 300


@pytest.mark.parametrize("kind, quirk", [
    ("random", True), ("random", False), ("called_deep", True),
])
def test_emit_fields_plain_matches_host_prep(tables, kind, quirk):
    """quirk=False is --fix-reference-quirks: the GT genotype's Fisher
    table without the reference's counts[0][6] (call_genotypes.c:98)."""
    rng = np.random.default_rng(11)
    n = 1024
    if kind == "random":
        inputs = random_pileup(rng, n)
    else:
        inputs = called_pileup(rng, n, depth=50)
    k2, f = port_fields(*inputs, tables, quirk=quirk)
    want, agg, fs = host_prep(*inputs, k2, quirk=quirk)
    covered = agg["n"] > 0
    risk = f["risk"]
    assert risk[0] and risk[-1]  # the chunk's edges
    assert risk[covered].mean() <= 0.05
    ok = ~risk
    assert ok.sum() > 800
    np.testing.assert_array_equal(f["covered"], covered)
    np.testing.assert_array_equal(f["mq"][ok], agg["mq"][ok])
    for name in PREP_FIELDS:
        got, exp = f[name][ok], want[name][ok]
        if name == "het":
            got, exp = f[name][ok & covered], want[name][ok & covered]
        if name == "gl_vals":  # bit patterns: -0.0 prints as "-0"
            got, exp = got.view(np.uint32), exp.view(np.uint32)
        np.testing.assert_array_equal(got, exp.astype(got.dtype),
                                      err_msg=name)
    np.testing.assert_allclose(f["fs_hi"][ok], fs[ok], rtol=1e-12,
                               atol=1e-15)
    if kind == "called_deep":
        deep_het = f["het"] & (inputs[0].sum(axis=(1, 2)) >= E.LFACT_N)
        assert risk[deep_het].all()


def test_gq_band_flags_z1_near_one(tables):
    """GQ: rows whose 1 - z1 is a few ulps (off just above 2^-53) are
    flagged; rows where 1 + off rounds to 1 (phred 255 on every libm) and
    confident rows far from an integer phred are not."""
    off = np.array([0.0, 1e-300, 2.0**-54, 3e-16, 6e-16, 0.3, 0.5, 0.0])
    n = len(off)
    gp = np.full((n, 10), -5.0)
    gp[:, 0] = 0.0
    counts2 = np.zeros((n, 2, 8), np.int32)
    counts2[:, 0, 0] = 30  # 30 A reads on an A: AA, not het
    args = as_torch(
        gp, np.zeros(n, np.int32), np.full(n, 10.0), off, counts2,
        np.full(n, 30 * 3600.0, np.float32), np.ones(n, np.int32),
    )
    f = E.emit_fields_plain(*args, tables[1])
    risk, phred = f["risk"].numpy(), f["phred"].numpy()
    assert risk[0] and risk[-1]  # the chunk's edges
    assert not risk[1:3].any() and (phred[1:3] == 255).all()
    assert risk[3] and risk[4]
    assert not risk[5:7].any()
    z1 = np.exp(-np.log(1.0 + off[5:7]))
    np.testing.assert_array_equal(
        phred[5:7], (-10.0 * np.log(1.0 - z1) / LOG10).astype(np.int64)
    )


@pytest.fixture(scope="module")
def jax_and_port(tables):
    """One seed-made pileup of 256 positions (half drawn from genotypes,
    half the het-rich random mix) through bs_call_tpu's emit_fields_jit
    (df32 planes from genotype_ll_dd, het_cap=64) and through the port's
    plain K2 + emit fields."""
    rng = np.random.default_rng(23)
    counts2, qual_sum, mapq2, ref = (
        np.concatenate(ab) for ab in zip(
            called_pileup(rng, 128, depth=30), random_pileup(rng, 128)
        )
    )
    agg = aggregate_pileup(counts2, qual_sum, mapq2)
    hi, lo = genotype_ll_dd(
        jnp.asarray(agg["counts"]), jnp.asarray(agg["quals"]),
        jnp.asarray(ref), JaxParams(),
    )
    jf = emit_fields_jit(
        hi, lo, jnp.asarray(counts2), jnp.asarray(qual_sum),
        jnp.asarray(mapq2), jnp.asarray(ref), het_cap=64,
    )
    jf = {k: np.asarray(v) for k, v in jf.items()}
    _k2, pf = port_fields(counts2, qual_sum, mapq2, ref, tables)
    return jf, pf


@pytest.mark.parametrize("field", [
    "covered", "max_gt", "gt1", "ref5", "mq", "phred", "dp1", "qd",
    "fs_int", "flt", "mac1", "gl_len", "cg_code", "cond_cg", "het",
])
def test_plain_matches_jax_emit_fields(jax_and_port, field):
    jf, pf = jax_and_port
    ok = ~(jf["risk"] | pf["risk"])
    assert ok.sum() > 150
    np.testing.assert_array_equal(
        pf[field][ok], jf[field][ok].astype(pf[field].dtype)
    )


def test_plain_gl_matches_jax(jax_and_port, tables):
    """GL on rows neither flags: every slot but the winner's bit for bit.
    The winner's slot is -log(1 + off)/ln 10, the host's C-style rewrite
    (pipeline/engine.py:428), which is -0.0 once 1 + off rounds to 1; the
    JAX tier rebuilds -log1p(off)/ln 10 there (emit_device.py:382-427),
    so the two agree only to f32 precision above 1e-7 and both are
    within 1e-7 of zero below."""
    jf, pf = jax_and_port
    ok = ~(jf["risk"] | pf["risk"])
    gidx = tables[1].gl_idx.numpy()[pf["max_gt"] * 5 + pf["ref5"]]
    win = np.maximum(gidx, 0) == pf["max_gt"][:, None]
    got, want = pf["gl_vals"], jf["gl_vals"].astype(np.float32)
    rest = ok[:, None] & ~win
    np.testing.assert_array_equal(got[rest].view(np.uint32),
                                  want[rest].view(np.uint32))
    w = ok[:, None] & win
    np.testing.assert_allclose(got[w], want[w], rtol=2.0**-22, atol=1e-7)


def test_plain_fs_matches_jax(jax_and_port):
    jf, pf = jax_and_port
    ok = ~(jf["risk"] | pf["risk"]) & pf["het"]
    assert ok.sum() > 50
    jfs = jf["fs_hi"].astype(np.float64) + jf["fs_lo"].astype(np.float64)
    np.testing.assert_allclose(pf["fs_hi"][ok], jfs[ok], rtol=1e-9,
                               atol=1e-12)
    # both flag the chunk's edges
    assert jf["risk"][[0, -1]].all() and pf["risk"][[0, -1]].all()


def test_mapq2_sum_past_2_24_is_flagged(tables):
    """K1 sums mapq^2 exactly and casts once; the host sums in f32 in
    read order (bsc_pipeline.cpp:1524). Past 2^24 the two can differ,
    so MQ and the mq40 bit are the host's there: such a row is flagged,
    a row just below is not flagged by that rule."""
    depths = {5: 4800, 9: 4660, 12: 4900}  # position -> reads
    mapqs = {5: 60, 9: 60, 12: 59}
    rows = [(p, m) for p, d in depths.items() for m in [mapqs[p]] * d]
    R = len(rows)
    rd = np.full((R, 1), (30 << 2) | 0, np.uint8)  # base A, q30
    starts = np.array([p for p, _ in rows], np.int32)
    ori = (np.arange(R) % 2).astype(np.int32)
    strand = np.zeros(R, np.int32)
    mapq = np.array([m for _, m in rows], np.int32)
    n_pos = 16
    ref = np.ones(n_pos, np.int32)  # A: every covered row calls AA
    batch = as_torch(rd, starts, ori, strand, mapq, ref)
    _c2, _qs, m2 = PD.device_pileup(*batch[:5], n_pos, 20)
    m2 = m2.numpy()
    # the fault: at mapq 59 the host's ordered f32 sum leaves the exact
    # sum once it passes 2^24; the exact sum of mapq 60 at 4660 reads
    # stays below it
    ordered = np.float32(0)
    for _ in range(depths[12]):
        ordered = np.float32(ordered + np.float32(59 * 59))
    assert m2[12] == np.float32(depths[12] * 59 * 59) != ordered
    assert m2[9] == depths[9] * 3600 < 2**24 <= m2[5]
    *_k2, packed = PD.fused_ll_emit(
        *batch, n_pos=n_pos, min_qual=20, tables=tables[0], emit=tables[1],
    )
    f = E.unpack_fields(packed.numpy(), n_pos)
    assert f["covered"][[5, 9, 12]].all() and not f["het"].any()
    assert f["risk"][5] and f["risk"][12]
    assert not f["risk"][9]
    assert f["mq"][9] == 60


def test_cg_codes_match_host_automaton(tables):
    """Every (left, self, right) genotype code triple through the CG
    automaton against bsc_emit.cpp's."""
    et = tables[1]
    g = np.arange(11)
    a1, a2, a3 = (a.reshape(-1).astype(np.int32)
                  for a in np.meshgrid(g, g, g, indexing="ij"))
    a2 = np.maximum(a2, 1)  # an emitted row is covered
    mx = a2 - 1
    code, ccg = E.cg_codes(*as_torch(a2.astype(np.int64),
                                     a1.astype(np.int64),
                                     a3.astype(np.int64),
                                     mx.astype(np.int64)),
                           et.cflag, et.gflag)
    n = len(a2)
    prep = _native_emit_prep(
        n, np.zeros((n, 8), np.int32), np.zeros((n, 10)), mx,
        np.ones(n, np.int32), np.zeros(n, np.int32), np.zeros(n), a1, a2,
        a3,
    )
    want = dict(zip(PREP_FIELDS, prep))
    np.testing.assert_array_equal(code.numpy(), want["cg_code"])
    np.testing.assert_array_equal(ccg.numpy(), want["cond_cg"].astype(bool))


def test_fused_ll_emit_dispatch_and_refusals(tables):
    mt, et = tables
    rng = np.random.default_rng(2)
    R, L, n_pos = 64, 40, 256
    rd = ((rng.integers(5, 44, (R, L)) << 2)
          | rng.integers(0, 4, (R, L))).astype(np.uint8)
    starts = np.sort(rng.integers(-10, n_pos, R)).astype(np.int32)
    cols = [rng.integers(0, k, R).astype(np.int32) for k in (2, 3)]
    mapq = rng.integers(0, 61, R).astype(np.int32)
    ref = rng.integers(0, 5, n_pos).astype(np.int32)
    batch = as_torch(rd, starts, *cols, mapq, ref)
    out = PD.fused_ll_emit(*batch, n_pos=n_pos, min_qual=20, tables=mt,
                           emit=et)
    base = PD.fused_ll_f64(*batch, n_pos=n_pos, min_qual=20, tables=mt)
    for a, b in zip(out[:5], base):
        assert torch.equal(a, b)
    f = E.unpack_fields(out[5].numpy(), n_pos, rows=100)
    assert all(len(v) == 100 for v in f.values())
    c2, _qs, m2 = PD.device_pileup(*batch[:5], n_pos, 20)
    want = E.emit_fields_plain(*base[:4], c2, m2, batch[5], et)
    np.testing.assert_array_equal(f["phred"], want["phred"][:100].numpy())
    np.testing.assert_array_equal(f["risk"], want["risk"][:100].numpy())
    args = (*base[:4], c2, m2, batch[5])
    with pytest.raises(ValueError):
        emit_cuda.emit_fields_cuda(*args, et)  # the launcher is CUDA-only
    with pytest.raises(ValueError):
        E.emit_fields(*(t.to("meta") for t in args), et)
    with pytest.raises(ValueError):
        E.unpack_fields(out[5].numpy()[:-1], n_pos)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(tables):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    mt = model_tables(ModelParams(), torch.float64, dev)
    et = emit_tables(dev)
    rng = np.random.default_rng(4)
    counts2, qual_sum, mapq2, ref = random_pileup(rng, 4096)
    mapq2[100:104] = 2.0**24 + 4096  # past the exact range
    c2, qs, m2, r = as_torch(counts2, qual_sum, mapq2, ref, device=dev)
    k2 = call_genotypes_pileup(c2, qs, r, mt)[:4]
    n0 = emit_cuda.emit_fields_cuda.launches
    got = E.emit_fields(*k2, c2, m2, r, et)
    assert emit_cuda.emit_fields_cuda.launches == n0 + 1
    want = E.pack_fields(E.emit_fields_plain(*k2, c2, m2, r, et))
    torch.cuda.synchronize()
    g = E.unpack_fields(got.cpu().numpy(), len(ref))
    w = E.unpack_fields(want.cpu().numpy(), len(ref))
    ok = ~(g["risk"] | w["risk"])
    assert ok.sum() > 3500
    deep = g["covered"][100:104]
    assert g["risk"][100:104][deep].all() and w["risk"][100:104][deep].all()
    for name, a in g.items():
        b = w[name]
        if name == "fs_hi":
            np.testing.assert_allclose(a[ok], b[ok], rtol=1e-12, atol=1e-15)
        elif name != "risk":
            np.testing.assert_array_equal(
                a[ok].view(np.uint8), b[ok].view(np.uint8), err_msg=name
            )
