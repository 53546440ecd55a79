"""The device emit tier: per-position emit fields of the fused exact tier,
the plain PyTorch version of K3 (`csrc/emit.cu`), and the packed layout
both return.

Counterpart of `bs_call_tpu/ops/kernels/emit_device.py` (`emit_fields_dd`
:256, `_fisher_dd` :90, `_cg_codes` :495, `compact_emitted` :666,
`fused_emit_chunk` :692, and the position-sharded `_winner_codes` :558,
`_gt1_halo` :570, `sharded_fused_ll_emit` :581, `sharded_emit_fields`
:635). From the model's outputs and
the pileup's accumulators (K12's on the fused tier) it computes what the host emit prep (`bsc_emit.cpp`, with
the Fisher test of `bsc_stats.cpp`) computes per row: GQ phred, QD, FS,
the q20/qd2/fs60/mq40 filter bits, mac1, the GL values, the CG-status
code, het, plus MQ and the genotype codes. `call_block_soa` and
`output/vector_site.py:_splice_dev_prep` use the fields of every row not
flagged `risk`, and recompute flagged rows on the host.

Everything runs in f64, operation for operation as `bsc_emit.cpp:54-128`
and `bsc_stats.cpp:41-99`; the TPU version's df32 arithmetic, 2^-53-grid
emulation, dd log1p, log2 GL rebuild and het compaction have no
counterpart. What can still differ from the host is the libm (`exp`,
`log`, `lgamma`; CUDA's and torch's are within a few ulps of glibc's,
not equal to it) and FMA contraction on the host. A row is flagged
exactly where those can reach a quantization:

* MQ: exact below 2^24 (f32 division and f64 sqrt are correctly
  rounded); the device's exact mapq2 sum reaches the host's ordered f32 sum only
  below 2^24, so a covered row at or above 2^24 is flagged;
* GQ: the phred value within an error band of an integer, the band
  widening as 1 - z1 shrinks (an ulp of z1 near 1 is a large part of
  1 - z1), and z1 rounding to 1.0 from a non-zero exponent;
* FS: -fs*10 + 0.5 within 1e-9 of an integer, p within 1e-9 (relative)
  of the 1e-20 clamp, any lfact argument >= 256 (lgamma), a walk longer
  than FISHER_IMAX;
* GL: the winner's value (-log(1+off)/ln 10, recomputed with this libm
  as the host recomputes it with its own) when a relative move of
  GL_BAND changes its f32 cast or clamp; the other slots are K2's own
  doubles, the same the host holds, so their cast is exact;
* the first and last row, unless `ctx` gives the genotype codes just
  outside the chunk (their CG context), and ll ties (margin < 1e-9, which
  the host's oracle recomputes).
"""

from __future__ import annotations

import numpy as np
import torch

from bs_call_tpu_torch.constants import LOG10
from bs_call_tpu_torch.ops.emit_tables import EmitTables
from bs_call_tpu_torch.ops.kernels.emit_cuda import (
    LAYOUT,
    ROW_BYTES,
    emit_fields_cuda,
)
from bs_call_tpu_torch.parallel.sharding import gather, halo, shard_positions

FISHER_IMAX = 512  # steps of one Fisher tail walk; longer -> flagged
LFACT_N = 256  # the lfact table; larger arguments call lgamma -> flagged
MQ2_EXACT = float(1 << 24)  # mapq2 sums at or above are flagged
TIE_MARGIN = 1e-9  # _finish_exact's scalar oracle recomputes rows below
# error bands, each wider than the libm and FMA differences it covers
# phred moves by 10/ln10 * d(1-z1)/(1-z1). Two libms whose exp is within
# 1 ulp (CUDA's, torch's) and 0.51 ulp (glibc's) of the true value return
# values at most one ulp (2^-53 below 1.0) apart, and the exponent x,
# from log and two roundings on each side, moves z1 by at most 4|x|
# ulps: d(1-z1) <= (1 + 4|x|) 2^-53
GQ_BAND = 10.0 / LOG10 * 2.0**-53
FS_BAND = 1e-9  # on -fs*10 + 0.5 (walks <= 512 steps: ~1e-12 relative)
CLAMP_BAND = 1e-9  # relative, around p = 1e-20
GL_BAND = 8 * 2.0**-52  # relative, on the winner's GL value

_NP_DTYPE = {
    torch.float64: np.dtype(np.float64), torch.float32: np.dtype(np.float32),
    torch.int32: np.dtype(np.int32), torch.uint8: np.dtype(np.uint8),
    torch.bool: np.dtype(np.bool_),
}


def _near_int(y, band):
    f = y - torch.floor(y)
    return (f < band) | (f > 1.0 - band)


def _lfact(x, lfact):
    """log(x!) as the host computes it: the table below LFACT_N, lgamma
    above (bsc_stats.cpp:36-39). x int64."""
    small = lfact[x.clamp(0, LFACT_N - 1)]
    return torch.where(x < LFACT_N, small, torch.lgamma(x.double() + 1.0))


def _walk(l, p, u, v, w, z, steps):
    """The reference's multiplicative carry, per row for i < steps:
    l *= (u-i)(v-i) / ((w+i+1)(z+i+1)); p += l. The integer products are
    exact in int64 (bsc_stats.cpp:55); each f64 operation is its own op
    (no fused multiply-add)."""
    top = int(steps.max()) if steps.numel() else 0
    for i in range(top):
        live = i < steps
        r = ((u - i) * (v - i)).double() / ((w + i + 1) * (z + i + 1)).double()
        l = torch.where(live, l * r, l)
        p = torch.where(live, p + l, p)
    return p


def fisher_plain(ftab, lfact):
    """Two-sided Fisher exact test of [m,4] int tables, the reference
    walk of bsc_stats.cpp:41-99 (ops/oracle.py fisher) vectorised over
    rows: two exp calls, then the multiplicative carry, with a step loop
    up to the longest walk (bounded by FISHER_IMAX). Returns (log10 p
    [m] f64, with p clamped below at 1e-20 as bsc_stats.cpp:392-399, and
    risk [m] bool)."""
    a, b, c, d = (ftab[:, j].long() for j in range(4))
    row0, row1, col0, col1 = a + b, c + d, a + c, b + d
    n = row0 + row1

    def lf(x):
        return _lfact(x, lfact)

    delta = a.double() - (row0 * col0).double() / n.clamp(min=1).double()
    knst = lf(col0) + lf(col1) + lf(row0) + lf(row1) - lf(n)
    l0 = torch.exp(knst - lf(a) - lf(b) - lf(c) - lf(d))
    pos = delta > 0
    # first tail: delta > 0 walks a up (b, c down), else a down
    u, v, w, z = (torch.where(pos, x, y) for x, y in
                  ((b, a), (c, d), (a, b), (d, c)))
    steps1 = torch.minimum(u, v)
    p = _walk(l0, l0, u, v, w, z, steps1.clamp(max=FISHER_IMAX))
    # the mirrored tail, from k = ceil(2|delta|) steps the other way
    k = torch.where(pos, torch.ceil(2.0 * delta),
                    torch.ceil(-2.0 * delta).clamp(min=1)).long()
    mn2 = torch.where(pos, torch.minimum(a, d), torch.minimum(b, c))
    have2 = k <= mn2
    sgn = torch.where(pos, -1, 1)
    a2, b2, c2, d2 = (
        torch.where(have2, x + s * k, 0)
        for x, s in ((a, sgn), (b, -sgn), (c, -sgn), (d, sgn))
    )
    l2 = torch.exp(knst - lf(a2) - lf(b2) - lf(c2) - lf(d2))
    p = torch.where(have2, p + l2, p)
    u, v, w, z = (torch.where(pos, x, y) for x, y in
                  ((a2, b2), (d2, c2), (b2, a2), (c2, d2)))
    steps2 = torch.where(have2, mn2 - k, 0)
    p = _walk(l2, p, u, v, w, z, steps2.clamp(max=FISHER_IMAX))
    risk = (
        (steps1 > FISHER_IMAX) | (steps2 > FISHER_IMAX) | (n >= LFACT_N)
        | ((p - 1e-20).abs() <= 1e-20 * CLAMP_BAND)
    )
    p = torch.where(p < 1e-20, 1e-20, p)
    fs = torch.where(n > 0, torch.log(p) / LOG10, 0.0)
    return fs, risk & (n > 0)


def cg_codes(a2, a1, a3, mx, cflag, gflag):
    """The CG-status decision tree (print_vcf.c:227-266, bsc_emit.cpp:
    107-126) on 1-based genotype codes a1/a2/a3 (0 = uncalled) of the
    row's left neighbour, itself and its right neighbour. Returns
    (code [n] int64 as ASCII, cond_cg [n] bool)."""
    g1c = (a1 - 1).clamp(min=0)
    g3c = (a3 - 1).clamp(min=0)
    ccg = ((a2 == 5) & (a3 == 8)) | ((a2 == 8) & (a1 == 5))
    Q, H, N, G, D = (ord(ch) for ch in "?HNG.")
    code_a3 = torch.where(a3 > 0, torch.where(gflag[g3c], H, N), Q)
    code_a1 = torch.where(a1 > 0, torch.where(cflag[g1c], H, N), Q)
    code_g = torch.where(a1 > 0, torch.where(cflag[g1c], H, N), D)
    code = torch.where(
        ccg, G,
        torch.where(
            a2 == 5, code_a3,
            torch.where(
                a2 == 8, code_a1,
                torch.where(
                    cflag[mx], code_a3, torch.where(gflag[mx], code_g, D)
                ),
            ),
        ),
    )
    return code, ccg


def _gl_cast(v):
    """The host's GL value: clamp below at -99.999 in f64, then f32."""
    return v.clamp(min=-99.999).to(torch.float32)


def emit_fields_plain(gt_prob, max_gt, margin, off, counts2, mapq2_sum, ref,
                      tables: EmitTables, quirk: bool = True, ctx=None):
    """Plain version of K3. gt_prob [n,10] f64, max_gt [n], margin [n]
    f64, off [n] f64 (the model's outputs); counts2 [n,2,8], mapq2_sum
    [n] f32 (the pileup's); ref [n] (0..4, clipped). quirk: the
    reference's counts[0][6] in the GT genotype's Fisher table
    (call_genotypes.c:98). ctx: None, or int32 [2] on the same device, the
    1-based genotype codes just before and just after the chunk, -1 where
    unknown (`emit_cuda.emit_fields_cuda`). Returns a dict of [n] tensors
    (gl_vals [n,5]) named as LAYOUT. Every row's fields follow from its
    own inputs, its neighbours' codes and, at the ends, ctx, so a slab
    given its neighbours' codes gets the whole chunk's rows."""
    n = gt_prob.shape[0]
    c2 = counts2.long()
    counts = c2.sum(dim=1)
    n_all = counts.sum(dim=1)
    covered = n_all > 0
    mx = max_gt.long().clamp(0, 9)

    # MQ (aggregate_pileup: f32 division, f64 sqrt), exact below 2^24
    nf = torch.where(covered, n_all, 1).to(torch.float32)
    mq = torch.where(
        covered, (0.5 + torch.sqrt((mapq2_sum / nf).double())).long(), 0
    )
    risk = covered & (mapq2_sum >= MQ2_EXACT)

    # GQ (bsc_emit.cpp:59-65) from the host's winner rewrite
    # gp = -log(1 + off) / ln 10 (pipeline/engine.py:428)
    gp_w = -torch.log(1.0 + off) / LOG10
    x = gp_w * LOG10
    z1 = torch.exp(x)
    sat = z1 >= 1.0
    om = torch.where(sat, 1.0, 1.0 - z1)
    ph_f = -10.0 * torch.log(om) / LOG10
    ph = torch.where(sat, 255, ph_f.long().clamp(max=255))
    band = GQ_BAND * (1.0 + 4.0 * x.abs()) / om + 1e-11
    risk |= torch.where(
        sat, x != 0, _near_int(ph_f, band) & (ph_f < 256.0)
    )
    dp1 = counts[:, :4].sum(dim=1)
    qd = torch.where(dp1 > 0, ph // dp1.clamp(min=1), ph)

    # FS: Fisher strand test on het rows (call_genotypes.c:62-108)
    het = tables.het[mx] & covered
    ma, mb = tables.ftab_a[mx], tables.ftab_b[mx]
    f2 = (c2[:, 1] * ma).sum(dim=1)
    if quirk:
        f2 = torch.where(
            mx == 8, c2[:, 1, 2] + c2[:, 1, 4] + c2[:, 0, 6], f2
        )
    ftab = torch.stack([
        (c2[:, 0] * ma).sum(dim=1), (c2[:, 0] * mb).sum(dim=1), f2,
        (c2[:, 1] * mb).sum(dim=1),
    ], dim=1)
    hidx = torch.nonzero(het).reshape(-1)
    fs = torch.zeros(n, dtype=torch.float64, device=gt_prob.device)
    fs_risk = torch.zeros(n, dtype=torch.bool, device=gt_prob.device)
    if hidx.numel():
        fs_h, risk_h = fisher_plain(ftab[hidx], tables.lfact)
        fs[hidx] = fs_h
        fs_risk[hidx] = risk_h
    fs_q = -fs * 10.0 + 0.5
    fs_int = fs_q.long()
    risk |= het & (fs_risk | _near_int(fs_q, FS_BAND))

    flt = (
        (ph < 20).long() | ((qd < 2).long() << 1)
        | ((fs_int > 60).long() << 2) | ((mq < 40).long() << 3)
    )
    sa = (counts * tables.mac_a[mx]).sum(dim=1)
    sb = (counts * tables.mac_b[mx]).sum(dim=1)
    mac1 = (flt == 0) & tables.mac_valid[mx] & ((sa <= 1) | (sb <= 1))

    # GL (bsc_emit.cpp:92-106)
    r = ref.long().clamp(0, 4)
    key = mx * 5 + r
    gidx = tables.gl_idx[key]
    gl_len = tables.gl_len[key]
    safe = gidx.clamp(min=0)
    is_win = safe == mx[:, None]
    v = torch.where(is_win, gp_w[:, None], gt_prob.gather(1, safe))
    fixed = gidx == -2
    gl_vals = torch.where(fixed, -99.999, _gl_cast(v))
    e = v.abs() * GL_BAND
    moved = (_gl_cast(v - e) != gl_vals) | (_gl_cast(v + e) != gl_vals)
    risk |= (is_win & ~fixed & moved).any(dim=1)

    # genotype codes and the CG automaton over the rows' neighbours, ctx's
    # codes (0, uncalled, where unknown) past the chunk's ends
    gt1 = torch.where(covered, mx + 1, 0)
    ctx = gt1.new_full((2,), -1) if ctx is None else ctx.long().clamp(max=10)
    edge = ctx.clamp(min=0)
    a1 = torch.cat([edge[:1], gt1[:-1]])
    a3 = torch.cat([gt1[1:], edge[1:]])
    cg_code, cond_cg = cg_codes(gt1, a1, a3, mx, tables.cflag, tables.gflag)
    if n:
        risk[0] |= ctx[0] < 0
        risk[-1] |= ctx[1] < 0
    risk |= margin < TIE_MARGIN
    return {
        "fs_hi": fs, "gl_vals": gl_vals, "dp1": dp1, "mq": mq,
        "risk": risk, "covered": covered, "gt1": gt1, "max_gt": mx,
        "ref5": r, "phred": ph, "qd": qd, "fs_int": fs_int, "flt": flt,
        "mac1": mac1, "gl_len": gl_len, "cg_code": cg_code,
        "cond_cg": cond_cg, "het": het,
    }


def pack_fields(fields: dict):
    """The dict of `emit_fields_plain` as K3's packed byte buffer."""
    parts = [
        fields[name].to(dt).reshape(-1).contiguous().view(torch.uint8)
        for name, dt, _ in LAYOUT
    ]
    return torch.cat(parts)


def unpack_fields(buf, n: int, rows: int | None = None, start: int = 0):
    """Views of a packed buffer of n rows (K3's or `pack_fields`'), numpy
    views of a numpy buffer and tensor views of a tensor, each sliced to
    `rows` rows from row `start` (all n by default)."""
    is_tensor = isinstance(buf, torch.Tensor)
    nbytes = buf.numel() if is_tensor else buf.nbytes
    if buf.ndim != 1 or nbytes != n * ROW_BYTES:
        raise ValueError(f"packed buffer of {nbytes} bytes, {n} rows")
    end = n if rows is None else start + rows
    out = {}
    o = 0
    for name, dt, k in LAYOUT:
        size = n * k * dt.itemsize
        a = buf[o:o + size].view(dt if is_tensor else _NP_DTYPE[dt])
        out[name] = (a.reshape(n, k) if k > 1 else a)[start:end]
        o += size
    return out


def emit_fields(gt_prob, max_gt, margin, off, counts2, mapq2_sum, ref,
                tables: EmitTables, quirk: bool = True, ctx=None):
    """Packed emit fields (uint8 [n * ROW_BYTES]): a CPU tensor goes to
    the plain version, a CUDA tensor to K3."""
    kind = gt_prob.device.type
    if tables.device != gt_prob.device:
        raise ValueError(
            f"tensor on {gt_prob.device} but emit tables on {tables.device}"
        )
    if kind == "cpu":
        return pack_fields(emit_fields_plain(
            gt_prob, max_gt, margin, off, counts2, mapq2_sum, ref, tables,
            quirk, ctx,
        ))
    if kind == "cuda":
        return emit_fields_cuda(
            gt_prob, max_gt, margin, off, counts2, mapq2_sum, ref, tables,
            quirk, ctx,
        )
    raise ValueError(f"no emit kernel for device {gt_prob.device}")


def compact_emitted(packed, n: int, cap: int):
    """The covered rows of a packed buffer of n rows (K3's or
    `pack_fields`'), in position order, packed again into cap rows: what
    the host emits without --all-positions. Returns (n_emit int32 [],
    pos int32 [cap], packed uint8 [cap * ROW_BYTES]), rows past n_emit
    zero (`covered` false). n_emit > cap means the chunk overflowed: the
    rows past cap are dropped, never written, and the caller reruns the
    chunk. "Covered" is the buffer's own `covered` field. Each field's
    segment is gathered on its own (the buffer is struct of arrays): a
    cumsum and one scatter a field, in order on the tensor's device with
    no host round trip."""
    views = unpack_fields(packed, n)
    covered = views["covered"]
    dev = packed.device
    seq = torch.cumsum(covered, 0, dtype=torch.int32) - 1
    slot = torch.where(covered & (seq < cap), seq, cap).long()  # cap: dump
    pos = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    pos[slot] = torch.arange(n, dtype=torch.int32, device=dev)
    parts = []
    for name, _dt, _k in LAYOUT:
        v = views[name]
        buf = v.new_zeros((cap + 1, *v.shape[1:]))
        buf[slot] = v
        parts.append(buf[:cap].reshape(-1).view(torch.uint8))
    return covered.sum(dtype=torch.int32), pos[:cap], torch.cat(parts)


def fused_emit_chunk(rd, starts, ori, strand, mapq, ref, n_pos: int,
                     min_qual: int, tables, emit: EmitTables, cap: int,
                     quirk: bool = True):
    """The whole fused tier of a chunk: any read batch ->
    `pileup_device.prepare_batch` -> K12 (pileup and f64 model) -> K3
    (emit fields) -> `compact_emitted`, in order on the current stream
    with no host round trip (the plain versions for a CPU batch). tables
    are the f64 ModelTables: the JAX function's df32 model is real f64
    here. Returns `compact_emitted`'s (n_emit, pos, packed).

    The JAX function's `het_cap` has no counterpart: it sized the TPU
    program's compacted buffer of het rows for the Fisher walks, which
    K3's per-tile queue of het rows replaces (no het row is ever dropped
    or flagged for lack of room)."""
    from bs_call_tpu_torch.ops.kernels.pileup_device import fused_ll_emit

    *_out, packed = fused_ll_emit(rd, starts, ori, strand, mapq, ref, n_pos,
                                  min_qual, tables, emit, quirk)
    return compact_emitted(packed, n_pos, cap)


# ---- position sharding (`parallel/sharding.py`): a chunk's emit fields
# over slabs of whole tiles, one device each ----


def _winner_codes(max_gt, counts2):
    """1-based genotype codes as K3 derives them: max_gt clamped to a
    genotype, plus one, and 0 where the position has no reads. int32."""
    covered = counts2.reshape(counts2.shape[0], -1).sum(dim=1) > 0
    return torch.where(covered, max_gt.clamp(0, 9) + 1, 0).to(torch.int32)


def _ends(t):
    """The first and the last row of t."""
    return torch.cat([t[:1], t[-1:]])


def _gt1_halo(borders):
    """K3's ctx for each slab. borders: per slab, (max_gt, counts2) of its
    first and last rows, on its device. Returns per slab int32 [2] on its
    device: the code of the row before the slab (the last of the slab
    before) and of the row after it (the first of the slab after), -1 at
    the two ends of the chunk. Each code crosses as a one-row copy between
    devices, so K3 reads it without a host round trip."""
    codes = [_winner_codes(mx, c2) for mx, c2 in borders]
    return [torch.cat(pair) for pair in halo(codes, -1)]


def concat_packed(parts, device):
    """One packed buffer of the rows of several, in order, on `device`:
    parts = [(packed uint8 [n * ROW_BYTES], n)], each field's rows of
    every part one after the other (the buffer is struct of arrays)."""
    views = [unpack_fields(buf, n) for buf, n in parts]
    return torch.cat([
        gather([v[name] for v in views], device).reshape(-1).view(
            torch.uint8)
        for name, _dt, _k in LAYOUT
    ])


def sharded_emit_fields(devices, gt_prob, max_gt, margin, off, counts2,
                        mapq2_sum, ref, emit, quirk: bool = True):
    """`emit_fields` over the mesh: the chunk's inputs (any device) cut
    into slabs of whole tiles, K3 (its plain version on the CPU) on each
    slab's device with that device's tables (`emit`, one per device), the
    slab's border genotype codes handed to its neighbours as ctx. Returns
    the chunk's packed fields on the first device, bit for bit those of
    `emit_fields` on the whole chunk: only the chunk's own two ends stay
    flagged for their missing context."""
    parts = shard_positions(devices, gt_prob, max_gt, margin, off, counts2,
                            mapq2_sum, ref)
    ctx = _gt1_halo([(_ends(p[1]), _ends(p[4])) for p in parts])
    bufs = [emit_fields(*p, e, quirk, c)
            for p, e, c in zip(parts, emit, ctx)]
    return concat_packed([(b, p[0].shape[0]) for b, p in zip(bufs, parts)],
                         devices[0])


def sharded_fused_ll_emit(devices, rd, starts, ori, strand, mapq, ref,
                          n_pos: int, min_qual: int, tables, emit,
                          quirk: bool = True, tiles=None):
    """`pileup_device.fused_ll_emit` over the mesh. Not the TPU's design
    (reads data-parallel, a full-width partial pileup on each chip, a psum
    over ICI): each device takes a slab of whole tiles and only the rows
    its tiles name (`pileup_device.slab_pileup_model`), so no pileup is
    ever reduced across devices. Then K12 on every slab, each slab's
    border codes copied to its neighbours as ctx, and K3 on every slab.
    tables / emit: the f64 ModelTables and the EmitTables of each device.
    Returns (gt_prob, max_gt, margin, off_sum, quals_u8, packed) on the
    first device, bit for bit those of `fused_ll_emit` on one device,
    risk bits included: the pileup's sums are integers, and every other
    output is a per-position function of them and of the neighbours'
    codes."""
    from bs_call_tpu_torch.ops.kernels.pileup_device import (
        slab_pileup_model,
    )

    outs = slab_pileup_model(devices, rd, starts, ori, strand, mapq, ref,
                             n_pos, min_qual, tables, tiles)
    ctx = _gt1_halo([(_ends(o[4]), _ends(o[0])) for o in outs])
    bufs = [emit_fields(*o[3:7], o[0], o[2], o[8], e, quirk, c)
            for o, e, c in zip(outs, emit, ctx)]
    dev0 = devices[0]
    model = (gather([o[j] for o in outs], dev0) for j in (3, 4, 5, 6, 7))
    return (*model, concat_packed(
        [(b, o[4].shape[0]) for b, o in zip(bufs, outs)], dev0))
