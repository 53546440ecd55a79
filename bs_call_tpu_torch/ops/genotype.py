"""10-genotype bisulfite likelihood model: plain PyTorch version and the
dispatching entry points.

Counterpart of `bs_call_tpu.ops.genotype` (genotype_model.c:23-246,
call_genotypes.c:43-60). The plain functions below run on any device and
are what the CPU path and the tests use; `call_genotypes` and
`call_genotypes_pileup` send a CPU tensor to them and a CUDA tensor to the
hand-written kernel K2 (`ops/kernels/genotype_cuda.py`), and raise on any
other device. Nothing falls back from the kernel to the plain version.

dtype follows the tables: float64 is the exact tier (the H100 computes
f64 natively, so the TPU's double-float32 emulation is not ported),
float32 the `--no-exact` tier.
"""

from __future__ import annotations

import torch

from bs_call_tpu.constants import LOG10
from bs_call_tpu_torch.ops.kernels.genotype_cuda import (
    genotype_column,
    genotype_pileup,
)
from bs_call_tpu_torch.ops.params import ModelTables

NQ = 44  # MAX_QUAL + 1 quality rows in ModelTables.qual


def _get_z(x1, x2, k1, k2, l: float, t: float):
    """Closed-form maximisation over the methylation proportion
    (genotype_model.c:23-42) for the three (w, p) configurations."""
    lpt = l + t
    lmt = l - t
    d = (x1 + x2) * lmt
    d = torch.where(d == 0, torch.ones_like(d), d)
    zs = []
    for a1, a2 in (
        (lpt + 2.0 * k2, 2.0 - lpt + 2.0 * k1),
        (2.0 + lpt + 4.0 * k2, 2.0 - lpt + 4.0 * k1),
        (lpt + 4.0 * k2, 2.0 - lpt + 4.0 * k1),
    ):
        sinm = torch.clamp((x1 * a1 - x2 * a2) / d, -1.0, 1.0)
        zs.append(0.5 * (lmt * sinm + 2.0 - lpt))
    return zs


def genotype_log_likelihoods(counts, quals, ref, tables: ModelTables):
    """counts [N,8] (any numeric), quals [N,8] int, ref [N] int (0..4)
    -> ll [N,10] in tables.dtype (natural-log likelihoods incl. prior).
    Out-of-range quals and ref clamp to the table, as XLA's gather does."""
    dtype = tables.dtype
    n = counts.to(dtype)
    q = quals.long().clamp(0, NQ - 1)
    tab = tables.qual
    k, lnk, lnkh, lnk1 = (tab[:, c][q] for c in range(4))
    ll = tables.prior[ref.long().clamp(0, 4)]
    sel = tables.sel

    # non-informative categories (genotype_model.c:109-164)
    for i in range(4):
        coef = torch.where(
            sel[i] == 2,
            lnk1[:, i : i + 1],
            torch.where(sel[i] == 1, lnkh[:, i : i + 1], lnk[:, i : i + 1]),
        )
        ll = ll + torch.where(n[:, i : i + 1] > 0, n[:, i : i + 1] * coef, 0)

    # methylation-informative categories (genotype_model.c:165-230)
    l, t = tables.l, tables.t
    Z0, Z1, Z2 = _get_z(n[:, 5], n[:, 7], k[:, 5], k[:, 7], l, t)
    Z3, Z4, Z5 = _get_z(n[:, 6], n[:, 4], k[:, 6], k[:, 4], l, t)
    tiny = torch.finfo(dtype).tiny

    def lg(x):
        return torch.log(torch.clamp_min(x, tiny))

    def add(ni, cols):
        coef = torch.stack(cols, dim=-1)
        return torch.where(ni[:, None] > 0, ni[:, None] * coef, 0)

    k4, k5, k6, k7 = k[:, 4], k[:, 5], k[:, 6], k[:, 7]
    t58 = lg(0.5 * (1.0 - Z5) + k4)
    ll = ll + add(n[:, 4], [
        lnk1[:, 4], lnkh[:, 4], lg(1.0 - 0.5 * Z4 + k4), lnkh[:, 4],
        lnk[:, 4], t58, lnk[:, 4], lg(1.0 - Z3 + k4), t58, lnk[:, 4],
    ])
    t15 = lg(0.5 * Z2 + k5)
    ll = ll + add(n[:, 5], [
        lnk[:, 5], t15, lnk[:, 5], lnk[:, 5], lg(Z0 + k5), t15,
        lg(0.5 * Z1 + k5), lnk[:, 5], lnk[:, 5], lnk[:, 5],
    ])
    t58b = lg(0.5 * Z5 + k6)
    ll = ll + add(n[:, 6], [
        lnk[:, 6], lnk[:, 6], lg(0.5 * Z4 + k6), lnk[:, 6], lnk[:, 6],
        t58b, lnk[:, 6], lg(Z3 + k6), t58b, lnk[:, 6],
    ])
    t15b = lg(0.5 * (1.0 - Z2) + k7)
    ll = ll + add(n[:, 7], [
        lnk[:, 7], t15b, lnk[:, 7], lnkh[:, 7], lg(1.0 - Z0 + k7), t15b,
        lg(1.0 - 0.5 * Z1 + k7), lnk[:, 7], lnkh[:, 7], lnk1[:, 7],
    ])
    return ll


def finish_genotypes(ll):
    """ll [N,10] -> (gt_prob [N,10], max_gt [N] int32, margin [N],
    off_sum [N]) (genotype_model.c:231-245): first-maximum argmax, best
    minus runner-up, the off-max exponent sum kept apart from 1 so that
    1-p keeps its relative precision, and log10 posteriors."""
    mx = torch.argmax(ll, dim=-1)
    mval = ll.gather(1, mx[:, None])
    onehot = torch.nn.functional.one_hot(mx, 10).bool()
    margin = mval[:, 0] - ll.masked_fill(onehot, float("-inf")).amax(dim=-1)
    off_sum = torch.where(onehot, 0, torch.exp(ll - mval)).sum(dim=-1)
    gt_prob = (ll - mval - torch.log1p(off_sum)[:, None]) / LOG10
    return gt_prob, mx.to(torch.int32), margin, off_sum


def call_genotypes_plain(counts, quals, ref, tables: ModelTables):
    """Plain version of K2's column entry."""
    return finish_genotypes(
        genotype_log_likelihoods(counts, quals, ref, tables)
    )


def agg_quals_f32(counts, qual_sum):
    """Per-category rounded average quality with the reference's float32
    rule (call_genotypes.c:45-59): (int)floorf(0.5f + qual_sum /
    (float)count), 0 where count == 0. counts [N,8] int, qual_sum [N,8]
    float32 -> [N,8] int32."""
    live = counts > 0
    nn = counts.to(torch.float32)
    avg = qual_sum / torch.where(live, nn, 1.0)
    return torch.where(live, torch.floor(0.5 + avg), 0.0).to(torch.int32)


def call_genotypes_pileup_plain(counts2, qual_sum, ref, tables: ModelTables):
    """Plain version of K2's pileup entry: counts2 [N,2,8] int32 summed
    over orientation, quals by `agg_quals_f32`, then the model. Returns
    (gt_prob, max_gt, margin, off_sum, quals_u8 [N,8])."""
    counts = counts2.sum(dim=1)
    quals = agg_quals_f32(counts, qual_sum)
    return (
        *call_genotypes_plain(counts, quals, ref, tables),
        quals.to(torch.uint8),
    )


def _check_device(tables: ModelTables, *tensors):
    dev = tables.device
    for x in tensors:
        if x.device != dev:
            raise ValueError(
                f"tensor on {x.device} but model tables on {dev}"
            )
    return dev.type


def call_genotypes(counts, quals, ref, tables: ModelTables):
    """Column entry: counts/quals [N,8], ref [N] -> (gt_prob [N,10],
    max_gt [N] int32, margin [N], off_sum [N]) in tables.dtype."""
    kind = _check_device(tables, counts, quals, ref)
    if kind == "cpu":
        return call_genotypes_plain(counts, quals, ref, tables)
    if kind == "cuda":
        return genotype_column(counts, quals, ref, tables)
    raise ValueError(f"no genotype kernel for device {tables.device}")


def call_genotypes_pileup(counts2, qual_sum, ref, tables: ModelTables):
    """Pileup entry: counts2 [N,2,8] int32, qual_sum [N,8] float32, ref
    [N] -> (gt_prob, max_gt, margin, off_sum, quals_u8)."""
    kind = _check_device(tables, counts2, qual_sum, ref)
    if kind == "cpu":
        return call_genotypes_pileup_plain(counts2, qual_sum, ref, tables)
    if kind == "cuda":
        return genotype_pileup(counts2, qual_sum, ref, tables)
    raise ValueError(f"no genotype kernel for device {tables.device}")
