"""Per-position pileup aggregation and Fisher-strand preparation.

Reference semantics: call_genotypes.c:43-115 (call_thread). The C code
accumulates per-category quality sums and mapq^2 in float32 and rounds with
float32 arithmetic; we reproduce exactly that so integer outputs (AMQ, MQ,
average quality) are bit-identical on any backend.
"""

from __future__ import annotations

import numpy as np

from portbench.ref.constants import GT_HET, LOG10
from portbench.ref.ops import oracle

# Fisher 2x2 table construction per heterozygous genotype
# (call_genotypes.c:63-104). Rows: genotype index; the table is built as
#   ftab[0] = sum counts[0][cats_a], ftab[1] = sum counts[0][cats_b]
#   ftab[2] = sum counts[1][cats_a], ftab[3] = sum counts[1][cats_b]
# EXCEPT genotype 8 (GT), where the reference has a quirk: ftab[2] uses
# counts[0][6] instead of counts[1][6] (call_genotypes.c:98). We reproduce
# output-parity by default and expose fix_reference_quirks to disable it.
_FTAB_CATS = {
    1: ((0, 4), (1, 5, 7)),        # AC
    2: ((0,), (2, 6)),             # AG
    3: ((0, 4), (3, 7)),           # AT
    5: ((1, 5, 7), (2, 4, 6)),     # CG
    6: ((1, 5), (3,)),             # CT
    8: ((2, 4, 6), (3, 7)),        # GT
}


def aggregate_pileup(counts2, qual_sum, mapq2_sum):
    """Aggregate raw pileup accumulators into per-position stats.

    counts2:   [N, 2, 8] int  (orientation-split category counts)
    qual_sum:  [N, 8] float32 (per-category summed base quality)
    mapq2_sum: [N] float32    (summed squared mapping quality)
    Returns dict with counts [N,8], quals [N,8], aq [N], mq [N], n [N].
    Matches call_genotypes.c:45-59 with float32 arithmetic.
    """
    counts2 = np.asarray(counts2)
    qual_sum = np.asarray(qual_sum, dtype=np.float32)
    mapq2_sum = np.asarray(mapq2_sum, dtype=np.float32)
    counts = counts2.sum(axis=1).astype(np.int64)  # [N, 8]
    n = counts.sum(axis=1).astype(np.int64)
    nn = counts.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        avg = qual_sum / np.where(nn > 0, nn, np.float32(1))  # f32 div as in C
    quals = np.where(counts > 0, np.floor(np.float32(0.5) + avg), 0).astype(
        np.int32
    )
    tot_qual = np.where(counts > 0, qual_sum, np.float32(0)).sum(
        axis=1, dtype=np.float32
    )
    nf = np.where(n > 0, n, 1).astype(np.float32)
    aq = np.where(n > 0, np.floor(np.float32(0.5) + tot_qual / nf), 0).astype(
        np.int32
    )
    # C: (int)(0.5 + sqrt(mapq2 / (float)n)) — division in f32, sqrt in f64
    mq = np.where(
        n > 0,
        (0.5 + np.sqrt((mapq2_sum / nf).astype(np.float64))).astype(np.int64),
        0,
    ).astype(np.int32)
    return {
        "counts": counts,
        "quals": quals.astype(np.int32),
        "aq": aq,
        "mq": mq,
        "n": n,
    }


# [10, 8] 0/1 masks of categories entering each het genotype's 2x2 table
_FTAB_MASK_A = np.zeros((10, 8), dtype=np.int64)
_FTAB_MASK_B = np.zeros((10, 8), dtype=np.int64)
for _g, (_ca, _cb) in _FTAB_CATS.items():
    _FTAB_MASK_A[_g, list(_ca)] = 1
    _FTAB_MASK_B[_g, list(_cb)] = 1

# mac1 minor-allele category sets per het genotype (print_vcf.c:192-212)
# — the single Python source of truth for the emitter's numpy fallback
# and the device emit kernel (bsc_emit.cpp's kMac is the C++ transcription
# of the same contract)
MAC_CATS = {
    1: ((1, 5, 7), (0, 4)),
    2: ((2, 6), (0,)),
    3: ((3, 7), (0, 4)),
    5: ((2, 6, 4), (1, 5, 7)),
    6: ((3,), (1, 5)),
    8: ((3, 7), (2, 6, 4)),
}
MAC_MASK_A = np.zeros((10, 8), dtype=np.int32)
MAC_MASK_B = np.zeros((10, 8), dtype=np.int32)
MAC_VALID = np.zeros(10, dtype=bool)
for _g, (_ca, _cb) in MAC_CATS.items():
    MAC_MASK_A[_g, list(_ca)] = 1
    MAC_MASK_B[_g, list(_cb)] = 1
    MAC_VALID[_g] = True


def fisher_tables(counts2, max_gt, fix_reference_quirks: bool = False):
    """Vectorized 2x2 table construction (call_genotypes.c:63-104):
    counts2 [N,2,8], max_gt [N] -> ftab [N,4] int64. Rows for
    non-heterozygous genotypes are zeros (no test)."""
    counts2 = np.asarray(counts2, dtype=np.int64)
    max_gt = np.asarray(max_gt)
    ma = _FTAB_MASK_A[max_gt]  # [N, 8]
    mb = _FTAB_MASK_B[max_gt]
    ftab = np.empty((len(max_gt), 4), dtype=np.int64)
    ftab[:, 0] = (counts2[:, 0] * ma).sum(axis=1)
    ftab[:, 1] = (counts2[:, 0] * mb).sum(axis=1)
    ftab[:, 2] = (counts2[:, 1] * ma).sum(axis=1)
    ftab[:, 3] = (counts2[:, 1] * mb).sum(axis=1)
    if not fix_reference_quirks:
        # call_genotypes.c:98 uses counts[0][6] in the reverse-strand row
        # of the GT genotype's table
        quirk = max_gt == 8
        if quirk.any():
            ftab[quirk, 2] = (
                counts2[quirk, 1, 2]
                + counts2[quirk, 1, 4]
                + counts2[quirk, 0, 6]
            )
    return ftab


def fisher_strand(counts2, max_gt, fix_reference_quirks: bool = False):
    """Phred-scaled Fisher strand-bias log10 p-value per position.

    counts2: [N, 2, 8]; max_gt: [N]. Only heterozygous calls get a test
    (call_genotypes.c:62-108); homozygous positions return 0.0. Table
    construction is vectorized; the diagonal-walk exact test runs in the
    scalar oracle."""
    counts2 = np.asarray(counts2)
    max_gt = np.asarray(max_gt)
    fs = np.zeros(len(max_gt), dtype=np.float64)
    het_idx = np.nonzero(GT_HET[max_gt])[0]
    if len(het_idx) == 0:
        return fs
    ftab = fisher_tables(
        counts2[het_idx], max_gt[het_idx], fix_reference_quirks
    )
    import math

    for j, i in enumerate(het_idx):
        z = oracle.fisher([int(v) for v in ftab[j]])
        if z < 1.0e-20:
            z = 1.0e-20
        # libm log, matching both the native kernel and the C binary
        fs[i] = math.log(z) / LOG10
    return fs


def phred_scores(gt_prob, max_gt):
    """GQ phred from the winning genotype posterior (print_vcf.c:140-148).

    phred = 255 if posterior >= 1 else min(255, int(-10*log10(1-p))).
    Vectorized with a scalar-libm rescue for rows near an integer
    boundary or p==1 saturation, where numpy's SIMD exp/log could
    round the last ulp differently from the C binary's libm."""
    import math

    gt_prob = np.asarray(gt_prob)
    max_gt = np.asarray(max_gt)
    n = len(max_gt)
    out = np.zeros(n, dtype=np.int32)
    if n == 0:
        return out
    z = gt_prob[np.arange(n), max_gt]
    z1 = np.exp(z * LOG10)
    with np.errstate(divide="ignore", invalid="ignore"):
        pf = -10.0 * np.log(1.0 - np.minimum(z1, 1.0 - 1e-300)) / LOG10
        out = np.where(
            z1 >= 1.0, 255, np.minimum(pf.astype(np.int64), 255)
        ).astype(np.int32)
        frac = pf - np.floor(pf)
    bnd = np.nonzero(
        (z1 < 1.0)
        & ((frac < 1e-9) | (frac > 1.0 - 1e-9) | (z1 > 1.0 - 1e-12))
    )[0]
    for i in bnd:
        z1i = math.exp(float(z[i]) * LOG10)
        if z1i >= 1.0:
            out[i] = 255
        else:
            p = int(-10.0 * math.log(1.0 - z1i) / LOG10)
            out[i] = 255 if p > 255 else p
    return out
