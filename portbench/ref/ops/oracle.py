"""Scalar float64 oracle for the genotype model and Fisher test.

This module is the numerical ground truth for the framework: a direct,
unoptimized float64 transcription of the reference math
(genotype_model.c:23-246, stats_utils.c:25-91, call_genotypes.c:43-115).
The device kernels are validated against it in tests, and the runtime
uses it as the "rescue" path to recompute positions whose likelihoods lie
too close to an argmax decision boundary.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.ref.constants import LFACT_STORE_SIZE, LOG10, MAX_QUAL, lfact_store

_LFACT = lfact_store()

# lfact overflow uses lgamma (bs_call.h:335). CPython's math.lgamma is its
# own ulp-different algorithm, NOT the platform libm the C binary links —
# call libm directly so big-count Fisher tables stay bit-identical.
try:
    import ctypes as _ctypes

    _libm_lgamma = _ctypes.CDLL("libm.so.6").lgamma
    _libm_lgamma.restype = _ctypes.c_double
    _libm_lgamma.argtypes = [_ctypes.c_double]
except OSError:  # non-glibc platform: closest available
    _libm_lgamma = math.lgamma


def _lfact(x: int) -> float:
    if x < LFACT_STORE_SIZE:
        return float(_LFACT[x])
    return _libm_lgamma(float(x) + 1.0)


class QualProb:
    __slots__ = ("e", "k", "ln_k", "ln_k_half", "ln_k_one")

    def __init__(self, q: int):
        e = math.exp(-0.1 * q * LOG10)
        if e > 0.5:
            e = 0.5
        k = e / (3.0 - 4.0 * e)
        self.e = e
        self.k = k
        self.ln_k = math.log(k)
        self.ln_k_half = math.log(0.5 + k)
        self.ln_k_one = math.log(1.0 + k)


_QPROB = [QualProb(q) for q in range(MAX_QUAL + 1)]


def get_z(x1: float, x2: float, k1: float, k2: float, l: float, t: float):
    """Closed-form maximization over methylation proportion
    (genotype_model.c:23-42). Returns the 3 Z values for
    (w=1,p=1), (w=1,p=1/2), (w=1/2,p=1)."""
    lpt = l + t
    lmt = l - t
    d = (x1 + x2) * lmt
    out = []
    for a1, a2 in (
        (lpt + 2.0 * k2, 2.0 - lpt + 2.0 * k1),
        (2.0 + lpt + 4.0 * k2, 2.0 - lpt + 4.0 * k1),
        (lpt + 4.0 * k2, 2.0 - lpt + 4.0 * k1),
    ):
        sinm = (x1 * a1 - x2 * a2) / d
        sinm = min(1.0, max(-1.0, sinm))
        out.append(0.5 * (lmt * sinm + 2.0 - lpt))
    return out


def calc_gt_prob(
    counts, quals, ref_base: int, under_conv: float, over_conv: float, ref_bias: float
):
    """Float64 10-genotype log-likelihood model (genotype_model.c:44-246).

    counts: 8 ints (categories ACGT noninf, ACGT informative)
    quals:  8 ints (per-category average quality, 0..MAX_QUAL)
    ref_base: 0..4 (N,A,C,G,T)
    Returns (gt_prob log10-normalized [10], max_gt index).
    """
    qp = [_QPROB[int(q)] for q in quals]
    l = 1.0 - under_conv
    t = over_conv
    n = [float(c) for c in counts]
    ll = [0.0] * 10

    lrb = math.log(ref_bias)
    lrb1 = math.log(0.5 * (1.0 + ref_bias))
    if ref_base == 1:
        ll[0] = lrb
        ll[1] = ll[2] = ll[3] = lrb1
    elif ref_base == 2:
        ll[4] = lrb
        ll[1] = ll[5] = ll[6] = lrb1
    elif ref_base == 3:
        ll[7] = lrb
        ll[2] = ll[5] = ll[8] = lrb1
    elif ref_base == 4:
        ll[9] = lrb
        ll[3] = ll[6] = ll[8] = lrb1

    # Non-informative counts (genotype_model.c:109-164)
    noninf_spec = (
        (0, 0, (1, 2, 3), (4, 5, 6, 7, 8, 9)),  # A: hom AA; het AC AG AT
        (1, 4, (1, 5, 6), (0, 2, 3, 7, 8, 9)),  # C
        (2, 7, (2, 5, 8), (0, 1, 3, 4, 6, 9)),  # G
        (3, 9, (3, 6, 8), (0, 1, 2, 4, 5, 7)),  # T
    )
    for i, hom, hets, others in noninf_spec:
        if n[i]:
            ll[hom] += n[i] * qp[i].ln_k_one
            tz = n[i] * qp[i].ln_k_half
            for g in hets:
                ll[g] += tz
            tz = n[i] * qp[i].ln_k
            for g in others:
                ll[g] += tz

    Z = [-1.0] * 6
    if n[5] + n[7] > 0.0:
        Z[0:3] = get_z(n[5], n[7], qp[5].k, qp[7].k, l, t)
    if n[4] + n[6] > 0.0:
        Z[3:6] = get_z(n[6], n[4], qp[6].k, qp[4].k, l, t)

    # Informative counts (genotype_model.c:173-230)
    if n[4]:
        k4 = qp[4].k
        ll[0] += n[4] * qp[4].ln_k_one
        ll[2] += math.log(1.0 - 0.5 * Z[4] + k4) * n[4]
        ll[7] += math.log(1.0 - Z[3] + k4) * n[4]
        tz = math.log(0.5 * (1.0 - Z[5]) + k4) * n[4]
        ll[5] += tz
        ll[8] += tz
        tz = n[4] * qp[4].ln_k_half
        ll[1] += tz
        ll[3] += tz
        tz = n[4] * qp[4].ln_k
        ll[4] += tz
        ll[6] += tz
        ll[9] += tz
    if n[5]:
        k5 = qp[5].k
        ll[4] += math.log(Z[0] + k5) * n[5]
        tz = math.log(0.5 * Z[2] + k5) * n[5]
        ll[1] += tz
        ll[5] += tz
        ll[6] += math.log(0.5 * Z[1] + k5) * n[5]
        tz = n[5] * qp[5].ln_k
        for g in (0, 2, 3, 7, 8, 9):
            ll[g] += tz
    if n[6]:
        k6 = qp[6].k
        ll[7] += math.log(Z[3] + k6) * n[6]
        tz = math.log(0.5 * Z[5] + k6) * n[6]
        ll[5] += tz
        ll[8] += tz
        ll[2] += math.log(0.5 * Z[4] + k6) * n[6]
        tz = n[6] * qp[6].ln_k
        for g in (0, 1, 3, 4, 6, 9):
            ll[g] += tz
    if n[7]:
        k7 = qp[7].k
        ll[9] += n[7] * qp[7].ln_k_one
        ll[4] += math.log(1.0 - Z[0] + k7) * n[7]
        ll[6] += math.log(1.0 - 0.5 * Z[1] + k7) * n[7]
        tz = math.log(0.5 * (1.0 - Z[2]) + k7) * n[7]
        ll[1] += tz
        ll[5] += tz
        tz = n[7] * qp[7].ln_k_half
        ll[3] += tz
        ll[8] += tz
        tz = n[7] * qp[7].ln_k
        ll[0] += tz
        ll[2] += tz
        ll[7] += tz

    mx = 0
    mval = ll[0]
    for i in range(1, 10):
        if ll[i] > mval:
            mval = ll[i]
            mx = i
    s = 0.0
    for i in range(10):
        s += math.exp(ll[i] - mval)
    s = math.log(s)
    gt_prob = [(ll[i] - mval - s) / LOG10 for i in range(10)]
    return np.array(gt_prob, dtype=np.float64), mx


def fisher(c) -> float:
    """Two-sided Fisher exact test, reference algorithm
    (stats_utils.c:25-91). `c` is a 4-element 2x2 table [a,b,c,d];
    NOTE: the reference mutates its input mid-algorithm, reproduced here
    on a local copy."""
    c = [int(v) for v in c]
    row0 = c[0] + c[1]
    row1 = c[2] + c[3]
    col0 = c[0] + c[2]
    col1 = c[1] + c[3]
    n = row0 + row1
    if n == 0:
        return 1.0
    delta = float(c[0]) - float(row0 * col0) / float(n)
    knst = _lfact(col0) + _lfact(col1) + _lfact(row0) + _lfact(row1) - _lfact(n)
    l = math.exp(knst - _lfact(c[0]) - _lfact(c[1]) - _lfact(c[2]) - _lfact(c[3]))
    p = l
    if delta > 0.0:
        mn = min(c[1], c[2])
        for i in range(mn):
            l *= float((c[1] - i) * (c[2] - i)) / float((c[0] + i + 1) * (c[3] + i + 1))
            p += l
        mn = min(c[0], c[3])
        k = math.ceil(2.0 * delta)
        if k <= mn:
            c[0] -= k
            c[3] -= k
            c[1] += k
            c[2] += k
            l = math.exp(
                knst - _lfact(c[0]) - _lfact(c[1]) - _lfact(c[2]) - _lfact(c[3])
            )
            p += l
            for i in range(mn - k):
                l *= float((c[0] - i) * (c[3] - i)) / float(
                    (c[1] + i + 1) * (c[2] + i + 1)
                )
                p += l
    else:
        mn = min(c[0], c[3])
        for i in range(mn):
            l *= float((c[0] - i) * (c[3] - i)) / float((c[1] + i + 1) * (c[2] + i + 1))
            p += l
        mn = min(c[1], c[2])
        k = math.ceil(-2.0 * delta)
        if not k:
            k = 1
        if k <= mn:
            c[0] += k
            c[3] += k
            c[1] -= k
            c[2] -= k
            l = math.exp(
                knst - _lfact(c[0]) - _lfact(c[1]) - _lfact(c[2]) - _lfact(c[3])
            )
            p += l
            for i in range(mn - k):
                l *= float((c[1] - i) * (c[2] - i)) / float(
                    (c[0] + i + 1) * (c[3] + i + 1)
                )
                p += l
    return p
