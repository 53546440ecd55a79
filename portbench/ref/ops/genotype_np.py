"""Vectorized float64 genotype model (NumPy).

Same math as `ops/genotype.py`'s plain version, in NumPy float64: the
host model of `--device numpy` under BS_CALL_PY_MODEL=1
(`ops/genotype_native.py`), and the reference the tests hold the native
model against. The port's copy of `bs_call_tpu.ops.genotype_np`.
"""

from __future__ import annotations

import numpy as np

from portbench.ref.constants import LOG10
from portbench.ref.ops.tables import NONINF_SEL, qual_tables, ref_prior_matrix

_QT = {np.float64: qual_tables(np.float64)}
_SEL = NONINF_SEL


def _get_z(x1, x2, k1, k2, l, t):
    lpt = l + t
    lmt = l - t
    d = (x1 + x2) * lmt
    d = np.where(d == 0, 1.0, d)
    out = []
    for a1, a2 in (
        (lpt + 2.0 * k2, 2.0 - lpt + 2.0 * k1),
        (2.0 + lpt + 4.0 * k2, 2.0 - lpt + 4.0 * k1),
        (lpt + 4.0 * k2, 2.0 - lpt + 4.0 * k1),
    ):
        sinm = np.clip((x1 * a1 - x2 * a2) / d, -1.0, 1.0)
        out.append(0.5 * (lmt * sinm + 2.0 - lpt))
    return out


def _safe_log(x):
    return np.log(np.maximum(x, np.finfo(x.dtype).tiny))


def genotype_ll_np(counts, quals, ref, under_conv, over_conv, ref_bias,
                   dtype=np.float64):
    """counts [N,8], quals [N,8], ref [N] -> ll [N,10] in `dtype`
    (float64; float32 for the control)."""
    if dtype not in _QT:
        _QT[dtype] = qual_tables(dtype)
    qt = _QT[dtype]
    n = np.asarray(counts, dtype=dtype)
    q = np.asarray(quals, dtype=np.int64)
    k = qt.k[q]
    lnk = qt.ln_k[q]
    lnkh = qt.ln_k_half[q]
    lnk1 = qt.ln_k_one[q]
    ll = ref_prior_matrix(ref_bias, dtype)[np.asarray(ref)]
    for i in range(4):
        coef = np.where(
            _SEL[i] == 2,
            lnk1[:, i : i + 1],
            np.where(_SEL[i] == 1, lnkh[:, i : i + 1], lnk[:, i : i + 1]),
        )
        ll = ll + np.where(n[:, i : i + 1] > 0, n[:, i : i + 1] * coef, 0)
    l = dtype(1.0 - under_conv)
    t = dtype(over_conv)
    Z0, Z1, Z2 = _get_z(n[:, 5], n[:, 7], k[:, 5], k[:, 7], l, t)
    Z3, Z4, Z5 = _get_z(n[:, 6], n[:, 4], k[:, 6], k[:, 4], l, t)
    lg = _safe_log

    def add(ni, cols):
        coef = np.stack(cols, axis=-1)
        return np.where(ni[:, None] > 0, ni[:, None] * coef, 0)

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


def call_genotypes_np(counts, quals, ref, under_conv, over_conv, ref_bias,
                      dtype=np.float64):
    """Returns (gt_prob [N,10] log10, max_gt [N], margin [N],
    off_sum [N]), in `dtype`."""
    ll = genotype_ll_np(counts, quals, ref, under_conv, over_conv, ref_bias,
                        dtype)
    mx = np.argmax(ll, axis=-1).astype(np.int32)
    mval = ll[np.arange(len(ll)), mx][:, None]
    onehot = np.zeros_like(ll, dtype=bool)
    onehot[np.arange(len(ll)), mx] = True
    masked = np.where(onehot, -np.inf, ll)
    margin = mval[:, 0] - masked.max(axis=-1)
    off_sum = np.where(onehot, 0.0, np.exp(ll - mval)).sum(axis=-1)
    gt_prob = (ll - mval - np.log1p(off_sum)[:, None]) / dtype(LOG10)
    return gt_prob, mx, margin, off_sum
