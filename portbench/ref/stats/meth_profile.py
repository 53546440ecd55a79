"""Non-CpG methylation read profile.

Behavioral contract: meth_profile.c:14-76 and the flt_tab construction
(init_param.c:57-68). For every read position (in original read
coordinates) counts 4 event classes over non-CpG C/G reference contexts:
    a = C->C on G2A / G->G on C2T (or either, non-converted)
    b = C->T on G2A / G->A on C2T
    c = C->C on C2T / G->G on G2A
    d = C->T on C2T / G->A on G2A
d/(c+d) estimates conversion+error, b/(a+b) estimates error alone.
"""

from __future__ import annotations

import numpy as np

from portbench.ref.constants import FLT_QUAL, MIN_QUAL

# rtab (meth_profile.c:14-23): bit 2 set for C followed by A/C/T,
# bit 3 set for G preceded by A/G/T. State = (prev_base << 3) | cur_base.
_RTAB = np.zeros(64, dtype=np.uint8)
for prev in range(5):
    for cur in range(5):
        st = (prev << 3) | cur
        if prev == 2 and cur in (1, 2, 4):  # C followed by A/C/T
            _RTAB[st] = 4
        elif cur == 3 and prev in (1, 3, 4):  # G preceded by A/G/T
            _RTAB[st] = 8


def build_flt_tab(min_qual: int = MIN_QUAL) -> np.ndarray:
    """768-entry strand/base byte -> event code table (init_param.c:57-68)."""
    tab = np.zeros(3 * 256, dtype=np.uint8)
    for q in range(min_qual, FLT_QUAL):
        x = q << 2
        tab[x : x + 4] = (11, 6, 10, 7)          # non-converted
        tab[256 + x : 256 + x + 4] = (11, 4, 10, 5)  # C2T
        tab[512 + x : 512 + x + 4] = (9, 6, 8, 7)    # G2A
    return tab


_FLT_TAB_CACHE = {}


def _flt_tab(min_qual: int) -> np.ndarray:
    if min_qual not in _FLT_TAB_CACHE:
        _FLT_TAB_CACHE[min_qual] = build_flt_tab(min_qual)
    return _FLT_TAB_CACHE[min_qual]


def meth_profile(al, x, orig_pos, max_pos, ref_window, stats, min_qual=MIN_QUAL):
    """Accumulate conversion-event counts into stats.meth_profile.

    al: normalized AlignDetails; x: block window start (1-based);
    ref_window: block reference codes (0..4) starting at position x."""
    stats.grow_meth_profile(max_pos + 1)
    mp = stats.meth_profile  # row index = orig read position + 1
    tab = _flt_tab(min_qual)
    for k in range(2):
        rd = al.read[k]
        if rd is None or len(rd) == 0:
            continue
        pos = al.reverse_position if k else al.forward_position
        btab = tab[256 * al.bs_strand : 256 * (al.bs_strand + 1)]
        op = orig_pos[k]
        ri = pos - x  # next ref index to consume
        if pos > x:
            state = ((int(ref_window[ri - 1]) << 3) | int(ref_window[ri])) & 63
            ri += 1
        else:
            state = 0
        mask = _RTAB[state]
        n_ref = len(ref_window)
        for j in range(len(rd)):
            xx = int(btab[int(rd[j])])
            mask1 = (xx & mask) >> 1
            if pos >= x:
                nxt = int(ref_window[ri]) if ri < n_ref else 0
                state = ((state << 3) | nxt) & 63
                ri += 1
            else:
                state = 0
            mask = _RTAB[state]
            inc = ((xx & mask) | mask1) >> 2 & 1
            row = int(op[j]) + 1
            if inc and row >= 0:
                mp[row, xx & 3] += 1
