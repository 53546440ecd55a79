"""Template normalization: read-end trims, soft-clip removal, paired-end
overlap resolution and indel normalization.

Behavioral contracts:
  - trim_read:        read_utils.c:13-26 (quality masking, not deletion;
                      the reference's right-trim base-bit corruption is NOT
                      reproduced because masked base bits are never read
                      downstream)
  - trim_soft_clips:  al_utils.c:122-162
  - handle_overlap:   al_utils.c:164-318
  - indel normalize:  process_template.c:66-111
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from portbench.ref.constants import FLT_QUAL
from portbench.ref.pipeline.alignments import AlignDetails, Misms, MismsType


def trim_read(read: Optional[np.ndarray], left: int, right: int):
    """Mask the first `left` / last `right` bases with quality FLT_QUAL."""
    if read is None or len(read) == 0:
        return
    rl = len(read)
    for k in range(min(left, rl)):
        read[k] = (read[k] & 3) | (FLT_QUAL << 2)
    for k in range(min(right, rl)):
        read[rl - k - 1] = (read[rl - k - 1] & 3) | (FLT_QUAL << 2)


def trim_soft_clips(al: AlignDetails, stats=None) -> Tuple[List[int], List[int]]:
    """Remove soft-clipped extremities (bases deleted, mismatch positions
    shifted). Returns (trim_left[2], trim_right[2])."""
    trim_left = [0, 0]
    trim_right = [0, 0]
    for k in range(2):
        rd = al.read[k]
        if rd is None or len(rd) == 0:
            continue
        rl = len(rd)
        misms = al.mismatches[k]
        nclip = 0
        adj = 0
        kept: List[Misms] = []
        for z, m in enumerate(misms):
            if m.misms_type == MismsType.SOFT:
                if z and z != len(misms) - 1:
                    raise ValueError("Soft clip not at extremity of read")
                nclip += 1
                if m.position == 0:
                    if m.size >= rl:
                        raise ValueError("Illegal soft clip")
                    adj = m.size
                    if stats is not None:
                        stats.base_filter[2] += adj  # base_clip
                    al.read[k] = rd = rd[adj:]
                    trim_left[k] = adj
                else:
                    if m.position + m.size != rl:
                        raise ValueError("Illegal soft clip")
                    al.read[k] = rd = rd[: len(rd) - m.size]
                    trim_right[k] = m.size
                    if stats is not None:
                        stats.base_filter[2] += m.size
            else:
                if nclip:
                    m.position -= adj
                kept.append(m)
        al.mismatches[k] = kept
    return trim_left, trim_right


def _mean_qual(read: np.ndarray) -> int:
    q = (read >> 2).astype(np.int64)
    sel = q != FLT_QUAL
    n = int(sel.sum())
    return int(q[sel].sum()) // n if n else 0


def handle_overlap(
    al: AlignDetails, stats=None, trim_left=None, trim_right=None
):
    """Paired-end overlap resolution (al_utils.c:164-318): when the two
    segments overlap on the reference, trim the overlapping part from the
    segment with smaller reference span (ties broken by mean quality) so
    each fragment base is counted once. The trim walks the mismatch list to
    convert the reference-overlap length into read coordinates."""
    if trim_left is None:
        trim_left = [0, 0]
    if trim_right is None:
        trim_right = [0, 0]
    rdl = [
        len(al.read[0]) if al.read[0] is not None else 0,
        len(al.read[1]) if al.read[1] is not None else 0,
    ]
    if not (rdl[0] > 0 and rdl[1] > 0):
        return trim_left, trim_right
    if al.forward_position <= al.reverse_position:
        overlap = al.reference_span[0] - al.reverse_position + al.forward_position
        rev = False
    else:
        overlap = al.reference_span[1] + al.reverse_position - al.forward_position
        rev = True
    if al.forward_position + al.reference_span[0] < al.reverse_position:
        return trim_left, trim_right

    rspan = al.reference_span
    if rspan[0] > rspan[1]:
        tr = 1
    elif rspan[0] < rspan[1]:
        tr = 0
    else:
        tot0 = _mean_qual(al.read[0])
        tot1 = _mean_qual(al.read[1])
        tr = 0 if tot0 <= tot1 else 1

    # left-trim case adjusts the start position (al_utils.c:204-207)
    if rev != (tr == 1):
        if tr:
            al.reverse_position += overlap
        else:
            al.forward_position += overlap

    misms = al.mismatches[tr]
    right_trim_case = (rev and tr == 1) or not (rev or tr == 1)

    def right_trim(n):
        if n > 0:
            if n >= len(al.read[tr]):
                al.read[tr] = al.read[tr][:0]
            else:
                al.read[tr] = al.read[tr][: len(al.read[tr]) - n]

    def left_trim(n):
        if n > 0:
            if n >= len(al.read[tr]):
                al.read[tr] = al.read[tr][:0]
            else:
                al.read[tr] = al.read[tr][n:]

    if not misms:
        if right_trim_case:
            right_trim(overlap)
        else:
            left_trim(overlap)
    elif right_trim_case:
        # trim `overlap` reference bases off the right end, mapping through
        # indels (al_utils.c:218-246)
        xx = al.reference_span[tr] - overlap
        adj = 0
        trimmed = False
        for z, m in enumerate(misms):
            if m.position + adj >= xx:
                trim = rdl[tr] - xx + adj
                right_trim(trim)
                al.mismatches[tr] = misms[:z]
                trimmed = True
                break
            if m.misms_type == MismsType.INS:
                if m.position + adj + m.size >= xx:
                    trim = rdl[tr] - m.position
                    m.size = xx - (m.position + adj)
                    right_trim(trim)
                    al.mismatches[tr] = misms[: z + 1]
                    trimmed = True
                    # C keeps scanning? No: it sets trimmed and continues
                    # the loop, but adj += size then subsequent events have
                    # position+adj >= xx and hit the first branch with the
                    # list already truncated; in practice it breaks out via
                    # the first branch on the next event or ends. We break
                    # to keep a single truncation, matching the final state.
                    break
                adj += m.size
            elif m.misms_type == MismsType.DEL:
                adj -= m.size
        if not trimmed:
            right_trim(overlap)
    else:
        # trim `overlap` reference bases off the left end (al_utils.c:247-303)
        xx = overlap
        adj = 0
        trimmed = False
        for z, m in enumerate(misms):
            if m.position + adj >= xx:
                trim = xx - adj
                left_trim(trim)
                trimmed = True
                for m2 in misms[z:]:
                    m2.position -= trim
                al.mismatches[tr] = misms[z:]
                break
            if m.misms_type == MismsType.INS:
                if m.position + adj + m.size >= xx:
                    m.size = m.position + m.size + adj - xx
                    trim = m.position
                    left_trim(trim)
                    trimmed = True
                    z2 = z if m.size else z + 1
                    for m2 in misms[z2:]:
                        m2.position -= trim
                    al.mismatches[tr] = misms[z2:]
                    break
                adj += m.size
            elif m.misms_type == MismsType.DEL:
                adj -= m.size
        if not trimmed:
            left_trim(overlap - adj)
            al.mismatches[tr] = []

    rdl1 = [
        len(al.read[0]) if al.read[0] is not None else 0,
        len(al.read[1]) if al.read[1] is not None else 0,
    ]
    if stats is not None:
        stats.base_filter[3] += (rdl[0] - rdl1[0]) + (rdl[1] - rdl1[1])
    if right_trim_case:
        trim_right[tr] += rdl[tr] - rdl1[tr]
    else:
        trim_left[tr] += rdl[tr] - rdl1[tr]
    return trim_left, trim_right


def normalize_indels(
    al: AlignDetails, trim_left, trim_right
) -> Tuple[List[Optional[np.ndarray]], int]:
    """Rewrite each segment into reference coordinates: reference deletions
    (stored as INS) padded with N (byte 0), read insertions (stored as DEL)
    removed. Builds orig_pos arrays mapping each normalized base back to its
    original read position for the methylation profile
    (process_template.c:66-111). Returns (orig_pos[2], max_pos)."""
    orig_pos: List[Optional[np.ndarray]] = [None, None]
    max_pos = 0
    for k in range(2):
        rd = al.read[k]
        if rd is None:
            continue
        rl = len(rd)
        if k:
            posx = rl + trim_right[k] - 1
            orig = list(range(posx, posx - rl, -1))
            mpos = posx
        else:
            posx = trim_left[k]
            orig = list(range(posx, posx + rl))
            mpos = posx + rl
        if mpos > max_pos:
            max_pos = mpos
        sp = list(rd)
        adj = 0
        for m in al.mismatches[k]:
            ix1 = m.position + adj
            if m.misms_type == MismsType.INS:
                sp[ix1:ix1] = [0] * m.size
                orig[ix1:ix1] = [-1] * m.size
                adj += m.size
            elif m.misms_type == MismsType.DEL:
                del sp[ix1 : ix1 + m.size]
                del orig[ix1 : ix1 + m.size]
                adj -= m.size
        al.read[k] = np.array(sp, dtype=np.uint8)
        orig_pos[k] = np.array(orig, dtype=np.int32)
    return orig_pos, max_pos


def process_template(
    al: AlignDetails,
    left_trim=(0, 0),
    right_trim=(0, 0),
    stats=None,
    min_qual: int = 20,
):
    """Full per-template normalization (process_template.c:36-111).

    Returns (orig_pos, max_pos)."""
    msk = 0 if al.orientation == 0 else 1
    if left_trim[0] or right_trim[0]:
        trim_read(al.read[0 ^ msk], left_trim[0], right_trim[0])
    if left_trim[1] or right_trim[1]:
        trim_read(al.read[1 ^ msk], left_trim[1], right_trim[1])
    tl, tr_ = trim_soft_clips(al, stats)
    handle_overlap(al, stats, tl, tr_)
    if stats is not None:
        for k in range(2):
            rd = al.read[k]
            if rd is None:
                continue
            q = (rd >> 2).astype(np.int64)
            stats.base_filter[1] += int((q == FLT_QUAL).sum())
            stats.base_filter[4] += int(((q != FLT_QUAL) & (q < min_qual)).sum())
            stats.base_filter[0] += int(((q != FLT_QUAL) & (q >= min_qual)).sum())
            stats.filter_cts[0] += 1
            stats.filter_bases[0] += len(rd)
    return normalize_indels(al, tl, tr_)
