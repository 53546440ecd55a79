"""In-memory alignment representation.

Host-side analogue of the reference's align_details (bs_call.h:64-73), but
holding numpy byte arrays. A read byte packs base and quality exactly like
the reference (input_sam.c:77-87): low 2 bits = base (A,C,G,T = 0..3),
high 6 bits = quality; N bases are stored as byte 0 (quality 0).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional

import numpy as np


class MismsType(IntEnum):
    """CIGAR-derived events, using the reference's (swapped) naming
    (input_sam.c:117-130): read insertions are stored as DEL, reference
    deletions as INS."""

    MISMS = 0
    INS = 1   # deletion from the reference (CIGAR D): consumes ref, not read
    DEL = 2   # insertion to the reference (CIGAR I): consumes read, not ref
    SOFT = 3


@dataclass
class Misms:
    misms_type: MismsType
    position: int  # read-coordinate offset
    size: int


@dataclass
class AlignDetails:
    """One template (read pair or single read).

    read[0] holds the forward-strand segment, read[1] the reverse-strand
    segment (input_sam.c:63). orientation captures R1/R2 layout
    (input_sam.c:259): FORWARD if (read2 and reverse) or (read1 and
    forward)."""

    forward_position: int = 0
    reverse_position: int = 0
    reference_span: List[int] = field(default_factory=lambda: [0, 0])
    read: List[Optional[np.ndarray]] = field(default_factory=lambda: [None, None])
    mismatches: List[List[Misms]] = field(default_factory=lambda: [[], []])
    mapq: List[int] = field(default_factory=lambda: [0, 0])
    orientation: int = 0  # FORWARD / REVERSE
    bs_strand: int = 0    # NON_CONVERTED / STRAND_C2T / STRAND_G2A


def get_al_qual(al: AlignDetails, reference_quirks: bool = True) -> int:
    """Mean read quality used for duplicate tie-breaks.

    The reference's get_al_qual (al_utils.c:19-35) indexes `sq[k]` with the
    segment index k instead of the base index j, so each segment contributes
    rl copies of the quality of base #k. We reproduce that behavior by
    default for output parity; reference_quirks=False computes the intended
    mean."""
    qual = 0
    n = 0
    for k in range(2):
        rd = al.read[k]
        if rd is None or len(rd) == 0:
            continue
        rl = len(rd)
        if reference_quirks:
            if k < rl:
                q = int(rd[k]) >> 2
                if q != 63:
                    qual += q * rl
                    n += rl
        else:
            qs = (rd >> 2).astype(np.int64)
            sel = qs != 63
            qual += int(qs[sel].sum())
            n += int(sel.sum())
    return qual // n if n > 0 else 0
