"""Pileup tensorization.

Converts a block of normalized (indel-free, reference-coordinate) reads into
dense per-position accumulators:
    counts2   [sz, 2, 8] int32   orientation x strand/base category
    qual_sum  [sz, 8]    float32 per-category summed base quality
    mapq2_sum [sz]       float32 summed squared mapping quality

Reference semantics: call_genotypes.c:180-226. Accumulation order follows
the C loop (templates in list order, segment 0 then 1, positions ascending)
so the float32 sums are bit-identical.

The host path (build_pileup) produces a flat observation stream which is
also the input format for the device scatter-add kernel.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from portbench.ref.constants import BASE_TAB_ST, FLT_QUAL
from portbench.ref.pipeline.alignments import AlignDetails


def flatten_block(
    align_list: List[AlignDetails], x: int, y: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a block of templates into parallel observation arrays.

    Returns (pos_off, cat, qual, ori, mapq) — one entry per base observation
    that passes the leading/trailing mask trim (call_genotypes.c:196-213).
    pos_off is the position offset relative to x; entries beyond y are
    dropped (the C loop stops at pos > y)."""
    # gather per-(template, segment) metadata in C order, then process
    # the whole block in one vectorized pass (the per-read numpy version
    # of this loop was ~20us/read — block-level reduceat is ~10x less)
    reads, p0_l, ori_l_, st_l, mq_l_ = [], [], [], [], []
    for al in align_list:
        ori = al.orientation
        st = al.bs_strand
        for k in range(2):
            rd = al.read[k]
            if rd is not None and len(rd):
                reads.append(rd)
                p0_l.append(al.reverse_position if k else al.forward_position)
                ori_l_.append(ori)
                st_l.append(st)
                mq_l_.append(al.mapq[k])
            ori ^= 1
    if not reads:
        z = np.zeros(0, dtype=np.int32)
        return z, z, z, z, z
    lens = np.fromiter((len(r) for r in reads), dtype=np.int64,
                       count=len(reads))
    offs = np.zeros(len(reads), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    total = int(offs[-1] + lens[-1])
    big = np.concatenate(reads)
    q = (big >> 2).astype(np.int32)
    base = (big & 3).astype(np.int32)
    rid = np.repeat(np.arange(len(reads)), lens)
    j = np.arange(total, dtype=np.int64) - offs[rid]
    # leading/trailing mask trim per read (call_genotypes.c:196-213):
    # only bases between the first and last live (q>0, q!=FLT) survive;
    # interior masked bases stay in the stream (the caller's min-qual
    # filter drops them exactly as the C loop's qual check does)
    live = (q > 0) & (q != FLT_QUAL)
    jlive_lo = np.where(live, j, np.int64(1 << 60))
    jlive_hi = np.where(live, j, np.int64(-1))
    lo = np.minimum.reduceat(jlive_lo, offs)
    hi = np.maximum.reduceat(jlive_hi, offs)
    positions = np.asarray(p0_l, dtype=np.int64)[rid] + j
    keep = (j >= lo[rid]) & (j <= hi[rid]) & (positions <= y)
    st_arr = np.asarray(st_l, dtype=np.int32)[rid[keep]]
    return (
        (positions[keep] - x).astype(np.int32),
        BASE_TAB_ST[st_arr, base[keep]].astype(np.int32),
        q[keep],
        np.asarray(ori_l_, dtype=np.int32)[rid[keep]],
        np.asarray(mq_l_, dtype=np.int32)[rid[keep]],
    )


def build_pileup(
    align_list: List[AlignDetails], x: int, y: int, min_qual: int
):
    """Host scatter-add pileup for positions x..y inclusive."""
    sz = y - x + 1
    counts2 = np.zeros((sz, 2, 8), dtype=np.int32)
    qual_sum = np.zeros((sz, 8), dtype=np.float32)
    mapq2_sum = np.zeros(sz, dtype=np.float32)
    pos, cat, q, ori, mapq = flatten_block(align_list, x, y)
    sel = (q >= min_qual) & (q != FLT_QUAL)
    pos, cat, q, ori, mapq = pos[sel], cat[sel], q[sel], ori[sel], mapq[sel]
    np.add.at(counts2, (pos, ori, cat), 1)
    np.add.at(qual_sum, (pos, cat), q.astype(np.float32))
    np.add.at(mapq2_sum, pos, (mapq * mapq).astype(np.float32))
    return counts2, qual_sum, mapq2_sum
