"""Per-record filtering and conversion to AlignDetails.

Behavioral contract: input_sam.c:222-312 (get_next_align_details). Produces
the same 13-reason filter classification, orientation rules, position
bookkeeping and 'mis-matched pair' handling as the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from portbench.ref import constants as C
from portbench.ref.io import bam as B
from portbench.ref.io.bam import BamRec, decode_bs_strand
from portbench.ref.pipeline.alignments import AlignDetails, Misms, MismsType


@dataclass
class RecResult:
    al: Optional[AlignDetails]
    filtered: int          # gt_filter_reason
    skip: bool             # record rejected (ret == 1 in the reference)
    reverse: bool
    align_length: int
    alignment_flag: int


def cigar_to_misms(rec: BamRec, al: AlignDetails, ix: int) -> int:
    """CIGAR decode (input_sam.c:90-136). Returns read length consumed
    (`align_length`). Stores events in the reference's swapped naming:
    CIGAR I -> DEL, CIGAR D -> INS. CIGAR P is treated like S (quirk),
    N/H are ignored."""
    position = 0
    reference_span = 0
    misms = []
    for length, op in rec.cigar:
        ch = B.CIGAR_OPS[op]
        if ch in "M=X":
            position += length
            reference_span += length
        elif ch in "SP":
            misms.append(Misms(MismsType.SOFT, position, length))
            position += length
        elif ch == "I":
            misms.append(Misms(MismsType.DEL, position, length))
            position += length
        elif ch == "D":
            misms.append(Misms(MismsType.INS, position, length))
            reference_span += length
    al.mismatches[ix] = misms
    al.reference_span[ix] = reference_span
    return position


def classify_record(
    rec: BamRec,
    al: AlignDetails,
    mapq_thresh: int,
    max_template_len: int,
    keep_unmatched: bool,
    ignore_duplicates: bool,
) -> RecResult:
    """Flag-based filtering + position/orientation bookkeeping
    (input_sam.c:226-306)."""
    filtered = C.FLT_NONE
    flag = rec.flag
    if (flag & B.FPAIRED) and not keep_unmatched:
        bad = flag & (
            B.FPROPER_PAIR
            | B.FUNMAP
            | B.FMUNMAP
            | B.FQCFAIL
            | B.FSECONDARY
            | B.FSUPPLEMENTARY
            | B.FDUP
        )
        if bad != B.FPROPER_PAIR:
            if flag & (B.FSECONDARY | B.FSUPPLEMENTARY):
                filtered = C.FLT_SECONDARY
            elif flag & B.FUNMAP:
                filtered = C.FLT_UNMAPPED
            elif flag & B.FMUNMAP:
                filtered = C.FLT_MATE_UNMAPPED
            elif flag & B.FQCFAIL:
                filtered = C.FLT_QC
            elif flag & B.FDUP:
                if not ignore_duplicates:
                    filtered = C.FLT_DUPLICATE
            else:
                filtered = C.FLT_NOT_CORRECTLY_ALIGNED
    else:
        if flag & (
            B.FUNMAP | B.FQCFAIL | B.FSECONDARY | B.FSUPPLEMENTARY | B.FDUP
        ):
            if flag & (B.FSECONDARY | B.FSUPPLEMENTARY):
                filtered = C.FLT_SECONDARY
            elif flag & B.FUNMAP:
                filtered = C.FLT_UNMAPPED
            elif flag & B.FQCFAIL:
                filtered = C.FLT_QC
            elif flag & B.FDUP:
                filtered = C.FLT_DUPLICATE

    # corrupt coordinates (< -1) would wrap to huge unsigned positions
    # and hold blocks open across the whole coordinate space (matches
    # the native classify)
    if not filtered and rec.pos < -1:
        filtered = C.FLT_NOPOS
    if not filtered and (flag & B.FPAIRED) and rec.mpos < -1:
        filtered = C.FLT_NOMATEPOS
    mis_matched = (flag & (B.FMUNMAP | B.FPROPER_PAIR)) != B.FPROPER_PAIR
    reverse = bool(flag & B.FREVERSE)
    second_read = bool(flag & B.FREAD2)
    al.orientation = (
        C.FORWARD
        if ((second_read and reverse) or not (second_read or reverse))
        else C.REVERSE
    )
    mult_seg = (flag & (B.FPAIRED | B.FMUNMAP)) == B.FPAIRED
    if reverse:
        al.forward_position = rec.mpos + 1
        al.reverse_position = rec.pos + 1
        al.mapq[1] = rec.mapq
    else:
        al.forward_position = rec.pos + 1
        al.reverse_position = rec.mpos + 1
        al.mapq[0] = rec.mapq
    if rec.mapq < mapq_thresh and not filtered:
        filtered = C.FLT_MAPQ
    alignment_flag = flag
    if mult_seg:
        if rec.tid != rec.mtid:
            if not filtered:
                filtered = C.FLT_MISMATCH_CHR
            if keep_unmatched:
                mis_matched = True
        if not filtered:
            if abs(rec.isize) > max_template_len:
                filtered = C.FLT_INSERT_SIZE
                if keep_unmatched:
                    mis_matched = True
        if (
            not filtered
            and not reverse
            and rec.mpos - rec.pos > max_template_len
        ):
            # field-consistency bound (matches native classify): a legal
            # pair with |isize| <= max_template_len cannot have its mate
            # further downstream than that; corrupt mpos would otherwise
            # grow the open block without limit
            filtered = C.FLT_INSERT_SIZE
            if keep_unmatched:
                mis_matched = True
        if reverse:
            if rec.pos < rec.mpos:
                if not filtered:
                    filtered = C.FLT_ORIENTATION
                if keep_unmatched:
                    mis_matched = True
            if mis_matched:
                al.forward_position = 0
        else:
            if rec.pos > rec.mpos:
                if not filtered:
                    filtered = C.FLT_ORIENTATION
                if keep_unmatched:
                    mis_matched = True
            if mis_matched:
                al.reverse_position = 0
    if not mult_seg or mis_matched:
        alignment_flag &= ~B.FPAIRED

    skip = False
    if filtered:
        if not (
            keep_unmatched
            and filtered
            in (C.FLT_INSERT_SIZE, C.FLT_MISMATCH_CHR, C.FLT_ORIENTATION)
        ):
            skip = True

    align_length = 0
    if not skip:
        ix = 1 if reverse else 0
        align_length = cigar_to_misms(rec, al, ix)
        if align_length != rec.l_qseq:
            # read-consuming CIGAR ops must cover the sequence exactly
            # (htslib invariant; matches the native classify) — corrupt
            # CIGARs would otherwise drive out-of-range trims
            return RecResult(
                al=al,
                filtered=filtered or C.FLT_NOT_CORRECTLY_ALIGNED,
                skip=True,
                reverse=reverse,
                align_length=0,
                alignment_flag=alignment_flag,
            )
        packed = getattr(rec, "packed", None)
        if packed is not None:  # native ingest precomputed these
            al.read[ix] = packed
            al.bs_strand = rec.bs_strand
        else:
            al.read[ix] = rec.packed_read()
            al.bs_strand = decode_bs_strand(rec.aux)
    return RecResult(
        al=al,
        filtered=filtered,
        skip=skip,
        reverse=reverse,
        align_length=align_length,
        alignment_flag=alignment_flag,
    )
