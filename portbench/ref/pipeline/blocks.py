"""Streaming block builder: the reference's producer loop re-imagined as a
generator.

Consumes a coordinate-sorted record stream and yields maximal runs of
overlapping templates ("blocks"), pairing mates by name and resolving
duplicates on the fly. Behavioral contract: get_template_vector.c:49-389
(read_input) — block-split rule, insert/backward-mate decision, duplicate
selection (mapq then mean read quality), keep-unmatched handling, and the
PairNotFound accounting.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

from portbench.ref import constants as C
from portbench.ref.config import CallerConfig
from portbench.ref.io.bam import FPAIRED
from portbench.ref.pipeline.alignments import AlignDetails, get_al_qual
from portbench.ref.pipeline.contigs import ContigTable
from portbench.ref.pipeline.reads import classify_record


@dataclass
class HashEntry:
    al: AlignDetails
    alignment_flag: int
    ix: int
    tag: str = ""


@dataclass
class Block:
    align_list: List[AlignDetails]
    ctg: object  # Contig
    y: int       # max_pos (one past the rightmost covered position)
    region: object = None  # Region the block's reads belong to (or None)


def region_filtered_records(records, table: ContigTable):
    """Restrict a sorted record stream to the -C regions (linear-scan
    equivalent of the reference's indexed region iteration,
    get_template_vector.c:69-101). Each record is assigned to the first
    region of its contig it overlaps; the contig's curr_reg is updated so
    the emitter's in-region check (print_vcf.c:156) applies. A record
    spanning two regions is returned once (the reference's two iterators
    would return it twice)."""
    regions_by_tid = {}
    for reg in table.regions:
        regions_by_tid.setdefault(reg.ctg.bam_tid, []).append(reg)
    for regs in regions_by_tid.values():
        regs.sort(key=lambda r: r.start)
    for rec in records:
        regs = regions_by_tid.get(rec.tid)
        if regs is None:
            continue
        start = rec.pos + 1
        end = rec.pos + sum(
            ln for ln, op in rec.cigar if op in (0, 2, 3, 7, 8)
        )
        if not rec.cigar:
            end = start
        for reg in regs:
            if start <= reg.stop and end >= reg.start:
                rec.region = reg
                yield rec
                break


def read_blocks(
    records, table: ContigTable, cfg: CallerConfig, stats=None,
    prefiltered: bool = False,
) -> Iterator[Block]:
    """Generator over pileup blocks from a sorted record iterator.
    prefiltered=True means region restriction already happened upstream
    (indexed iteration)."""
    if table.regions and not prefiltered:
        records = region_filtered_records(records, table)
    align_list: List[AlignDetails] = []
    al_hash_list: List[Optional[HashEntry]] = []
    hash_base: Dict[str, HashEntry] = {}
    curr_tid = -1
    old_tid = -1
    chr_skip = False
    max_pos = 0
    start_pos = 0
    curr_pos = 0
    start_idx = 0
    last_start = 0
    last_region = None
    block_region = None  # region of the first record in the current block

    def flush(tid: int) -> Optional[Block]:
        nonlocal align_list, al_hash_list
        hash_base.clear()
        if align_list:
            k = table.tid2id.get(tid, -1)
            assert k >= 0
            blk = Block(
                align_list=align_list,
                ctg=table.contigs[k],
                y=max_pos,
                region=block_region,
            )
            align_list = []
            al_hash_list = []
            return blk
        return None

    for rec in records:
        al = AlignDetails()
        res = classify_record(
            rec,
            al,
            cfg.mapq_thresh,
            cfg.max_template_len,
            cfg.keep_unmatched,
            cfg.ignore_duplicates,
        )
        if res.skip:
            if stats is not None:
                stats.filter_cts[res.filtered] += 1
                stats.filter_bases[res.filtered] += rec.l_qseq
            continue
        tag = rec.name
        reverse = res.reverse
        alignment_flag = res.alignment_flag

        new_block = False
        new_contig = False
        if curr_tid < 0 or curr_tid != rec.tid:
            new_contig = new_block = True
            chr_skip = False
            old_tid = curr_tid
            curr_tid = rec.tid
            k = table.tid2id.get(curr_tid, -1)
            if k < 0:
                chr_skip = True
            elif not table.regions:
                table.contigs[k].curr_reg = None

        insert = True
        if not (chr_skip or new_contig):
            if (
                (alignment_flag & FPAIRED)
                and al.forward_position > 0
                and al.reverse_position > 0
            ):
                if al.forward_position == al.reverse_position:
                    insert = tag not in hash_base
                elif reverse:
                    insert = al.forward_position > al.reverse_position
                else:
                    insert = al.forward_position < al.reverse_position
            if insert and start_pos > 0:
                if al.forward_position > 0:
                    if al.forward_position > max_pos and (
                        al.reverse_position > max_pos
                        or al.reverse_position == 0
                    ):
                        if al.forward_position - max_pos > 1:
                            new_block = True
                elif (
                    al.reverse_position > max_pos
                    and al.reverse_position - max_pos > 1
                ):
                    new_block = True

        if new_block:
            tid = old_tid if new_contig else curr_tid
            blk = flush(tid) if align_list else None
            hash_base.clear()
            curr_pos = 0
            start_idx = 0
            if blk is not None:
                yield blk
            if new_contig and old_tid >= 0:
                old_tid = -1
            max_pos = start_pos = 0
        if chr_skip:
            continue

        if not align_list:
            block_region = getattr(rec, "region", None)
        # update block extent
        if reverse:
            ml = al.reverse_position + al.reference_span[1]
            st = al.reverse_position
        else:
            ml = al.forward_position + al.reference_span[0]
            st = al.forward_position
        # sortedness enforcement (matches the native builder): a backward
        # jump within one contig+region is corrupt/unsorted input and
        # would otherwise build garbage blocks
        rec_region = getattr(rec, "region", None)
        if new_contig or rec_region is not last_region:
            last_start = 0
            last_region = rec_region
        if last_start and st < last_start:
            raise ValueError(
                "corrupt or unsorted alignment stream (input must be "
                "coordinate-sorted)"
            )
        last_start = st
        if ml > max_pos:
            max_pos = ml
        if start_pos == 0 or start_pos > st:
            start_pos = st

        if alignment_flag & FPAIRED:
            if not insert:
                # backward-facing mate: pair with the stored forward read
                thash = hash_base.get(tag)
                if thash is not None:
                    del hash_base[tag]
                    ix = 1 if reverse else 0
                    tal = thash.al
                    tal.read[ix], al.read[ix] = al.read[ix], tal.read[ix]
                    tal.mapq[ix] = al.mapq[ix]
                    tal.reference_span[ix] = al.reference_span[ix]
                    tal.mismatches[ix], al.mismatches[ix] = (
                        al.mismatches[ix],
                        tal.mismatches[ix],
                    )
                    al_hash_list[thash.ix] = None
                else:
                    if stats is not None:
                        stats.filter_cts[C.FLT_PAIR_NOT_FOUND] += 1
                        rd = al.read[1 if reverse else 0]
                        stats.filter_bases[C.FLT_PAIR_NOT_FOUND] += (
                            len(rd) if rd is not None else 0
                        )
                    al_skip = False
                    # likely mate removed as duplicate: skip if pair start is
                    # within the current block (get_template_vector.c:249-254)
                    if not cfg.keep_duplicates:
                        x = (
                            al.reverse_position
                            if reverse
                            else al.forward_position
                        )
                        if x >= start_pos:
                            al_skip = True
                    if not al_skip:
                        if cfg.keep_unmatched:
                            if al.forward_position > 0:
                                x = al.forward_position + res.align_length
                            else:
                                x = al.reverse_position + res.align_length
                            if x > max_pos:
                                max_pos = x
                            align_list.append(al)
                            al_hash_list.append(None)
                        # else: warning only (reference prints to stderr)
            else:
                # forward-facing: store for later mate pairing; dedup first
                al_skip = False
                if not cfg.keep_duplicates:
                    pos = (
                        al.forward_position
                        if al.forward_position > 0
                        else al.reverse_position
                    )
                    if pos == curr_pos:
                        for ix in range(start_idx, len(align_list)):
                            al1 = align_list[ix]
                            if (
                                al.forward_position == al1.forward_position
                                and al.reverse_position == al1.reverse_position
                                and al.bs_strand == al1.bs_strand
                            ):
                                q = cfg.reference_quirks
                                maxq = kn = 0
                                maxq1 = kn1 = 0
                                for s in range(2):
                                    if al.read[s] is not None and len(al.read[s]):
                                        maxq += al.mapq[s]
                                        kn += 1
                                    if al1.read[s] is not None and len(
                                        al1.read[s]
                                    ):
                                        maxq1 += al1.mapq[s]
                                        kn1 += 1
                                maxq //= max(kn, 1)
                                maxq1 //= max(kn1, 1)
                                if (maxq1 < maxq) or (
                                    maxq == maxq1
                                    and get_al_qual(al1, q) < get_al_qual(al, q)
                                ):
                                    thash = hash_base.get(tag)
                                    if thash is None:
                                        thash = al_hash_list[ix]
                                    else:
                                        assert al_hash_list[ix] is None
                                    align_list[ix] = al
                                    if thash is not None:
                                        hash_base.pop(thash.tag, None)
                                        thash.al = al
                                        thash.alignment_flag = alignment_flag
                                        thash.ix = ix
                                    else:
                                        thash = HashEntry(
                                            al, alignment_flag, ix
                                        )
                                    thash.tag = tag
                                    hash_base[tag] = thash
                                    al_hash_list[ix] = thash
                                    al = al1
                                if stats is not None:
                                    l1 = (
                                        len(al.read[0])
                                        if al.read[0] is not None
                                        else 0
                                    )
                                    l2 = (
                                        len(al.read[1])
                                        if al.read[1] is not None
                                        else 0
                                    )
                                    paired = l1 and l2
                                    stats.filter_cts[C.FLT_DUPLICATE] += (
                                        2 if paired else 1
                                    )
                                    stats.filter_bases[C.FLT_DUPLICATE] += (
                                        l1 + l2
                                    )
                                al_skip = True
                    else:
                        curr_pos = pos
                        start_idx = len(align_list)
                if not al_skip:
                    if tag in hash_base:
                        raise ValueError(f"duplicate sequence tag {tag}")
                    thash = HashEntry(al, alignment_flag, len(align_list), tag)
                    hash_base[tag] = thash
                    align_list.append(al)
                    al_hash_list.append(thash)
        else:
            # single (non-paired) reads
            al_skip = False
            if not cfg.keep_duplicates:
                pos = (
                    al.forward_position
                    if al.forward_position > 0
                    else al.reverse_position
                )
                if pos == curr_pos:
                    for ix in range(start_idx, len(align_list)):
                        al1 = align_list[ix]
                        thash = al_hash_list[ix]
                        if (
                            al.forward_position == al1.forward_position
                            and al.reverse_position == al1.reverse_position
                            and al.bs_strand == al1.bs_strand
                            and (
                                thash is None
                                or (thash.alignment_flag & 9) in (9, 0)
                            )
                        ):
                            q = cfg.reference_quirks
                            if (al1.mapq[0] < al.mapq[0]) or (
                                al1.mapq[0] == al.mapq[0]
                                and get_al_qual(al1, q) < get_al_qual(al, q)
                            ):
                                align_list[ix] = al
                                al = al1
                            if stats is not None:
                                stats.filter_cts[C.FLT_DUPLICATE] += 1
                                rd = al.read[1 if reverse else 0]
                                # reference adds discarded bases to class 0
                                stats.filter_bases[C.FLT_NONE] += (
                                    len(rd) if rd is not None else 0
                                )
                            al_skip = True
                else:
                    curr_pos = pos
                    start_idx = len(align_list)
            if not al_skip:
                align_list.append(al)
                al_hash_list.append(None)

    blk = flush(curr_tid) if align_list else None
    if blk is not None:
        yield blk
