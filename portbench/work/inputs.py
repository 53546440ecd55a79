"""What a pass's input asks of the pileup, counted from the generated
records and the configuration's flags, never from the program's padded
shapes or launch arguments.

A record is used when the caller keeps it by its flags: mapping quality
at or above `-q`, not marked duplicate (0x400), mapped with its mate
when paired. A fragment's bases are the union of its used records'
reference spans (mates overlap once; bs_call trims the overlap). A
position is covered when a used record spans it.

With `-C` regions (the dataset's `regions`) the job reads only the
records that meet a region, by the BAM index, and pairs them as the
reference's block builder does: a pair both of whose used records meet a
region is whole; of a pair with one used record meeting a region, the
forward-facing record (it starts before its mate, or at its mate's start
and first in the file) is piled alone, and the backward-facing one is
dropped as unpaired, unless it is the first record the job reads on its
contig, which the builder takes as forward-facing; a single-end record
is piled. A kept record is piled over its whole span, also where it
reaches past a region's edge, and the model runs at every covered
position of the block, not only the region's (the emitter alone keeps to
the region): those positions and bases are counted, and no other. A
block wider than a chunk (the builder holds a block open across a gap
when a dropped mate's span reaches past it, so blocks chain regions)
goes to the column tier's K2, not to K12 and K3: the count does not
split the tiers. Regions are taken to lie further apart than the longest
fragment, as the generator plants them, so no fragment meets two.
Neither count models bs_call's removal of unmarked pairs that share both
ends and the strand (a few pairs a pass)."""

from __future__ import annotations

import numpy as np

from portbench.gen.library import FDUP, FMUNMAP, FPAIRED


def _flag_value(flags, name, default):
    return int(flags[flags.index(name) + 1]) if name in flags else default


def used_records(r: dict, flags) -> np.ndarray:
    """The records the caller keeps by their flags, with the job's flags
    (`-q`) in `flags`."""
    mapq_min = _flag_value(flags, "-q", 20)
    return ((r["mapq"] >= mapq_min) & ((r["flag"] & FDUP) == 0)
            & ((r["flag"] & FMUNMAP) == 0))


def meets_regions(r: dict, regions) -> np.ndarray:
    """The records whose span meets one of `regions` ([(tid, lo, hi)],
    0-based, half-open, sorted, not overlapping): those the job reads."""
    meets = np.zeros(len(r["pos"]), dtype=bool)
    for t in {t for t, _lo, _hi in regions}:
        lo = np.array([a for u, a, _b in regions if u == t])
        hi = np.array([b for u, _a, b in regions if u == t])
        sel = np.nonzero(r["tid"] == t)[0]
        # the first region ending past the record's start
        i = np.searchsorted(hi, r["pos"][sel], side="right")
        ok = i < len(lo)
        meets[sel[ok]] = lo[i[ok]] < r["end"][sel[ok]]
    return meets


def piled_in_regions(r: dict, used: np.ndarray, regions) -> np.ndarray:
    """The used records the job piles up when it calls `regions`."""
    fetched = used & meets_regions(r, regions)
    paired = fetched & ((r["flag"] & FPAIRED) != 0)
    idx = np.nonzero(paired)[0]
    order = idx[np.argsort(r["name"][idx], kind="stable")]
    name = r["name"][order]
    both = np.zeros(len(order), dtype=bool)
    both[1:] = name[1:] == name[:-1]
    both[:-1] |= name[:-1] == name[1:]
    pos, mpos = r["pos"][order], r["mpos"][order]
    # a pair's records are in file order here (a stable sort of indices)
    ahead = np.ones(len(order), dtype=bool)
    ahead[1:] = name[1:] != name[:-1]
    forward = (pos < mpos) | ((pos == mpos) & ahead)
    keep = fetched.copy()
    keep[order[~both & ~forward]] = False
    # the builder takes a contig's first record as forward-facing
    at = np.nonzero(fetched)[0]
    keep[at[np.unique(r["tid"][at], return_index=True)[1]]] = True
    return keep


def pileup_input(ds, cfg) -> dict:
    r = ds.reads
    used = used_records(r, cfg["flags"])
    regions = getattr(ds, "regions", None)
    if regions:
        used = piled_in_regions(r, used, regions)
    tid, lo, hi = r["tid"][used], r["pos"][used], r["end"][used]
    name = r["name"][used]
    # a fragment's records (one or two) side by side
    order = np.lexsort((lo, name))
    tid, lo, hi, name = tid[order], lo[order], hi[order], name[order]
    first = np.ones(len(name), dtype=bool)
    first[1:] = name[1:] != name[:-1]
    frag = np.cumsum(first) - 1
    n_frag = int(frag[-1]) + 1 if len(frag) else 0
    span = hi - lo
    # bases: each record's span, less the overlap with its mate's
    ov = np.zeros(n_frag, dtype=np.int64)
    two = np.bincount(frag, minlength=n_frag) == 2
    if two.any():
        firsts = np.nonzero(first)[0]
        a = firsts[two]
        ov[two] = np.maximum(0, np.minimum(hi[a], hi[a + 1])
                             - np.maximum(lo[a], lo[a + 1]))
    bases = int(span.sum() - ov.sum())
    covered = 0
    for t, ln in enumerate(ds.lengths):
        sel = tid == t
        d = np.zeros(ln + 1, dtype=np.int64)
        np.add.at(d, lo[sel], 1)
        np.add.at(d, hi[sel], -1)
        covered += int((np.cumsum(d)[:ln] > 0).sum())
    return {"records_used": int(used.sum()), "bases": bases,
            "covered": covered}
