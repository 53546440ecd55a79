"""What a pass's input asks of the pileup, counted from the generated
records and the configuration's flags, never from the program's padded
shapes or launch arguments.

A record is used when the caller keeps it by its flags: mapping quality
at or above `-q`, not marked duplicate (0x400), mapped with its mate
when paired. A fragment's bases are the union of its used records'
reference spans (mates overlap once; bs_call trims the overlap). A
position is covered when a used record spans it."""

from __future__ import annotations

import numpy as np

from portbench.gen.library import FDUP, FMUNMAP


def _flag_value(flags, name, default):
    return int(flags[flags.index(name) + 1]) if name in flags else default


def pileup_input(ds, cfg) -> dict:
    r = ds.reads
    mapq_min = _flag_value(cfg["flags"], "-q", 20)
    used = ((r["mapq"] >= mapq_min) & ((r["flag"] & FDUP) == 0)
            & ((r["flag"] & FMUNMAP) == 0))
    tid, lo, hi = r["tid"][used], r["pos"][used], r["end"][used]
    name = r["name"][used]
    # fragment spans: union of a fragment's records (one or two)
    order = np.lexsort((lo, name))
    tid, lo, hi, name = tid[order], lo[order], hi[order], name[order]
    first = np.ones(len(name), dtype=bool)
    first[1:] = name[1:] != name[:-1]
    frag = np.cumsum(first) - 1
    n_frag = int(frag[-1]) + 1 if len(frag) else 0
    f_lo = np.full(n_frag, np.iinfo(np.int64).max)
    f_hi = np.zeros(n_frag, dtype=np.int64)
    np.minimum.at(f_lo, frag, lo)
    np.maximum.at(f_hi, frag, hi)
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
