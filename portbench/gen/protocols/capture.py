"""Targeted bisulfite capture: a directional paired-end WGBS library
whose fragments come mostly from planted targets, called over the
targets' BED with `-C`, as hybrid-capture methylation panels are.

Targets (`plant`): `targets_per_mb` a contig (at least one), so they
shrink with the slab; lengths log-normal around `target_median`
(`target_sigma`), clipped to [`target_min`, `target_max`], from the fixed
multiset; at least `target_gap_min` apart and `pad_bp + insert_max` from
a contig's ends; a target's bases drawn anew uniformly over ACGT
(CpG-island-like: GC 0.5, CpG not depleted), as targeted methylation
panels are built around CpG islands.

Fragments (`reads`): a target gets the fragments that give its padded
span [lo - `pad_bp`, hi + `pad_bp`) a depth of `target_coverage`; each
meets that span by a base at least, its start uniform over the starts
that do, so the depth is flat across the padded span and falls off over
one insert beyond it. Off-target fragments, `1 - on_target_share` of
all, start uniformly on the slab as WGBS fragments do. Both go through
`library.pair_records` at the library's other rates (read length,
inserts, duplicates, singletons, layouts, qualities, mapq)."""

import numpy as np

from portbench.gen import library


def plant(rng, seqs, lib):
    """(tid, lo, hi) of each target, 0-based, half-open, sorted; the
    targets' bases in `seqs` are redrawn."""
    pad, gap = lib["pad_bp"], lib["target_gap_min"]
    edge = pad + lib["insert_max"]
    out = []
    for t, s in enumerate(seqs):
        n = max(1, int(round(lib["targets_per_mb"] * len(s) / 1e6)))
        ln = np.clip(np.rint(library._fixed(lambda g: g.lognormal(
            np.log(lib["target_median"]), lib["target_sigma"], n), rng)),
            lib["target_min"], lib["target_max"]).astype(np.int64)
        slack = len(s) - 2 * edge - int(ln.sum()) - (n - 1) * gap
        if slack < 0:
            raise ValueError(f"{n} targets do not fit a contig of "
                             f"{len(s)} bp")
        # target i starts after the targets and gaps before it and a
        # sorted share of the slack
        cut = np.sort(rng.integers(0, slack + 1, n))
        lo = edge + cut + np.concatenate([[0], np.cumsum(ln[:-1] + gap)])
        hi = lo + ln
        bases = library.ACGT[rng.integers(0, 4, int(ln.sum()))]
        at = 0
        for a, b in zip(lo.tolist(), hi.tolist()):
            s[a:b] = bases[at:at + b - a]
            at += b - a
        out.append(np.stack([np.full(n, t), lo, hi], axis=1))
    return np.concatenate(out)


def reads(rng, sample, planted, lib, contig_bp):
    """Read specs (unsorted): on-target fragments, target by target, then
    off-target ones, contig by contig."""
    L = lib["read_length"]
    pad = lib["pad_bp"]
    t_tid, t_lo, t_hi = planted[:, 0], planted[:, 1], planted[:, 2]
    # a fragment of length f meets the padded span from
    # (hi - lo) + 2 pad + f - 1 starts, each read covering a position of
    # the span from as many starts as its length
    width = t_hi - t_lo + 2 * pad + lib["insert_mean"] - 1
    per_t = np.rint(lib["target_coverage"] * width / (2 * L)).astype(
        np.int64)
    n_on = int(per_t.sum())
    share = lib["on_target_share"]
    n_off = int(round(n_on * (1 - share) / share))
    total = sum(contig_bp)
    per_c = [int(round(n_off * bp / total)) for bp in contig_bp]
    tid = np.concatenate([np.repeat(t_tid, per_t),
                          np.repeat(np.arange(len(contig_bp)), per_c)])
    n_frag = len(tid)
    flen = library.insert_sizes(rng, lib, n_frag)
    u = rng.random(n_frag)
    first = np.repeat(t_lo - pad, per_t) - flen[:n_on] + 1
    past = np.repeat(t_hi + pad, per_t)
    f0_on = first + (u[:n_on] * (past - first)).astype(np.int64)
    bp = np.asarray(contig_bp)[tid[n_on:]]
    f0_off = (u[n_on:] * (bp - flen[n_on:])).astype(np.int64)
    return library.pair_records(rng, lib, tid, flen,
                                np.concatenate([f0_on, f0_off]))


def regions(planted):
    return [(int(t), int(lo), int(hi)) for t, lo, hi in planted.tolist()]
