"""The one generator: a genome slab, a sample on it, and a bisulfite
library sequenced from it, all from `--seed` and a configuration's
parameters (`portbench/configs/<name>.json`). NumPy only.

A configuration's `library.protocol` names its module in
`portbench/gen/protocols/`, which places the fragments with the functions
here:

* `wgbs`: directional paired-end whole-genome bisulfite sequencing.
  Fragments start uniformly on the slab, inserts ~N(mean, sd); read 1
  comes from the original top (OT, `XB:A:C`, C->T) or bottom (OB,
  `XB:A:G`, G->A) strand; PCR duplicates are copies of a fragment,
  marked 0x400 as a duplicate-marking step leaves them
  (`pair_records`: fragments to records).
* `rrbs`: directional single-end reduced-representation sequencing.
  MspI sites (C^CGG) are planted around size-selected fragments; reads
  start at a fragment end, OT reads at its left end, OB reads (reverse)
  at its right end, trimmed to the fragment when it is shorter; the depth
  of each end is log-normal.

Methylation and conversion are drawn per molecule: a hash of (molecule,
genome position) decides whether a C is protected, so the two mates of
a fragment and its duplicates agree where they overlap. Sequencing
errors and qualities are drawn per read. Every seed asks the same work:
sizes (inserts, fragment lengths, depths) come from one fixed multiset
and the counts of each kind of read are fixed; the seed orders and
places them."""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_C, _G, _T, _A = (ord(c) for c in "CGTA")

# record layouts: 0 all matched, 1 soft clip left, 2 soft clip right,
# 3 deletion mid-read, 4 insertion mid-read
CLIP, DEL, INS = 6, 3, 2
FPAIRED, FPROPER, FMUNMAP, FREVERSE, FMREVERSE = 0x1, 0x2, 0x8, 0x10, 0x20
FREAD1, FREAD2, FDUP = 0x40, 0x80, 0x400


def cigar(kind: int, length: int):
    """(oplen, op) list of a layout (BAM op codes: M 0, I 1, D 2, S 4)."""
    m = length // 2
    return [
        [(length, 0)],
        [(CLIP, 4), (length - CLIP, 0)],
        [(length - CLIP, 0), (CLIP, 4)],
        [(m, 0), (DEL, 2), (length - m, 0)],
        [(m, 0), (INS, 1), (length - m - INS, 0)],
    ][kind]


def ref_span(kind, length):
    """Reference bases a read of this layout covers."""
    return length + np.choose(kind, [0, -CLIP, -CLIP, DEL, -INS])


def ref_offsets(kind: int, length: int) -> np.ndarray:
    """Reference offset of each read base from the record's position, -1
    where the base is clipped or inserted."""
    j = np.arange(length)
    m = length // 2
    if kind == 0:
        return j
    if kind == 1:
        return np.where(j < CLIP, -1, j - CLIP)
    if kind == 2:
        return np.where(j < length - CLIP, j, -1)
    if kind == 3:
        return np.where(j < m, j, j + DEL)
    return np.where(j < m, j, np.where(j < m + INS, -1, j - INS))


def _u01(key: np.ndarray) -> np.ndarray:
    """splitmix64 of uint64 keys -> uniform [0, 1)."""
    z = key.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


# the multisets every seed shares: sizes come from this fixed generator and
# the seed only orders them, so every seed asks the same work
_FIXED = 0x5EEDF1ED


def _fixed(draw, rng):
    """`draw(generator)` from the fixed generator, in the order of a
    permutation drawn from `rng`."""
    return rng.permutation(draw(np.random.default_rng(_FIXED)))


def _exact(rng, n, shares):
    """n labels: 1 + i for round(n * shares[i]) of them, 0 for the rest,
    in an order drawn from `rng`."""
    lab = np.zeros(n, dtype=np.int64)
    at = 0
    for i, sh in enumerate(shares):
        k = int(round(n * sh))
        lab[at:at + k] = i + 1
        at += k
    return rng.permutation(lab)


def make_genome(rng, g: dict):
    """Contig sequences (uint8 ASCII) of the slab: i.i.d. bases at the
    configured composition, CpG depleted as in a mammalian genome (a C
    of a CG becomes T with probability `cpg_depletion`)."""
    p = np.array([g["base_freq"][b] for b in "ACGT"], dtype=np.float64)
    seqs = []
    for _ in range(g["contigs"]):
        s = ACGT[rng.choice(4, size=g["contig_bp"], p=p / p.sum())]
        cg = np.nonzero((s[:-1] == _C) & (s[1:] == _G))[0]
        s[cg[rng.random(len(cg)) < g["cpg_depletion"]]] = _T
        seqs.append(s)
    return seqs


class Sample:
    """The sequenced sample on the slab: two haplotypes carrying SNVs
    (heterozygous or homozygous), and a methylation level per CpG."""

    def __init__(self, rng, seqs, s: dict):
        self.offsets = np.cumsum([0] + [len(x) for x in seqs])
        ref = np.concatenate(seqs)
        n = len(ref)
        n_snv = int(round(s["snv_per_bp"] * n))
        pos = np.sort(rng.choice(n, size=n_snv, replace=False))
        het = _exact(rng, n_snv, [s["het_share"]]) == 1
        idx = np.searchsorted(ACGT, ref[pos])
        # transitions (A<->G, C<->T) twice as often as each transversion
        ts = np.array([2, 3, 0, 1])[idx]
        tv = (idx + rng.integers(1, 4, n_snv)) % 4
        tv = np.where(tv == ts, (tv + 1) % 4, tv)
        tv = np.where(tv == idx, (tv + 1) % 4, tv)
        alt = ACGT[np.where(_exact(rng, n_snv, [s["transition_share"]]) == 1,
                            ts, tv)]
        hap0 = ref.copy()
        hap0[pos[~het]] = alt[~het]
        hap1 = hap0.copy()
        hap1[pos[het]] = alt[het]
        self.ref = ref
        self.haps = (hap0, hap1)
        self.snv_pos = pos
        # per-position level, read at the C of each CpG
        hi = rng.random(n) < s["cpg_high_share"]
        lev = np.where(hi, rng.beta(*s["cpg_high_beta"], n),
                       rng.beta(*s["cpg_low_beta"], n))
        self.level_c = lev
        self.level_g = np.roll(lev, 1)
        self.noncpg_meth = 1.0 - s["noncpg_conversion"]
        self.cpg = []
        for h in self.haps:
            c = np.zeros(n, dtype=bool)
            c[:-1] = (h[:-1] == _C) & (h[1:] == _G)
            self.cpg.append((c, np.roll(c, 1)))
        # both haplotypes end to end, and their CpG context (1: the C of
        # a CpG, 2: its G), for one gather a base
        self.hap_flat = np.concatenate(self.haps)
        self.cpg_flat = np.concatenate(
            [c.astype(np.uint8) | (g.astype(np.uint8) << 1)
             for c, g in self.cpg])


def wgbs_reads(rng, sample: Sample, lib: dict, contig_bp):
    """Read specs (dict of arrays, unsorted) of a paired-end WGBS
    library."""
    L = lib["read_length"]
    n_ctg = len(contig_bp)
    per = [int(round(lib["coverage"] * bp / (2 * L))) for bp in contig_bp]
    n_frag = sum(per)
    tid = np.repeat(np.arange(n_ctg), per)
    flen = insert_sizes(rng, lib, n_frag)
    bp = np.asarray(contig_bp)[tid]
    f0 = (rng.random(n_frag) * (bp - flen)).astype(np.int64)
    return pair_records(rng, lib, tid, flen, f0)


def insert_sizes(rng, lib: dict, n: int) -> np.ndarray:
    """`n` fragment lengths ~N(insert_mean, insert_sd) clipped to
    [insert_min, insert_max], from the fixed multiset in an order drawn
    from `rng`."""
    return np.clip(np.rint(_fixed(lambda g: g.normal(
        lib["insert_mean"], lib["insert_sd"], n), rng)),
        lib["insert_min"], lib["insert_max"]).astype(np.int64)


def pair_records(rng, lib: dict, tid, flen, f0):
    """Read specs (unsorted) of directional paired-end reads of
    `read_length` from fragments [f0, f0 + flen) on contigs `tid`: strand,
    haplotype, marked PCR duplicates, layouts (soft clips, indels),
    singletons and mapping qualities drawn at the library's rates."""
    L = lib["read_length"]
    n_frag = len(f0)
    ot = _exact(rng, n_frag, [0.5]) == 1
    hap = _exact(rng, n_frag, [0.5])
    mol = np.arange(n_frag, dtype=np.int64)
    # PCR duplicates: copies of fragments, the copy marked 0x400
    n_dup = int(round(lib["duplicate_share"] * n_frag))
    src = rng.choice(n_frag, size=n_dup, replace=False)
    dup = np.concatenate([np.zeros(n_frag, bool), np.ones(n_dup, bool)])
    tid, flen, f0, ot, hap, mol = (
        np.concatenate([a, a[src]]) for a in (tid, flen, f0, ot, hap, mol))
    nf = len(f0)
    f1 = f0 + flen

    def layout(soft_kind):
        lab = _exact(rng, nf, [lib["softclip_share"], lib["deletion_share"],
                               lib["insertion_share"]])
        return np.array([0, soft_kind, 3, 4])[lab]

    kf, kr = layout(1), layout(2)
    sf, sr = ref_span(kf, L), ref_span(kr, L)
    pos_f, pos_r = f0, f1 - sr
    # singletons: one mate mapped, the other not (0x8); which one is kept
    n_single = int(round(lib["singleton_share"] * nf))
    single = np.zeros(nf, dtype=bool)
    single[rng.choice(nf, size=n_single, replace=False)] = True
    keep_f = ~single | (_exact(rng, nf, [0.5]) == 1)
    keep_r = ~single | ~keep_f
    name = np.arange(nf, dtype=np.int64)
    ins = f1 - f0
    # flags: OT: read 1 forward, read 2 reverse; OB: the other way round
    base = np.where(single, FPAIRED | FMUNMAP, FPAIRED | FPROPER)
    flag_f = (base | np.where(single, 0, FMREVERSE)
              | np.where(ot, FREAD1, FREAD2) | np.where(dup, FDUP, 0))
    flag_r = (base | FREVERSE | np.where(ot, FREAD2, FREAD1)
              | np.where(dup, FDUP, 0))
    mq = _mapq(rng, 2 * nf, lib["mapq"])

    def part(keep, pos, kind, span, flag, mpos, tlen, mapq):
        s = np.nonzero(keep)[0]
        return dict(
            tid=tid[s], pos=pos[s], end=pos[s] + span[s],
            length=np.full(len(s), L), kind=kind[s],
            xb=np.where(ot[s], _C, _G), hap=hap[s], mol=mol[s],
            flag=flag[s], mapq=mapq[s], mtid=tid[s],
            mpos=np.where(single[s], pos[s], mpos[s]),
            tlen=np.where(single[s], 0, tlen[s]), name=name[s],
        )

    a = part(keep_f, pos_f, kf, sf, flag_f, pos_r, ins, mq[:nf])
    b = part(keep_r, pos_r, kr, sr, flag_r, pos_f, -ins, mq[nf:])
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def plant_rrbs(rng, seqs, lib: dict):
    """Plant MspI-bounded fragments in the slab; returns (tid, start, end)
    of each, 0-based, end exclusive. A fragment's interior is drawn
    uniformly over ACGT (CpG-rich, as RRBS's targets are) and flanked by
    C^CGG sites."""
    site = np.frombuffer(b"CCGG", dtype=np.uint8)
    out = []
    for t, s in enumerate(seqs):
        n = int(round(len(s) / lib["bp_per_fragment"]))
        slot = len(s) // n
        flen = _fixed(lambda g: g.integers(
            lib["fragment_min"], lib["fragment_max"] + 1, n), rng)
        st = (np.arange(n) * slot + 8
              + (rng.random(n) * (slot - flen - 16)).astype(np.int64))
        for a, ln in zip(st, flen):
            s[a:a + ln] = ACGT[rng.integers(0, 4, ln)]
            s[a - 1:a + 3] = site
            s[a + ln - 1:a + ln + 3] = site
        out.append(np.stack([np.full(n, t), st, st + flen], axis=1))
    return np.concatenate(out)


def rrbs_reads(rng, frags, lib: dict):
    """Read specs (unsorted) of a directional single-end RRBS library
    over `frags`."""
    L = lib["read_length"]
    nf = len(frags)
    med, sig, cap = lib["depth_median"], lib["depth_sigma"], lib["depth_max"]
    depth = np.clip(np.rint(np.exp(_fixed(
        lambda g: g.normal(np.log(med), sig, 2 * nf), rng))),
        1, cap).astype(np.int64)
    end_ix = np.repeat(np.arange(2 * nf), depth)
    n = len(end_ix)
    fr = frags[end_ix % nf]
    ot = end_ix < nf
    flen = fr[:, 2] - fr[:, 1]
    length = np.minimum(L, flen)
    kind = np.array([0, 3, 4])[_exact(
        rng, n, [lib["deletion_share"], lib["insertion_share"]])]
    kind[length < L] = 0
    span = ref_span(kind, length)
    pos = np.where(ot, fr[:, 1], fr[:, 2] - span)
    return dict(
        tid=fr[:, 0], pos=pos, end=pos + span, length=length, kind=kind,
        xb=np.where(ot, _C, _G), hap=_exact(rng, n, [0.5]),
        mol=np.arange(n, dtype=np.int64),
        flag=np.where(ot, 0, FREVERSE), mapq=_mapq(rng, n, lib["mapq"]),
        mtid=np.full(n, -1), mpos=np.full(n, -1), tlen=np.zeros(n),
        name=np.arange(n, dtype=np.int64),
    )


def _mapq(rng, n, m: dict):
    """MAPQ: `top`, but on a share of the reads uniform in [lo, hi] for
    each of the `ranges` ([lo, hi, share] each)."""
    out = np.full(n, m["top"], dtype=np.int64)
    lab = _exact(rng, n, [share for _lo, _hi, share in m["ranges"]])
    for i, (lo, hi, _share) in enumerate(m["ranges"]):
        sel = lab == i + 1
        out[sel] = rng.integers(lo, hi + 1, int(sel.sum()))
    return out


def sort_reads(r: dict) -> dict:
    """Coordinate order (tid, pos), stable."""
    order = np.lexsort((r["pos"], r["tid"]))
    return {k: np.asarray(v)[order] for k, v in r.items()}


def read_bases(rng, sample: Sample, r: dict, lib: dict, lo: int, hi: int):
    """(seq, qual) [hi - lo, Lmax] uint8 of reads lo..hi-1 of the sorted
    specs `r`: the haplotype's bases, bisulfite conversion per molecule,
    then sequencing errors drawn from the base qualities."""
    n = hi - lo
    lmax = int(r["length"][lo:hi].max()) if n else 0
    seq = np.zeros((n, lmax), dtype=np.uint8)
    gbase = (sample.offsets[r["tid"][lo:hi]] + r["pos"][lo:hi]).astype(
        np.int64)
    kind = r["kind"][lo:hi]
    length = r["length"][lo:hi]
    hap = r["hap"][lo:hi].astype(np.int64)
    key = r["mol"][lo:hi].astype(np.uint64) * np.uint64(0x100000001B3)
    top = r["xb"][lo:hi] == _C
    n_g = len(sample.ref)
    for k, ln in set(zip(kind.tolist(), length.tolist())):
        sel = np.nonzero((kind == k) & (length == ln))[0]
        off = ref_offsets(k, ln)
        # flat index into the two haplotypes laid end to end
        g = gbase[sel][:, None] + np.maximum(off, 0)[None, :]
        hg = g + (hap[sel] * n_g)[:, None]
        b = sample.hap_flat[hg]
        ctx = sample.cpg_flat[hg]
        t = np.broadcast_to(top[sel][:, None], b.shape)
        cand = np.nonzero((t & (b == _C)) | (~t & (b == _G)))
        gc = g[cand]
        is_top = t[cand]
        in_cpg = np.where(is_top, ctx[cand] & 1, ctx[cand] & 2) != 0
        keep = np.where(in_cpg,
                        np.where(is_top, sample.level_c[gc],
                                 sample.level_g[gc]),
                        sample.noncpg_meth)
        u = _u01(key[sel][cand[0]] ^ gc.astype(np.uint64))
        conv = u >= keep
        b[cand[0][conv], cand[1][conv]] = np.where(is_top[conv], _T, _A)
        extra = off < 0
        if extra.any():
            b[:, extra] = ACGT[rng.integers(0, 4, (len(sel), extra.sum()))]
        seq[sel, :ln] = b
    qv = np.array([q for q, _ in lib["base_quals"]], dtype=np.uint8)
    qp = np.array([p for _, p in lib["base_quals"]], dtype=np.float64)
    cum = np.cumsum(qp / qp.sum())[:-1].astype(np.float32)
    qi = np.searchsorted(cum, rng.random((n, lmax), dtype=np.float32),
                         side="right")
    qual = qv[qi]
    perr = (10.0 ** (-qv.astype(np.float64) / 10.0)).astype(np.float32)
    err = np.nonzero(rng.random((n, lmax), dtype=np.float32) < perr[qi])
    idx = np.searchsorted(ACGT, seq[err])
    seq[err] = ACGT[(idx + rng.integers(1, 4, len(idx))) % 4]
    short = np.arange(lmax)[None, :] >= length[:, None]
    seq[short] = 0
    qual[short] = 0
    return seq, qual
