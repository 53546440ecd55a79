"""What decides `correct`: the BCF records and JSON report a timed pass
wrote, held against the plain reference (`portbench/ref/caller.py`) run on
the same generated records.

The reference runs on every record of the pass (`windows` 0 in the
configuration's `check`), or, where that would take longer than the
window, on the fragments that touch a sample of windows drawn from the
seed: every record whose span meets a window widened by `reach_bp` (the
longest insert) either way, and its mate. Every fragment that covers a
window then has both mates in one block of the reference's run, as in
the program's, so every position of the window sees the same reads on
both sides; records `margin_bp` or more inside a window are compared (a
record reads its neighbours' calls two positions either way). The report
is a sum over the whole pass, so it is compared only where the reference
ran on every record.

Where the job calls regions (`-C`, the dataset's `regions`), the windows
are drawn over the regions, and only positions inside both a window and
a region are compared: the job emits nothing outside its regions, and
every record it emits there counts as a differing site. The reference
also gets the fragment of the first record the job keeps on each contig:
the block builder takes a contig's first record as forward-facing, so a
backward-facing mate at a region's edge is piled alone there and dropped
anywhere else, and the reference has to meet the contig's first record
where the job does.

Numbers compared, each an exact count with the limit 0:
* `sites_differ`: compared positions whose BCF record differs in any
  byte (CHROM, POS, ID, REF/ALT, QUAL, FILTER, INFO: DP, MQ, CX, ...,
  FORMAT: GT, GL, GQ, DP, MC8, AMQ, CS, CG, CX, FT, QD, FS), or that one
  side has and the other has not, and the job's records outside every
  region;
* `report_differ`: lines of the JSON report that differ, the date line
  left out."""

from __future__ import annotations

import bisect
import struct
import zlib

import numpy as np

from portbench.ref.caller import run_reference
from portbench.ref.io.bam import BamHeader, BamRec
from portbench.gen import library
from portbench.work.inputs import meets_regions, used_records

_CODE = np.zeros(256, dtype=np.uint8)
for _c, _v in zip(b"ACGT", (1, 2, 3, 4)):
    _CODE[_c] = _v


def bgzf_decompress(raw: bytes) -> bytes:
    """The payload of a BGZF stream, block by block (`gzip.decompress`
    copies the rest of the stream at every member: quadratic here)."""
    out = []
    view = memoryview(raw)
    off, n = 0, len(raw)
    while off < n:
        (bsize,) = struct.unpack_from("<H", raw, off + 16)
        out.append(zlib.decompress(view[off + 18:off + bsize - 7], -15))
        off += bsize + 1
    return b"".join(out)


def bcf_records(raw: bytes, keep=None) -> dict:
    """{(chrom id, 0-based pos): record bytes} of a BCF stream (BGZF or
    uncompressed), of every record or of those inside `keep` ([(chrom id,
    lo, hi)], half-open)."""
    if raw[:2] == b"\x1f\x8b":
        raw = bgzf_decompress(raw)
    if raw[:5] != b"BCF\x02\x02":
        raise ValueError("not a BCF 2.2 stream")
    (lt,) = struct.unpack_from("<I", raw, 5)
    off = 9 + lt
    out = {}
    n = len(raw)
    starts, ends = {}, {}
    for c, lo, hi in sorted(keep or ()):
        if starts.get(c) and lo <= ends[c][-1]:
            ends[c][-1] = max(ends[c][-1], hi)
        else:
            starts.setdefault(c, []).append(lo)
            ends.setdefault(c, []).append(hi)
    unpack = struct.Struct("<IIii").unpack_from
    while off < n:
        ls, li, chrom, pos = unpack(raw, off)
        if keep is None:
            out[(chrom, pos)] = raw[off:off + 8 + ls + li]
        else:
            st = starts.get(chrom)
            if st:
                i = bisect.bisect_right(st, pos) - 1
                if i >= 0 and pos < ends[chrom][i]:
                    out[(chrom, pos)] = raw[off:off + 8 + ls + li]
        off += 8 + ls + li
    return out


def to_records(ds, idx) -> list:
    """The reference's `BamRec`s of generated reads `idx` (sorted)."""
    r = ds.reads
    out = []
    for i in np.asarray(idx).tolist():
        ln = int(r["length"][i])
        out.append(BamRec(
            name="r%09d" % int(r["name"][i]),
            flag=int(r["flag"][i]), tid=int(r["tid"][i]),
            pos=int(r["pos"][i]), mapq=int(r["mapq"][i]),
            cigar=[(a, b) for a, b in library.cigar(int(r["kind"][i]), ln)],
            mtid=int(r["mtid"][i]), mpos=int(r["mpos"][i]),
            isize=int(r["tlen"][i]),
            seq_code=_CODE[ds.seq[i, :ln]], qual=ds.qual[i, :ln].copy(),
            aux=b"XBA" + bytes([int(r["xb"][i])]), l_qseq=ln,
        ))
    return out


def pick_windows(ds, chk: dict, seed: int):
    """[(tid, lo, hi)] 0-based half-open windows drawn from `seed`, at
    least a window's width from a contig's ends; with regions, one a
    region (as many as there are, at most), drawn without replacement,
    each holding its region whole or lying inside it."""
    rng = np.random.default_rng([seed, 0x5EED])
    w = chk["window_bp"]
    out = []
    if ds.regions:
        pick = rng.choice(len(ds.regions), replace=False,
                          size=min(chk["windows"], len(ds.regions)))
        for i in pick.tolist():
            t, lo, hi = ds.regions[i]
            if hi - lo <= w:
                a = int(rng.integers(hi - w, lo + 1))
            else:
                a = int(rng.integers(lo, hi - w + 1))
            a = min(max(a, 0), ds.lengths[t] - w)
            out.append((t, a, a + w))
        return out
    for _ in range(chk["windows"]):
        t = int(rng.integers(0, len(ds.lengths)))
        lo = int(rng.integers(w, ds.lengths[t] - 2 * w))
        out.append((t, lo, lo + w))
    return out


def records_near(ds, windows, reach, argv=()) -> np.ndarray:
    """Sorted indices of every record of a fragment one of whose records
    meets a window widened by `reach` either way; with regions, also of
    the fragment of each contig's first record that meets a region and
    that the caller keeps by the job's flags (`argv`)."""
    r = ds.reads
    hit = np.zeros(len(r["pos"]), dtype=bool)
    for t, lo, hi in windows:
        hit |= ((r["tid"] == t) & (r["pos"] < hi + reach)
                & (r["end"] > lo - reach))
    if ds.regions:
        read = np.nonzero(meets_regions(r, ds.regions)
                          & used_records(r, argv))[0]
        hit[read[np.unique(r["tid"][read], return_index=True)[1]]] = True
    names = np.unique(r["name"][hit])
    return np.nonzero(np.isin(r["name"], names))[0]


def compare(ds, argv, bcf_bytes, report_text, chk, seed,
            dtype=np.float64):
    """Run the reference on the pass's records and compare. Returns a
    dict of the compared numbers and what they covered."""
    header = BamHeader(text=ds.header_text, ref_names=list(ds.names),
                       ref_lens=list(ds.lengths))
    spans = keep = None
    if chk["windows"]:
        windows = pick_windows(ds, chk, seed)
        idx = records_near(ds, windows, chk["reach_bp"], argv)
        # the reference calls a little past each window; positions
        # `margin_bp` inside it are compared
        spans = [(t, lo - 4, hi + 4) for t, lo, hi in windows]
        m = chk["margin_bp"]
        keep = [(t, lo + m, hi - m) for t, lo, hi in windows]
        if ds.regions:
            keep = [(t, max(lo, a), min(hi, b)) for t, lo, hi in keep
                    for u, a, b in ds.regions
                    if u == t and max(lo, a) < min(hi, b)]
    else:
        idx = np.arange(ds.n_records)
        if ds.regions:
            keep = list(ds.regions)
    ref_bcf, ref_report = run_reference(argv, to_records(ds, idx), header,
                                        dtype=dtype, spans=spans)
    got = bcf_records(bcf_bytes, keep)
    want = bcf_records(ref_bcf, keep)
    keys = set(got) | set(want)
    bad = sorted(k for k in keys if got.get(k) != want.get(k))
    outside = []
    if ds.regions:
        inside = bcf_records(bcf_bytes, ds.regions)
        outside = sorted(k for k in bcf_records(bcf_bytes)
                         if k not in inside)
    out = {
        "sites_compared": len(keys),
        "sites_differ": len(bad) + len(outside),
        "first_differ": [list(k) for k in (bad + outside)[:3]],
        "reads_referenced": int(len(idx)),
    }
    if ds.regions:
        out["sites_outside_regions"] = len(outside)
    if not chk["windows"] and report_text is not None:
        a = [ln for ln in report_text.splitlines() if '"date"' not in ln]
        b = [ln for ln in ref_report.splitlines() if '"date"' not in ln]
        n = max(len(a), len(b))
        out["report_differ"] = sum(
            1 for i in range(n)
            if (a[i] if i < len(a) else None) != (b[i] if i < len(b) else None))
    return out
