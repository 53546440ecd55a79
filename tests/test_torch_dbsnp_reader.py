"""The port's dbSNP reader (`bs_call_tpu_torch.io.dbsnp`: flat per-contig
arrays, decoded by `native/bsc_dbsnp.cpp` or in Python) against the JAX
package's (`bs_call_tpu.io.dbsnp`, a dict of bins), on indexes written by
the port's `DbSnpIndexBuilder` from a seeded generator; and a `-D` job
whose bytes, report and counters do not depend on the decoder."""

import zlib

import numpy as np
import pytest

from bs_call_tpu.io.dbsnp import DbSnpIndex as JaxIndex
from bs_call_tpu_torch import cli
from bs_call_tpu_torch.io import dbsnp, dbsnp_idx
from bs_call_tpu_torch.io.dbsnp import DbSnpIndex
from bs_call_tpu_torch.io.dbsnp_idx import ContigBins, DbSnpIndexBuilder
from bs_call_tpu_torch.output import vector_site
from bs_call_tpu_torch.utils.synth import make_wgbs_fixture
from bs_call_tpu_torch.utils.trace import Tracer

N_PREFIXES = 800
# pref_ix >= 3 is written as an explicit 2-byte id, little-endian, and read
# big-endian (dbSNP.c:332): the ids whose swapped bytes still name a prefix
EXPLICIT = [i for i in range(3, N_PREFIXES)
            if ((i & 255) << 8 | i >> 8) < N_PREFIXES]
# bin gaps of each varint width: 1-byte (< 64), 2 (< 256), 3 (< 65536), 5
GAPS = (1, 2, 63, 64, 255, 256, 65535, 65536, 70001)


def _prefixes():
    out = ["rs", "ss", "COSM"]
    for i in range(N_PREFIXES - 3):
        s = ""
        i += 1
        while i:
            i, r = divmod(i - 1, 26)
            s = chr(97 + r) + s
        out.append("p" + s)
    return out


def _random_index(path, seed, items_per_block):
    """Contigs `chrA` (every gap width, bins of 1 to 64 entries), `chrB`
    (from position 1, dense) and `chrC` (one entry): table and explicit
    prefixes, names of 0 to 12 digits, a fifth maf-selected, blocks of
    `items_per_block` bins."""
    rng = np.random.default_rng(seed)
    prefs = _prefixes()
    b = DbSnpIndexBuilder(header="track name=reader")
    for p in prefs:
        b._prefix_ix(p)

    def add(ctg, pos):
        k = rng.integers(0, 4)
        pref = prefs[k] if k < 3 else prefs[rng.choice(EXPLICIT)]
        digits = "".join(map(str, rng.integers(0, 10, rng.integers(0, 13))))
        maf = 1.0 if rng.random() < 0.2 else -1.0
        b.add_snp(ctg, int(pos), pref + digits, maf)

    gaps = list(GAPS) + list(rng.integers(1, 40, 120))
    rng.shuffle(gaps)
    binx = 7 + np.cumsum(gaps)
    for i, bn in enumerate(binx):
        n = 64 if i % 25 == 0 else int(rng.integers(1, 9))
        for off in np.sort(rng.choice(64, n, replace=False)):
            add("chrA", bn * 64 + off)
    for x in np.sort(rng.choice(np.arange(0, 64 * 300), 4000, replace=False)):
        add("chrB", x)
    add("chrC", 123457)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dbsnp_idx, "ITEMS_PER_BLOCK", items_per_block)
        b.write(str(path))
    return str(path)


def _gap(k):
    if k < 64:
        return bytes([k << 2])
    if k < 256:
        return bytes([1, k])
    if k < 65536:
        return bytes([2]) + k.to_bytes(2, "little")
    return bytes([3]) + k.to_bytes(4, "little")


def _entry(off, digits, pref=0, explicit=None, maf=False, last=False):
    """One entry as a block holds it; `explicit` gives the two id bytes
    as stored."""
    out = bytearray([off | (0 if explicit else (pref + 1) << 6)])
    if explicit:
        out += bytes(explicit)
    ds = [int(c) for c in digits]
    for z in range(0, len(ds) - 1, 2):
        out.append(dbsnp_idx._pack_byte(ds[z], ds[z + 1]))
    if len(ds) % 2:
        out.append(dbsnp_idx._pack_byte(ds[-1], None))
    out.append((2 if maf else 0) | (1 if last else 0))
    return bytes(out)


def _raw_index(path, min_bin, max_bin, blocks):
    """An index of one contig `chrR` whose blocks are `blocks` as given:
    raw block bytes, compressed here, or ("z", bytes) stored as they
    are."""
    b = DbSnpIndexBuilder(header="track name=raw")
    for p in ("rs", "ss", "COSM"):
        b._prefix_ix(p)
    b.contigs["chrR"] = ContigBins("chrR", min_bin, max_bin)
    b.prebuilt = {"chrR": [blk[1] if isinstance(blk, tuple)
                           else zlib.compress(blk) for blk in blocks]}
    b.write(str(path))
    return str(path)


# hand-made chains whose decoding has a rule of its own
RAW = {
    # a bin's entries continue in the next block (it starts with a gap)
    "split": (10, 400, [
        _gap(0) + _entry(3, "12") + _entry(9, "345", maf=True),
        _gap(5) + _entry(20, "6", last=True) + _gap(2)
        + _entry(0, "77", last=True),
    ]),
    # a bin that comes again replaces the earlier one
    "again": (10, 400, [
        _gap(1) + _entry(3, "12") + _entry(9, "345", last=True)
        + _gap(0) + _entry(4, "9", maf=True, last=True),
        _gap(0) + _entry(60, "1234", last=True)
        + _gap(3) + _entry(1, "5", last=True),
    ]),
    # a gap past max_bin ends its block; later blocks stay past it
    "past": (0, 30, [
        _gap(2) + _entry(5, "11", last=True) + _gap(40)
        + _entry(6, "22", last=True),
        _gap(1) + _entry(7, "33", last=True),
    ]),
    # an unfinished bin at the chain's end is dropped; so is a block that
    # ends on its gap
    "open": (0, 400, [
        _gap(0) + _entry(1, "1", last=True) + _gap(3),
        _gap(4) + _entry(2, "23", last=True) + _gap(1) + _entry(8, "4"),
    ]),
    # explicit ids as stored (big-endian read), an empty name, 64 entries
    "explicit": (0, 400, [
        _gap(0) + _entry(0, "8", explicit=(0, 2)) + _entry(1, "")
        + _entry(2, "90", explicit=(0, 1), last=True)
        + _gap(1) + b"".join(_entry(o, str(o), maf=o % 3 == 0,
                                    last=o == 63) for o in range(64)),
    ]),
}

# corrupt chains, and the error both decoders raise
CORRUPT = {
    "offsets": ([_gap(0) + _entry(9, "1") + _entry(9, "2", last=True)],
                "bin offsets"),
    "unterminated": ([_gap(0) + _entry(9, "1", last=True)[:-1]], "name"),
    "explicit_cut": ([_gap(0) + bytes([5, 0])], "name"),
    "gap_cut": ([_gap(0) + _entry(9, "1", last=True) + bytes([2, 7])],
                "block"),
    "zlib_cut": ([("z", zlib.compress(_gap(0) + _entry(1, "1", last=True)
                                      * 50)[:-6])], "block"),
    "zlib_bad": ([("z", b"\x78\x9c" + bytes(range(40)))], "block"),
}


@pytest.fixture(params=["native", "python"])
def decoder(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(dbsnp, "_native", lambda: None)
    return request.param


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dbsnp_reader")
    out = {"blocks5": _random_index(tmp / "a.bin", 11, 5),
           "blocks2048": _random_index(tmp / "b.bin", 12, 2048)}
    for name, (lo, hi, blocks) in RAW.items():
        out[name] = _raw_index(tmp / f"{name}.bin", lo, hi, blocks)
    return out


def _span(jctg):
    """Positions to hold the readers to: every position of every bin
    the JAX reader holds and of its two neighbours, 64 beyond the
    contig's ends, and 2,000 drawn from the whole span. No other
    position can be present (the JAX reader holds no other bin)."""
    bins = np.array(sorted(jctg.bins), np.int64)
    lo, hi = jctg.info.min_bin * 64, jctg.info.max_bin * 64 + 63
    near = (bins[:, None] + np.arange(-1, 2)).ravel()
    xs = (near[:, None] * 64 + np.arange(64)).ravel()
    rng = np.random.default_rng(lo + hi)
    ends = np.r_[np.arange(lo - 64, lo + 64), np.arange(hi - 64, hi + 65)]
    return np.unique(np.r_[xs, ends, rng.integers(lo - 64, hi + 65, 2000)])


@pytest.mark.parametrize("name", ["blocks5", "blocks2048"] + list(RAW))
def test_lookup_and_range_flags_match_jax(indexes, name, decoder):
    path = indexes[name]
    port, jax = DbSnpIndex(path), JaxIndex(path)
    assert list(port.contigs) == list(jax.contigs)
    assert port.load_contig("chrZ") is None
    for cname in port.contigs:
        ctg, jctg = port.load_contig(cname), jax.load_contig(cname)
        assert ctg.native == (decoder == "native")
        xs = _span(jctg)
        want = [jctg.lookup(int(x)) for x in xs]
        assert [ctg.lookup(int(x)) for x in xs] == want
        # range_flags over chunks that straddle bins, against the lookups
        lo, hi = int(xs[0]), int(xs[-1])
        flag = np.zeros(hi - lo + 1, np.int64)
        flag[xs - lo] = [w[0] for w in want]
        rng = np.random.default_rng(len(xs))
        x0 = lo
        while x0 <= hi:
            step = int(rng.integers(1, 200)) if rng.random() < 0.9 else 9000
            x1 = min(x0 + step - 1, hi)
            present, selected = ctg.range_flags(x0, x1)
            f = flag[x0 - lo:x1 - lo + 1]
            assert np.array_equal(present, f > 0)
            assert np.array_equal(selected, f == 3)
            x0 = x1 + 1
        # the rs ids of a chunk's rows: names as lookup gives them, the
        # trailing NUL of an odd-digit name included; empty elsewhere
        rows = np.flatnonzero(flag[xs - lo] > 0)
        off, blob = ctg.rs_ids(xs, rows)
        assert off.dtype == np.int64 and len(off) == len(xs) + 1
        got = [blob[off[i]:off[i + 1]].tobytes() for i in range(len(xs))]
        assert got == [w[1].encode() for w in want]


def test_names_cover_the_format(indexes):
    """The generated indexes hold what the reader has to decode."""
    jax = JaxIndex(indexes["blocks5"])
    names = [jctg.lookup(int(x))[1]
             for jctg in map(jax.load_contig, jax.contigs)
             for x in _span(jctg) if jctg.lookup(int(x))[0]]
    assert any(n.endswith("\x00") for n in names)
    assert any(n[-1:].isdigit() for n in names)
    prefixes = {n.rstrip("0123456789\x00") for n in names}
    assert {"rs", "ss", "COSM"} <= prefixes and len(prefixes) > 3
    sel = [jctg.lookup(int(x))[0] for jctg in map(jax.load_contig, ["chrA"])
           for x in _span(jctg)]
    assert 3 in sel and 1 in sel
    assert max(len(b.entries) for b in jax.load_contig("chrA").bins.values()) \
        == 64


@pytest.mark.parametrize("name", ["blocks5", "blocks2048"] + list(RAW))
def test_native_and_python_arrays_equal(indexes, name, monkeypatch):
    idx = DbSnpIndex(indexes[name])
    native = {c: idx.load_contig(c) for c in idx.contigs}
    monkeypatch.setattr(dbsnp, "_native", lambda: None)
    for c, ctg in native.items():
        py = idx.load_contig(c)
        assert ctg.native and not py.native
        for a in ("pos", "sel", "pfx", "name_off", "names"):
            x, y = getattr(ctg, a), getattr(py, a)
            assert x.dtype == y.dtype and np.array_equal(x, y), a
        assert np.all(np.diff(ctg.pos) > 0)


@pytest.mark.parametrize("case", list(CORRUPT))
def test_corrupt_block_raises_the_same_both_ways(tmp_path, case, decoder):
    blocks, what = CORRUPT[case]
    idx = DbSnpIndex(_raw_index(tmp_path / "bad.bin", 0, 400, blocks))
    with pytest.raises(ValueError) as e:
        idx.load_contig("chrR")
    assert str(e.value) == f"dbSNP index corrupt: {what}"
    if case in ("offsets", "unterminated"):  # the JAX reader's own checks
        with pytest.raises(ValueError, match=what):
            JaxIndex(str(tmp_path / "bad.bin")).load_contig("chrR")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """One `-D` job a decoder and output type (`-O b`, `-O v`; and `-O v`
    with the Python decoder and text formatter), with a report, over a
    two-contig fixture and an index of odd- and even-digit names, a
    quarter of them maf-selected."""
    tmp = tmp_path_factory.mktemp("dbsnp_job")
    ref, bam, _n = make_wgbs_fixture(str(tmp), 1500, 4000, seed=5,
                                     n_contigs=2)
    b = DbSnpIndexBuilder(header="track name=job")
    rng = np.random.default_rng(5)
    for name in ("chr1", "chr2"):
        for pos in range(3, 4000, 7):
            rs = f"{('rs', 'ss')[pos % 2]}{rng.integers(1, 10**7)}"
            b.add_snp(name, pos, rs, 1.0 if pos % 4 == 0 else -1.0)
    idx = str(tmp / "idx.bin")
    b.write(idx)
    out = {}
    for dec, ot in (("native", "b"), ("native", "v"), ("python", "b"),
                    ("python", "v"), ("python_text", "v")):
        tr = Tracer()
        with pytest.MonkeyPatch.context() as mp:
            if dec.startswith("python"):
                mp.setattr(dbsnp, "_native", lambda: None)
            if dec == "python_text":  # the Python text formatter too
                mp.setattr(vector_site, "_native_format",
                           lambda *a: False)
            rc = cli.main([bam, "-r", ref, "-D", idx, "-O", ot,
                           "--benchmark-mode", "--device", "cpu",
                           "-t", "2", "-o", str(tmp / f"{dec}.{ot}"),
                           "--report-file", str(tmp / f"{dec}{ot}.json")],
                          tracer=tr)
        assert rc == 0
        out[dec, ot] = (tr.counts, (tmp / f"{dec}.{ot}").read_bytes(),
                        (tmp / f"{dec}{ot}.json").read_text())
    return out


@pytest.mark.parametrize("dec,ot", [("python", "b"), ("python", "v"),
                                    ("python_text", "v")])
def test_job_bytes_and_report_do_not_depend_on_the_decoder(jobs, dec, ot):
    _c, out_n, rep_n = jobs["native", ot]
    _c, out_p, rep_p = jobs[dec, ot]
    assert out_n == out_p
    assert rep_n == rep_p
    if ot == "v":
        assert b"\x00\t" in out_n  # an odd-digit name's trailing NUL


@pytest.mark.parametrize("dec", ["native", "python"])
def test_job_counters(jobs, dec):
    vcf = jobs[dec, "v"][1].decode()
    ids = [ln.split("\t")[2] for ln in vcf.splitlines()
           if not ln.startswith("#")]
    n_rs = sum(i != "." for i in ids)
    assert n_rs > 100
    for ot in ("b", "v"):
        counts = jobs[dec, ot][0]
        native = 2 if dec == "native" else 0
        assert counts["dbsnp_native_contigs"] == native
        assert counts["dbsnp_py_contigs"] == 2 - native
        assert counts["dbsnp_rs_rows"] == n_rs
