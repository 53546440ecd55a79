"""The port's own readers read what the benchmark writes: the BAM, the
FASTA with its .fai and the dbSNP index."""

import json
import os

import numpy as np

from portbench.gen import library
from portbench.gen.dataset import make_dataset

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _dataset(tmp_path, name="wgbs_30x_pe150", scale=0.02):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        cfg = json.load(f)
    return make_dataset(cfg, 4242, str(tmp_path), scale=scale)


def test_bam_reads_back(tmp_path):
    from bs_call_tpu_torch.io.bam import BamReader

    ds = _dataset(tmp_path)
    r = ds.reads
    rd = BamReader(ds.bam_path)
    assert rd.header.ref_names == ds.names
    assert rd.header.ref_lens == ds.lengths
    recs = list(rd)
    assert len(recs) == ds.n_records
    code = np.zeros(256, np.uint8)
    code[list(b"ACGT")] = [1, 2, 3, 4]
    for i in np.linspace(0, ds.n_records - 1, 200).astype(int):
        rec = recs[i]
        ln = int(r["length"][i])
        assert rec.name == "r%09d" % r["name"][i]
        assert (rec.flag, rec.tid, rec.pos, rec.mapq) == (
            r["flag"][i], r["tid"][i], r["pos"][i], r["mapq"][i])
        assert (rec.mpos, rec.isize) == (r["mpos"][i], r["tlen"][i])
        assert rec.cigar == library.cigar(int(r["kind"][i]), ln)
        assert (rec.seq_code == code[ds.seq[i, :ln]]).all()
        assert (rec.qual == ds.qual[i, :ln]).all()
        assert rec.aux == b"XBA" + bytes([r["xb"][i]])


def test_fasta_and_dbsnp_read_back(tmp_path):
    from bs_call_tpu_torch.io.dbsnp import DbSnpIndex
    from bs_call_tpu_torch.io.fasta import FastaIndex

    ds = _dataset(tmp_path)
    fa = FastaIndex(ds.ref_path)
    off = ds.sample.offsets
    for t, name in enumerate(ds.names):
        seq = fa.load_contig(name)
        want = np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                               ds.sample.ref[off[t]:off[t + 1]]) + 1
        # the reference's decode leaves the contig's last base N
        assert (seq.codes[:-1] == want[:-1]).all()
    idx = DbSnpIndex(ds.dbsnp_path)
    assert idx.header_line == "name=portbench description=synthetic"
    for name, pos, ids in ds.dbsnp:
        ctg = idx.load_contig(name)
        have = set(pos.tolist())
        for p, i in list(zip(pos.tolist(), ids.tolist()))[::37]:
            flag, rs = ctg.lookup(p)
            assert (flag, rs.rstrip("\x00")) == (1, f"rs{i}")
            if p + 1 not in have:
                assert ctg.lookup(p + 1)[0] == 0


def test_dbsnp_index_bytes_equal_the_ports_builder(tmp_path):
    from bs_call_tpu_torch.io.dbsnp_idx import DbSnpIndexBuilder

    ds = _dataset(tmp_path)
    b = DbSnpIndexBuilder(header="track name=portbench description=synthetic")
    for name, pos, ids in ds.dbsnp:
        for p, i in zip(pos.tolist(), ids.tolist()):
            b.add_snp(name, p, f"rs{i}")
    b.write(str(tmp_path / "port.idx"))
    with open(ds.dbsnp_path, "rb") as x, open(tmp_path / "port.idx", "rb") as y:
        assert x.read() == y.read()
