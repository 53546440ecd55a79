"""The kernel work counters against hand counts on a hand-made batch."""

from types import SimpleNamespace

import numpy as np

from portbench.gen.library import FDUP, FMREVERSE, FMUNMAP, FPAIRED, \
    FPROPER, FREAD1, FREAD2, FREVERSE
from portbench.work import k3, k12
from portbench.work.inputs import pileup_input


def _batch():
    # a pair overlapping by 50 (spans [100, 250) and [200, 350)), its
    # duplicate, a read below the mapping-quality floor, a singleton and
    # a single-end read on the second contig
    rows = [
        # tid, pos, end, flag, mapq, name
        (0, 100, 250, FPAIRED | FPROPER | FMREVERSE | FREAD1, 60, 1),
        (0, 200, 350, FPAIRED | FPROPER | FREVERSE | FREAD2, 60, 1),
        (0, 100, 250, FPAIRED | FPROPER | FMREVERSE | FREAD1 | FDUP, 60, 2),
        (0, 200, 350, FPAIRED | FPROPER | FREVERSE | FREAD2 | FDUP, 60, 2),
        (0, 400, 550, 0, 10, 3),
        (0, 600, 750, FPAIRED | FMUNMAP, 60, 4),
        (1, 10, 60, 0, 60, 5),
    ]
    a = np.array(rows, dtype=np.int64)
    reads = {k: a[:, i] for i, k in enumerate(
        ("tid", "pos", "end", "flag", "mapq", "name"))}
    return SimpleNamespace(reads=reads, lengths=[1000, 100])


def test_pileup_input_by_hand():
    inp = pileup_input(_batch(), {"flags": ["-q", "20"]})
    # used: the pair (2) and the single-end read (1)
    assert inp["records_used"] == 3
    # the pair's union [100, 350) = 250 bases, the single read 50
    assert inp["bases"] == 300
    assert inp["covered"] == 300


def test_k12_and_k3_bytes_by_hand():
    inp = {"records_used": 3, "bases": 300, "covered": 300}
    w = k12.work(inp)
    assert w["bytes"] == 2 * 300 + 16 * 3 + 300 * (1 + 132)
    assert w["flop"] == 940 * 300
    assert k3.work(inp)["bytes"] == 300 * (172 + 50)
