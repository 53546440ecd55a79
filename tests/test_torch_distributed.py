"""The port's stats merge for `--num-hosts`
(`bs_call_tpu_torch.parallel.distributed`, on `torch.distributed` with
gloo) against the JAX package's (`bs_call_tpu.parallel.distributed`, on
its 8 virtual CPU devices): the flattening of a BsStats into one vector
and sparse tables, and its rebuild, give the JAX functions' arrays on the
same seed-made stats; the merge in one process is the identity, as in
JAX; two gloo processes sum int64 counters past 2^31 and f64 grids
exactly, gather with one slot per process, and merge two hosts' stats into
what `BsStats.merge` makes of them on one host; the contig assignment and
universe are the JAX package's."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from bs_call_tpu.parallel import distributed as jax_dist
from bs_call_tpu.stats.collect import BsStats as JaxStats
from bs_call_tpu_torch.parallel import distributed as D
from bs_call_tpu_torch.stats.collect import BsStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_stats(cls, seed):
    """`tests/test_distributed.py`'s stats, built on either package's
    BsStats from one numpy seed."""
    rng = np.random.default_rng(seed)
    s = cls()
    s.snps = [int(rng.integers(100)), int(rng.integers(50))]
    s.CpG_ref = [int(rng.integers(100)), int(rng.integers(50))]
    s.mut_counts = rng.integers(0, 100, (12, 2))
    s.qual = rng.integers(0, 1000, (4, 256))
    s.filter_cts = rng.integers(0, 100, 15)
    s.filter_bases = rng.integers(0, 5000, 15)
    s.base_filter = rng.integers(0, 100, 5)
    s.filter_counts = rng.integers(0, 100, (2, 32))
    s.CpG_ref_meth = rng.random((2, 101))
    for d in rng.integers(1, 100, 10):
        cs = s.cov_stats[int(d)]
        cs.all = int(rng.integers(1, 50))
        cs.var = int(rng.integers(0, 10))
        cs.CpG = [int(rng.integers(5)), int(rng.integers(5))]
        cs.CpG_inf = [int(rng.integers(5)), int(rng.integers(5))]
        cs.gc_pcent = rng.integers(0, 10, 101)
    for k in rng.integers(0, 200, 8):
        s.fs_stats[int(k)][0] = int(rng.integers(10))
        s.fs_stats[int(k)][1] = int(rng.integers(10))
    s.grow_meth_profile(60)
    s.meth_profile[:61] = rng.integers(0, 50, (61, 4))
    return s


def summary(s):
    """Every field of a BsStats (either package's) as plain values."""
    out = {name: np.asarray(getattr(s, name)).tolist() for name in (
        "snps", "indels", "multi", "dbSNP_sites", "dbSNP_var", "CpG_ref",
        "CpG_nonref", "mut_counts", "dbSNP_mut_counts", "qual", "filter_cts",
        "filter_bases", "base_filter", "filter_counts", "CpG_ref_meth",
        "CpG_nonref_meth")}
    out["cov"] = {int(k): (v.all, v.var, list(v.CpG), list(v.CpG_inf),
                           np.asarray(v.gc_pcent).tolist())
                  for k, v in s.cov_stats.items()}
    for attr in ("fs_stats", "qd_stats", "mq_stats"):
        out[attr] = {int(k): list(v) for k, v in getattr(s, attr).items()}
    out["mprof"] = np.asarray(s.meth_profile[:s.meth_profile_used]).tolist()
    out["mprof_used"] = s.meth_profile_used
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_vectors_and_sparse_tables_equal_jax(seed):
    port, jax = random_stats(BsStats, seed), random_stats(JaxStats, seed)
    for mine, theirs in ((D.stats_to_vectors(port),
                          jax_dist.stats_to_vectors(jax)),
                         (D.stats_to_sparse(port),
                          jax_dist.stats_to_sparse(jax))):
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_vector_roundtrip():
    s = random_stats(BsStats, 0)
    s2 = D.vectors_to_stats(D.stats_to_vectors(s))
    D.sparse_into_stats(s2, D.stats_to_sparse(s), s.meth_profile_used)
    assert summary(s2) == summary(s)


def test_merge_in_one_process_equals_jax():
    """No process group: the merge is this host's stats, as JAX's merge
    over its local devices (one carrying the payload) is."""
    merged = D.merge_stats_collective(random_stats(BsStats, 1))
    want = jax_dist.merge_stats_collective(random_stats(JaxStats, 1))
    assert summary(merged) == summary(want)
    assert summary(merged) == summary(random_stats(BsStats, 1))


def test_one_process_collectives_are_the_identity():
    v = {"a": np.arange(6, dtype=np.int64).reshape(2, 3),
         "b": np.full(3, 0.1)}
    summed, gathered = D.psum_arrays(v), D.allgather_arrays(v)
    for k in v:
        np.testing.assert_array_equal(summed[k], v[k])
        np.testing.assert_array_equal(gathered[k], v[k][None])
        assert summed[k].dtype == gathered[k].dtype == v[k].dtype


def test_merge_exact_beyond_fold_bounds():
    """Depths past 4096 and fs/qd/mq keys past 512 survive exactly
    (`tests/test_distributed.py`'s case)."""
    s = BsStats()
    for d in (3, 4095, 4096, 50_000, 1_000_000):
        cs = s.cov_stats[d]
        cs.all = d + 1
        cs.var = 2
        cs.gc_pcent = np.arange(101, dtype=np.int64)
    s.fs_stats[10_000][0] = 7
    s.qd_stats[511][1] = 3
    s.qd_stats[9_999][1] = 4
    s.mq_stats[70_000][0] = 5
    assert summary(D.merge_stats_collective(s)) == summary(s)


@pytest.mark.parametrize("n_hosts", [2, 3, 4])
def test_contig_assignment_equals_jax(n_hosts):
    rng = np.random.default_rng(n_hosts)
    universe = [(f"c{i}", int(rng.integers(1, 6)) * 1000) for i in range(10)]
    mine = [D.my_contigs(universe, n_hosts, h) for h in range(n_hosts + 1)]
    assert mine == [jax_dist.my_contigs(universe, n_hosts, h)
                    for h in range(n_hosts + 1)]
    assert sorted(sum(mine, [])) == sorted(n for n, _ in universe)


def test_contig_universe_equals_jax(tmp_path):
    from types import SimpleNamespace

    from test_shard_runner import make_fixture

    ref, bam = make_fixture(tmp_path)
    cfg = SimpleNamespace(input_file=bam, reference_file=ref)
    assert D.contig_universe(cfg) == jax_dist.contig_universe(cfg)


# ---- two processes over gloo ----

_HOST = r"""
import json, sys
import numpy as np
sys.path.insert(0, {tests!r})
from bs_call_tpu_torch.parallel import distributed as D
from bs_call_tpu_torch.stats.collect import BsStats
from test_torch_distributed import random_stats, summary

rank = int(sys.argv[1])
D.initialize("127.0.0.1:" + sys.argv[2], 2, rank)
big = np.array([(1 << 35) + 7 + rank, -(1 << 40)], dtype=np.int64)
grid = np.full((2, 3), 1.0 + 2.0 ** -40, dtype=np.float64) * (rank + 1)
summed = D.psum_arrays({{"big": big, "grid": grid}})
gathered = D.allgather_arrays({{"big": big}})
merged = D.merge_stats_collective(random_stats(BsStats, 10 + rank))
import torch.distributed as dist
dist.destroy_process_group()
print(json.dumps({{
    "big": summed["big"].tolist(), "big_dtype": str(summed["big"].dtype),
    "grid": summed["grid"].tolist(), "grid_dtype": str(summed["grid"].dtype),
    "gathered": gathered["big"].tolist(), "merged": summary(merged)}}))
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_hosts():
    """What each of two gloo processes computed, by rank."""
    code = _HOST.format(tests=os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": REPO}
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr[-2000:]
            out.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_two_processes_sum_int64_past_2_31_and_f64_exactly(two_hosts):
    for r in two_hosts:
        assert r["big_dtype"] == "int64" and r["grid_dtype"] == "float64"
        assert r["big"] == [(1 << 36) + 15, -(1 << 41)]
        want = (np.full((2, 3), 1.0 + 2.0 ** -40) * 1
                + np.full((2, 3), 1.0 + 2.0 ** -40) * 2)
        assert r["grid"] == want.tolist()


def test_two_processes_gather_one_slot_each(two_hosts):
    for r in two_hosts:
        assert r["gathered"] == [[(1 << 35) + 7, -(1 << 40)],
                                 [(1 << 35) + 8, -(1 << 40)]]


def test_two_process_merge_equals_the_host_merge(two_hosts):
    """Both hosts hold the same global stats, and they are what
    `BsStats.merge` makes of the two hosts' stats in one process."""
    want = random_stats(BsStats, 10)
    want.merge(random_stats(BsStats, 11))
    want = json.loads(json.dumps(summary(want)))
    for r in two_hosts:
        assert r["merged"] == want
