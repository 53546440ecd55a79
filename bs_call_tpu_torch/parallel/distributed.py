"""Multi-host runs (`--num-hosts`) on `torch.distributed`.

Counterpart of `bs_call_tpu/parallel/distributed.py`. Each host runs one
process, assigned its contigs by greedy LPT (`my_contigs`, the shard
runner's partitioner), and writes a VCF of them with a uniform header, so
that the hosts' files concatenate (`python -m bs_call_tpu_torch.concat`,
the reference's -s contract). The JSON stats then merge with collectives
over a gloo process group on CPU tensors: the JAX package runs its merge
on its CPU backend on purpose, because the payload carries float64 grids,
and gloo is the same choice here. Every fixed-size counter flattens into
one vector and a single all-reduce sums it; the dynamically keyed
counters (the coverage hash, fs/qd/mq, the methylation profile) are
all-gathered as sparse tables and folded exactly on every host: no fold
bounds, as the reference's hashes are unbounded (stats.c:208-228).

Entry points:
  initialize(coordinator, num_processes, process_id): the process group
  my_contigs(universe, n_hosts, host_id): deterministic assignment
  merge_stats_collective(stats): the global stats on every host
  run_multihost(cfg, device, num_hosts, host_id, coordinator): one host
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bs_call_tpu_torch.parallel.shard_runner import partition_contigs
from bs_call_tpu_torch.pipeline.runner import _ensure_bam_index, run_caller
from bs_call_tpu_torch.stats.collect import BsStats, CtgStats


def initialize(coordinator: str, num_processes: int, process_id: int
               ) -> None:
    """Join the gloo process group whose TCP store host 0 serves at
    `coordinator` (host:port)."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", rank=process_id,
        world_size=num_processes,
    )


def my_contigs(
    universe: List[Tuple[str, int]], n_hosts: int, host_id: int
) -> List[str]:
    """Deterministic contig assignment for this host."""
    shards = partition_contigs(universe, n_hosts)
    return shards[host_id] if host_id < len(shards) else []


# ---------------- collective stats merge ----------------

_FIXED_FIELDS = [
    ("snps", 2), ("indels", 2), ("multi", 2), ("dbSNP_sites", 2),
    ("dbSNP_var", 2), ("CpG_ref", 2), ("CpG_nonref", 2),
]
_ARRAY_FIELDS = [
    ("mut_counts", (12, 2)),
    ("dbSNP_mut_counts", (12, 2)),
    ("qual", (4, 256)),
    ("filter_cts", (15,)),
    ("filter_bases", (15,)),
    ("base_filter", (5,)),
    ("filter_counts", (2, 32)),
]
_FLOAT_FIELDS = [
    ("CpG_ref_meth", (2, 101)),
    ("CpG_nonref_meth", (2, 101)),
]
_CTG_FIELDS = ("snps", "indels", "multi", "dbSNP_sites", "dbSNP_var",
               "CpG_ref", "CpG_nonref")


def stats_to_vectors(stats: BsStats) -> Dict[str, np.ndarray]:
    """Flatten the FIXED-shape part of a BsStats for one all-reduce: int64
    counters and float64 grids. The dynamically keyed parts travel as
    exact sparse tables instead (`stats_to_sparse`)."""
    ints = []
    for name, _n in _FIXED_FIELDS:
        ints.extend(int(v) for v in getattr(stats, name))
    for name, _shape in _ARRAY_FIELDS:
        ints.extend(np.asarray(getattr(stats, name)).ravel().tolist())
    fv = np.concatenate(
        [np.asarray(getattr(stats, name)).ravel() for name, _ in _FLOAT_FIELDS]
    )
    return {"ints": np.array(ints, dtype=np.int64), "floats": fv}


def stats_to_sparse(stats: BsStats) -> Dict[str, np.ndarray]:
    """The dynamically keyed counters as [K, 1+C] int64 tables (column 0 =
    key + 1, so an all-zero padding row never aliases a real entry),
    sorted by key."""
    cov_keys = sorted(int(d) for d in stats.cov_stats)
    cov = np.zeros((len(cov_keys), 1 + 6 + 101), dtype=np.int64)
    for i, d in enumerate(cov_keys):
        cs = stats.cov_stats[d]
        cov[i, 0] = d + 1
        cov[i, 1:7] = (
            cs.all, cs.var, cs.CpG[0], cs.CpG[1],
            cs.CpG_inf[0], cs.CpG_inf[1],
        )
        cov[i, 7:] = cs.gc_pcent
    out = {"cov": cov}
    for attr in ("fs_stats", "qd_stats", "mq_stats"):
        dct = getattr(stats, attr)
        keys = sorted(int(k) for k in dct)
        t = np.zeros((len(keys), 3), dtype=np.int64)
        for i, k in enumerate(keys):
            t[i] = (k + 1, dct[k][0], dct[k][1])
        out[attr] = t
    mp = np.asarray(stats.meth_profile, dtype=np.int64)
    mprof = np.zeros((len(mp), 5), dtype=np.int64)
    if len(mp):
        mprof[:, 0] = np.arange(1, len(mp) + 1)
        mprof[:, 1:] = mp
    out["mprof"] = mprof
    return out


def sparse_into_stats(stats: BsStats, tables: Dict[str, np.ndarray],
                      mprof_used: int) -> None:
    """Fold gathered sparse tables (leading axis: one slot per host) into
    `stats`. Zero key columns are padding."""
    cov = np.asarray(tables["cov"]).reshape(-1, 1 + 6 + 101)
    for row in cov:
        if row[0] == 0:
            continue
        cs = stats.cov_stats[int(row[0]) - 1]
        cs.all += int(row[1])
        cs.var += int(row[2])
        cs.CpG[0] += int(row[3])
        cs.CpG[1] += int(row[4])
        cs.CpG_inf[0] += int(row[5])
        cs.CpG_inf[1] += int(row[6])
        cs.gc_pcent = cs.gc_pcent + row[7:]
    for attr in ("fs_stats", "qd_stats", "mq_stats"):
        dct = getattr(stats, attr)
        for row in np.asarray(tables[attr]).reshape(-1, 3):
            if row[0] == 0:
                continue
            dct[int(row[0]) - 1][0] += int(row[1])
            dct[int(row[0]) - 1][1] += int(row[2])
    stats.grow_meth_profile(max(mprof_used, 0))
    for row in np.asarray(tables["mprof"]).reshape(-1, 5):
        idx = int(row[0]) - 1
        if idx < 0:
            continue
        if idx >= len(stats.meth_profile):
            stats.grow_meth_profile(idx)
        stats.meth_profile[idx] += row[1:]
    stats.meth_profile_used = mprof_used


def vectors_to_stats(v: Dict[str, np.ndarray]) -> BsStats:
    stats = BsStats()
    iv = np.asarray(v["ints"])
    off = 0
    for name, n in _FIXED_FIELDS:
        setattr(stats, name, [int(x) for x in iv[off : off + n]])
        off += n
    for name, shape in _ARRAY_FIELDS:
        size = int(np.prod(shape))
        setattr(stats, name, np.asarray(iv[off : off + size]).reshape(shape))
        off += size
    fv = np.asarray(v["floats"])
    off = 0
    for name, shape in _FLOAT_FIELDS:
        size = int(np.prod(shape))
        setattr(stats, name, fv[off : off + size].reshape(shape))
        off += size
    return stats


def psum_arrays(vecs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One all-reduce (sum) over the hosts for each array of a dict. With
    no process group, the identity."""
    return _collective(vecs, gather=False)


def allgather_arrays(vecs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """all_gather counterpart of `psum_arrays`: each array with a new
    leading axis of one slot per host (of 1 with no process group). The
    exact sparse-stats merge uses it: tables whose keys differ per host
    cannot be summed, but they can be gathered. Every host must pass the
    same shapes."""
    return _collective(vecs, gather=True)


def _collective(vecs: Dict[str, np.ndarray], gather: bool
                ) -> Dict[str, np.ndarray]:
    """gloo sums and gathers int64 and float64 as they are: a counter past
    2^31 and the f64 grids cross unchanged, which the dtype check holds."""
    grouped = dist.is_available() and dist.is_initialized()
    merged = {}
    for k in sorted(vecs):
        a = np.asarray(vecs[k])
        t = torch.from_numpy(np.array(a))  # a copy the collective may own
        if not grouped:
            merged[k] = t[None].numpy() if gather else t.numpy()
        elif gather:
            slots = [torch.empty_like(t) for _ in range(dist.get_world_size())]
            dist.all_gather(slots, t)
            merged[k] = torch.stack(slots).numpy()
        else:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            merged[k] = t.numpy()
        if merged[k].dtype != a.dtype:
            raise AssertionError(
                f"collective changed dtype of {k}: {a.dtype} -> "
                f"{merged[k].dtype}"
            )
    return merged


def merge_stats_collective(stats: BsStats) -> BsStats:
    """Merge the hosts' stats into the global stats, the same on every
    host: fixed-shape counters with one all-reduce; the dynamically keyed
    tables EXACTLY, each host's padded to the largest row count (learned
    from one small all_gather), all-gathered, and folded in host order.
    With no process group, this host's stats."""
    sparse = stats_to_sparse(stats)
    names = sorted(sparse)
    sizes = np.array(
        [len(sparse[n]) for n in names] + [stats.meth_profile_used],
        dtype=np.int64,
    )
    g_sizes = allgather_arrays({"sizes": sizes})["sizes"].reshape(
        -1, len(sizes)
    )
    kmax = g_sizes.max(axis=0)
    padded = {}
    for i, n in enumerate(names):
        t = sparse[n]
        p = np.zeros((max(int(kmax[i]), 1),) + t.shape[1:], dtype=np.int64)
        p[: len(t)] = t
        padded[n] = p
    gathered = allgather_arrays(padded)
    merged = vectors_to_stats(psum_arrays(stats_to_vectors(stats)))
    sparse_into_stats(merged, gathered, int(kmax[-1]))
    return merged


# ---------------- multi-host runtime ----------------


def _ctg_stats_matrix(universe, table) -> np.ndarray:
    """[n_contigs, 14] int64 of per-contig counters in universe order
    (zero rows for contigs this host did not call): summable, because each
    contig is called by exactly one host."""
    by_name = {c.name: c.ctg_stats for c in table.contigs if c.ctg_stats}
    m = np.zeros((len(universe), 2 * len(_CTG_FIELDS)), dtype=np.int64)
    for i, (name, _ln) in enumerate(universe):
        gs = by_name.get(name)
        if gs is not None:
            m[i] = [v for f in _CTG_FIELDS for v in getattr(gs, f)]
    return m


def _matrix_to_ctg_stats(universe, m):
    out = []
    for i, (name, _ln) in enumerate(universe):
        r = [int(x) for x in m[i]]
        out.append((name, CtgStats(**{
            f: r[2 * j : 2 * j + 2] for j, f in enumerate(_CTG_FIELDS)
        })))
    return out


def contig_universe(cfg):
    """(name, length) of the reference's contigs that the alignment
    header names, in reference order: the same on every host, so the LPT
    assignment is too (the reference's process_sam_header.c:52-70)."""
    from bs_call_tpu_torch.io.fasta import FastaIndex
    from bs_call_tpu_torch.io.sam import open_alignment_file

    reader = open_alignment_file(cfg.input_file, native=False)
    fasta = FastaIndex(cfg.reference_file)
    header_names = set(reader.header.ref_names)
    universe = [
        (e.name, e.length) for e in fasta.entries if e.name in header_names
    ]
    if hasattr(reader, "close"):
        reader.close()
    return universe


def run_multihost(cfg, device: torch.device | str, num_hosts: int,
                  host_id: int, coordinator: str | None = None,
                  tracer=None):
    """One host's share of a multi-host run (the reference's external
    per-contig sharding plus `bcftools concat`, made first class): call
    this host's LPT contig assignment on `device` with a uniform header,
    so the hosts' VCFs concatenate; then, when `coordinator` names host
    0's process-group address, merge the JSON stats across hosts and
    return the GLOBAL stats on every host (the caller writes the report
    on host 0). Without a coordinator, this host's own stats. The process
    group is destroyed before returning.

    Returns (stats | None, ordered_ctg_stats, wrote_output)."""
    if coordinator:
        initialize(coordinator, num_hosts, host_id)
    tmp_bed = tmp_sizes = None
    try:
        universe = contig_universe(cfg)
        mine = my_contigs(universe, num_hosts, host_id)
        collect = bool(cfg.report_file)
        stats = BsStats() if collect else None
        table = None
        if mine:
            # as the shard runner does: with an index, the native ingest
            # seeks to this host's contigs; without one it scans the whole
            # file and its read-level filter counts (Duplicate, LowMAPQ)
            # take in the other hosts' reads too
            _ensure_bam_index(cfg.input_file)
            fd, tmp_bed = tempfile.mkstemp(suffix=".bed")
            sizes = dict(universe)
            with os.fdopen(fd, "w") as bed:
                for name in mine:
                    bed.write(f"{name}\t0\t{sizes[name]}\n")
            cfg.contig_bed = tmp_bed
            if not cfg.contig_sizes:
                # the uniform header universe (the -s contract)
                fd, tmp_sizes = tempfile.mkstemp(suffix=".sizes")
                with os.fdopen(fd, "w") as f:
                    for name, ln in universe:
                        f.write(f"{name}\t{ln}\n")
                cfg.contig_sizes = tmp_sizes
            stats, table = run_caller(cfg, device, stats=stats, tracer=tracer)
        if collect and coordinator:
            ctg_local = (
                _ctg_stats_matrix(universe, table)
                if table is not None
                else np.zeros((len(universe), 2 * len(_CTG_FIELDS)),
                              dtype=np.int64)
            )
            merged_ctg = psum_arrays({"ctg": ctg_local})["ctg"]
            # zero-count contigs are gated out by the report writer
            return (merge_stats_collective(stats),
                    _matrix_to_ctg_stats(universe, merged_ctg), bool(mine))
        ordered = []
        if collect and table is not None:
            ordered = [(c.name, c.ctg_stats) for c in table.contigs
                       if c.ctg_stats is not None]
        return stats, ordered, bool(mine)
    finally:
        for p in (tmp_bed, tmp_sizes):
            if p:
                os.unlink(p)
        if coordinator and dist.is_initialized():
            dist.destroy_process_group()
