"""Statistics accumulators for the JSON report.

Mirrors bs_stats / gt_ctg_stats / gt_cov_stats (bs_call.h:75-146). All
fields are sums or histograms, so multi-shard runs merge with elementwise
addition (see merge())."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


def _pair():
    """Picklable defaultdict factory (shard workers return stats)."""
    return [0, 0]


@dataclass
class CovStats:
    """Per-coverage-depth counters (bs_call.h:87-95)."""

    all: int = 0
    var: int = 0
    CpG: List[int] = field(default_factory=lambda: [0, 0])
    CpG_inf: List[int] = field(default_factory=lambda: [0, 0])
    gc_pcent: np.ndarray = field(
        default_factory=lambda: np.zeros(101, dtype=np.int64)
    )


@dataclass
class CtgStats:
    """Per-contig counters (bs_call.h:75-85)."""

    snps: List[int] = field(default_factory=lambda: [0, 0])
    indels: List[int] = field(default_factory=lambda: [0, 0])
    multi: List[int] = field(default_factory=lambda: [0, 0])
    dbSNP_sites: List[int] = field(default_factory=lambda: [0, 0])
    dbSNP_var: List[int] = field(default_factory=lambda: [0, 0])
    CpG_ref: List[int] = field(default_factory=lambda: [0, 0])
    CpG_nonref: List[int] = field(default_factory=lambda: [0, 0])
    gc: np.ndarray = None  # per-100bp GC bins while contig is active


class BsStats:
    """Global stats block (bs_call.h:124-146)."""

    def __init__(self):
        self.snps = [0, 0]
        self.indels = [0, 0]
        self.multi = [0, 0]
        self.dbSNP_sites = [0, 0]
        self.dbSNP_var = [0, 0]
        self.CpG_ref = [0, 0]
        self.CpG_nonref = [0, 0]
        self.mut_counts = np.zeros((12, 2), dtype=np.int64)
        self.dbSNP_mut_counts = np.zeros((12, 2), dtype=np.int64)
        self.qual = np.zeros((4, 256), dtype=np.int64)
        self.filter_cts = np.zeros(15, dtype=np.int64)
        self.filter_bases = np.zeros(15, dtype=np.int64)
        self.base_filter = np.zeros(5, dtype=np.int64)
        self.filter_counts = np.zeros((2, 32), dtype=np.int64)
        self.CpG_ref_meth = np.zeros((2, 101), dtype=np.float64)
        self.CpG_nonref_meth = np.zeros((2, 101), dtype=np.float64)
        self.cov_stats: Dict[int, CovStats] = defaultdict(CovStats)
        # QC distributions: value -> [nonvariant, variant]
        self.fs_stats: Dict[int, List[int]] = defaultdict(_pair)
        self.qd_stats: Dict[int, List[int]] = defaultdict(_pair)
        self.mq_stats: Dict[int, List[int]] = defaultdict(_pair)
        # meth profile: per original-read-position conversion counts a,b,c,d.
        # The array carries one slack row beyond `meth_profile_used`: the
        # reference's reverse-segment accumulation writes one row past the
        # reported size (meth_profile.c:56 `mc = mem + 1` with orig_pos up
        # to max_pos), and that row becomes visible if a longer template
        # later grows the vector. We reproduce that by keeping the write
        # and only reporting rows < meth_profile_used.
        self.meth_profile = np.zeros((0, 4), dtype=np.int64)
        self.meth_profile_used = 0

    def grow_meth_profile(self, n: int):
        """Ensure capacity for rows 0..n (inclusive) and set used = n."""
        self.meth_profile_used = max(self.meth_profile_used, n)
        if n + 1 > len(self.meth_profile):
            pad = np.zeros(
                (n + 1 - len(self.meth_profile), 4), dtype=np.int64
            )
            self.meth_profile = np.concatenate([self.meth_profile, pad])

    def merge(self, other: "BsStats"):
        """Elementwise merge for multi-shard runs (the psum analogue)."""
        for a in (
            "snps",
            "indels",
            "multi",
            "dbSNP_sites",
            "dbSNP_var",
            "CpG_ref",
            "CpG_nonref",
        ):
            mine = getattr(self, a)
            theirs = getattr(other, a)
            for i in range(2):
                mine[i] += theirs[i]
        for a in (
            "mut_counts",
            "dbSNP_mut_counts",
            "qual",
            "filter_cts",
            "filter_bases",
            "base_filter",
            "filter_counts",
            "CpG_ref_meth",
            "CpG_nonref_meth",
        ):
            setattr(self, a, getattr(self, a) + getattr(other, a))
        for cov, cs in other.cov_stats.items():
            mine = self.cov_stats[cov]
            mine.all += cs.all
            mine.var += cs.var
            for i in range(2):
                mine.CpG[i] += cs.CpG[i]
                mine.CpG_inf[i] += cs.CpG_inf[i]
            mine.gc_pcent = mine.gc_pcent + cs.gc_pcent
        for a in ("fs_stats", "qd_stats", "mq_stats"):
            mine = getattr(self, a)
            for k, v in getattr(other, a).items():
                mine[k][0] += v[0]
                mine[k][1] += v[1]
        if len(other.meth_profile):
            self.grow_meth_profile(
                max(other.meth_profile_used, len(other.meth_profile) - 1)
            )
            self.meth_profile[: len(other.meth_profile)] += (
                other.meth_profile
            )
            self.meth_profile_used = max(
                self.meth_profile_used, other.meth_profile_used
            )
