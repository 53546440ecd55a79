"""Native emit-side stats accumulator (bsc_stats.cpp StatsAcc).

One C++ pass per emitted-row batch replaces the ~30 numpy kernels of
VectorBlockEmitter._accumulate_stats — the native twin of the
reference's inline printer-thread accumulation (print_vcf.c:382-526).
Counters accumulate in an unordered_map/array store inside the handle;
merge_into() folds them into the Python BsStats once at end of run, so
shard pickling, the multi-host psum and the report writer all see the
usual structures. Set BS_CALL_PY_STATS=1 to force the numpy path (used
by the parity tests)."""

from __future__ import annotations

import ctypes
import os

import numpy as np


def _i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeStatsAcc:
    """Handle wrapper; create via NativeStatsAcc.create() (None when the
    native library is unavailable or BS_CALL_PY_STATS is set)."""

    @classmethod
    def create(cls, quirks=True):
        if os.environ.get("BS_CALL_PY_STATS"):
            return None
        try:
            from bs_call_tpu_torch.native import load

            lib = load()
            if lib is None or not hasattr(lib, "bsc_stats_acc_new"):
                return None
            return cls(lib, quirks=quirks)
        except Exception:
            return None

    def __init__(self, lib, quirks=True):
        from bs_call_tpu_torch.constants import logp_table
        from bs_call_tpu_torch.output.vector_site import (
            GT_HET_A, MUT_A, variant_gate_luts,
        )

        self._lib = lib
        is_var, is_multi = variant_gate_luts(quirks)
        het = np.ascontiguousarray(GT_HET_A, dtype=np.uint8)
        isvar = np.ascontiguousarray(is_var, dtype=np.uint8)
        ismulti = np.ascontiguousarray(is_multi, dtype=np.uint8)
        mut = np.ascontiguousarray(MUT_A, dtype=np.int32)
        plus = np.zeros(10, dtype=np.uint8)
        plus[[1, 4, 6]] = 1  # CS_STR == '+' genotypes
        minus = np.zeros(10, dtype=np.uint8)
        minus[[2, 7, 8]] = 1  # CS_STR == '-'
        logp = np.ascontiguousarray(logp_table(), dtype=np.float64)
        self._h = lib.bsc_stats_acc_new(
            _u8(het), _u8(isvar), _u8(ismulti), _i32(mut), _u8(plus),
            _u8(minus), _f64(logp),
        )
        self._gc_cache = (None, None)  # (id(bins), uint8 view)

    def close(self):
        if self._h:
            self._lib.bsc_stats_acc_free(ctypes.c_void_p(self._h))
            self._h = None

    def accumulate(self, lag, ctg, soa, pos, reach, idx, g, r, rf7,
                   phred, qd, fs_int, mq, flt, mac1, counts, cond_cg,
                   rs_present):
        """Mirror of _accumulate_stats' inputs; updates the emitter's
        CpG carry state (`lag`'s prev_cpg_x/prev_cpg_flt) like the numpy
        path."""
        h = ctypes.c_void_p(self._h)
        lib = self._lib
        pos = np.ascontiguousarray(pos, dtype=np.int64)
        if reach.any():
            call = np.ascontiguousarray(soa["counts"], dtype=np.int32)
            rch = np.ascontiguousarray(reach, dtype=np.uint8)
            ctg_stats = ctg.ctg_stats
            bins = ctg_stats.gc if ctg_stats is not None else None
            if bins is not None and len(bins):
                key = id(bins)
                if self._gc_cache[0] != key:
                    self._gc_cache = (
                        key, np.ascontiguousarray(bins, dtype=np.uint8)
                    )
                gbins = self._gc_cache[1]
                gp, glen = _u8(gbins), len(gbins)
            else:
                gp, glen = None, 0
            lib.bsc_stats_acc_cov(
                h, len(rch), _i32(call), _u8(rch), _i64(pos), gp, glen,
                int(getattr(ctg, "gc_start_pos", 1)),
            )
        n = len(idx)
        if n == 0:
            return True
        pos_e = np.ascontiguousarray(pos[idx])
        g32 = np.ascontiguousarray(g, dtype=np.int32)
        r32 = np.ascontiguousarray(r, dtype=np.int32)
        ph32 = np.ascontiguousarray(phred, dtype=np.int32)
        qd32 = np.ascontiguousarray(qd, dtype=np.int32)
        fs64 = np.ascontiguousarray(fs_int, dtype=np.int64)
        mq32 = np.ascontiguousarray(mq, dtype=np.int32)
        fltf = np.ascontiguousarray(
            np.asarray(flt, dtype=np.int32) | np.where(mac1, 128, 0),
            dtype=np.int32,
        )
        cnt = np.ascontiguousarray(counts, dtype=np.int32)
        cg8 = np.ascontiguousarray(cond_cg, dtype=np.uint8)
        rsp = (
            np.ascontiguousarray(rs_present[idx], dtype=np.uint8)
            if rs_present is not None
            else np.zeros(n, dtype=np.uint8)
        )
        rf3 = np.ascontiguousarray(rf7[idx, 1:4], dtype=np.int32)
        px = ctypes.c_int64(int(lag.prev_cpg_x))
        pf = ctypes.c_uint8(1 if lag.prev_cpg_flt else 0)
        lib.bsc_stats_acc_rows(
            h, n, int(ctg.bam_tid), _i64(pos_e), _i32(g32), _i32(r32),
            _i32(ph32), _i32(qd32), _i64(fs64), _i32(mq32), _i32(fltf),
            _i32(cnt), _u8(cg8), _u8(rsp), _i32(rf3),
            ctypes.byref(px), ctypes.byref(pf),
        )
        lag.prev_cpg_x = int(px.value)
        lag.prev_cpg_flt = bool(pf.value)
        return True

    def merge_into(self, stats, table) -> None:
        """Fold the native counters into BsStats + per-contig CtgStats
        (id = bam_tid), then free the handle."""
        if not self._h:
            return
        h = ctypes.c_void_p(self._h)
        lib = self._lib
        qual = np.zeros((4, 256), dtype=np.int64)
        fcounts = np.zeros((2, 32), dtype=np.int64)
        meth = np.zeros((2, 2, 101), dtype=np.float64)
        mut = np.zeros((12, 2), dtype=np.int64)
        dmut = np.zeros((12, 2), dtype=np.int64)
        pairs = np.zeros((6, 2), dtype=np.int64)
        lib.bsc_stats_acc_fixed(
            h, _i64(qual), _i64(fcounts), _f64(meth), _i64(mut),
            _i64(dmut), _i64(pairs),
        )
        stats.qual += qual
        stats.filter_counts += fcounts
        stats.CpG_ref_meth += meth[0]
        stats.CpG_nonref_meth += meth[1]
        stats.mut_counts += mut
        stats.dbSNP_mut_counts += dmut
        for row, name in enumerate(
            ("snps", "multi", "dbSNP_sites", "dbSNP_var", "CpG_ref",
             "CpG_nonref")
        ):
            tgt = getattr(stats, name)
            tgt[0] += int(pairs[row, 0])
            tgt[1] += int(pairs[row, 1])
        nc = lib.bsc_stats_acc_cov_size(h)
        if nc:
            keys = np.zeros(nc, dtype=np.int64)
            allv = np.zeros(nc, dtype=np.int64)
            var = np.zeros(nc, dtype=np.int64)
            cpg = np.zeros((nc, 2), dtype=np.int64)
            cpg_inf = np.zeros((nc, 2), dtype=np.int64)
            gc = np.zeros((nc, 101), dtype=np.int64)
            lib.bsc_stats_acc_cov_dump(
                h, _i64(keys), _i64(allv), _i64(var), _i64(cpg),
                _i64(cpg_inf), _i64(gc),
            )
            for i in range(nc):
                cs = stats.cov_stats[int(keys[i])]
                cs.all += int(allv[i])
                cs.var += int(var[i])
                cs.CpG[0] += int(cpg[i, 0])
                cs.CpG[1] += int(cpg[i, 1])
                cs.CpG_inf[0] += int(cpg_inf[i, 0])
                cs.CpG_inf[1] += int(cpg_inf[i, 1])
                cs.gc_pcent += gc[i]
        for which, name in ((0, "fs_stats"), (1, "qd_stats"),
                            (2, "mq_stats")):
            nm = lib.bsc_stats_acc_map_size(h, which)
            if not nm:
                continue
            keys = np.zeros(nm, dtype=np.int64)
            vals = np.zeros((nm, 2), dtype=np.int64)
            lib.bsc_stats_acc_map_dump(h, which, _i64(keys), _i64(vals))
            dct = getattr(stats, name)
            for i in range(nm):
                e = dct[int(keys[i])]
                e[0] += int(vals[i, 0])
                e[1] += int(vals[i, 1])
        nctg = lib.bsc_stats_acc_nctg(h)
        if nctg:
            ids = np.zeros(nctg, dtype=np.int64)
            cp = np.zeros((nctg, 6, 2), dtype=np.int64)
            lib.bsc_stats_acc_ctg_dump(h, _i64(ids), _i64(cp))
            by_tid = {c.bam_tid: c for c in table.contigs}
            for i in range(nctg):
                c = by_tid.get(int(ids[i]))
                cst = c.ctg_stats if c is not None else None
                if cst is None:
                    continue
                for row, name in enumerate(
                    ("snps", "multi", "dbSNP_sites", "dbSNP_var",
                     "CpG_ref", "CpG_nonref")
                ):
                    tgt = getattr(cst, name)
                    tgt[0] += int(cp[i, row, 0])
                    tgt[1] += int(cp[i, row, 1])
        self.close()
