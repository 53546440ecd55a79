"""Host row engine wrapper (bsc_rowengine.cpp).

The whole-block host path of `--device numpy`: pileup -> aggregate ->
f64 model -> Fisher -> emit prep -> stats -> formatted VCF text runs as
three native calls per staged block, with Python only orchestrating
threads and resolving likelihood ties through the scalar oracle (the tie
authority, the `_finish_exact` contract). Output bytes are identical to
the vector-emitter path (output/vector_site.py), which remains the
behavioral reference; tests/test_torch_rowengine.py pins the parity.
"""

from __future__ import annotations

import ctypes

import numpy as np

from bs_call_tpu_torch.constants import GT_HET
from bs_call_tpu_torch.native import load
from bs_call_tpu_torch.ops import oracle
from bs_call_tpu_torch.ops.genotype_native import _n_threads, native_model
from bs_call_tpu_torch.ops.postprocess import _FTAB_MASK_A, _FTAB_MASK_B
from bs_call_tpu_torch.output import vector_site as vs

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _P(a, tp):
    return a.ctypes.data_as(tp)


class HostRowEngine:
    """One per run. Not thread-safe per slot: the runner's producer /
    main / emit threads each own a disjoint phase (load / model / emit)
    of any given slot at a time. Raises when the native library, the
    native model or the engine itself cannot be built."""

    N_SLOTS = 4

    def __init__(self, cfg, stats_acc=None):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        model = native_model(cfg.under_conv, cfg.over_conv, cfg.ref_bias)
        if model is None:
            raise RuntimeError("native model unavailable")
        self._lib = lib
        self._h = None
        self._model = model  # keep alive: bsre holds its raw handle
        self._cfg = cfg
        self._stats_acc = stats_acc  # NativeStatsAcc or None
        # LUT staging (kept alive for the bsre_new copy)
        gt_flag = np.ascontiguousarray(vs.GT_FLAG_A, dtype=np.uint8)
        fma = np.ascontiguousarray(_FTAB_MASK_A, dtype=np.uint8)
        fmb = np.ascontiguousarray(_FTAB_MASK_B, dtype=np.uint8)
        het_mask = np.ascontiguousarray(GT_HET, dtype=np.uint8)
        iupac = vs.IUPAC_B.tobytes()[:11]
        self._h = lib.bsre_new(
            ctypes.c_void_p(model._h),
            ctypes.c_void_p(stats_acc._h if stats_acc else None),
            ctypes.c_int(_n_threads()),
            ctypes.c_int(1 if cfg.all_positions else 0),
            ctypes.c_int(1 if cfg.reference_quirks else 0),
            ctypes.c_void_p(vs._GL_IDX_C.ctypes.data),
            ctypes.c_void_p(vs._GL_LEN_C.ctypes.data),
            ctypes.c_void_p(vs._HET_U8.ctypes.data),
            ctypes.c_void_p(vs._CFLAG_U8.ctypes.data),
            ctypes.c_void_p(vs._GFLAG_U8.ctypes.data),
            ctypes.c_void_p(gt_flag.ctypes.data),
            ctypes.c_void_p(fma.ctypes.data),
            ctypes.c_void_p(fmb.ctypes.data),
            ctypes.c_void_p(het_mask.ctypes.data),
            ctypes.c_char_p(vs._GT_LUT),
            ctypes.c_char_p(vs._ALT_LUT),
            ctypes.c_char_p(vs._CS_LUT),
            ctypes.c_char_p(vs._FT_LUT),
            ctypes.c_void_p(vs._FT_LEN.ctypes.data),
            ctypes.c_char_p(vs._PBASE_B5),
            ctypes.c_char_p(iupac),
            ctypes.c_int(self.N_SLOTS),
        )
        if not self._h:
            raise RuntimeError("bsre_new failed")
        self._out = np.empty(1 << 24, dtype=np.uint8)  # grows on demand
        self._gc_keep = None

    def close(self):
        h, self._h = self._h, None
        if h:
            self._lib.bsre_free(ctypes.c_void_p(h))

    def abandon(self):
        """Drop the handle without freeing it: a thread that never came
        back from a native call may still be using it."""
        self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def load(self, slot: int, npipe, x: int, y: int, refw) -> None:
        """Pileup+aggregate the pipeline's staged block into `slot`.
        Must run before the pipeline advances (producer thread)."""
        refw = np.ascontiguousarray(refw, dtype=np.uint8)
        self._lib.bsre_load(
            ctypes.c_void_p(self._h), ctypes.c_int32(slot),
            ctypes.c_void_p(npipe._h), ctypes.c_int64(x),
            ctypes.c_int64(y), _P(refw, _u8p),
            ctypes.c_int64(len(refw)),
        )

    def model(self, slot: int) -> int:
        """f64 model + C-style finish; resolves ties via the oracle.
        Returns the number of tied rows the oracle replaced."""
        n_ties = self._lib.bsre_model(
            ctypes.c_void_p(self._h), ctypes.c_int32(slot)
        )
        if not n_ties:
            return 0
        idx = np.empty(n_ties, np.int64)
        c8 = np.empty((n_ties, 8), np.int32)
        q8 = np.empty((n_ties, 8), np.int32)
        rf = np.empty(n_ties, np.int32)
        self._lib.bsre_ties(
            ctypes.c_void_p(self._h), ctypes.c_int32(slot),
            _P(idx, _i64p), _P(c8, _i32p), _P(q8, _i32p), _P(rf, _i32p),
        )
        gp = np.empty((n_ties, 10), np.float64)
        mg = np.empty(n_ties, np.int32)
        cfg = self._cfg
        for j in range(n_ties):
            gp[j], mg[j] = oracle.calc_gt_prob(
                c8[j], q8[j], int(rf[j]), cfg.under_conv,
                cfg.over_conv, cfg.ref_bias,
            )
        self._lib.bsre_fix(
            ctypes.c_void_p(self._h), ctypes.c_int32(slot),
            ctypes.c_int64(n_ties), _P(idx, _i64p), _P(gp, _f64p),
            _P(mg, _i32p),
        )
        return int(n_ties)

    def emit(self, slot: int, lag, ctg, hold_back: int,
             collect_stats: bool, fileobj) -> None:
        """Format + write one block; carries the run's dedup / CpG state
        (`lag`, an `output.site.LagState`) exactly like
        VectorBlockEmitter.emit_block."""
        if lag.old_ctg is not ctg:
            lag.old_ctg = ctg
            lag.old_x = 0
        gc_p, gc_len = None, 0
        ctg_stats = getattr(ctg, "ctg_stats", None)
        if collect_stats and ctg_stats is not None and \
                ctg_stats.gc is not None and len(ctg_stats.gc):
            gc = np.ascontiguousarray(ctg_stats.gc, dtype=np.uint8)
            self._gc_keep = gc
            gc_p, gc_len = _P(gc, _u8p), len(gc)
        old_x = ctypes.c_int64(int(lag.old_x))
        pcx = ctypes.c_int64(int(lag.prev_cpg_x))
        pcf = ctypes.c_uint8(1 if lag.prev_cpg_flt else 0)
        while True:
            n = self._lib.bsre_emit(
                ctypes.c_void_p(self._h), ctypes.c_int32(slot),
                ctg.name.encode(), ctypes.c_int32(ctg.bam_tid),
                ctypes.c_int64(ctg.seq_len), ctypes.c_int64(hold_back),
                ctypes.c_int32(1 if collect_stats else 0),
                gc_p, ctypes.c_int64(gc_len),
                ctypes.c_int64(int(getattr(ctg, "gc_start_pos", 1))),
                ctypes.byref(old_x), ctypes.byref(pcx),
                ctypes.byref(pcf),
                ctypes.c_void_p(self._out.ctypes.data),
                ctypes.c_int64(len(self._out)),
            )
            if n >= 0:
                break
            self._out = np.empty(len(self._out) * 2, dtype=np.uint8)
        lag.old_x = int(old_x.value)
        lag.prev_cpg_x = int(pcx.value)
        lag.prev_cpg_flt = bool(pcf.value)
        if n:
            fileobj.write(memoryview(self._out.data)[:n])
