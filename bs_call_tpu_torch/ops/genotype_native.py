"""Native (C++/libm) float64 genotype model, and the host's thread budget.

`--device numpy` calls every covered position through this model: one
batched call into the port's copy of bsc_model.cpp, glibc libm
transcendentals (the same libm the reference binary links,
genotype_model.c:87-247). Math twins: `ops/genotype_np.py` (numpy,
vectorized; the model under BS_CALL_PY_MODEL=1) and `ops/oracle.py` (the
scalar parity anchor). The port's copy of `bs_call_tpu.ops.
genotype_native`, with one difference: where the JAX package falls back
to the numpy model when the native library does not load, `native_model`
raises.

Threading: the batch is split into contiguous ranges across C++ threads
(deterministic for any thread count); the thread count follows this
process's CPU affinity (`_n_threads`, which also sizes every native
thread pool), so shard workers pinned to a few cores do not
oversubscribe them.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from bs_call_tpu_torch.ops.tables import qual_tables, ref_prior_matrix

_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _n_threads() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


class NativeGtModel:
    """Owns one bsc_model handle for a fixed (under, over, ref_bias)."""

    def __init__(self, lib, under_conv: float, over_conv: float,
                 ref_bias: float):
        self._lib = lib
        qt = qual_tables(np.float64)
        prior = np.ascontiguousarray(
            ref_prior_matrix(ref_bias, np.float64)
        )
        # bsc_model_new copies the tables
        self._h = lib.bsc_model_new(
            len(qt.k),
            qt.k.ctypes.data_as(_f64p),
            qt.ln_k.ctypes.data_as(_f64p),
            qt.ln_k_half.ctypes.data_as(_f64p),
            qt.ln_k_one.ctypes.data_as(_f64p),
            prior.ctypes.data_as(_f64p),
            ctypes.c_double(under_conv),
            ctypes.c_double(over_conv),
        )

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            try:
                self._lib.bsc_model_free(h)
            except Exception:
                pass  # interpreter shutdown: ctypes may be gone already

    def call(self, counts, quals, ref):
        """counts [N,8] i32, quals [N,8] i32, ref [N] i32 ->
        (gt_prob [N,10] f64 log10, max_gt [N] i32, margin [N] f64,
        off_sum [N] f64): the `call_genotypes_np` contract (the argmax
        entry of gt_prob is -log1p(off)/LOG10; the engine's
        `_finish_exact` replaces it C-style)."""
        counts = np.ascontiguousarray(counts, dtype=np.int32)
        quals = np.ascontiguousarray(quals, dtype=np.int32)
        ref = np.ascontiguousarray(ref, dtype=np.int32)
        n = len(ref)
        gt_prob = np.empty((n, 10), dtype=np.float64)
        max_gt = np.empty(n, dtype=np.int32)
        margin = np.empty(n, dtype=np.float64)
        off_sum = np.empty(n, dtype=np.float64)
        if n:
            self._lib.bsc_model_call(
                self._h, n,
                counts.ctypes.data_as(_i32p),
                quals.ctypes.data_as(_i32p),
                ref.ctypes.data_as(_i32p),
                _n_threads(),
                gt_prob.ctypes.data_as(_f64p),
                max_gt.ctypes.data_as(_i32p),
                margin.ctypes.data_as(_f64p),
                off_sum.ctypes.data_as(_f64p),
            )
        return gt_prob, max_gt, margin, off_sum


_cache: dict = {}


def native_model(under_conv: float, over_conv: float, ref_bias: float):
    """Process-cached NativeGtModel, or None when BS_CALL_PY_MODEL=1 asks
    for the numpy model (the parity-test switch). Raises RuntimeError when
    the native library does not build or load: nothing falls back."""
    if os.environ.get("BS_CALL_PY_MODEL"):
        return None
    key = (under_conv, over_conv, ref_bias)
    if key not in _cache:
        from bs_call_tpu_torch import native

        lib = native.load()
        if lib is None:
            raise RuntimeError(
                "the native host library (bs_call_tpu_torch/native, g++) "
                "did not build or load: the host model has no library to "
                "run on; set BS_CALL_PY_MODEL=1 for the numpy model"
            )
        _cache[key] = NativeGtModel(lib, under_conv, over_conv, ref_bias)
    return _cache[key]
