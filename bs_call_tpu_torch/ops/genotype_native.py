"""The host's thread budget, at the JAX package's module path.

`bs_call_tpu.ops.genotype_native` wraps the native f64 model
(bsc_model.cpp) and sizes every native thread pool with `_n_threads`.
This package calls its model on the device, so it keeps only the thread
budget: this process's CPU affinity, so that a process pinned to a few
cores does not oversubscribe them.
"""

from __future__ import annotations

import os


def _n_threads() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1
