"""Per-stage timing and throughput counters.

The reference has no tracing beyond stderr progress lines (SURVEY §5);
here every run can report where its wall time went: ingest (native block
production), calling (device batches + rescue), emission (formatting +
stats). Enabled by -v/--verbose; also usable programmatically."""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from contextlib import contextmanager


class Tracer:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t

    def count(self, name: str, n: int = 1):
        self.counts[name] += n

    def progress(self, msg: str):
        if self.enabled:
            print(msg, file=sys.stderr)

    def report(self, fileobj=None):
        if not self.enabled:
            return
        f = fileobj or sys.stderr
        wall = time.perf_counter() - self._t0
        print(f"--- bs_call_tpu_torch timings (wall {wall:.2f}s) ---", file=f)
        for name in sorted(self.times, key=lambda k: -self.times[k]):
            t = self.times[name]
            print(f"  {name:<12} {t:8.2f}s  {100*t/max(wall,1e-9):5.1f}%",
                  file=f)
        for name in sorted(self.counts):
            n = self.counts[name]
            line = f"  {name:<12} {n:>12}"
            if wall > 0:
                line += f"  ({n/wall:,.0f}/s)"
            print(line, file=f)


NULL_TRACER = Tracer(enabled=False)
