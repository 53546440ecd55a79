"""Per-stage timing, throughput counters and spans.

The reference has no tracing beyond stderr progress lines (SURVEY §5);
here every run can report where its wall time went: ingest (native block
production), calling (device batches + rescue), emission (formatting +
stats), each split into the stages inside it. `-v` prints the stage sums
and the counters; `--trace-file PATH` also keeps every span and writes
them as Chrome trace JSON (`write_chrome_trace`); both are also usable
programmatically (`cli.main(argv, tracer=...)`)."""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict

_clock = time.perf_counter_ns


class _Stage:
    """One entry of a stage with spans off: adds its inclusive seconds to
    `times[name]` on exit. `block` is settable (and ignored)."""

    __slots__ = ("times", "name", "block", "t0")

    def __init__(self, times, name, block):
        self.times = times
        self.name = name
        self.block = block

    def __enter__(self):
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.times[self.name] += (_clock() - self.t0) / 1e9
        return False


class _Span:
    """One entry of a stage with spans on: `_Stage`'s sum, and the span
    kept as (name, thread id, start ns, end ns, parent id, block). `block`
    may be set inside the span (the producer learns a block's id only when
    the block arrives); unset, it is the enclosing span's."""

    __slots__ = ("tracer", "name", "block", "t0", "id", "parent")

    def __init__(self, tracer, name, block):
        self.tracer = tracer
        self.name = name
        self.block = block

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        if self.block is None and self.parent is not None:
            self.block = self.parent.block
        self.id = next(tr._ids)
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        tr = self.tracer
        tr._local.stack.pop()
        tr.times[self.name] += (t1 - self.t0) / 1e9
        tr._spans[self.id] = (
            self.name, threading.get_ident(), self.t0, t1,
            -1 if self.parent is None else self.parent.id, self.block,
        )
        return False


class Tracer:
    """Stage seconds (`times`) and counters (`counts`), kept whether or
    not the tracer is enabled; `enabled` (-v) prints progress lines and
    `report`. With `spans=True` every stage entry is also kept as a span
    (`spans`), on `time.perf_counter_ns`.

    `stage(name, block=None)` is a context manager: the stages nest, and
    a stage's time is inclusive of the stages inside it. Each stage name
    is timed on one thread only (the sums take no lock). `block` tags the
    span with the id of the block it works on; spans inside it inherit
    the id."""

    def __init__(self, enabled: bool = False, spans: bool = False):
        self.enabled = enabled
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self._t0 = time.perf_counter()
        # spans: id -> span, filled as each span ends; thread names by id
        self._spans = {} if spans else None
        self._threads = {}
        self._ids = itertools.count()
        self._local = threading.local()

    def stage(self, name: str, block=None):
        if self._spans is None:
            return _Stage(self.times, name, block)
        return _Span(self, name, block)

    def _stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._threads[threading.get_ident()] = (
                threading.current_thread().name)
            self._local.stack = []
            return self._local.stack

    @property
    def spans(self):
        """The ended spans in the order they began, each (name, thread
        id, start ns, end ns, parent, block): `parent` is the index in
        this list of the innermost span open on the same thread when it
        began, or -1; `block` the block id or None. None when the tracer
        keeps no spans."""
        if self._spans is None:
            return None
        ids = sorted(self._spans)
        at = {i: k for k, i in enumerate(ids)}
        return [(n, tid, s, e, at.get(p, -1), b)
                for n, tid, s, e, p, b in map(self._spans.get, ids)]

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
            print(f"  {name:<14} {t:8.2f}s  {100*t/max(wall,1e-9):5.1f}%",
                  file=f)
        for name in sorted(self.counts):
            n = self.counts[name]
            line = f"  {name:<14} {n:>12}"
            if wall > 0:
                line += f"  ({n/wall:,.0f}/s)"
            print(line, file=f)

    def write_chrome_trace(self, path: str) -> None:
        """The spans as Chrome trace JSON (Perfetto, chrome://tracing):
        one complete ("X") event a span, microseconds on perf_counter,
        one track a thread (tids numbered from 1 in the order the threads
        first opened a span, named by thread-name metadata), the span's
        `block` and `parent` (an index into the X events) in `args`."""
        spans = self.spans or []
        pid = os.getpid()
        tids = {}
        for _n, tid, *_ in spans:
            tids.setdefault(tid, len(tids) + 1)
        events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": k,
                   "args": {"name": self._threads.get(tid, str(tid))}}
                  for tid, k in tids.items()]
        events += [{"name": n, "ph": "X", "pid": pid, "tid": tids[tid],
                    "ts": s / 1e3, "dur": (e - s) / 1e3,
                    "args": {"block": b, "parent": p}}
                   for n, tid, s, e, p, b in spans]
        # dumps, not dump: only the one-shot encoder is the C one
        doc = json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})
        with open(path, "w") as f:
            f.write(doc)


class _NullStage:
    __slots__ = ("block",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NullTracer(Tracer):
    """Times, counts and keeps nothing: the tracer of code run without
    one."""

    _STAGE = _NullStage()

    def stage(self, name: str, block=None):
        return self._STAGE

    def count(self, name: str, n: int = 1):
        pass


NULL_TRACER = _NullTracer()
