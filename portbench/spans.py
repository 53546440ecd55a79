"""Host spans of the traced run, recorded by the harness around the
port's layer entry points (the job, the engine's block call, the vector
emitter's block entry, the native producer's next block), on whichever
thread runs them. Each span is also a `torch.profiler.record_function`
range, so it shows in the profiler's trace. Spans stay in memory; the
reader of the trace labels each idle gap on the device with the spans
open during it.

`install` patches the classes; `uninstall` puts them back. Nothing here
runs in an untraced run."""

from __future__ import annotations

import functools
import threading
import time

# (module, class or None, attribute, span name)
ENTRY_POINTS = (
    ("bs_call_tpu_torch.cli", None, "main", "job"),
    ("bs_call_tpu_torch.pipeline.engine", "TorchCallEngine",
     "call_block_soa", "engine.call_block_soa"),
    ("bs_call_tpu_torch.output.vector_site", "VectorBlockEmitter",
     "emit_block", "emit.emit_block"),
    ("bs_call_tpu_torch.native.pipeline", "NativePipeline",
     "next_block_meta", "ingest.next_block"),
    ("bs_call_tpu_torch.native.pipeline", "NativePipeline",
     "next_block", "ingest.next_block"),
)


class SpanRecorder:
    def __init__(self):
        self.spans = []  # (name, thread id, start ns, end ns)
        self._saved = []

    def wrap(self, fn, name):
        from torch.profiler import record_function

        spans = self.spans

        @functools.wraps(fn)
        def traced(*a, **k):
            t0 = time.perf_counter_ns()
            try:
                with record_function(name):
                    return fn(*a, **k)
            finally:
                spans.append((name, threading.get_ident(), t0,
                              time.perf_counter_ns()))

        return traced

    def install(self):
        import importlib

        for mod, cls, attr, name in ENTRY_POINTS:
            owner = importlib.import_module(mod)
            if cls is not None:
                owner = getattr(owner, cls)
            fn = owner.__dict__[attr]
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self.wrap(fn, name))

    def uninstall(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()
