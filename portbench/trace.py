"""The traced run's device timeline, from `torch.profiler` (CUPTI): time
by device operation, the union of busy intervals, and the idle gaps,
each labelled by the harness's host spans open during it."""

from __future__ import annotations

import time
from collections import defaultdict


def _device_events(prof):
    """[(name, start ns, end ns)] of the operations that ran on a card
    (kernels, copies, sets), and {name: [start ns]} of host events. The
    profiler also draws each `record_function` range on the card's
    timeline; those carry a host event's name and are left out."""
    dev, host = [], defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if str(e.device_type()).endswith("CUDA"):
            dev.append((e.name(), s, s + e.duration_ns()))
        else:
            host[e.name()].append(s)
    dev = [d for d in dev if d[0] not in host]
    return dev, host


def kernel_seconds(prof) -> float:
    """Seconds of every kernel (not a copy or a set) that a stopped profiler
    saw on a card. For a profiler started just before the window and stopped
    once the card has finished the window's work, so that every kernel it
    saw lies in the window."""
    dev, _host = _device_events(prof)
    return sum(e - s for n, s, e in dev
               if not n.startswith(("Memcpy", "Memset"))) / 1e9


class Anchor:
    """Ties the host's perf_counter clock to the profiler's: a named
    `record_function` range whose start the profiler records, at a host
    time this object records."""

    NAME = "portbench.anchor"

    def __init__(self):
        self.host_ns = []

    def mark(self):
        from torch.profiler import record_function

        with record_function(self.NAME):
            self.host_ns.append(time.perf_counter_ns())


class DeviceTrace:
    def __init__(self, prof, anchor: Anchor, spans, t0_ns: int, t1_ns: int):
        """`prof` stopped; `spans` the harness's host spans; [t0_ns,
        t1_ns) the traced window on the host's perf_counter clock."""
        dev, host = _device_events(prof)
        marks = sorted(host.get(Anchor.NAME, []))
        if len(marks) != len(anchor.host_ns) or not marks:
            raise RuntimeError("profiler lost the clock anchors")
        off = sum(m - h for m, h in zip(marks, sorted(anchor.host_ns))
                  ) // len(marks)
        lo, hi = t0_ns + off, t1_ns + off
        self.window_s = (t1_ns - t0_ns) / 1e9
        self.ops = [(n, max(s, lo), min(e, hi)) for n, s, e in dev
                    if e > lo and s < hi]
        self.spans = [(n, tid, s + off, e + off) for n, tid, s, e in spans]
        self.lo, self.hi = lo, hi

    def seconds_by_name(self) -> dict:
        out = defaultdict(float)
        for n, s, e in self.ops:
            out[n] += (e - s) / 1e9
        return dict(out)

    def seconds_matching(self, pred) -> float:
        return sum((e - s) / 1e9 for n, s, e in self.ops if pred(n))

    def busy_intervals(self):
        out = []
        for _n, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self):
        """[(start ns, end ns)] of the window when nothing ran on the
        card."""
        gaps, t = [], self.lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.hi > t:
            gaps.append((t, self.hi))
        return gaps

    def label(self, t_ns: int) -> str:
        """The host spans open at `t_ns`, innermost a thread, by name."""
        open_by_thread = {}
        for n, tid, s, e in self.spans:
            if s <= t_ns < e:
                cur = open_by_thread.get(tid)
                if cur is None or s > cur[0]:
                    open_by_thread[tid] = (s, n)
        names = sorted({n for _s, n in open_by_thread.values()})
        return " + ".join(names) if names else "outside every span"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[self.label((s + e) // 2), (e - s) / 1e9]
                          for s, e in gaps],
        }
