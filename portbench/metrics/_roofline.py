"""Shared by the `<kernel>_roofline` readers: a kernel's share of its
roofline over the window. The least time is the larger of the bytes over
the card's memory bandwidth and the operations over its peak rate (the
benchmark's own counts of one pass's work, `portbench/work/<kernel>.py`,
times the passes); the time is the kernel's device time in the trace."""

import importlib


def roofline_pct(ctx, kernel_module):
    work_mod = importlib.import_module("portbench.work." + kernel_module)
    peaks = ctx["peaks"]
    if peaks is None:
        return None
    t = ctx["trace"].seconds_matching(lambda n: work_mod.KERNEL in n)
    if t <= 0 or not ctx["passes"]:
        return None
    w = work_mod.work(ctx["pileup_input"])
    least = max(w["bytes"] / peaks["bytes_per_s"],
                w["flop"] / peaks[w["flop_kind"]]) * ctx["passes"]
    return 100.0 * least / t
