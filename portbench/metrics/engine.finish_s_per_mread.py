"""Seconds of the engine's host work after the device (quals check, unpacking, `_finish_exact` and its rescue, risk bands, host Fisher test; `Tracer` stage `call.finish`), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "call.finish")
