"""Seconds of the engine's host preparation of a call (covered rows, read batch padding, the tile table; `Tracer` stage `call.prep`), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "call.prep")
