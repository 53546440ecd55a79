"""Seconds of the fused call's copies to the device (`Tracer` stage `call.h2d`), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "call.h2d")
