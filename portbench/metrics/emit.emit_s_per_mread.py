"""Seconds the emit worker spent formatting and writing (`Tracer` stage `emit`: the vector emitter, the BCF formatter, the stats), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "emit")
