"""Seconds of the vector emitter's report statistics (`_accumulate_stats`; `Tracer` stage `emit.stats`), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "emit.stats")
