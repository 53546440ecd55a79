"""Seconds of the vector emitter's record formatting and write (the native BCF formatter; `Tracer` stage `emit.format`), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "emit.format")
