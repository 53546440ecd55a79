"""Seconds the caller waits on the emit worker (a full emit queue, or the end of a pass; `Tracer` stage `emit.backlog`), per million input records: how far the emitter sets the pace."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "emit.backlog")
