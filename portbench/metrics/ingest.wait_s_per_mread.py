"""Seconds the caller thread waited for the native producer's next block (`Tracer` stage `ingest`), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "ingest")
