"""Seconds the native producer spends on the host pileup and aggregate of each block (`_collect_block`; `Tracer` stage `ingest.pileup`), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "ingest.pileup")
