"""Seconds the native producer spends in `NativePipeline.next_block_meta` (the C++ `bsp_next_block`: reading and staging the next block; `Tracer` stage `ingest.native`), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "ingest.native")
