"""Seconds of the fused call's copies back to the host, the wait for K12 and K3 included (`Tracer` stage `call.d2h`), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "call.d2h")
