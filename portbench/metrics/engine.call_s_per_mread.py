"""Seconds in `TorchCallEngine.call_block_soa` (`Tracer` stage `call`: batch preparation, H2D, K12 and K3, D2H, `_finish_exact`), per million input records."""

from portbench.metrics._stage import per_mread


def read(ctx):
    return per_mread(ctx, "call")
