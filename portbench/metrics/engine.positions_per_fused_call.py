"""Covered positions a fused-tier call carried (`Tracer` counts `tier_fused` / `fused_chunks`): useful work a fixed-width K12 + K3 launch."""


def read(ctx):
    n = ctx["counts"].get("fused_chunks", 0)
    if not n:
        return None
    return ctx["counts"].get("tier_fused", 0) / n
