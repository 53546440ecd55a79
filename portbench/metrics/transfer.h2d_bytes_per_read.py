"""Bytes the engine copies to the device (`Tracer` count `h2d_bytes`), per input record."""


def read(ctx):
    n = ctx["counts"].get("h2d_bytes")
    if n is None or not ctx["mreads"]:
        return None
    return n / (ctx["mreads"] * 1e6)
