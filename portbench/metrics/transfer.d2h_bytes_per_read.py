"""Bytes the engine copies back to the host (`Tracer` count `d2h_bytes`), per input record."""


def read(ctx):
    n = ctx["counts"].get("d2h_bytes")
    if n is None or not ctx["mreads"]:
        return None
    return n / (ctx["mreads"] * 1e6)
