"""Input records of the traced window's passes over the window, on the host's clock: the wall-time throughput, read per layer since its runs spread too widely on the card's host to hold it end to end."""


def read(ctx):
    if not ctx["mreads"] or ctx["window_s"] <= 0:
        return None
    return ctx["mreads"] * 1e6 / ctx["window_s"]
