"""Process CPU seconds (user + sys, all threads, `getrusage`) over the traced window, per million input records: the host's cost per read, read per layer since its runs spread too widely on the card's host to hold it end to end."""


def read(ctx):
    if not ctx["mreads"]:
        return None
    return ctx["cpu_s"] / ctx["mreads"]
