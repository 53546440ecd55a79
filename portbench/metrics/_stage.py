"""Shared by the stage readers: a `Tracer` stage's seconds, summed over
the window's passes, per million input records."""


def per_mread(ctx, stage):
    t = ctx["times"].get(stage)
    if t is None or not ctx["mreads"]:
        return None
    return t / ctx["mreads"]
