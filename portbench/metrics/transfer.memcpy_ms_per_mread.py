"""Device milliseconds of copies between host and card (CUPTI memcpy records) over the window, per million input records."""


def read(ctx):
    t = ctx["trace"].seconds_matching(lambda n: n.startswith("Memcpy"))
    if t <= 0 or not ctx["mreads"]:
        return None
    return 1e3 * t / ctx["mreads"]
