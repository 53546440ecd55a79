"""Seconds a job spends outside its blocks: opening (reader, indexes, engine, output, native pipeline; `Tracer` stage `job.open`), closing (flush, `finalize_stats`; `job.close`) and writing the report (`job.report`, absent in a job without one), per pass."""


def read(ctx):
    times = ctx["times"]
    if "job.open" not in times or not ctx["passes"]:
        return None
    t = sum(times.get(s, 0.0) for s in ("job.open", "job.close",
                                        "job.report"))
    return t / ctx["passes"]
