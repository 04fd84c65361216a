"""Runner layer: the mean time of the steps that restart at least one
stream (the bootstrap of every row, the carried step and the merge of the
carries; host clock, as ``step_ms_p95``), in ms, outside the profiled
slice. None where no step restarted a stream."""


def read(ctx):
    t = [r[0] for r in ctx["records"] if r[2] and not r[3]]
    return 1e3 * sum(t) / len(t) if t else None
