"""Runner layer: host clock around the runner call, before the outputs'
copy and the synchronize, mean a step, in ms, over the steps of the
``--trace 1`` run's window outside its profiled slice. Where it nears the
step's time, the host sets the pace."""


def read(ctx):
    t = [r[1] for r in ctx["records"] if not r[3]]
    return 1e3 * sum(t) / len(t) if t else None
