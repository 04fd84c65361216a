"""Step layer: device time a step outside the configuration's kernels
(``kernels`` of its configuration file): the flow head, sigmoid, flow
rotation, NMS, the carries' merge and their glue, the copies, in ms, from
the profiled slice."""


def read(ctx):
    view = ctx["trace"]
    if view is None or view.total_s() <= 0.0:
        return None
    ours = [n for names in ctx["cfg"]["kernels"].values() for n in names]
    return 1e3 * (view.total_s() - view.time_s(ours)) / view.steps
