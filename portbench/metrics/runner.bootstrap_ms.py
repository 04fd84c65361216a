"""Runner layer: device ms of ``runner.bootstrap`` (the bootstrap pass of
the restarted streams' rows, enqueued after the carried pass, in a step
that restarts a stream), mean a restart step (the count of
``runner.restart``). Read under the profiler from the port's own spans
(``portbench/spans.py``)."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "runner.bootstrap", "runner.restart")
