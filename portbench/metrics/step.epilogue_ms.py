"""Step layer: device ms of ``step.epilogue`` (sigmoid, flow rotation and
the top-64 vote NMS) over the count of ``runner.call``: a restart step runs
it twice. Read under the profiler from the port's own spans
(``portbench/spans.py``)."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "step.epilogue", "runner.call")
