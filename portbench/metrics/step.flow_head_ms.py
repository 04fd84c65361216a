"""Step layer: device ms of ``step.flow_head`` (the bf16 flow head in plain
torch) over the count of ``runner.call``: a restart step runs it twice.
Read under the profiler from the port's own spans
(``portbench/spans.py``)."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "step.flow_head", "runner.call")
