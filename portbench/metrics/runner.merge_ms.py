"""Runner layer: device ms of ``runner.merge`` (the restarted rows of the
carry and the outputs taken from the bootstrap), mean a restart step (the
count of ``runner.restart``). Read under the profiler from the port's own
spans (``portbench/spans.py``)."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "runner.merge", "runner.restart")
