"""Runner layer: host ms of ``runner.merge``, mean a restart step (the
count of ``runner.restart``): a blocking copy of the merge's mask to the
card shows here as the host waiting. Read under the profiler from the
port's own spans (``portbench/spans.py``)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, ("runner.merge",), "runner.restart")
