"""Step layer: host ms inside ``step.cutout``, ``step.backbone``,
``step.gate`` and ``step.head`` (the kernels' wrappers and launches) over
the count of ``runner.call``; where it nears the kernels' device time the
card waits on the host (``device.idle_share``). Read under the profiler
from the port's own spans (``portbench/spans.py``)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, ("step.cutout", "step.backbone", "step.gate",
                         "step.head"), "runner.call")
