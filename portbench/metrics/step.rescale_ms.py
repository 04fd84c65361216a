"""Step layer: device ms of ``step.rescale`` (the int8c bootstrap's
features rescaled to the carry's scale), mean a bootstrap (its own count).
Read under the profiler from the port's own spans
(``portbench/spans.py``)."""

from portbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "step.rescale", "step.rescale")
