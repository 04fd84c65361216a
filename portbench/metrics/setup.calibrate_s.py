"""Set-up: host seconds of ``serve.calibrate``, the port's int8c
calibration while the runner is built (recorded whether tracing is on or
not; reported in the ``--trace 1`` run). From the port's own spans
(``portbench/spans.py``)."""

from portbench.spans import snapshot


def read(ctx):
    snap = snapshot(ctx)
    span = None if snap is None else snap["spans"].get("serve.calibrate")
    return None if span is None else span["host_s"]
