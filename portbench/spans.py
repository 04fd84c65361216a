"""What the port's own spans and counters (``planar_optical_flow_tpu_torch.
utils.tracing``) hold after a ``--trace 1`` run, for the metrics that read
them.

The recorder records the per-step spans while a profiler runs, so they
cover the harness's profiled set-up step and the window's profiled slice,
and their metrics divide by the recorder's own counts (of ``runner.call``,
``runner.restart``), not by the slice's length. Set-up spans record in
every run. Read under the profiler, a span metric compares only with its
own history. A program without the recorder, and a run without a device
trace, give None.
"""


def snapshot(ctx):
    """The recorder's totals (``tracing.snapshot()``), or None where the run
    has no device trace or the program no recorder."""
    if ctx.get("trace") is None:
        return None
    try:
        from planar_optical_flow_tpu_torch.utils import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    return snap if snap["spans"] or snap["counters"] else None


def device_ms(ctx, name, per):
    """Device ms of the spans ``name`` over the count of the spans ``per``."""
    snap = snapshot(ctx)
    if snap is None:
        return None
    span, base = snap["spans"].get(name), snap["spans"].get(per)
    if span is None or base is None or span["device_s"] is None:
        return None
    return 1e3 * span["device_s"] / base["count"]


def host_ms(ctx, names, per):
    """Host ms inside the spans ``names`` (disjoint) over the count of the
    spans ``per``."""
    snap = snapshot(ctx)
    if snap is None:
        return None
    spans, base = snap["spans"], snap["spans"].get(per)
    found = [spans[n]["host_s"] for n in names if n in spans]
    if base is None or not found:
        return None
    return 1e3 * sum(found) / base["count"]
