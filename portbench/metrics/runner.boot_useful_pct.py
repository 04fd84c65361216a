"""Runner layer: the share of the rows a restart step's bootstrap runs that
it was asked to restart, in %: 100 x the counter
``runner.restarted_streams`` over ``runner.boot_streams``. Read under the
profiler from the port's own counters (``portbench/spans.py``)."""

from portbench.spans import snapshot


def read(ctx):
    snap = snapshot(ctx)
    if snap is None:
        return None
    boot = snap["counters"].get("runner.boot_streams", 0)
    if not boot:
        return None
    return 100.0 * snap["counters"].get("runner.restarted_streams", 0) / boot
