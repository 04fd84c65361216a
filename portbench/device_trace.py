"""Reading the device trace of a ``--trace 1`` run.

``torch.profiler`` (CPU and CUDA activities) records a slice of the
window's steps. From its events this module takes what the per-layer
metrics read: the device operations by name (time and count), the busy
time (the union of the device operations' intervals; a frozen copy of
``report_spans`` in the repository's ``chip_smoke.py``), the traced window's
length, and the idle gaps between device operations, each named by what the
host was doing in the middle of the gap: the innermost host operation
running then, or, where none ran, the one that ended last before it
(Python between operations).
"""

from __future__ import annotations

import bisect


class TraceView:
    """What a traced slice of the window holds."""

    def __init__(self, device_events, host_events, window_s, steps):
        self.window_s = window_s
        self.steps = steps
        self.by_name = {}
        spans = []
        for name, start, end in device_events:
            spans.append((start, end))
            tot, cnt = self.by_name.get(name, (0.0, 0))
            self.by_name[name] = (tot + (end - start) * 1e-6, cnt + 1)
        self.busy_s, gaps = _busy_and_gaps(spans)
        self.gaps = _name_gaps(gaps, host_events)

    def time_s(self, substrings) -> float:
        """Device seconds of the operations whose name holds any of
        ``substrings``."""
        return sum(t for n, (t, _) in self.by_name.items()
                   if any(s in n for s in substrings))

    def launches(self, substring) -> int:
        return sum(c for n, (_, c) in self.by_name.items() if substring in n)

    def total_s(self) -> float:
        return sum(t for t, _ in self.by_name.values())

    def breakdown(self, top=10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        idle = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], t] for n, (t, _) in ops],
                "idle_gaps": [[n[:160], t] for n, t in idle]}


def _busy_and_gaps(spans):
    """(busy seconds, [(gap start us, gap end us)]) of device intervals."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6, gaps


def _name_gaps(gaps, host_events):
    """Idle seconds by the host operation running at each gap's middle."""
    host = sorted(host_events, key=lambda ev: ev[1])
    starts = [ev[1] for ev in host]
    named = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid)
        inner, last = None, None
        for name, s, e in reversed(host[max(0, i - 400):i]):
            if e >= mid:
                inner = name  # the latest-starting one that covers mid
                break
            if last is None or e > last[1]:
                last = (name, e)
        label = (f"host in {inner}" if inner is not None else
                 f"host after {last[0]}" if last is not None else "host")
        named[label] = named.get(label, 0.0) + (g1 - g0) * 1e-6
    return named


def events(prof):
    """(device events, host events) of a finished profile, each ``(name,
    start us, end us)``."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in prof.events():
        item = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            dev.append(item)
        elif ev.device_type == DeviceType.CPU:
            host.append(item)
    return dev, host
