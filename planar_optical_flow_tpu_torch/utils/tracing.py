"""Spans and counters inside the serving path, in one process-wide recorder.

    from planar_optical_flow_tpu_torch.utils import tracing

    with tracing.span("step.head"):
        ...
    tracing.count("runner.restarted_streams", 2)
    tracing.snapshot()  # {"spans": {name: {...}}, "counters": {name: n}}

Tracing is active after :func:`enable` and, without it, while a
``torch.profiler`` session runs (torch's own flag), so a profiled window
holds the spans with no call here. Inactive, :func:`span` is one flag test
that returns a shared no-op context and :func:`count` does nothing: no
allocation, no CUDA event, no profiler call. Spans opened with
``always=True`` (set-up: calibration, weight layout, kernel builds) record
whether tracing is active or not. While ``torch.compile`` or
``torch.export`` traces, every span is inert, so exported graphs hold none.

An active span records its name, the step it belongs to (a span opened
while none is open on its thread starts a new step; the spans under it
share that index), its parent span and its host start and end on
``time.time_ns()`` (the clock ``torch.profiler`` stamps its events with, so
the spans and a profiler trace lay out on one timeline). A span opened with
``device=True`` also records, once CUDA is initialised, a pair of pooled
``torch.cuda.Event`` on the current stream: its device seconds are the
stream's time between the two markers, the span's kernels and any idle
between them. Only the spans whose device time is read take them: each
marker costs the host a few microseconds, more under a profiler, and where
the card waits on the host that shows as idle (a profiler's trace times the
kernels under the other spans). While a profiler runs a span also opens a
function-scope range (``_RecordFunctionFast``), which shows in the
profiler's host timeline and emits no device-side annotation
(``record_function``'s user-scope range would add a CUDA event over the
span's kernels and so count as device work in a trace).

The recorder does not synchronise while it records: device times are read
in :func:`snapshot` and :func:`write_chrome_trace`, or by ``query()`` on
the oldest markers once more than ``MAX_PENDING`` are outstanding (it
waits on them only past four times that, a card far behind the host). It
keeps per-name totals for the whole process and a ring of the latest
``RING_SPANS`` spans for :func:`write_chrome_trace`.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

RING_SPANS = 100_000
MAX_PENDING = 4096
# a host-only range in the profiler's timeline (function scope: no
# gpu_user_annotation event on the device); absent from older torch
_HOST_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)

# a ring entry's fields
_NAME, _STEP, _PARENT, _T0, _T1, _DEVICE_MS, _ARGS, _TID = range(8)


class _Null:
    """The span of inactive tracing: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    """An active span: one entry of the recorder's ring once it closes."""

    __slots__ = ("rec", "name", "args", "device", "entry", "child_ns",
                 "parent", "stream", "events", "range")

    def __init__(self, rec, name, args, device):
        self.rec, self.name, self.args, self.device = rec, name, args, device

    def __enter__(self):
        self.rec._open(self)
        return self

    def __exit__(self, *exc):
        self.rec._close(self)
        return False


class Recorder:
    """Per-name span totals, counters and a ring of the latest spans."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._free_events = []
        self.reset()

    def reset(self):
        """Drop every span, total and counter (``enabled`` stays)."""
        with self._lock:
            self._step = -1
            self._totals = {}  # name -> [count, host ns, self ns, device ms, n]
            self._counters = {}
            self._ring = collections.deque(maxlen=RING_SPANS)
            self._pending = collections.deque()  # (entry, start, end event)

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _events(self):
        """A (start, end) pair of timing events, from the pool."""
        with self._lock:
            if self._free_events:
                return self._free_events.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _open(self, span):
        stack = self._stack()
        span.parent = stack[-1] if stack else None
        if span.parent is None:
            with self._lock:
                self._step += 1
                step = self._step
        else:
            step = span.parent.entry[_STEP]
        span.child_ns = 0
        span.range = None
        if _autograd_profiler._is_profiler_enabled and _HOST_RANGE:
            span.range = _HOST_RANGE(span.name)
            span.range.__enter__()
        span.events = None
        if span.device and torch.cuda.is_initialized():
            span.stream = torch.cuda.current_stream()
            span.events = self._events()
            span.events[0].record(span.stream)
        stack.append(span)
        span.entry = [span.name, step,
                      span.parent.name if span.parent else None,
                      time.time_ns(), None, None, span.args,
                      threading.get_ident()]

    def _close(self, span):
        entry = span.entry
        entry[_T1] = t1 = time.time_ns()
        if span.events is not None:
            span.events[1].record(span.stream)
        if span.range is not None:
            span.range.__exit__(None, None, None)
        self._stack().pop()
        host_ns = t1 - entry[_T0]
        if span.parent is not None:
            span.parent.child_ns += host_ns
        with self._lock:
            tot = self._totals.get(span.name)
            if tot is None:
                tot = self._totals[span.name] = [0, 0, 0, 0.0, 0]
            tot[0] += 1
            tot[1] += host_ns
            tot[2] += host_ns - span.child_ns
            self._ring.append(entry)
            if span.events is not None:
                self._pending.append((entry,) + span.events)
                if len(self._pending) > MAX_PENDING:
                    self._resolve(wait=len(self._pending) > 4 * MAX_PENDING)

    def _resolve(self, wait: bool):
        """Read the device time of the oldest pending spans: those whose end
        marker the card has passed, or (``wait``) every one. Under the
        lock."""
        while self._pending:
            entry, start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            ms = start.elapsed_time(end)
            entry[_DEVICE_MS] = ms
            tot = self._totals[entry[_NAME]]
            tot[3] += ms
            tot[4] += 1
            self._free_events.append((start, end))

    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def snapshot(self) -> dict:
        """``{"spans": {name: {"count", "host_s", "self_s", "device_s"}},
        "counters": {name: n}}``; ``device_s`` is None for a span that
        recorded no device markers (not ``device=True``, or CUDA not
        initialised). Waits for the card to pass every pending marker."""
        with self._lock:
            self._resolve(wait=True)
            spans = {name: {"count": c, "host_s": h * 1e-9,
                            "self_s": s * 1e-9,
                            "device_s": d * 1e-3 if n else None}
                     for name, (c, h, s, d, n) in self._totals.items()}
            return {"spans": spans, "counters": dict(self._counters)}

    def write_chrome_trace(self, path) -> str:
        """The ring's spans as Chrome trace JSON (``ph: "X"`` events in us
        on the ``time.time_ns`` clock, ``args`` {step, parent, device_ms}
        and the span's own), the counters under ``"counters"``; opens in
        Perfetto beside a profiler trace. Returns ``path``."""
        with self._lock:
            self._resolve(wait=True)
            entries = list(self._ring)
            counters = dict(self._counters)
        pid = os.getpid()
        events = []
        for e in entries:
            args = {"step": e[_STEP], "parent": e[_PARENT],
                    "device_ms": e[_DEVICE_MS]}
            if e[_ARGS]:
                args.update(e[_ARGS])
            events.append({"name": e[_NAME], "ph": "X", "pid": pid,
                           "tid": e[_TID], "ts": e[_T0] / 1e3,
                           "dur": (e[_T1] - e[_T0]) / 1e3, "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "counters": counters}, f)
        return str(path)


_RECORDER = Recorder()


def _recording(always: bool) -> bool:
    """Whether a span or count records now: the flags first, so that with
    tracing off nothing else is asked."""
    return ((always or _RECORDER.enabled
             or _autograd_profiler._is_profiler_enabled)
            and not torch.compiler.is_compiling())


def span(name: str, always: bool = False, args: dict | None = None,
         device: bool = False):
    """A context manager that records ``name`` while tracing is active (or
    always, with ``always``: set-up spans); ``args`` go to the Chrome trace;
    ``device`` times it on the card too. Spans of one thread nest."""
    if not _recording(always):
        return _NULL
    return _Span(_RECORDER, name, args, device)


def count(name: str, n: int = 1, always: bool = False):
    """Add ``n`` to the counter ``name`` while tracing is active (or
    always)."""
    if _recording(always):
        _RECORDER.count(name, n)


def enable(on: bool = True):
    """Turn tracing on (or off) for the process; a running profiler turns it
    on by itself."""
    _RECORDER.enabled = bool(on)


def active() -> bool:
    """Whether per-step spans and counters record now."""
    return _recording(False)


def snapshot() -> dict:
    """Totals of every span name and the counters (:meth:`Recorder.
    snapshot`)."""
    return _RECORDER.snapshot()


def reset():
    """Clear the recorder's spans, totals and counters."""
    _RECORDER.reset()


def write_chrome_trace(path) -> str:
    """Write the latest spans as Chrome trace JSON (:meth:`Recorder.
    write_chrome_trace`)."""
    return _RECORDER.write_chrome_trace(path)
