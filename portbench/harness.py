"""One run of one cell: set-up, the measured window, the trace, the check.

The program under test is the port's ``infer.StreamingRunner`` (what
``cli.infer`` serves): a closed loop of steps, each a ``(B, P)`` batch of
host scans handed to the runner, ending when the outputs ``cli.infer``
reads (``det_xys``, ``det_cls``, ``det_keep``, and ``pred_flow`` where the
model has it) are on the host. Streams restart through ``runner.reset``
as the mix schedules. Set-up (process start to the first timed step) builds
or loads the kernels, makes the weights and the scan pool from the seed,
fits the BatchNorm statistics to the first scans, calibrates (int8), and
runs every kind of step the window will run once:
the bootstrap, a carried step and, where the mix restarts streams, a step
with a restart. The window then starts every stream afresh.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

from portbench.spec import angle_inc

BANNED = ("jax", "jaxlib", "flax", "planar_optical_flow_tpu")
TRACE_FROM = 3      # the traced slice starts at this window step
TRACE_STEPS = 40    # ... and holds this many steps
_SALT_SAMPLE = 4


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), else since the
    harness was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`BANNED`
    (compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def cutout_kwargs(cfg: dict) -> dict:
    """The runner's cutout arguments: the configuration's geometry on the
    serving cutout (fixed geometry, centred)."""
    return dict(cfg["cutout"], fixed=True, centered=True)


def build_model(cfg: dict):
    """The port's model of the configuration, on the default device, its
    parameters as the model initialises them; the configuration's
    ``model_kwargs`` are passed as they stand."""
    import torch

    from planar_optical_flow_tpu_torch.models import FlowDrow, SpatialDrow

    cls = FlowDrow if cfg["model"] == "flow_drow" else SpatialDrow
    return cls(alpha=cfg["alpha"], window_size=cfg["window_size"],
               pedestrian_only=cfg["pedestrian_only"],
               num_cutout_pts=cfg["cutout"]["num_cutout_pts"],
               generator=torch.Generator(), **cfg.get("model_kwargs", {}))


def make_model(cfg: dict, sd: dict, device):
    """The port's model of the configuration, holding ``sd``."""
    model = build_model(cfg).to(device).eval()
    model.load_state_dict(sd)
    return model


def template_state_dict(cfg: dict) -> dict:
    """Keys, shapes and dtypes of the configuration's state dict (a model
    on the meta device: nothing drawn)."""
    import torch

    with torch.device("meta"):
        return build_model(cfg).state_dict()


def make_runner(cfg: dict, sd: dict, calib_scans, device, engine=None):
    """The port's ``StreamingRunner`` on the configuration's engine (or
    ``engine``), with every output field. The configuration's
    ``runner_kwargs`` are passed as they stand, and its beam angle
    (``angle_inc``, radians) only where the configuration states one."""
    from planar_optical_flow_tpu_torch.infer.streaming import StreamingRunner

    engine = engine or cfg["engine"]
    model = make_model(cfg, sd, device)
    extra = dict(cfg.get("runner_kwargs", {}))
    if "angle_inc_deg" in cfg:
        extra["angle_inc"] = angle_inc(cfg)
    return StreamingRunner(
        model, cutout_kwargs(cfg), num_pts=cfg["num_pts"],
        nms_min_dist=cfg["nms"]["min_dist"], engine=engine,
        calib_scans=calib_scans if engine == "int8c" else None,
        device=device, **extra)


def sample_streams(cell, seed: int) -> np.ndarray:
    """The compared streams of ``cell``, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (2 ** 64), _SALT_SAMPLE])
    n = min(int(cell.config["check"]["sample_streams"]), cell.streams)
    return np.sort(rng.choice(cell.streams, n, replace=False))


class _Consumer:
    """The host side of a step: copies what ``cli.infer`` reads into pinned
    buffers and, for the check, every compared field's rows of the sampled
    streams into the step's slot of a pinned history; then waits. Nothing
    is done on the host after the wait."""

    FIELDS = ("pred_cls", "pred_reg")

    def __init__(self, fields, sample, device, capacity):
        import torch

        self.fields = fields
        self.sample_t = torch.as_tensor(sample, device=device)
        self.pinned = torch.device(device).type == "cuda"
        self.device = device
        self.capacity = capacity
        self.bufs, self.hist = {}, {}
        self.n = 0

    def _host(self, shape, dtype):
        import torch

        return torch.empty(shape, dtype=dtype, pin_memory=self.pinned)

    def _slot(self, key, k, like):
        h = self.hist.get(key)
        if h is None or k >= h.shape[0]:
            grown = self._host(
                (max(self.capacity, 2 * k),) + tuple(like.shape), like.dtype)
            if h is not None:
                grown[:h.shape[0]] = h
            self.hist[key] = h = grown
        return h[k]

    def __call__(self, out, k=None):
        """Start the copies of step ``k`` (None: set-up, nothing kept) and
        wait for them."""
        import torch

        for f in self.fields:
            buf = self.bufs.get(f)
            if buf is None:
                buf = self.bufs[f] = self._host(out[f].shape, out[f].dtype)
            buf.copy_(out[f], non_blocking=True)
        if k is not None:
            for f in self.FIELDS + tuple(self.fields):
                rows = out[f].index_select(0, self.sample_t)
                self._slot(f, k, rows).copy_(rows, non_blocking=True)
            self.n = max(self.n, k + 1)
        if self.pinned:
            torch.cuda.current_stream(self.device).synchronize()

    def history(self) -> dict:
        """The compared fields, ``(steps, streams, ...)`` numpy arrays."""
        return {f: self.hist[f][:self.n].numpy()
                for f in self.FIELDS + tuple(self.fields)}


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def power_limit_w():
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        program=None, log=print, min_steps=0) -> dict:
    """Run ``cell`` once; returns the result line as a dict. ``program``
    (None: the port's runner on the configuration's engine) is a callable
    ``(cell, sd, calib_scans, device, sample) -> runner`` that puts another
    program in the runner's place: the check's control and its planted
    faults. The window lasts ``seconds`` and at least ``min_steps`` steps
    (for a slow device: a fault that shows over steps needs them)."""
    import torch

    from portbench import check, weights
    from portbench.device_trace import TraceView, events

    cfg, mix, reference = cell.config, cell.traffic, cell.reference()
    b, p = cell.streams, int(cfg["num_pts"])
    marks = [("start", process_age_s())]
    is_cuda = torch.device(device).type == "cuda"
    sd = weights.make_state_dict(template_state_dict(cfg), seed, device)
    marks.append(("weights", process_age_s()))
    streams = cell.generator().make(mix, b, p, seed, device,
                                    angle_inc=angle_inc(cfg))
    marks.append(("scans", process_age_s()))
    sample = sample_streams(cell, seed)
    rows0 = streams.rows_at_start()
    calib = streams.pool[torch.from_numpy(
        rows0[:int(cfg["calib_scans"])])].clone()
    # BatchNorm statistics of the model's own data, on the same scans
    reference.fit_batch_norm(sd, cfg, check.sanitize(
        calib, float(cfg["cutout"]["padding_val"])))
    marks.append(("batch_norm", process_age_s()))
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if program is None:
        runner = make_runner(cfg, sd, calib, device)
    else:
        runner = program(cell, sd, calib, device, sample)
    marks.append(("runner", process_age_s()))
    fields = ["det_xys", "det_cls", "det_keep"] + (
        ["pred_flow"] if cfg["model"] == "flow_drow" else [])
    # the schedule, worked out before the window: each step's pool rows and
    # restarted streams (steps past the plan are worked out as they come)
    plan = [streams.advance(k) for k in range(int(seconds * 100) + 64)]
    consume = _Consumer(fields, sample, device, capacity=len(plan))
    batch0 = streams.pool[torch.from_numpy(rows0)].clone()
    # set-up: every kind of step the window runs, once
    warm = ["boot", "carried", "carried"]
    if streams.restarts_per_block:
        warm.append("restart")
    for i, kind in enumerate(warm):
        if kind == "restart":
            runner.reset([0])
        # the last one also allocates the history (step 0's slot, which the
        # window's step 0 overwrites)
        consume(runner(batch0), 0 if i == len(warm) - 1 else None)
    if trace and is_cuda:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()  # the profiler's own start-up, outside the window
        consume(runner(batch0))
        prof.stop()
    runner.reset()
    # what set-up made lives on: the cyclic collector need not walk it again
    # (its full passes stalled a window by up to ~0.6 s)
    gc.collect()
    gc.freeze()
    threads = torch.get_num_threads()
    if is_cuda:
        # the window's host tensors are small: one thread, no pool to wake
        # (set-up keeps them all: the int8 calibration runs on the host)
        torch.set_num_threads(1)
    _sync(device)
    setup_s = process_age_s()
    marks.append(("warm_up", setup_s))
    gc_before = [g["collections"] for g in gc.get_stats()]

    # the producer: the next batch is gathered from the pool into one of two
    # pinned buffers while the card works on the current step
    bufs = [torch.empty((b, p), dtype=torch.float32, pin_memory=is_cuda)
            for _ in range(2)]

    def gather(k):
        if k == len(plan):
            plan.append(streams.advance(k))
        return torch.index_select(streams.pool, 0,
                                  torch.from_numpy(plan[k][0]),
                                  out=bufs[k % 2])

    gather(0)

    # ---- the window
    records = []
    prof = None
    trace_steps = (TRACE_FROM, TRACE_FROM + TRACE_STEPS) if trace else None
    t_w0 = time.perf_counter()
    t_tr = [None, None]
    k = 0
    while True:
        t_it = time.perf_counter()
        restarted = plan[k][1]
        if restarted.size:
            runner.reset(restarted.tolist())
        batch = bufs[k % 2]
        traced = bool(trace_steps) and trace_steps[0] <= k < trace_steps[1]
        if traced and k == trace_steps[0] and is_cuda:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            t_tr[0] = time.perf_counter()
        t0 = time.perf_counter()
        out = runner(batch)
        t1 = time.perf_counter()
        gather(k + 1)
        consume(out, k)
        t2 = time.perf_counter()
        if traced and k == trace_steps[1] - 1 and prof is not None:
            prof.stop()
            t_tr[1] = t2
        # (step, runner call, restarted, traced, before the step, after it)
        records.append((t2 - t0, t1 - t0, bool(restarted.size), traced,
                        t0 - t_it, time.perf_counter() - t2))
        k += 1
        done = t2 - t_w0 >= seconds and k >= min_steps
        if done and not (trace_steps and k < trace_steps[1]):
            break
    wall_s = t2 - t_w0
    gc_runs = [g["collections"] - g0
               for g, g0 in zip(gc.get_stats(), gc_before)]
    gc.unfreeze()
    torch.set_num_threads(threads)
    del out

    found = banned_modules()
    if found:
        raise RuntimeError("modules of JAX or of the JAX package are loaded: "
                           + ", ".join(found))
    peak = int(torch.cuda.max_memory_allocated(device)) if is_cuda else 0
    view = None
    if prof is not None:
        dev_ev, host_ev = events(prof)
        view = TraceView(dev_ev, host_ev, t_tr[1] - t_tr[0], TRACE_STEPS)
        del prof
    runner = None
    if is_cuda:
        torch.cuda.empty_cache()

    # ---- the check
    n = len(records)
    got = consume.history()
    got["pred_cls"] = got["pred_cls"][..., 0]
    got["det_cls"] = got["det_cls"][..., 0]
    rows = np.stack([r[sample] for r, _ in plan[:n]])
    boot = np.stack([np.isin(sample, rs) for _, rs in plan[:n]])
    boot[0] = True
    scans = streams.pool[torch.from_numpy(rows.reshape(-1))].reshape(
        rows.shape + (p,))
    detail = {}
    numbers = check.compare(sd, cfg, scans, boot, got, device, calib,
                            reference, detail=detail)
    correct, table = check.verdict(numbers, cfg["check"]["limits"])

    ctx = {"cfg": cfg, "cell": cell, "records": records, "wall_s": wall_s,
           "setup_s": setup_s, "streams": b, "trace": view}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if is_cuda:
        dev["power_limit_w"] = power_limit_w()
    if view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
    result = {"correct": bool(correct), "attempted": len(records) * b,
              "failed": 0, "metrics": metrics, "device": dev}
    if view is not None:
        result["breakdown"] = view.breakdown()
    step_ms = np.array([r[0] for r in records]) * 1e3
    result["window"] = {
        "steps": len(records), "wall_s": wall_s,
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_mean": float(step_ms.mean()),
        "step_ms_max": float(step_ms.max()),
        "slow_steps": int((step_ms > 2 * np.median(step_ms)).sum()),
        "gc_collections": gc_runs,
        "before_step_ms_mean": float(np.mean([r[4] for r in records])) * 1e3,
        "after_step_ms_mean": float(np.mean([r[5] for r in records])) * 1e3,
        "restart_steps": sum(1 for r in records if r[2]),
        "compared": {"streams": len(sample), "steps": n},
        "setup_marks_s": dict(marks),
        "check_detail": detail}
    result["check"] = table
    for name, row in table.items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    return result


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.spec import Cell

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(result), flush=True)
    return 0
