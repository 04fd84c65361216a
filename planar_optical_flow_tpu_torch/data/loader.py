"""Batch loader: shuffled fixed-shape numpy batches with background
prefetch.

Counterpart of ``planar_optical_flow_tpu/data/loader.py`` ``BatchLoader``,
with its order: ``np.random.default_rng(seed)`` shuffles the indices once an
epoch, ``drop_last`` drops the ragged tail or, without it, the tail is
filled by wrapping to the epoch's first indices, and one prefetch thread
builds the next batches. ``put_fn`` places a batch (e.g. onto the card) in
that thread; the trainer moves batches itself otherwise.
"""

from __future__ import annotations

import queue
import threading
import warnings

import numpy as np


class BatchLoader:
    """Iterate dict batches over a dataset with a ``batch(indices)`` method
    (or ``__getitem__`` + default stacking)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 put_fn=None, process_index: int = 0, process_count: int = 1):
        """``batch_size`` is the GLOBAL batch; under multi-host each process
        constructs only its ``batch_size / process_count`` slice (same seed
        on every host keeps the global order consistent)."""
        if batch_size % process_count != 0:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"{process_count} processes"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.put_fn = put_fn  # e.g. device/shard placement
        self.process_index = process_index
        self.process_count = process_count
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, idx):
        if self.process_count > 1:
            per = self.batch_size // self.process_count
            idx = idx[self.process_index * per:(self.process_index + 1) * per]
        if hasattr(self.dataset, "batch"):
            b = self.dataset.batch(idx)
        else:
            samples = [self.dataset[int(i)] for i in idx]
            b = {
                k: np.stack([s[k] for s in samples])
                for k in samples[0]
                if isinstance(samples[0][k], np.ndarray)
                or np.isscalar(samples[0][k])
            }
        return self.put_fn(b) if self.put_fn is not None else b

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        limit = len(self) * self.batch_size if self.drop_last else n
        chunks = [
            order[i:i + self.batch_size]
            for i in range(0, limit, self.batch_size)
        ]
        if not self.drop_last and chunks and len(chunks[-1]) < self.batch_size:
            # pad the ragged tail by wrapping (keeps shapes static for jit)
            pad = self.batch_size - len(chunks[-1])
            chunks[-1] = np.concatenate([chunks[-1], order[:pad]])

        if self.prefetch <= 0:
            for c in chunks:
                yield self._make_batch(c)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def _put(item) -> bool:
            # bounded-queue put that gives up once the consumer is gone —
            # otherwise an early ``break`` out of the epoch would leave the
            # worker blocked in q.put forever, leaking the thread and the
            # prefetched (possibly device-placed) batches every epoch
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            # a worker error must reach the consumer — swallowing it would
            # silently truncate the epoch
            try:
                for c in chunks:
                    if not _put(self._make_batch(c)):
                        return
                _put(stop)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                _put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # runs on exhaustion, error, AND consumer abandonment
            # (GeneratorExit): release the worker and drop queued batches
            abandoned.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            # bounded join: the worker is a daemon, so if _make_batch or
            # put_fn is wedged (e.g. a stuck device transfer) a leaked
            # thread is safe — an unbounded join here would hang
            # interpreter teardown (this finally can run inside GC via
            # GeneratorExit)
            t.join(timeout=10.0)
            if t.is_alive():
                warnings.warn(
                    "BatchLoader prefetch worker did not exit within 10 s "
                    "of consumer teardown; leaking the daemon thread",
                    RuntimeWarning, stacklevel=2)
