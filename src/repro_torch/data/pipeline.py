"""Host data pipeline: double-buffered prefetch + bucketed dynamic batching.

The serving batcher implements the queue the paper's load monitor watches:
requests arrive one by one, are grouped into padded buckets (static shapes for
jit), and the queue depth / batch-size stream feeds the adaptive-cache
controller.  The training iterator is a simple background-thread prefetcher
with a restartable position (checkpointable data state).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np


class PrefetchIterator:
    """Wraps a batch factory with a background prefetch thread."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self._make = make_batch
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self.step
        while not self._stop:
            batch = self._make(step)
            while not self._stop:
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def close(self):
        self._stop = True


@dataclasses.dataclass
class Request:
    rid: int
    payload: dict
    arrival: float  # perf_counter timestamp (intended arrival when open-loop)
    deadline_s: float | None = None  # latency budget from arrival, if any


class BucketBatcher:
    """Groups incoming requests into padded batches (powers-of-two buckets).

    `poll(max_wait)` returns (batch_size_bucket, requests) — the stream of
    bucket sizes is exactly what SlidingWindowLoadMonitor.observe consumes.
    """

    def __init__(self, buckets=(32, 64, 128, 256, 512, 1024), max_wait: float = 0.002):
        self.buckets = tuple(sorted(buckets))
        self.max_wait = max_wait
        self._q: queue.SimpleQueue[Request] = queue.SimpleQueue()
        self._rid = 0

    def submit(self, payload: dict, arrival: float | None = None,
               deadline_s: float | None = None) -> int:
        """Enqueue one request.  ``arrival`` overrides the submit instant
        with the request's *intended* arrival (open-loop drivers stamp it so
        a late submission is charged as queue wait, not hidden); clamped to
        now so clock skew can't make latency negative."""
        self._rid += 1
        t = time.perf_counter()
        if arrival is not None:
            t = min(arrival, t)
        self._q.put(Request(self._rid, payload, t, deadline_s))
        return self._rid

    def poll(self) -> tuple[int, list[Request]] | None:
        deadline = time.perf_counter() + self.max_wait
        reqs: list[Request] = []
        max_bucket = self.buckets[-1]
        while len(reqs) < max_bucket:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                reqs.append(self._q.get(timeout=timeout))
            except queue.Empty:
                break
        if not reqs:
            return None
        bucket = next(b for b in self.buckets if b >= len(reqs))
        return bucket, reqs

    @staticmethod
    def pad_batch(reqs: list[Request], bucket: int, key_shapes: dict) -> dict:
        """Stack request payloads, padding to the bucket size."""
        out = {}
        n = len(reqs)
        for key, (shape, dtype) in key_shapes.items():
            arr = np.zeros((bucket,) + tuple(shape), dtype)
            for i, r in enumerate(reqs):
                arr[i] = r.payload[key]
            out[key] = arr
        out["valid"] = np.arange(bucket) < n
        return out
