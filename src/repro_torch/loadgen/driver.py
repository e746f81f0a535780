"""Open-loop drivers: wall-clock against a live server, virtual for replay.

``OpenLoopDriver`` submits each :class:`~repro_torch.loadgen.arrivals.ArrivalEvent`
to a ``FlexEMRServer`` when its due time comes and *never* waits for a
completion before submitting the next one — the arrival process is fixed in
advance, so when the server saturates, requests pile up in the batcher queue
and the measured latency finally includes the queueing delay a closed-loop
harness structurally hides.  Each request is stamped with its *intended*
arrival time (not the submit instant): if the single driver thread is
briefly stuck inside ``server.step()``, the late submission is charged to
the request as queue wait, exactly as a kernel-level arrival would be.

``replay_open_loop`` is the deterministic companion: a discrete-event
recurrence over the same arrival sequence with explicit per-batch lookup /
dense service times and a pipeline-depth overlap model, on a virtual clock.
It produces bit-identical latencies and SLO verdicts run after run (the
loadgen determinism tests pin this), predicts where the latency-vs-load
knee sits before ever touching the server, and is the clock the SLO
monitor's burn-rate windows run on in simulation.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.loadgen.arrivals import ArrivalEvent
from repro_torch.runtime.admission import ShedError


class OpenLoopDriver:
    """Wall-clock open-loop replay of an arrival sequence into a server.

    The loop alternates "submit everything due" with one ``server.step()``;
    when idle it sleeps until the next arrival.  Completion pacing never
    feeds back into submission times — the definition of open loop.
    """

    def __init__(self, poll_sleep: float = 0.0005):
        self.poll_sleep = poll_sleep

    def run(self, server, events: list[ArrivalEvent],
            on_output=None) -> dict:
        """Drive ``server`` through ``events``; returns driver-side stats.
        ``on_output``, when given, is called with every retired batch's
        ``server.step()`` result.

        The server owns latency/SLO accounting (its retire path measures
        arrival -> retire); the driver reports the submission honesty
        metrics: how late submissions ran behind their due times (driver
        lag — nonzero lag is *measured*, not hidden, since requests carry
        their intended arrival stamps).
        """
        events = sorted(events, key=lambda e: e.t)
        n = len(events)
        done_before = server.metrics.requests
        lag_max = 0.0
        lag_sum = 0.0
        shed = 0
        epoch = time.perf_counter()
        i = 0
        steps = 0
        while i < n or server.metrics.requests - done_before < n - shed:
            now = time.perf_counter() - epoch
            while i < n and events[i].t <= now:
                ev = events[i]
                lag = now - ev.t
                lag_sum += lag
                lag_max = max(lag_max, lag)
                try:
                    server.submit(
                        ev.payload,
                        arrival=epoch + ev.t,
                        deadline_s=ev.deadline_s,
                    )
                except ShedError:
                    # Overload shed (admission control): the request never
                    # enters the pipeline, so it will never retire — drop
                    # it from the completion target.  The server's
                    # serve.admission.* counters record the reason.
                    shed += 1
                i += 1
            out = server.step()
            steps += 1
            if out is not None and on_output is not None:
                on_output(out)
            if out is None and i < n:
                # Idle and ahead of schedule: sleep until the next arrival
                # (bounded so a long gap still lets the pipeline retire).
                wait = events[i].t - (time.perf_counter() - epoch)
                if wait > 0:
                    time.sleep(min(wait, self.poll_sleep))
        wall = time.perf_counter() - epoch
        return {
            "submitted": n,
            "shed": shed,
            "wall_s": wall,
            "offered_qps": n / max(events[-1].t, 1e-9) if n else 0.0,
            "achieved_qps": n / max(wall, 1e-9),
            "steps": steps,
            "submit_lag_mean_s": lag_sum / max(1, n),
            "submit_lag_max_s": lag_max,
        }


def replay_open_loop(
    arrival_times: np.ndarray,
    batch_size: int,
    lookup_s: float,
    dense_s: float,
    pipeline_depth: int = 2,
    batch_timeout_s: float = 0.002,
    deadline_s: float | None = None,
    slo=None,
) -> dict:
    """Deterministic virtual-clock replay of an open-loop arrival sequence.

    Queueing model of the admit/retire pipeline: arrivals group into FIFO
    batches of up to ``batch_size`` (a partial batch closes
    ``batch_timeout_s`` after its first arrival, like the bucket batcher's
    poll window); each batch needs ``lookup_s`` of wire time and
    ``dense_s`` of ranker time.  With pipeline depth ``d``, batch k's
    lookup may start once k-d has retired (d lookups in flight), and the
    dense stage is the serialized resource:

        admit_k  = max(ready_k, retire_{k-d})
        fetch_k  = admit_k + lookup_s
        retire_k = max(fetch_k, retire_{k-1}) + dense_s

    Per-request latency is ``retire_k - arrival_i``.  Pure arithmetic over
    float64 — bit-identical run after run for the same inputs — so SLO
    verdicts derived from it (pass ``slo`` to feed a
    :class:`repro_torch.obs.slo.SloMonitor` on the virtual clock) are
    reproducible, and sweeping the offered rate locates the knee
    ``capacity ~ batch_size / max(lookup_s [depth 1: + dense_s], dense_s)``
    without touching the server.
    """
    if pipeline_depth <= 0:
        raise ValueError("pipeline_depth must be positive")
    t = np.sort(np.asarray(arrival_times, np.float64))
    n = len(t)
    # FIFO batching: close a batch at batch_size or batch_timeout after its
    # first member, whichever comes first.
    bounds = [0]
    start = 0
    for i in range(1, n):
        if i - start >= batch_size or t[i] - t[start] > batch_timeout_s:
            bounds.append(i)
            start = i
    bounds.append(n)
    retires = np.zeros(len(bounds) - 1, np.float64)
    latencies = np.zeros(n, np.float64)
    d = pipeline_depth
    for k in range(len(bounds) - 1):
        lo, hi = bounds[k], bounds[k + 1]
        ready = t[hi - 1] if hi - lo >= batch_size \
            else t[lo] + batch_timeout_s
        gate = retires[k - d] if k >= d else 0.0
        admit = max(ready, gate)
        fetched = admit + lookup_s
        prev = retires[k - 1] if k >= 1 else 0.0
        retires[k] = max(fetched, prev) + dense_s
        latencies[lo:hi] = retires[k] - t[lo:hi]
        if slo is not None:
            for i in range(lo, hi):
                met = None if deadline_s is None \
                    else bool(latencies[i] <= deadline_s)
                slo.observe(latencies[i], now=retires[k], deadline_met=met)
    return {
        "latencies": latencies,
        "batches": len(retires),
        "retire_times": retires,
        "makespan_s": float(retires[-1] - t[0]) if n else 0.0,
        "p50_s": float(np.quantile(latencies, 0.5)) if n else 0.0,
        "p99_s": float(np.quantile(latencies, 0.99)) if n else 0.0,
    }
