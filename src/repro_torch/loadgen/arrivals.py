"""Seeded open-loop arrival generation: Poisson thinning over a QPS schedule.

``poisson_arrivals`` draws a non-homogeneous Poisson process whose rate
follows a :class:`~repro_torch.loadgen.schedule.QpsSchedule` via Lewis-Shedler
thinning: candidate arrivals at the schedule's peak rate, each kept with
probability ``qps(t) / peak``.  The draw is a pure function of
``(schedule, seed)`` — bit-identical across runs and across however the
consumer paces itself, which is the determinism contract the loadgen tests
pin (an open-loop generator must not let the server's behaviour leak into
the arrival sequence).

``OpenLoopGenerator`` pairs the arrival times with request payloads and an
optional per-request latency deadline, yielding :class:`ArrivalEvent`
records the driver submits at their due times.  Payloads come from a
factory; :class:`RecsysPayloadFactory` draws the standard zipf serving
request (one row of ``data.synthetic.recsys_batch``) and applies a
:class:`~repro_torch.loadgen.schedule.FlashCrowd` marker by redirecting the hot
field's draws onto the crowd's id set during the spike window.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.loadgen.schedule import FlashCrowd, QpsSchedule


def poisson_arrivals(
    schedule: QpsSchedule, seed: int, max_events: int | None = None
) -> np.ndarray:
    """Arrival times (seconds, sorted float64) of a non-homogeneous Poisson
    process following ``schedule``, by Lewis-Shedler thinning.  Deterministic
    in ``(schedule, seed)``."""
    rng = np.random.default_rng(seed)
    peak = schedule.peak
    if peak <= 0:
        return np.zeros((0,), np.float64)
    t0 = schedule.points[0][0]
    horizon = schedule.points[-1][0]
    # Candidate count ~ Poisson(peak * duration); draw in one vectorized
    # block (plus slack) rather than an exponential-gap loop.
    n_cand = rng.poisson(peak * (horizon - t0))
    cand = np.sort(rng.uniform(t0, horizon, n_cand))
    keep = rng.random(n_cand) < np.asarray(
        [schedule.qps_at(t) for t in cand]
    ) / peak
    times = cand[keep]
    if max_events is not None:
        times = times[:max_events]
    return times


@dataclasses.dataclass
class ArrivalEvent:
    """One open-loop request: due time, payload, optional latency budget."""

    t: float  # arrival time, seconds since the schedule origin
    payload: dict
    deadline_s: float | None = None  # latency budget (None = no deadline)


class RecsysPayloadFactory:
    """Draws one serving request per call from the zipf recsys workload.

    A :class:`FlashCrowd` marker redirects field ``crowd.field``'s index
    draws onto ``crowd.hot_ids`` for ``hot_frac`` of the arrivals inside
    the spike window — the whole crowd asking for the same rows.
    """

    def __init__(self, tables, n_dense: int, alpha: float = 1.05,
                 crowd: FlashCrowd | None = None):
        self.tables = tables
        self.n_dense = n_dense
        self.alpha = alpha
        self.crowd = crowd

    def __call__(self, rng: np.random.Generator, t: float) -> dict:
        from repro_torch.data import synthetic as syn

        b = syn.recsys_batch(
            rng, self.tables, 1, n_dense=self.n_dense, alpha=self.alpha
        )
        payload = {
            "indices": b["indices"][0],
            "mask": b["mask"][0],
            "dense": b["dense"][0],
        }
        crowd = self.crowd
        if crowd is not None and crowd.active(t) \
                and rng.random() < crowd.hot_frac:
            f = crowd.field
            nnz = payload["indices"].shape[1]
            payload["indices"][f, :] = rng.choice(
                np.asarray(crowd.hot_ids, np.int32), size=nnz
            )
        return payload


class OpenLoopGenerator:
    """Seeded (schedule, payload, deadline) -> list[ArrivalEvent].

    ``events()`` is deterministic in the constructor arguments and
    independent of any consumer: the same seed and schedule produce
    bit-identical arrival sequences however the server paces itself.
    """

    def __init__(
        self,
        schedule: QpsSchedule,
        payload_fn,
        seed: int = 0,
        deadline_s: float | None = None,
        max_events: int | None = None,
    ):
        self.schedule = schedule
        self.payload_fn = payload_fn
        self.seed = seed
        self.deadline_s = deadline_s
        self.max_events = max_events

    def events(self) -> list[ArrivalEvent]:
        times = poisson_arrivals(
            self.schedule, self.seed, max_events=self.max_events
        )
        # Payloads draw from their own stream (seed+1) so arrival thinning
        # and payload content cannot perturb each other's determinism.
        rng = np.random.default_rng(self.seed + 1)
        return [
            ArrivalEvent(float(t), self.payload_fn(rng, float(t)),
                         self.deadline_s)
            for t in times
        ]
