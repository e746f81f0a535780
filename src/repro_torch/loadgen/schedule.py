"""Offered-load schedules: the QPS-over-time half of the open-loop harness.

A :class:`QpsSchedule` is a piecewise-linear target arrival rate over a
finite horizon — the *offered* load, chosen by the experimenter, never by
the server.  That independence is the whole point of open-loop driving
(DisaggRec sizes its compute/memory nodes from exactly these
latency-vs-offered-load curves): a closed-loop client waits for completions
and therefore slows down exactly when the server saturates, hiding the
queueing delay that kills the tail in production.

Constructors cover the bench scenarios:

  * :func:`constant`       — flat QPS for a duration (the sweep points of a
                             latency-vs-load curve)
  * :func:`trace`          — piecewise-linear replay of recorded (t, qps)
                             breakpoints
  * :func:`diurnal`        — sinusoidal daily ramp compressed to bench time
                             (the Fig-5 load shape)
  * :func:`flash_crowd`    — base QPS with a step spike window, paired with
                             a :class:`FlashCrowd` marker that also
                             concentrates one sparse field's draws on a hot
                             id set (RecShard's per-field skew scenario:
                             everyone suddenly looks at the same items)

Schedules are pure data — deterministic, serializable, and consumed by
``loadgen.arrivals.poisson_arrivals`` (thinning) or directly as an exact
rate curve.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """One hot sparse field's crowd spike, riding a schedule's rate spike.

    During [t0, t1), a ``hot_frac`` share of arrivals redirect field
    ``field``'s index draws onto ``hot_ids`` — the flash-crowd shape where
    the *extra* traffic all wants the same rows (so the cache should absorb
    it, and the SLO monitor should still see the queueing).
    """

    field: int
    t0: float
    t1: float
    hot_ids: tuple[int, ...]
    hot_frac: float = 0.9

    def active(self, t: float) -> bool:
        return self.t0 <= t < self.t1


class QpsSchedule:
    """Piecewise-linear offered load: breakpoints (t_i, qps_i), t_i sorted.

    ``qps_at(t)`` interpolates linearly between breakpoints and is 0 outside
    [t_0, t_last].  ``duration`` is the horizon; ``peak`` bounds the rate
    (the thinning envelope for Poisson arrival generation).
    """

    def __init__(self, points: list[tuple[float, float]]):
        if len(points) < 2:
            raise ValueError("a schedule needs >= 2 (t, qps) breakpoints")
        ts = [float(t) for t, _ in points]
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError("breakpoint times must be sorted")
        if any(q < 0 for _, q in points):
            raise ValueError("qps must be non-negative")
        self.points = [(float(t), float(q)) for t, q in points]
        self._ts = ts

    @property
    def duration(self) -> float:
        return self.points[-1][0] - self.points[0][0]

    @property
    def peak(self) -> float:
        return max(q for _, q in self.points)

    def qps_at(self, t: float) -> float:
        pts = self.points
        if t < pts[0][0] or t > pts[-1][0]:
            return 0.0
        i = bisect.bisect_right(self._ts, t) - 1
        if i >= len(pts) - 1:
            return pts[-1][1]
        (t0, q0), (t1, q1) = pts[i], pts[i + 1]
        if t1 == t0:
            return q1
        return q0 + (q1 - q0) * (t - t0) / (t1 - t0)

    def expected_arrivals(self) -> float:
        """Integral of the rate curve (trapezoid over the breakpoints)."""
        total = 0.0
        for (t0, q0), (t1, q1) in zip(self.points, self.points[1:]):
            total += 0.5 * (q0 + q1) * (t1 - t0)
        return total

    def scaled(self, factor: float) -> "QpsSchedule":
        """Same shape, every rate multiplied by ``factor`` (load sweeps)."""
        return QpsSchedule([(t, q * factor) for t, q in self.points])


def constant(qps: float, duration: float) -> QpsSchedule:
    """Flat offered load: the individual points of a QPS sweep."""
    return QpsSchedule([(0.0, qps), (duration, qps)])


def trace(points: list[tuple[float, float]]) -> QpsSchedule:
    """Trace-driven load: replay recorded (t, qps) breakpoints verbatim."""
    return QpsSchedule(points)


def diurnal(
    base_qps: float, peak_qps: float, duration: float, cycles: float = 1.0,
    steps: int = 48,
) -> QpsSchedule:
    """Sinusoidal daily ramp compressed into ``duration`` seconds of bench
    time (the Fig-5 shape ``data.synthetic.diurnal_batches`` draws batch
    sizes from, expressed as an arrival rate)."""
    if peak_qps < base_qps:
        raise ValueError("peak_qps must be >= base_qps")
    t = np.linspace(0.0, duration, steps + 1)
    phase = t / duration * 2.0 * np.pi * cycles - np.pi / 2.0
    q = base_qps + (peak_qps - base_qps) * 0.5 * (1.0 + np.sin(phase))
    return QpsSchedule(list(zip(t.tolist(), q.tolist())))


def flash_crowd(
    base_qps: float,
    spike_qps: float,
    duration: float,
    spike_t0: float,
    spike_t1: float,
    field: int = 0,
    hot_ids: tuple[int, ...] = tuple(range(8)),
    hot_frac: float = 0.9,
) -> tuple[QpsSchedule, FlashCrowd]:
    """Base load with a step spike on [spike_t0, spike_t1), plus the
    :class:`FlashCrowd` marker that concentrates field ``field`` on
    ``hot_ids`` for the spike's arrivals."""
    if not 0.0 <= spike_t0 < spike_t1 <= duration:
        raise ValueError("spike window must fall inside [0, duration]")
    eps = min(1e-6, (spike_t1 - spike_t0) / 4, spike_t0 / 2 or 1e-9)
    pts = [(0.0, base_qps)]
    if spike_t0 > 0:
        pts.append((spike_t0 - eps, base_qps))
    pts += [(spike_t0, spike_qps), (spike_t1 - eps, spike_qps),
            (spike_t1, base_qps), (duration, base_qps)]
    crowd = FlashCrowd(
        field=field, t0=spike_t0, t1=spike_t1,
        hot_ids=tuple(int(i) for i in hot_ids), hot_frac=hot_frac,
    )
    return QpsSchedule(pts), crowd
