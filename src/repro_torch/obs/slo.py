"""SLO monitor: windowed objectives, multi-window burn-rate alerts, goodput.

An :class:`SloMonitor` watches the per-request latency stream the server
already produces and answers the operational question the raw histograms
cannot: *are we burning error budget fast enough to page someone?*

Mechanics (Google SRE-workbook multi-window multi-burn-rate alerting,
adapted to run on either the wall clock or the bench's virtual clock —
every entry point takes an explicit ``now``):

  * An :class:`SloObjective` declares the contract: requests under
    ``latency_target_s`` are *good*; at least ``target`` (e.g. 0.999) of
    requests must be good.  The error budget is ``1 - target``.
  * Each observation lands in two sliding count windows (fast + slow) and a
    :class:`WindowedHistogram` (sliding-window quantiles built from rings
    of the existing exact-warmup/P² :class:`~repro.obs.metrics.Histogram`).
  * The **burn rate** of a window is ``bad_fraction / (1 - target)`` — 1.0
    means budget burns exactly at the sustainable rate, 14.4 means a 30-day
    budget dies in ~2 days.  The alert fires only when *both* windows
    exceed ``burn_threshold``: the slow window supplies evidence that the
    problem is real, the fast window makes the alert reset quickly once
    the problem stops (no stale paging long after recovery).
  * Fire/resolve transitions are emitted as ``CAT_SLO`` tracer instants
    and counted; :meth:`summary` is a registry provider for the ``slo.*``
    namespace, including goodput (deadline-met requests/s) next to raw
    throughput so overload shows up as the *gap* between them.

Nothing here imports the serving stack: like ``obs.metrics`` it must stay
importable from every layer.  See docs/OBSERVABILITY.md for the ``slo.*``
key table.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.obs.metrics import Histogram
from repro_torch.obs.trace import CAT_SLO, NULL_TRACER


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One latency SLO: which requests are good, and when to page.

    ``burn_threshold`` is in budget-burn multiples: 1.0 = burning exactly
    the sustainable rate.  The SRE-workbook pairing for a fast page is
    e.g. (5 min, 1 h) windows at 14.4x; the bench compresses the windows
    to sub-second but keeps the multiples.
    """

    latency_target_s: float  # requests at or under this are "good"
    target: float = 0.99  # required good fraction (SLO target)
    fast_window_s: float = 0.25
    slow_window_s: float = 1.0
    burn_threshold: float = 10.0
    min_samples: int = 20  # per window, before burn rate is trusted

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast window must not exceed slow window")


class _CountWindow:
    """Sliding (good, bad) counts over the trailing ``window_s`` seconds.

    Time-bucket ring: ``n_buckets`` fixed slots of width ``window_s /
    n_buckets``; an observation lands in the bucket its timestamp maps to,
    and buckets older than the window are zeroed lazily as time advances.
    O(n_buckets) memory regardless of rate; resolution is one bucket width.
    Single-writer (the serving/replay loop), like ServeMetrics.
    """

    def __init__(self, window_s: float, n_buckets: int = 20):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.window_s = window_s
        self.n_buckets = n_buckets
        self._dt = window_s / n_buckets
        self._good = [0] * n_buckets
        self._bad = [0] * n_buckets
        self._epochs = [-1] * n_buckets  # absolute bucket index, -1 = empty

    def _slot(self, now: float) -> int:
        epoch = int(now / self._dt)
        i = epoch % self.n_buckets
        if self._epochs[i] != epoch:  # stale bucket from a prior lap
            self._epochs[i] = epoch
            self._good[i] = 0
            self._bad[i] = 0
        return i

    def add(self, now: float, good: bool) -> None:
        i = self._slot(now)
        if good:
            self._good[i] += 1
        else:
            self._bad[i] += 1

    def totals(self, now: float) -> tuple[int, int]:
        """(good, bad) over buckets still inside the trailing window."""
        horizon = int(now / self._dt) - self.n_buckets
        good = bad = 0
        for i in range(self.n_buckets):
            if self._epochs[i] > horizon:
                good += self._good[i]
                bad += self._bad[i]
        return good, bad


class WindowedHistogram:
    """Sliding-window latency quantiles from a ring of ``Histogram`` buckets.

    Each time bucket owns a full :class:`~repro.obs.metrics.Histogram`;
    ``quantile(q, now)`` merges the live buckets — exactly, by
    concatenating the per-bucket warmup buffers while they are all still
    exact, and by count-weighted averaging of the per-bucket P² estimates
    once any bucket has handed off (an approximation, but one whose error
    is bounded by cross-bucket quantile spread, fine for burn-rate work).
    """

    def __init__(self, window_s: float, n_buckets: int = 8,
                 quantiles=(0.5, 0.9, 0.99), bucket_warmup: int = 512):
        self.window_s = window_s
        self.n_buckets = n_buckets
        self.quantiles = tuple(quantiles)
        self.bucket_warmup = bucket_warmup
        self._dt = window_s / n_buckets
        self._hists: list[Histogram | None] = [None] * n_buckets
        self._epochs = [-1] * n_buckets

    def add(self, x: float, now: float) -> None:
        epoch = int(now / self._dt)
        i = epoch % self.n_buckets
        if self._epochs[i] != epoch:
            self._epochs[i] = epoch
            self._hists[i] = Histogram(self.quantiles,
                                       warmup=self.bucket_warmup)
        self._hists[i].add(x)

    def _live(self, now: float) -> list[Histogram]:
        horizon = int(now / self._dt) - self.n_buckets
        return [h for h, e in zip(self._hists, self._epochs)
                if h is not None and e > horizon and h.count]

    def count(self, now: float) -> int:
        return sum(h.count for h in self._live(now))

    def quantile(self, q: float, now: float) -> float:
        live = self._live(now)
        if not live:
            return 0.0
        if all(h._buf is not None for h in live):
            import numpy as np

            return float(np.quantile(
                np.concatenate([np.asarray(h._buf) for h in live]), q))
        total = sum(h.count for h in live)
        return sum(h.quantile(q) * h.count for h in live) / total


class SloMonitor:
    """Multi-window burn-rate SLO monitor over a per-request latency stream.

    Feed it from the server's retire path (``observe`` per request); read
    it through :meth:`summary` (registered under ``slo.*``) or
    :attr:`alerting`.  ``now`` is explicit everywhere so the same monitor
    runs on wall time (live serving) or the replay's virtual clock with
    bit-identical verdicts.
    """

    def __init__(self, objective: SloObjective, tracer=None,
                 clock_epoch: float | None = None):
        self.objective = objective
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._epoch = (time.perf_counter() if clock_epoch is None
                       else clock_epoch)
        o = objective
        self._fast = _CountWindow(o.fast_window_s)
        self._slow = _CountWindow(o.slow_window_s)
        self._lat = WindowedHistogram(o.slow_window_s)
        # Lifetime totals (windows above forget; these never do).
        self.requests = 0
        self.good = 0
        self.deadline_met = 0
        self.deadline_total = 0  # observations that carried a deadline
        self.breaches = 0  # individual observations over latency_target_s
        self.alerts_fired = 0
        self.alerts_resolved = 0
        self.alerting = False
        self._t_first = None
        self._t_last = 0.0

    # ------------------------------------------------------------- ingestion

    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    def observe(self, latency_s: float, now: float | None = None,
                deadline_met: bool | None = None) -> None:
        """Record one retired request.  ``now`` in seconds on the monitor's
        clock (wall by default; pass virtual timestamps in replay)."""
        if now is None:
            now = self._now()
        o = self.objective
        good = latency_s <= o.latency_target_s
        self.requests += 1
        if self._t_first is None:
            self._t_first = now
        self._t_last = max(self._t_last, now)
        if good:
            self.good += 1
        else:
            self.breaches += 1
        if deadline_met is not None:
            self.deadline_total += 1
            if deadline_met:
                self.deadline_met += 1
        self._fast.add(now, good)
        self._slow.add(now, good)
        self._lat.add(latency_s, now)
        self._evaluate(now)

    # ------------------------------------------------------------ burn rates

    def _burn(self, win: _CountWindow, now: float) -> tuple[float, int]:
        good, bad = win.totals(now)
        n = good + bad
        if n == 0:
            return 0.0, 0
        budget = 1.0 - self.objective.target
        return (bad / n) / budget, n

    def burn_rates(self, now: float | None = None) -> tuple[float, float]:
        """(fast, slow) window burn rates at ``now`` (1.0 = sustainable)."""
        if now is None:
            now = self._now()
        return self._burn(self._fast, now)[0], self._burn(self._slow, now)[0]

    def _evaluate(self, now: float) -> None:
        o = self.objective
        bf, nf = self._burn(self._fast, now)
        bs, ns = self._burn(self._slow, now)
        ready = nf >= o.min_samples and ns >= o.min_samples
        hot = ready and bf >= o.burn_threshold and bs >= o.burn_threshold
        if hot and not self.alerting:
            self.alerting = True
            self.alerts_fired += 1
            if self.tracer.enabled:
                self.tracer.instant(
                    "slo_alert_fire", CAT_SLO, now,
                    args={"burn_fast": round(bf, 3),
                          "burn_slow": round(bs, 3),
                          "threshold": o.burn_threshold},
                )
        elif self.alerting and ready and bf < o.burn_threshold:
            # Fast window recovering is the resolve signal (the slow window
            # keeps the stale bad counts for up to slow_window_s more).
            self.alerting = False
            self.alerts_resolved += 1
            if self.tracer.enabled:
                self.tracer.instant(
                    "slo_alert_resolve", CAT_SLO, now,
                    args={"burn_fast": round(bf, 3),
                          "burn_slow": round(bs, 3)},
                )

    # --------------------------------------------------------------- reading

    def window_quantile(self, q: float, now: float | None = None) -> float:
        """Latency quantile over the trailing slow window."""
        if now is None:
            now = self._now()
        return self._lat.quantile(q, now)

    def summary(self, now: float | None = None) -> dict:
        """Registry-provider dict: register under the ``slo`` prefix."""
        if now is None:
            now = self._now()
        bf, bs = self.burn_rates(now)
        span = (self._t_last - self._t_first) if self._t_first is not None \
            else 0.0
        rps = self.requests / span if span > 0 else 0.0
        # Goodput: deadline-met rate when deadlines were stamped, else the
        # SLO-good rate (latency under target) as the proxy.
        good_n = self.deadline_met if self.deadline_total else self.good
        goodput = good_n / span if span > 0 else 0.0
        o = self.objective
        return {
            "objective": {
                "latency_target_s": o.latency_target_s,
                "target": o.target,
                "fast_window_s": o.fast_window_s,
                "slow_window_s": o.slow_window_s,
                "burn_threshold": o.burn_threshold,
            },
            "requests": self.requests,
            "good": self.good,
            "breaches": self.breaches,
            "good_fraction": self.good / self.requests if self.requests
            else 1.0,
            "deadline_met": self.deadline_met,
            "deadline_total": self.deadline_total,
            "throughput_rps": rps,
            "goodput_rps": goodput,
            "burn_fast": bf,
            "burn_slow": bs,
            "alerting": self.alerting,
            "alerts_fired": self.alerts_fired,
            "alerts_resolved": self.alerts_resolved,
            "window": {
                "count": self._lat.count(now),
                "p50_s": self._lat.quantile(0.5, now),
                "p99_s": self._lat.quantile(0.99, now),
            },
        }
