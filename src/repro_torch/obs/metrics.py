"""Unified metrics registry: counters, gauges, streaming-quantile histograms.

One process-wide :class:`MetricsRegistry` collects every subsystem's metrics
under a stable dotted namespace (``serve.*``, ``tier.*``, ``rdma.pool.*``,
``rdma.pool.credit_window.*``, ``prefetch.*`` — see docs/OBSERVABILITY.md)
and exports them as a single flat JSON snapshot.  Two kinds of sources:

  * **Instruments** — :class:`Counter`, :class:`Gauge`, :class:`Histogram`
    objects created through the registry and updated by the hot path.  All
    are thread-safe (engine-pool threads update them concurrently with the
    serving thread) and bounded: the histogram keeps an exact window of the
    first ``warmup`` observations (small-sample quantiles are *interpolated*,
    never floor-indexed) and then hands off to P² streaming estimators
    (Jain & Chlamtac 1985) — five markers per tracked quantile, O(1) memory
    forever after.
  * **Providers** — the existing ``summary()`` callables of FlexEMRServer /
    ServeMetrics, RdmaEnginePool, TieredLookupService, PrefetchEngine and
    CreditGate, registered under a prefix; ``snapshot()`` calls them and
    flattens their nested dict/list output into dotted keys.

Nothing here imports jax or the serving stack: the registry must stay
importable from every layer (verbs, engine, serving) without cycles.
"""
from __future__ import annotations

import json
import threading

import numpy as np


class P2Quantile:
    """P² streaming estimator of one quantile (Jain & Chlamtac 1985).

    Five markers track (min, q/2-ish, q, (1+q)/2-ish, max); each observation
    shifts marker positions and adjusts heights with a piecewise-parabolic
    fit.  O(1) memory, no buffering past the first five observations.
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        self.q = q
        self._init_buf: list[float] = []
        self._n: list[float] = []  # marker positions (1-based)
        self._h: list[float] = []  # marker heights
        self._np: list[float] = []  # desired positions
        self._dn = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def add(self, x: float) -> None:
        if self._h:
            self._add_steady(x)
            return
        self._init_buf.append(x)
        if len(self._init_buf) == 5:
            self._init_buf.sort()
            self._h = list(self._init_buf)
            self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
            q = self.q
            self._np = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q,
                        3.0 + 2.0 * q, 5.0]
            self._init_buf = []

    def _add_steady(self, x: float) -> None:
        n, h = self._n, self._h
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                d = 1.0 if d > 0 else -1.0
                # piecewise-parabolic (P²) height adjustment
                hp = h[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (h[i + 1] - h[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1])
                    / (n[i] - n[i - 1])
                )
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # parabola left the bracket: fall back to linear
                    j = i + (1 if d > 0 else -1)
                    h[i] = h[i] + d * (h[j] - h[i]) / (n[j] - n[i])
                n[i] += d

    def value(self) -> float:
        if self._h:
            return float(self._h[2])
        if not self._init_buf:
            return 0.0
        # <5 observations: exact interpolated quantile over the buffer
        return float(np.quantile(np.asarray(self._init_buf), self.q))


class Counter:
    """Thread-safe monotonically increasing counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    inc = add

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A point-in-time value: either ``set()`` by the owner or pulled from a
    callback at snapshot time (for values like queue depth that live in
    someone else's data structure)."""

    __slots__ = ("_value", "_fn", "_lock")

    def __init__(self, fn=None):
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value


class Histogram:
    """Bounded-memory streaming histogram with interpolated quantiles.

    Keeps an exact buffer of the first ``warmup`` observations — quantiles
    over it use proper linear interpolation (``np.quantile``), fixing the
    small-sample floor-indexing bias of ``sorted(x)[int(0.99*(len(x)-1))]``
    — then switches to one P² estimator per tracked quantile: O(1) memory
    however long the server runs.  count/sum/min/max are always exact.
    """

    def __init__(self, quantiles=(0.5, 0.9, 0.99), warmup: int = 256):
        if warmup < 5:
            raise ValueError("warmup must be >= 5 (P² seeding)")
        self.quantiles = tuple(float(q) for q in quantiles)
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._buf: list[float] | None = []
        self._p2 = {q: P2Quantile(q) for q in self.quantiles}
        self._lock = threading.Lock()

    def add(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self.count += 1
            self.total += x
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x
            for est in self._p2.values():
                est.add(x)
            if self._buf is not None:
                self._buf.append(x)
                if len(self._buf) > self.warmup:
                    self._buf = None  # hand off to the P² estimators

    def extend(self, xs) -> None:
        for x in xs:
            self.add(x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Interpolated (exact while in warmup, P² after).

        ``q`` must be one of the tracked quantiles once the exact buffer has
        been handed off; while the buffer is live any q works exactly.
        """
        with self._lock:
            if self.count == 0:
                return 0.0
            if self._buf is not None:
                return float(np.quantile(np.asarray(self._buf), q))
            est = self._p2.get(float(q))
            if est is None:
                raise ValueError(
                    f"quantile {q} not tracked (have {self.quantiles}); "
                    "past warmup only tracked quantiles are available"
                )
            return est.value()

    def summary(self) -> dict:
        with self._lock:
            count, total = self.count, self.total
        out = {
            "count": count,
            "sum": total,
            "mean": total / count if count else 0.0,
            "min": self.min if count else 0.0,
            "max": self.max if count else 0.0,
        }
        for q in self.quantiles:
            out[f"p{q * 100:g}".replace(".", "_")] = self.quantile(q)
        return out


def _flatten(prefix: str, value, out: dict) -> None:
    """Flatten nested dicts/lists/tuples into dotted keys with JSON scalars."""
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(value, (list, tuple, np.ndarray)):
        for i, v in enumerate(np.asarray(value).tolist()
                              if isinstance(value, np.ndarray) else value):
            _flatten(f"{prefix}.{i}", v, out)
    elif isinstance(value, (np.integer,)):
        out[prefix] = int(value)
    elif isinstance(value, (np.floating,)):
        out[prefix] = float(value)
    elif isinstance(value, (bool, int, float, str)) or value is None:
        out[prefix] = value
    else:  # last resort: stringify rather than break the JSON export
        out[prefix] = str(value)


class MetricsRegistry:
    """Process-wide named-instrument + provider registry (see module doc).

    Instruments are get-or-create by dotted name, so two subsystems naming
    the same counter share it.  ``snapshot()`` is safe to call concurrently
    with updates: instruments take their own locks, and providers are the
    pre-existing ``summary()`` methods (which take theirs).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._providers: dict[str, object] = {}

    # ------------------------------------------------------------ instruments

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str, fn=None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None or (fn is not None and g._fn is not fn):
                g = self._gauges[name] = Gauge(fn)
            return g

    def histogram(self, name: str, quantiles=(0.5, 0.9, 0.99),
                  warmup: int = 256) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(quantiles, warmup)
            return h

    # -------------------------------------------------------------- providers

    def register_provider(self, prefix: str, fn) -> None:
        """Register ``fn() -> dict`` whose output lands under ``prefix.*``.

        Re-registering a prefix replaces the provider (a rebuilt server
        takes over its namespace instead of double-reporting)."""
        with self._lock:
            self._providers[prefix] = fn

    def unregister_provider(self, prefix: str) -> None:
        with self._lock:
            self._providers.pop(prefix, None)

    # --------------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """One flat ``{dotted.name: scalar}`` dict over every instrument and
        provider — the single JSON export of the whole serving process."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
            providers = dict(self._providers)
        out: dict = {}
        for name, c in counters.items():
            _flatten(name, c.value, out)
        for name, g in gauges.items():
            _flatten(name, g.value, out)
        for name, h in hists.items():
            _flatten(name, h.summary(), out)
        for prefix, fn in providers.items():
            try:
                _flatten(prefix, fn(), out)
            except Exception as exc:  # a dead provider must not kill export
                out[f"{prefix}.error"] = repr(exc)
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (components accept an override)."""
    return _GLOBAL
