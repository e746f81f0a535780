"""End-to-end tracer: per-batch spans + per-WR events, Chrome-trace export.

One :class:`Tracer` records the journey of every batch through the serving
hot path as *complete* spans (``ph: "X"``) and *instant* events (``ph:
"i"``) in the Chrome trace event format, loadable directly in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.

Two timelines, exported as two Perfetto "processes":

  * ``PID_WALL`` — real wall-clock time (``time.perf_counter`` relative to
    the tracer's epoch).  The serving thread's admit/probe/post/stall/dense/
    merge spans and the engine threads' hedge win/cancel instants live here.
  * ``PID_VIRTUAL`` — the rdma verbs layer's deterministic virtual clock
    (``rdma.verbs.plan_schedule``).  Per-WR post->wire->server spans,
    doorbell instants, credit-stall spans, and steal instants live here,
    one Perfetto thread row per engine thread plus a ``batches`` row for
    whole-batch spans.  Virtual timestamps are reproducible run to run.

Emission is thread-safe (engine threads trace concurrently with the serving
loop) and bounded: past ``max_events`` new events are dropped and counted,
never silently resized.  The disabled path is :data:`NULL_TRACER`: every
instrumented site guards with ``if tracer.enabled:`` so tracing off costs
one attribute read per site.

Span args carry the correlation keys (``batch``, ``server``, ``slot``,
``rows``, ``bytes``...) that let tools/trace_export.py and the tests join
WR events to their batch span.  See docs/OBSERVABILITY.md for the taxonomy.
"""
from __future__ import annotations

import json
import threading
import time

# Perfetto "process" ids (timelines).
PID_WALL = 1  # wall clock: serving loop + engine-thread real events
PID_VIRTUAL = 2  # rdma verbs virtual time: WR schedule events

# Span/event categories (the ``cat`` field: filterable in Perfetto).
CAT_SERVE = "serve"  # admit / batch / retire
CAT_CACHE = "cache"  # probe / swap-in
CAT_LOOKUP = "lookup"  # post / stall / merge
CAT_DENSE = "dense"  # jit'd ranker stage
CAT_WIRE = "wire"  # per-WR virtual spans, doorbells, range reads
CAT_CREDIT = "credit"  # credit-window stalls
CAT_STEAL = "steal"  # work stealing
CAT_HEDGE = "hedge"  # hedge arm / win / cancel
CAT_PREFETCH = "prefetch"  # piggybacked speculative fetches
CAT_SLO = "slo"  # burn-rate alert fire/resolve instants, attribution marks
CAT_CHAOS = "chaos"  # fault injection: kill/drop/storm/reshard + recovery
CAT_ADMISSION = "admission"  # shed / adaptive-depth decisions at submit
CAT_RETRY = "retry"  # per-WR backoff retries + virtual-timeout re-flights

# The wall-clock serving thread's Perfetto thread row.
TID_RANKER = 0
# The virtual timeline's whole-batch row (engine rows are 0..T-1).
TID_VBATCH = 10_000


class NullTracer:
    """No-op tracer: the default.  ``enabled`` is False, so instrumented
    code skips event construction entirely (one branch per site)."""

    enabled = False

    def now(self) -> float:
        return 0.0

    def complete(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def name_thread(self, *a, **k) -> None:
        pass

    def save(self, *a, **k) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Collecting tracer (see module docstring)."""

    enabled = True

    def __init__(self, max_events: int = 1_000_000):
        self.max_events = max_events
        self.epoch = time.perf_counter()
        self.dropped = 0
        self._events: list[tuple] = []  # (ph, name, cat, ts, dur, pid, tid, args)
        self._thread_names: dict[tuple[int, int], str] = {
            (PID_WALL, TID_RANKER): "ranker",
            (PID_VIRTUAL, TID_VBATCH): "batches",
        }
        self._lock = threading.Lock()

    # ------------------------------------------------------------- recording

    def now(self) -> float:
        """Wall-clock seconds since the tracer epoch (PID_WALL timebase)."""
        return time.perf_counter() - self.epoch

    def complete(
        self,
        name: str,
        cat: str,
        ts: float,
        dur: float,
        pid: int = PID_WALL,
        tid: int = TID_RANKER,
        args: dict | None = None,
    ) -> None:
        """Record a complete span [ts, ts+dur] (seconds, timeline ``pid``)."""
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(("X", name, cat, ts, dur, pid, tid, args))

    def instant(
        self,
        name: str,
        cat: str,
        ts: float,
        pid: int = PID_WALL,
        tid: int = TID_RANKER,
        args: dict | None = None,
    ) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(("i", name, cat, ts, 0.0, pid, tid, args))

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        with self._lock:
            self._thread_names[(pid, tid)] = name

    # --------------------------------------------------------------- queries

    def events(self, name: str | None = None, cat: str | None = None):
        """Snapshot of recorded events as dicts (test/tooling surface)."""
        with self._lock:
            evs = list(self._events)
        out = []
        for ph, n, c, ts, dur, pid, tid, args in evs:
            if name is not None and n != name:
                continue
            if cat is not None and c != cat:
                continue
            out.append(
                {"ph": ph, "name": n, "cat": c, "ts": ts, "dur": dur,
                 "pid": pid, "tid": tid, "args": args or {}}
            )
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # ---------------------------------------------------------------- export

    def to_chrome(self) -> dict:
        """Chrome trace event format: microsecond timestamps, metadata rows
        naming the two timelines — drop the file into Perfetto as-is."""
        with self._lock:
            evs = list(self._events)
            names = dict(self._thread_names)
        trace: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": PID_WALL, "tid": 0,
             "args": {"name": "ranker (wall clock)"}},
            {"ph": "M", "name": "process_name", "pid": PID_VIRTUAL, "tid": 0,
             "args": {"name": "rdma verbs (virtual time)"}},
        ]
        for (pid, tid), name in sorted(names.items()):
            trace.append(
                {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                 "args": {"name": name}}
            )
        for ph, name, cat, ts, dur, pid, tid, args in evs:
            ev = {
                "ph": ph,
                "name": name,
                "cat": cat,
                "ts": ts * 1e6,  # Chrome trace format wants microseconds
                "pid": pid,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = dur * 1e6
            if ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = args
            trace.append(ev)
        return {
            "traceEvents": trace,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
