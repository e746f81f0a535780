"""Credit-based flow control with a priority credit channel (paper §3.2, T6).

The ranker bounds each per-connection response queue with *credits*; the
embedding server may only push a response when it holds a credit.  In the
strawman, credit grants share the channel with data messages and get stuck
behind bursts (head-of-line blocking); FlexEMR gives credits a dedicated
higher-QoS channel so the server learns about freed queue slots immediately.

This module is the executable model used by the serving runtime and by the
Fig-8(right) benchmark: `CreditedConnection` with `priority_credits=False`
reproduces the strawman, `True` the FlexEMR fast path.  `CreditGate` is the
*live* (thread-safe) form of the same window, enforcing the bounded
in-flight budget inside the repro.rdma engine pool.  The SPMD counterpart
(chunk quotas on collectives) lives in the lookup schedule itself.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import threading
import time
from typing import Iterable


class CreditGate:
    """Thread-safe bounded in-flight window — the live form of the credit
    scheme above, used by ``repro.rdma.RdmaEnginePool`` to cap outstanding
    lookup subrequests.

    Each posted subrequest consumes a credit; its completion returns it.
    ``acquire`` blocks the posting engine thread when the window is full,
    which is exactly the back-pressure the §3.2 credit loop applies to the
    embedding server.  The gate records how often posts stalled
    (``stalls``) and the peak window occupancy (``peak``) so the serving
    metrics can show whether the window, the wire, or the engines bound a
    run.  ``CreditedConnection`` stays the discrete-time model of the same
    mechanism (it prices *when* a credit comes back); the gate enforces
    *that* it must.
    """

    def __init__(self, max_credits: int = 64):
        if max_credits <= 0:
            raise ValueError("max_credits must be positive")
        self.max_credits = max_credits
        self._inflight = 0
        self._cond = threading.Condition()
        self.stalls = 0  # acquire() calls that had to wait
        self.stall_seconds = 0.0  # wall time posts spent blocked on the window
        self.peak = 0  # max simultaneous in-flight observed

    def acquire(self, n: int = 1, timeout: float | None = None) -> bool:
        """Take ``n`` credits, blocking while the window is full.

        ``n`` is clamp-checked against the window size (an acquire larger
        than the window would deadlock).  Returns False on timeout.
        """
        if n > self.max_credits:
            raise ValueError(
                f"acquire({n}) exceeds the credit window ({self.max_credits})"
            )
        with self._cond:
            stalled = self._inflight + n > self.max_credits
            if stalled:
                self.stalls += 1
                t0 = time.monotonic()
            ok = self._cond.wait_for(
                lambda: self._inflight + n <= self.max_credits, timeout
            )
            if stalled:
                self.stall_seconds += time.monotonic() - t0
            if not ok:
                return False
            self._inflight += n
            self.peak = max(self.peak, self._inflight)
            return True

    def release(self, n: int = 1) -> None:
        with self._cond:
            if n > self._inflight:
                raise RuntimeError("credit released without a matching acquire")
            self._inflight -= n
            self._cond.notify_all()

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def summary(self) -> dict:
        return {
            "max_credits": self.max_credits,
            "stalls": self.stalls,
            "stall_seconds": self.stall_seconds,
            "peak": self.peak,
        }


@dataclasses.dataclass(order=True)
class _Msg:
    deliver_at: float
    seq: int
    kind: str = dataclasses.field(compare=False)  # 'data' | 'credit'
    size: float = dataclasses.field(compare=False, default=1.0)


class SimChannel:
    """A serialized link: messages are delivered FIFO at `byte_time` per byte.

    Models one direction of the RDMA connection.  If `priority` is True the
    channel preempts nothing but is *separate*, so small messages never queue
    behind large ones on the paired data channel.
    """

    def __init__(self, byte_time: float):
        self.byte_time = byte_time
        self.busy_until = 0.0
        self.delivered: list[_Msg] = []
        self._seq = 0

    def send(self, now: float, kind: str, size: float) -> float:
        start = max(now, self.busy_until)
        done = start + size * self.byte_time
        self.busy_until = done
        self._seq += 1
        msg = _Msg(deliver_at=done, seq=self._seq, kind=kind, size=size)
        self.delivered.append(msg)
        return done


class CreditedConnection:
    """One <ranker, embedding-server> pair under credit flow control.

    Discrete-time model:
      * the server holds `credits`; sending a response consumes one;
      * the ranker drains its queue at `drain_time` per response and returns a
        credit after each drain;
      * credit messages travel back on the data channel (strawman) or on a
        dedicated priority channel (FlexEMR).
    """

    def __init__(
        self,
        max_credits: int = 8,
        response_size: float = 512.0,  # bytes per pooled response
        credit_size: float = 16.0,
        byte_time: float = 1e-8,  # 100 Gbps-ish: 1e-8 s/byte
        drain_time: float = 2e-6,
        priority_credits: bool = True,
    ):
        self.max_credits = max_credits
        self.credits = max_credits
        self.response_size = response_size
        self.credit_size = credit_size
        self.drain_time = drain_time
        self.priority_credits = priority_credits
        self.down = SimChannel(byte_time)  # server -> ranker (responses)
        self.up_data = SimChannel(byte_time)  # ranker -> server (requests+credits)
        self.up_credit = SimChannel(byte_time) if priority_credits else self.up_data
        self.credit_latencies: list[float] = []
        self.response_latencies: list[float] = []

    def credit_return_latency(self) -> float:
        """Unloaded flight time of one credit grant back to the server.

        This is the *floor* a blocked post pays for the window to reopen
        (under load the strawman's shared channel pays far more — that is
        ``run_burst``'s whole point).  The rdma verbs model charges exactly
        this floor per credit-blocked post (``VerbsTiming.t_credit_return``
        / ``VerbsTiming.from_flow_control``), so simulated p99 reflects
        window stalls instead of pricing them at zero.
        """
        return self.credit_size * self.up_credit.byte_time

    def run_burst(self, num_responses: int, request_size: float = 64.0) -> dict:
        # request_size=64 puts the shared channel at ~70% utilization — the
        # paper's regime (~35-40% credit-latency win).  At >=96B the strawman
        # saturates and collapses outright (>99% win) — see EXPERIMENTS.md.
        """Server answers a burst of `num_responses`; returns latency stats.

        The ranker is simultaneously issuing lookup requests (bulk traffic on
        the up-data channel), which is what blocks credit grants in the
        strawman.
        """
        import numpy as _np

        rng = _np.random.default_rng(7)
        now = 0.0
        ready: list[float] = []  # times at which a drained slot frees a credit

        sent = 0
        drain_free = 0.0
        while sent < num_responses:
            if self.credits > 0:
                self.credits -= 1
                # the ranker keeps issuing lookups on the shared up channel in
                # bursty arrivals (~70% utilization): the strawman's credit
                # grants queue behind these bursts — the §3.2 HoL blocking
                for _ in range(int(rng.poisson(5))):
                    self.up_data.send(now, "data", request_size)
                t_sent = self.down.send(now, "data", self.response_size)
                # ranker drains serially
                drain_free = max(drain_free, t_sent) + self.drain_time
                self.response_latencies.append(drain_free - now)
                # credit granted when drained; travels back on credit channel
                granted = self.up_credit.send(drain_free, "credit", self.credit_size)
                ready.append(granted)
                self.credit_latencies.append(granted - drain_free)
                sent += 1
            else:
                # wait for the earliest credit to arrive back at the server
                ready.sort()
                now = max(now, ready.pop(0))
                self.credits += 1
        return {
            "mean_credit_latency": (
                sum(self.credit_latencies) / len(self.credit_latencies)
            ),
            "p99_credit_latency": sorted(self.credit_latencies)[
                int(0.99 * (len(self.credit_latencies) - 1))
            ],
            "makespan": max(self.down.busy_until, drain_free),
        }


def compare_credit_paths(
    num_responses: int = 512, **kw
) -> dict[str, dict]:
    """Strawman (shared channel) vs FlexEMR (priority channel) — Fig 8 right."""
    strawman = CreditedConnection(priority_credits=False, **kw)
    flexemr = CreditedConnection(priority_credits=True, **kw)
    return {
        "strawman": strawman.run_burst(num_responses),
        "flexemr": flexemr.run_burst(num_responses),
    }
