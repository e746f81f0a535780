"""Simulated RDMA verbs layer for the multi-threaded lookup engine (§3.2).

Paper anchor: §3.2 — "an optimized multi-threaded RDMA engine for concurrent
lookup subrequests".  This container has no RNIC, so the *timing* of the
verbs path is simulated while the *data* path (the numpy gather/pool at each
embedding server) is executed for real by the engine threads in
``repro.rdma.engine``.

The model, in verbs vocabulary:

  * ``LookupSubrequest`` is one work request (WR): a per-shard slice of a
    batched lookup, destined for one embedding server.
  * Each engine thread owns a private queue pair (QP) per server — the
    mapping-aware design of Fig 6 (right): no two threads ever share a
    send queue, so there is no cross-thread unit contention to pay.
  * WRs are posted in *doorbell batches*: one MMIO doorbell (``t_doorbell``)
    covers up to ``doorbell_batch`` WQE writes (``t_post`` each) — the
    standard verbs amortization, mirrored on the completion side by polling
    the CQ in sweeps.
  * A QP's wire serializes: two responses on the same QP cannot overlap, so
    a shard whose subrequests all land on one thread is wire-bound until
    work-stealing spreads its chunks across threads (and thus across QPs).
  * The bounded in-flight window (``max_inflight``) models the §3.2 credit
    loop: a post whose window is full waits for the earliest outstanding
    completion *plus the credit-return flight time* (``t_credit_return``,
    priced from ``core.flow_control.CreditedConnection`` — the window is
    reopened by a credit grant travelling back, not by the completion
    itself).  ``core.flow_control.CreditGate`` enforces the same bound on
    the real threads.
  * ``VerbsState`` carries the per-engine clocks, QP wire horizons, and the
    outstanding-credit heap *across batches*: a batch posted while the
    previous one is still on the wire (cross-batch pipelining) is priced
    against busy QPs and a part-consumed credit window, not a fresh t=0.
    The state's ``now`` frontier only advances when a caller actually
    blocks on a batch (``RdmaEnginePool.sync_frontier``), so back-to-back
    submissions between waits are modeled as overlapped.
  * **Deduplicated WRs** (§3.1.1 temporal locality at the wire): a WR with
    ``dedup=True`` carries *unique* row ids — the service layer removed the
    batch's duplicate references before posting and scatters the returned
    rows back through ``gather_idx`` at the ranker.  Its response is priced
    per unique row (``response_bytes``), its request per id
    (``request_bytes``, 8 B each).  A dedup WR whose ids form one dense run
    is a **range read** (``contiguous=True``): one WQE posts one contiguous
    payload — no per-row wire tags (the payload is the raw row span) and a
    single 16 B (start, len) request descriptor — so doorbell batching and
    the credit window see fewer, larger WRs instead of many small ones.
    The timing model needs no special case: fewer WRs means fewer
    ``t_post``/``t_server`` charges, and the contiguous payload serializes
    on the QP wire exactly like any other ``response_bytes``.

``plan_schedule`` runs this model as a deterministic discrete-event
simulation over per-thread virtual clocks.  It decides which engine posts
each WR (idle engines steal from the longest backlog, exactly the policy the
real threads apply) and stamps every WR with its virtual completion time.
Determinism matters: per-batch p50/p99 and per-thread utilization must not
depend on OS scheduling noise, or the benchmark baselines and the simulator
calibration (``runtime.simulator.calibrate_to_engine``) would drift run to
run.

Invariants:
  * Scheduling never reorders the *merge*: results are combined in subrequest
    issue order by the service layer, so pooled outputs are bit-equal across
    thread counts, chunk sizes, stealing decisions, affinity tables, and
    pipeline depths.
  * ``plan_schedule`` touches only timing fields (``engine``, ``stolen``,
    ``v_complete``); row data flows exclusively through the real execution
    path.
  * With a shared ``VerbsState`` whose frontier was synced past the previous
    batch's completion, a batch prices identically to a fresh state: the
    closed-loop (depth-1) numbers are unchanged by the carry-over.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq

import numpy as np


class TransientWireError(RuntimeError):
    """A WR completion error worth retrying (flaky link, CQE flush, RNR).

    The engine's retry ladder (``RetryPolicy``) re-posts a WR that raised
    this, after a seeded-deterministic exponential backoff, up to the
    attempt cap and the pool-wide retry budget.  Anything else a server
    raises is treated as a hard failure and settles the slot immediately —
    retrying a deterministic bug only burns budget.
    """


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/timeout/backoff ladder for work requests (overload-safe).

    Three rungs, all deterministic given the same fault sequence:

      * **Backoff retry**: a WR that raises :class:`TransientWireError` is
        re-posted up to ``max_attempts`` total tries, sleeping
        ``backoff_base_s * backoff_mult**(attempt-1)`` plus seeded jitter
        between tries.  The jitter is a pure function of ``(seed, server,
        slot, attempt)`` — never wall clock — so a replayed fault sequence
        backs off identically run after run.
      * **Per-WR virtual timeout**: a WR whose priced flight time exceeds
        ``timeout_mult`` times its healthy (``latency_mult == 1``) span —
        i.e. a straggler-storm victim — is abandoned at the timeout mark on
        the emulated wire and re-flown once on the healthy path.  The wall
        watchdog for genuinely hung shards stays with the chaos layer's
        stall probe (``ChaosInjector.guarded_wait``).
      * **Retry budget**: retries, timeout re-flights, AND straggler
        hedges are charged against one pool-wide budget of
        ``budget_frac * primary subrequests``.  A charge that would exceed
        the budget is denied (the WR fails or flies the slow path instead),
        so mitigation traffic can never amplify an overload past the
        configured fraction.

    Bit-equality contract: with no fault fired, no rung triggers — every
    retry path re-executes the identical gather, so outputs are bit-equal
    with the policy on or off regardless.
    """

    max_attempts: int = 3  # total tries per WR (1 = no retry)
    backoff_base_s: float = 1e-4
    backoff_mult: float = 2.0
    jitter: float = 0.5  # fraction of the backoff randomized (seeded)
    budget_frac: float = 0.1  # (retries + hedges) / primary WRs cap
    timeout_mult: float = 4.0  # virtual timeout = mult * healthy WR span
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.budget_frac < 0.0:
            raise ValueError("budget_frac must be >= 0")
        if self.timeout_mult <= 1.0:
            raise ValueError("timeout_mult must be > 1")

    def backoff_delay_s(self, server: int, slot: int, attempt: int) -> float:
        """Deterministic backoff before try ``attempt + 1`` (attempt >= 1)."""
        base = self.backoff_base_s * self.backoff_mult ** (attempt - 1)
        r = np.random.default_rng(
            (self.seed, int(server) & 0x7FFFFFFF, int(slot) & 0x7FFFFFFF,
             attempt)
        ).random()
        return base * (1.0 + self.jitter * r)


@dataclasses.dataclass(frozen=True)
class VerbsTiming:
    """Calibration constants of the simulated verbs path.

    Defaults follow ``runtime.simulator.SimConfig`` (1us WQE post, 3us
    server-side processing, 100 Gbps wire) so the two models start from the
    same regime; ``calibrate_to_engine`` closes the remaining gap.
    """

    t_doorbell: float = 0.4e-6  # MMIO doorbell ring, once per batch
    t_post: float = 1.0e-6  # WQE build + post, per work request
    t_steal: float = 0.25e-6  # deque CAS + cacheline bounce on a steal
    t_server: float = 3.0e-6  # embedding-server processing per WR
    wire_bps: float = 100e9 / 8  # response payload bytes/s
    # Request-direction channel: the doorbell-batched WQE writes carry the
    # scattered id lists (``request_bytes``) across the same full-duplex
    # link, so a WR's span is request flight -> server -> response flight.
    # Pushdown shrinks responses to one vector per segment, which makes the
    # id-list requests the next wire bottleneck — pricing them keeps the
    # virtual clock honest in that regime.
    req_wire_bps: float = 100e9 / 8  # request payload bytes/s
    # Credit-return flight time charged to a post blocked on the in-flight
    # window: the window reopens when the credit *arrives back*, not when
    # the response completes.  Default = CreditedConnection's priority
    # channel (credit_size 16B at 1e-8 s/B); from_flow_control derives it
    # from a configured connection.  0 restores the free-credit model.
    t_credit_return: float = 0.16e-6

    @classmethod
    def from_flow_control(cls, conn, **kw) -> "VerbsTiming":
        """Couple the window price to a ``flow_control.CreditedConnection``:
        blocked posts pay that connection's credit-return latency."""
        return cls(t_credit_return=conn.credit_return_latency(), **kw)


@dataclasses.dataclass
class LookupSubrequest:
    """One work request: a per-shard (sub-)slice of a batched lookup.

    With ``dedup=True`` the WR is the unique-row wire protocol of §3.1.1:
    ``row_ids`` are unique (sorted ascending), the server returns the raw
    rows once each, and the ranker scatters them into bags via
    ``rows[gather_idx]`` aligned with ``bag_ids``.  ``contiguous=True``
    marks a dedup WR whose ids form one dense run — a range read executed
    as a single shard slice (no per-row gather) and priced as one post +
    contiguous payload.
    """

    server: int
    row_ids: np.ndarray
    bag_ids: np.ndarray
    num_bags: int
    pushdown: bool
    response_bytes: int
    slot: int  # issue-order position == result slot (merge order)
    # Unique-row wire protocol (§3.1.1 wire dedup):
    dedup: bool = False
    gather_idx: np.ndarray | None = None  # scatter map: rows[gather_idx]
    contiguous: bool = False  # row_ids are one dense range (range read)
    request_bytes: int = 0  # request-direction bytes (ids or descriptor)
    # Pooled-segment WR (pushdown near-memory reduction, §3.1 follow-on):
    # S+1 bounds into row_ids; the server sum-pools each
    # row_ids[seg_bounds[s]:seg_bounds[s+1]] segment in float64 and ships
    # one [D] partial per segment — bag_ids then holds the S destination
    # bags and response_bytes prices S vectors, not rows.
    seg_bounds: np.ndarray | None = None
    # True on the duplicate WRs RdmaEnginePool.hedge re-issues (so the real
    # layer can attribute hedge wins/cancellations to the right side).
    hedge_dup: bool = False
    # Straggler-storm injection (repro.chaos): >1 multiplies this WR's wire
    # and server time, both in the virtual pricing below and in the pool's
    # emulate_wire sleep.  Hedge duplicates reset it to 1.0 — the re-issue
    # takes the healthy path, which is what makes hedging a mitigation.
    latency_mult: float = 1.0
    # Epoch binding for quiesce-free live resharding (repro.chaos): the
    # engine pool stamps the server OBJECT this WR was cut against at
    # submit, so a reshard that swaps the shard map mid-flight cannot
    # re-route an old-epoch WR onto a new-epoch shard (dual-read window).
    server_obj: object = None
    # Stamped by plan_schedule:
    engine: int = -1
    stolen: bool = False
    v_complete: float = 0.0


@dataclasses.dataclass
class SchedulePlan:
    """Output of plan_schedule for one batch of subrequests."""

    assignments: list  # assignments[tid] = ordered [LookupSubrequest]
    makespan: float  # virtual batch latency (max completion - arrival)
    busy: list  # per-thread posting occupancy this batch (seconds, virtual)
    steals: int  # WRs executed by a thread other than their affinity owner
    doorbells: int  # doorbell batches rung
    arrival: float = 0.0  # absolute virtual submission time
    end: float = 0.0  # absolute virtual completion of the slowest WR
    credit_stall: float = 0.0  # virtual seconds posts spent window-blocked


@dataclasses.dataclass
class VerbsState:
    """Cross-batch virtual timing state of one engine pool.

    Survives between ``plan_schedule`` calls so a batch posted while an
    earlier one is still in flight contends with it for engine clocks, QP
    wire serialization, and window credits — the timing substrate of
    cross-batch pipelining.  ``now`` is the submission frontier: batches
    arrive at ``now``, and ``sync`` advances it to a completed batch's end
    (the closed-loop synchronization point).  A fresh state (or a frontier
    synced past every prior completion) degenerates to the independent
    per-batch model.
    """

    clock: list  # per-engine absolute posting clocks
    qp_busy: dict  # (engine, server) -> absolute wire-free time
    inflight: list  # absolute completion-time heap == outstanding credits
    now: float = 0.0  # submission frontier (absolute)

    @classmethod
    def fresh(cls, num_engines: int) -> "VerbsState":
        return cls(clock=[0.0] * num_engines, qp_busy={}, inflight=[], now=0.0)

    def sync(self, end: float) -> None:
        """Advance the frontier to a batch the caller actually waited on."""
        self.now = max(self.now, end)


def heat_affinity(shard_heat, num_threads: int) -> np.ndarray:
    """Heat-weighted shard -> engine-thread dealing table (LPT greedy).

    Shards are dealt hottest-first to the least-loaded thread, so two hot
    shards never share a thread by modulo accident and work stealing only
    has to rescue *unpredicted* skew, not the skew the controller already
    measured.  Deterministic (stable sort, lowest-tid tie break); falls
    back to ``shard % T`` when there is no heat signal at all.
    """
    heat = np.asarray(shard_heat, np.float64)
    if num_threads <= 0:
        raise ValueError("num_threads must be positive")
    if heat.ndim != 1 or len(heat) == 0 or not np.isfinite(heat).all() \
            or heat.min() < 0 or heat.sum() <= 0:
        return np.arange(max(len(heat), 1)) % num_threads
    order = np.argsort(-heat, kind="stable")
    load = np.zeros(num_threads, np.float64)
    aff = np.zeros(len(heat), np.int64)
    eps = float(heat.sum()) * 1e-12  # round-robin the all-cold tail
    for s in order:
        t = int(np.argmin(load))
        aff[int(s)] = t
        load[t] += heat[int(s)] + eps
    return aff


def plan_schedule(
    subreqs: list,
    num_engines: int,
    timing: VerbsTiming,
    doorbell_batch: int = 8,
    max_inflight: int = 32,
    work_stealing: bool = True,
    affinity: np.ndarray | None = None,
    state: VerbsState | None = None,
    tracer=None,
    batch_id: int = -1,
    disabled=None,
) -> SchedulePlan:
    """Deterministic virtual-time schedule of one batch's work requests.

    Affinity dealing (``affinity[shard]`` when a heat-weighted table is
    installed, ``shard % T`` otherwise) seeds per-thread FIFO queues; the
    event loop then advances whichever engine has the smallest virtual
    clock.  An engine with local work posts a doorbell batch from its queue
    head; an idle engine steals up to half the longest victim queue from the
    *tail* (classic work-stealing order, so the owner and the thief never
    contend for the same end).  Ties break on thread id, making the schedule
    a pure function of the subrequest list and the incoming ``state``.

    ``state`` (a ``VerbsState``) is mutated in place: engine clocks, QP wire
    horizons, and the outstanding-credit heap carry into the next batch, and
    this batch arrives at ``state.now``.  ``makespan`` is the batch latency
    relative to that arrival; ``end`` is the absolute completion.

    ``tracer`` (a ``repro.obs.Tracer``) turns the virtual clocks into span
    timestamps: one ``wr`` span per work request (post -> wire -> server, on
    the engine's virtual-timeline row), ``doorbell`` instants, ``steal``
    instants, and ``credit_stall`` spans for posts the in-flight window
    blocked — all tagged with ``batch_id`` so they nest inside the batch's
    ``lookup_batch`` span.  ``None`` (the default) emits nothing.

    ``disabled`` is the set of engine tids that have died (repro.chaos
    engine-kill): the virtual model re-deals their affinity traffic across
    the survivors (same deterministic remap the real dispatch applies),
    never advances their clocks, and never steals from or for them — so the
    post-fault virtual latencies price the degraded pool, not the healthy
    one.
    """
    if num_engines <= 0:
        raise ValueError("num_engines must be positive")
    disabled = frozenset(disabled or ())
    alive = [t for t in range(num_engines) if t not in disabled]
    if not alive:
        raise ValueError("all engines disabled: nothing can post")
    # A doorbell group must fit the credit window or its own post could
    # never be admitted (same clamp RdmaEnginePool applies).
    doorbell_batch = max(1, min(doorbell_batch, max_inflight))
    if tracer is not None and not tracer.enabled:
        tracer = None
    if tracer is not None:
        # Deferred import: verbs must stay importable below repro.obs.
        from repro_torch.obs.trace import (
            CAT_CREDIT,
            CAT_STEAL,
            CAT_WIRE,
            PID_VIRTUAL,
        )
    if state is None:
        state = VerbsState.fresh(num_engines)
    arrival = state.now
    queues: list[collections.deque] = [
        collections.deque() for _ in range(num_engines)
    ]
    for r in subreqs:
        if affinity is not None and 0 <= r.server < len(affinity):
            tid0 = int(affinity[r.server]) % num_engines
        else:
            tid0 = r.server % num_engines
        if tid0 in disabled:  # dead engine: deterministic re-deal
            tid0 = alive[tid0 % len(alive)]
        queues[tid0].append(r)

    # An engine idle since before this batch arrived starts at the arrival;
    # one still posting the previous batch keeps its (busier) clock.
    clock = [max(c, arrival) for c in state.clock]
    retired_clock = list(clock)  # real clocks behind any inf retirement
    busy = [0.0] * num_engines
    qp_busy = state.qp_busy  # (engine, server) -> wire free, carried over
    inflight = state.inflight  # completion-time heap == outstanding credits
    assignments: list[list] = [[] for _ in range(num_engines)]
    steals = 0
    doorbells = 0
    credit_stall = 0.0
    end = arrival

    while any(queues):
        tid = min(alive, key=lambda t: (clock[t], t))
        if clock[tid] == float("inf"):
            break  # no engine can make progress (stealing disabled)
        q = queues[tid]
        group: list = []
        if q:
            while q and len(group) < doorbell_batch:
                group.append(q.popleft())
        elif work_stealing:
            victim = max(alive, key=lambda t: (len(queues[t]), -t))
            n = max(1, min(len(queues[victim]) // 2, doorbell_batch))
            for _ in range(n):
                group.append(queues[victim].pop())
            group.reverse()  # preserve the victim's tail in FIFO order
            steals += len(group)
            if tracer is not None:
                tracer.instant(
                    "steal", CAT_STEAL, clock[tid], pid=PID_VIRTUAL, tid=tid,
                    args={"batch": batch_id, "victim": victim,
                          "wrs": len(group)},
                )
            clock[tid] += timing.t_steal
            busy[tid] += timing.t_steal
            for r in group:
                r.stolen = True
        else:
            # Drained and may not steal: retire from THIS batch's event
            # loop, remembering the real end-of-posting clock so the
            # carry-over prices the engine's actual availability.
            retired_clock[tid] = clock[tid]
            clock[tid] = float("inf")
            continue

        # Credit window: block the post until the WHOLE doorbell group fits,
        # mirroring CreditGate.acquire(len(group)) on the real threads.
        # Credits that already returned are free; a post that must *wait*
        # for one pays the credit-return flight on top of the completion
        # (the window reopens when the grant arrives, not when the response
        # lands) — the flow_control.CreditedConnection coupling.
        start = clock[tid]
        # A credit is usable once its grant has FLOWN back, not at the
        # response completion itself — the same pricing the blocked loop
        # below applies, so the free/blocked boundary is consistent.
        while inflight and inflight[0] + timing.t_credit_return <= start:
            heapq.heappop(inflight)
        while len(inflight) + len(group) > max_inflight:
            start = max(
                start, heapq.heappop(inflight) + timing.t_credit_return
            )
        if start > clock[tid]:
            credit_stall += start - clock[tid]
            if tracer is not None:
                tracer.complete(
                    "credit_stall", CAT_CREDIT, clock[tid],
                    start - clock[tid], pid=PID_VIRTUAL, tid=tid,
                    args={"batch": batch_id, "wrs": len(group)},
                )

        t = start + timing.t_doorbell
        doorbells += 1
        if tracer is not None:
            tracer.instant(
                "doorbell", CAT_WIRE, start, pid=PID_VIRTUAL, tid=tid,
                args={"batch": batch_id, "wrs": len(group)},
            )
        for r in group:
            post_start = t
            t += timing.t_post
            qk = (tid, r.server)
            # A straggler-storm WR (latency_mult > 1, repro.chaos) pays the
            # multiplier on wire + server time — the slow-server model.
            # The request-direction flight (scattered id lists in the WQE
            # writes) serializes on the same QP ahead of the response:
            # span = request flight -> server -> response flight.
            wire = r.response_bytes / timing.wire_bps * r.latency_mult
            req = r.request_bytes / timing.req_wire_bps * r.latency_mult
            wire_start = max(t, qp_busy.get(qk, 0.0))
            qp_busy[qk] = wire_start + req + wire
            r.v_complete = (
                wire_start + req + wire + timing.t_server * r.latency_mult
            )
            heapq.heappush(inflight, r.v_complete)
            r.engine = tid
            assignments[tid].append(r)
            end = max(end, r.v_complete)
            if tracer is not None:
                tracer.complete(
                    "range_read" if r.contiguous else "wr", CAT_WIRE,
                    post_start, r.v_complete - post_start,
                    pid=PID_VIRTUAL, tid=tid,
                    args={"batch": batch_id, "slot": r.slot,
                          "server": r.server, "rows": len(r.row_ids),
                          "bytes": r.response_bytes,
                          "req_bytes": r.request_bytes,
                          "pooled_segments": (
                              len(r.seg_bounds) - 1
                              if r.seg_bounds is not None else 0
                          ),
                          "stolen": r.stolen},
                )
        busy[tid] += t - start
        clock[tid] = t

    # Persist the carry-over.  Inf markers from stealing-off retirement are
    # local to this batch's event loop: the engine is merely idle next
    # batch, available from the point it actually finished posting.
    state.clock = [
        retired_clock[t] if clock[t] == float("inf") else clock[t]
        for t in range(num_engines)
    ]
    return SchedulePlan(
        assignments=assignments,
        makespan=end - arrival,
        busy=busy,
        steals=steals,
        doorbells=doorbells,
        arrival=arrival,
        end=end,
        credit_stall=credit_stall,
    )
