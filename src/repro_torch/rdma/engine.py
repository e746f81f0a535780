"""Multi-threaded RDMA lookup engine pool (paper §3.2).

Paper anchor: §3.2 — the optimized multi-threaded engine that executes the
concurrent lookup subrequests of one batched miss-path request.

``RdmaEnginePool`` runs two coupled layers:

  * **Real execution.**  ``num_threads`` daemon threads each own a deque of
    work requests and a private QP per embedding server.  A thread drains
    its own deque from the head in doorbell-sized groups; when empty it
    steals from the *tail* of the longest sibling deque (work-stealing), so
    a pathological all-one-shard batch still spreads across the pool.  The
    numpy gather/pool against the DRAM shard — the embedding server's work —
    is executed here, concurrently, for real.  Outstanding work requests are
    bounded by a ``core.flow_control.CreditGate`` (the §3.2 credit window):
    a thread must hold one credit per WR in its doorbell group before
    posting.
  * **Virtual timing.**  Each ``submit`` first runs
    ``verbs.plan_schedule`` — the deterministic discrete-event model of the
    same dealing/stealing policy — which prices doorbells, WQE posts, QP
    wire serialization, server time, and credit-window waits (including the
    ``flow_control``-priced credit-return flight), and stamps per-WR virtual
    completion times.  The model's ``verbs.VerbsState`` persists across
    submits: a batch posted before the previous one was waited on (cross-
    batch pipelining) is priced against busy QPs and a part-consumed credit
    window.  Batch latency (p50/p99) and per-thread utilization come from
    this layer, so they are reproducible and usable to calibrate
    ``runtime.simulator`` (``calibrate_to_engine``).

Invariants:
  * Every submitted work request settles its issue-order slot exactly once;
    callers merge in slot order, so results are independent of scheduling
    (bit-equal across thread counts, stealing, affinity tables, pipeline
    depths, and shutdown timing).  A *hedged* duplicate (``hedge``) races
    its primary for the slot: the first completion wins and the loser is
    cancelled — skipped if it has not started, discarded if it has — so a
    straggler re-issue can never double-count into the merge.  A WR whose
    execution raises still resolves its batch: the handle records the first
    failure and ``wait()`` re-raises it — batches fail loudly, never hang,
    and the engine threads survive.
  * ``close()`` drains: work in flight at shutdown is completed, its batch
    handles resolve, and only then do the threads exit (clean shutdown —
    never dropped or double-executed subrequests).
  * ``num_threads=1, work_stealing=False, doorbell_batch=1`` degenerates to
    the legacy single-queue ``core.lookup_engine.RdmaEngine`` behaviour: one
    engine configuration, not a separate code path.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Sequence

import numpy as np

from repro_torch.core.flow_control import CreditGate
from repro_torch.core.lookup_engine import ShardUnavailableError
from repro_torch.obs.trace import (
    CAT_HEDGE,
    CAT_RETRY,
    CAT_WIRE,
    NULL_TRACER,
    PID_VIRTUAL,
    PID_WALL,
    TID_VBATCH,
)
from repro_torch.rdma.verbs import (
    LookupSubrequest,
    RetryPolicy,
    SchedulePlan,
    TransientWireError,
    VerbsState,
    VerbsTiming,
    heat_affinity,
    plan_schedule,
)
from repro_torch.utils import logger

# Brownout policies for dropped-shard cold rows (repro.chaos composition):
#   strict   park the WR until the shard restores — strictly correct
#            answers, possibly late (the never-wrong-never-hung
#            default).
#   degrade  answer from the degraded stand-in's best partial — replica
#            rows bit-identically, truly absent rows as zero vectors —
#            and flag the affected bags (never-wrong-never-LATE: the
#            request retires on time, marked degraded).
#   block    refuse: settle the WR with the outage error after one
#            restore-race retry, so the batch fails fast instead of
#            waiting out the outage.
DEGRADE_POLICIES = ("strict", "degrade", "block")


class BatchHandle:
    """Completion handle of one submitted batch of subrequests.

    Each result slot *settles* at most once (first writer wins): hedged
    duplicates of a subrequest race for the slot and the loser's completion
    is dropped before it can touch the merge.
    """

    def __init__(self, n: int, virtual_latency: float, v_end: float = 0.0):
        self.results: list = [None] * n
        self.virtual_latency = virtual_latency
        self.v_end = v_end  # absolute virtual completion (frontier sync)
        self.error: Exception | None = None  # first per-WR failure
        self.wrs: list[LookupSubrequest] = []  # originals, for hedging
        # Brownout accounting (degrade policy): flat bag ids whose sums are
        # missing dropped-shard cold rows, the count of those rows, and —
        # for dedup WRs whose unique rows may be borrowed by a coalesced
        # in-flight twin — the missing positions within each slot's result.
        # All written inside _settle under _lock, so a waiter woken by the
        # final settle always sees the complete degraded record.
        self.degraded_rows = 0
        self.degraded_bags: set[int] = set()
        self._degraded_idx: dict[int, np.ndarray] = {}
        self._settled = bytearray(n)
        self._remaining = n
        self._lock = threading.Lock()
        self._done = threading.Event()
        if n == 0:
            self._done.set()

    def settled(self, slot: int) -> bool:
        """Lock-free monotone read: once True it stays True, so a racing
        hedge loser can only over-execute, never corrupt."""
        return bool(self._settled[slot])

    def _settle(self, slot: int, result=None, error: Exception | None = None,
                degraded=None) -> bool:
        """First completion of ``slot`` wins; returns False for the loser.

        ``degraded`` is a ``(bags, n_missing, missing_positions)`` record
        from a brownout partial (degrade policy): applied only on the win,
        under the same lock the waiter reads through."""
        with self._lock:
            if self._settled[slot]:
                return False
            self._settled[slot] = 1
            if error is not None:
                if self.error is None:
                    self.error = error
            else:
                self.results[slot] = result
                if degraded is not None:
                    bags, n_missing, missing = degraded
                    self.degraded_bags.update(bags)
                    self.degraded_rows += n_missing
                    if len(missing):
                        self._degraded_idx[slot] = missing
            self._remaining -= 1
            if self._remaining == 0:
                self._done.set()
            return True

    def degraded_rows_at(self, slot: int) -> np.ndarray | None:
        """Missing-row positions within ``results[slot]`` if that slot
        settled as a brownout partial, else None (borrow-chain flagging:
        a borrower scattering a donor's zero-filled row must inherit the
        degraded mark)."""
        with self._lock:
            return self._degraded_idx.get(slot)

    def unsettled(self) -> list[int]:
        with self._lock:
            return [i for i in range(len(self._settled))
                    if not self._settled[i]]

    def wait(self, timeout: float | None = None) -> list:
        """Results in slot order; re-raises the first subrequest failure.

        A failed WR still settles its slot (the slot stays None), so a bad
        batch resolves with an exception instead of hanging the caller, and
        the engine threads survive to serve the next batch."""
        if not self._done.wait(timeout):
            raise TimeoutError("lookup batch did not complete in time")
        if self.error is not None:
            raise self.error
        return self.results

    @property
    def done(self) -> bool:
        return self._done.is_set()


class _EngineThread(threading.Thread):
    """One engine: drains its own deque, steals from siblings when idle."""

    def __init__(self, pool: "RdmaEnginePool", tid: int):
        super().__init__(daemon=True, name=f"rdma-pool-{tid}")
        self.pool = pool
        self.tid = tid
        self.deque: collections.deque = collections.deque()
        self.executed = 0
        self.stolen = 0  # WRs this thread stole from siblings (steals in)
        self.stolen_from = 0  # WRs siblings stole from this thread (steals out)
        self.cancelled = 0  # hedge losers this thread skipped or discarded
        self.hedge_wins = 0  # hedge duplicates this thread won the slot with
        # Fault injection (repro.chaos): a killed thread re-deals its queued
        # work to the survivors and exits.  Set only under pool._cond.
        self.dead = False

    # All deque access happens under pool._cond's lock.

    def _take_group(self):
        pool = self.pool
        if self.deque:
            n = min(len(self.deque), pool.doorbell_batch)
            return [self.deque.popleft() for _ in range(n)]
        if pool.work_stealing:
            victim = max(
                (t for t in pool.threads if t is not self and not t.dead),
                key=lambda t: len(t.deque),
                default=None,
            )
            if victim is not None and victim.deque:
                n = max(
                    1, min(len(victim.deque) // 2, pool.doorbell_batch)
                )
                group = [victim.deque.pop() for _ in range(n)]
                group.reverse()
                self.stolen += len(group)
                victim.stolen_from += len(group)
                return group
        return None

    def run(self) -> None:
        pool = self.pool
        while True:
            with pool._cond:
                if self.dead:
                    return  # killed: deque was re-dealt by kill_thread
                group = self._take_group()
                while group is None:
                    if pool._stopping:
                        return
                    pool._cond.wait(timeout=0.05)
                    if self.dead:
                        return
                    group = self._take_group()
            # Post the doorbell group under the credit window, outside the
            # pool lock: credits are returned by this same thread after the
            # group completes, so the window can never deadlock the pool.
            pool.gate.acquire(len(group))
            try:
                for i, (wr, handle) in enumerate(group):
                    if self.dead:
                        # Killed mid-batch: the WR in progress (if any) has
                        # already settled; re-deal the unexecuted remainder
                        # to the survivors and exit.  Credits for the whole
                        # group are returned by the finally below.
                        with pool._cond:
                            pool._redeal_locked(group[i:])
                        return
                    self._execute(wr, handle)
            finally:
                pool.gate.release(len(group))

    def _cancel(self, wr: LookupSubrequest) -> None:
        """Account a cancelled WR (a hedge twin beat it to the slot)."""
        self.cancelled += 1
        tracer = self.pool.tracer
        if tracer.enabled:
            tracer.instant(
                "hedge_cancel", CAT_HEDGE, tracer.now(),
                pid=PID_WALL, tid=100 + self.tid,
                args={"slot": wr.slot, "server": wr.server,
                      "dup": wr.hedge_dup},
            )

    def _degrade_partial(self, wr: LookupSubrequest, srv):
        """Brownout (degrade policy) answer for a dropped shard's WR.

        Re-gathers through the stand-in's ``gather_partial`` — replica rows
        bit-identical, truly absent rows as zero vectors — and shapes the
        per-protocol result exactly as the healthy path would, so present
        contributions merge bit-equal.  Returns ``(result, degraded_record)``
        with the affected flat bag ids, or None when the server has no
        partial surface (caller falls back to strict parking).
        """
        gather = getattr(srv, "gather_partial", None)
        if gather is None:
            return None
        rows, present = gather(wr.row_ids)
        missing = np.flatnonzero(~present)
        if len(missing) == 0:
            # Restored between the raise and this re-gather: whole answer.
            missing = missing[:0]
        if wr.dedup:
            res = rows
            if wr.gather_idx is not None and wr.bag_ids is not None:
                bags = wr.bag_ids[np.isin(wr.gather_idx, missing)]
            else:
                bags = missing[:0]
        elif wr.seg_bounds is not None:
            S = len(wr.seg_bounds) - 1
            seg_of = np.repeat(np.arange(S), np.diff(wr.seg_bounds))
            out = np.zeros((S, rows.shape[1]), np.float64)
            np.add.at(out, seg_of, rows)
            res = out
            bags = wr.bag_ids[np.unique(seg_of[missing])]
        elif wr.pushdown:
            out = np.zeros((wr.num_bags, rows.shape[1]), np.float64)
            np.add.at(out, wr.bag_ids, rows)
            res = out
            bags = wr.bag_ids[missing]
        else:
            res = (rows, wr.bag_ids)
            bags = wr.bag_ids[missing]
        record = None
        if len(missing):
            record = (
                tuple(int(b) for b in np.unique(np.asarray(bags))),
                int(len(missing)),
                missing,
            )
        return res, record

    def _execute(self, wr: LookupSubrequest, handle: BatchHandle) -> None:
        if handle.settled(wr.slot):
            self._cancel(wr)  # hedge already lost: skip the gather
            return
        pool = self.pool
        if pool.emulate_wire:
            # Hold the WR for its wire + server time as a real (GIL-free)
            # wall-clock wait — the engine thread behaves like one blocked
            # on an RNIC completion, so cross-batch pipelining effects are
            # measurable end to end on a machine with no RNIC (and too few
            # cores for CPU-side overlap to stand in for wire latency).
            # A straggler-storm WR (latency_mult > 1) flies slower.
            t = pool.timing
            span = (
                t.t_server
                + wr.request_bytes / t.req_wire_bps
                + wr.response_bytes / t.wire_bps
            )
            policy = pool.retry_policy
            if (
                policy is not None
                and wr.latency_mult > policy.timeout_mult
                and not wr.hedge_dup
                and pool._charge_retry(1)
            ):
                # Per-WR timeout on the virtual clock: a storm-slowed
                # flight that would exceed timeout_mult healthy spans is
                # abandoned at the timeout and re-flown on the healthy
                # path — charged to the retry budget so a storm cannot
                # amplify itself.  No fault -> latency_mult == 1 -> this
                # rung never fires and the sleep below is bit-identical
                # to the no-policy path.
                with pool._retry_lock:
                    pool.retry_timeouts += 1
                time.sleep(policy.timeout_mult * span)
                tracer = pool.tracer
                if tracer.enabled:
                    tracer.instant(
                        "retry_timeout", CAT_RETRY, tracer.now(),
                        pid=PID_WALL, tid=100 + self.tid,
                        args={"slot": wr.slot, "server": wr.server,
                              "latency_mult": wr.latency_mult},
                    )
                if handle.settled(wr.slot):
                    self._cancel(wr)  # the twin landed during the timeout
                    return
                time.sleep(span)  # the re-flight flies healthy
            else:
                time.sleep(span * wr.latency_mult)
            if handle.settled(wr.slot):
                self._cancel(wr)  # the twin landed while we "flew"
                return
        attempts = 1  # tries of the WR so far, this flight included
        park_attempts = 0
        while True:
            try:
                srv = pool._resolve_server(wr)
                if wr.dedup:
                    # Unique-row wire protocol (§3.1.1): the server ships
                    # each row once; the ranker scatters via wr.gather_idx.
                    # A contiguous WR is a range read — one slice, no gather.
                    if wr.contiguous:
                        res = srv.read_range(
                            int(wr.row_ids[0]), len(wr.row_ids)
                        )
                    else:
                        res = srv.lookup_rows(wr.row_ids)
                elif wr.seg_bounds is not None:
                    # Pooled-segment WR (pushdown near-memory reduction):
                    # the server sum-pools each per-bag segment in float64
                    # and ships one [S, D] block of partials.
                    res = srv.pool_segments(wr.row_ids, wr.seg_bounds)
                elif wr.pushdown:
                    res = srv.lookup_pooled(
                        wr.row_ids, wr.bag_ids, wr.num_bags
                    )
                else:
                    res = (srv.lookup_rows(wr.row_ids), wr.bag_ids)
            except ShardUnavailableError as exc:
                # Dropped shard, cold row — the brownout policy decides:
                #   degrade  settle now with the stand-in's best partial
                #            (zero rows for the truly absent) and flag the
                #            affected bags — on time, marked degraded.
                #   strict   park until the shard restores (the
                #            default: resolves late, never wrong).
                #   block    no park: fail the batch fast with the outage.
                # _park re-checks the dropped mark under the pool lock — if
                # the shard was restored between the raise and the park,
                # retry once against the (now-forwarding) server; a shard
                # that raises while NOT marked dropped fails fast.
                dpolicy = pool.degrade_policy_for(wr.server)
                if dpolicy == "degrade":
                    partial = self._degrade_partial(wr, srv)
                    if partial is not None:
                        res, record = partial
                        if record is not None:
                            with pool._retry_lock:
                                pool.degraded_wrs += 1
                                pool.degraded_rows += record[1]
                        if not handle._settle(
                            wr.slot, result=res, degraded=record
                        ):
                            self._cancel(wr)
                            return
                        break
                    # No partial surface on this stand-in: strict fallback.
                    dpolicy = "strict"
                if dpolicy == "strict" and pool._park(wr, handle):
                    return
                park_attempts += 1
                if park_attempts < 2:
                    continue
                if not handle._settle(wr.slot, error=exc):
                    self._cancel(wr)
                    return
            except TransientWireError as exc:
                # Flaky completion: seeded-deterministic exponential backoff
                # with jitter, bounded by max_attempts AND the shared retry
                # budget.  Budget exhausted or attempts spent -> the error
                # settles (fail loudly); no fault -> this rung never runs.
                policy = pool.retry_policy
                if (
                    policy is not None
                    and attempts < policy.max_attempts
                    and pool._charge_retry(1)
                ):
                    delay = policy.backoff_delay_s(
                        wr.server, wr.slot, attempts
                    )
                    attempts += 1
                    with pool._retry_lock:
                        pool.retry_attempts += 1
                    tracer = pool.tracer
                    if tracer.enabled:
                        tracer.instant(
                            "retry_backoff", CAT_RETRY, tracer.now(),
                            pid=PID_WALL, tid=100 + self.tid,
                            args={"slot": wr.slot, "server": wr.server,
                                  "attempt": attempts,
                                  "delay_us": delay * 1e6},
                        )
                    time.sleep(delay)
                    if handle.settled(wr.slot):
                        self._cancel(wr)  # twin won during the backoff
                        return
                    continue
                if not handle._settle(wr.slot, error=exc):
                    self._cancel(wr)
                    return
            except Exception as exc:  # a bad WR must not kill the thread
                if not handle._settle(wr.slot, error=exc):
                    self._cancel(wr)  # losing twin failed: error dropped too
                    return
            else:
                if not handle._settle(wr.slot, result=res):
                    self._cancel(wr)  # raced a twin and lost: result dropped
                    return
            break
        self.executed += 1
        if wr.hedge_dup:
            # The straggler re-issue beat its primary to the slot.
            self.hedge_wins += 1
            tracer = self.pool.tracer
            if tracer.enabled:
                tracer.instant(
                    "hedge_win", CAT_HEDGE, tracer.now(),
                    pid=PID_WALL, tid=100 + self.tid,
                    args={"slot": wr.slot, "server": wr.server},
                )


class RdmaEnginePool:
    """Pool of engine threads executing lookup subrequests (§3.2)."""

    def __init__(
        self,
        servers: Sequence,
        num_threads: int = 4,
        timing: VerbsTiming | None = None,
        doorbell_batch: int = 8,
        max_inflight: int = 32,
        work_stealing: bool = True,
        gate: CreditGate | None = None,
        emulate_wire: bool = False,
        tracer=None,  # repro.obs.Tracer | None (NULL_TRACER: one branch off)
        retry_policy: RetryPolicy | None = None,
        degrade_policy: str = "strict",
    ):
        if num_threads <= 0:
            raise ValueError("num_threads must be positive")
        if degrade_policy not in DEGRADE_POLICIES:
            raise ValueError(
                f"degrade_policy must be one of {DEGRADE_POLICIES}, "
                f"got {degrade_policy!r}"
            )
        self.servers = list(servers)
        self.num_threads = num_threads
        self.timing = timing or VerbsTiming()
        self.max_inflight = max_inflight
        self.work_stealing = work_stealing
        # emulate_wire: engine threads sleep each WR's virtual wire+server
        # time for real (see _execute) — lookups become latency-bound like
        # a genuine RDMA deployment, so end-to-end overlap benches work on
        # RNIC-less CPU-starved containers.  Off for unit-latency paths.
        self.emulate_wire = emulate_wire
        self.gate = gate or CreditGate(max_inflight)
        # A doorbell group larger than the credit window would deadlock its
        # own acquire; clamp (mirrors real engines sizing SQ depth to credits).
        self.doorbell_batch = max(
            1, min(doorbell_batch, max_inflight, self.gate.max_credits)
        )
        self._cond = threading.Condition()
        self._stopping = False
        self._closed = False
        self._submit_lock = threading.Lock()
        # shard -> thread dealing table (heat-weighted); None = shard % T.
        self._affinity: np.ndarray | None = None
        # ---- fault-injection state (repro.chaos) ----------------------
        # Degraded stand-ins for dropped shards: shard -> wrapper object.
        # Consulted FIRST by _resolve_server, so in-flight WRs of any epoch
        # see the outage.  Mutated only under _cond.
        self._degraded: dict[int, object] = {}
        # Parked work: shard -> [(wr, handle)] of cold-row WRs waiting for
        # the shard to be restored.  Guarded by _cond.
        self._parked: dict[int, list] = {}
        # Per-server straggler-storm multipliers, stamped onto WRs at
        # submit (serving thread — the only writer is the chaos injector,
        # which runs on the same thread).
        self.latency_mults: dict[int, float] = {}
        self.killed_threads = 0
        self.wrs_redealt = 0  # queued WRs re-dealt off dead threads
        self.wrs_parked = 0  # WRs parked on a dropped shard
        self.parked_released = 0  # parked WRs re-dispatched at restore
        # ---- overload response (retry ladder + brownout) --------------
        # Retry budget state is guarded by its own leaf lock (_retry_lock):
        # engine threads charge it mid-execute, hedge() charges it under
        # _cond, so it must never acquire _cond itself.
        self.retry_policy = retry_policy
        self.degrade_policy = degrade_policy
        self._degrade_policies: dict[int, str] = {}  # per-server overrides
        self._retry_lock = threading.Lock()
        self.retry_charged = 0  # budget units consumed (retries + hedges)
        self.retry_denied = 0  # re-issues refused by an exhausted budget
        self.retry_attempts = 0  # backoff retries actually flown
        self.retry_timeouts = 0  # virtual-timeout re-flights
        self.hedges_charged = 0  # hedge duplicates debited from the budget
        self.degraded_wrs = 0  # WRs settled as brownout partials
        self.degraded_rows = 0  # cold rows answered as zeros across them
        self.leaked_threads = 0  # workers that outlived close()'s join
        # Virtual-layer accounting (deterministic, from plan_schedule).
        # Latencies keep a bounded recent window so a long-running server
        # neither grows without bound nor reports lifetime-global p99s.
        self.vstate = VerbsState.fresh(num_threads)
        self.virtual_latencies: collections.deque[float] = collections.deque(
            maxlen=8192
        )
        self.virtual_busy = np.zeros(num_threads)
        self.virtual_span = 0.0  # absolute end of the virtual timeline
        self.virtual_steals = 0
        self.virtual_credit_stall_s = 0.0  # window-blocked post time (virtual)
        self.doorbells = 0
        self.batches = 0
        self.subrequests = 0
        self.hedged = 0  # duplicate WRs issued by hedge()
        self.wire_response_bytes = 0  # response payload actually posted
        self.wire_request_bytes = 0  # request-direction ids / descriptors
        # Pushdown (near-memory reduction) accounting: pooled-segment WRs
        # posted, segments (= per-shard partial vectors shipped) and the
        # rows those segments reduced server-side instead of shipping.
        self.pooled_segment_wrs = 0
        self.pooled_segments = 0
        self.pooled_rows = 0
        self.tracer = NULL_TRACER if tracer is None else tracer
        if self.tracer.enabled:
            for t in range(num_threads):
                self.tracer.name_thread(PID_VIRTUAL, t, f"engine-{t}")
                self.tracer.name_thread(PID_WALL, 100 + t, f"rdma-pool-{t}")
        self.threads = [_EngineThread(self, t) for t in range(num_threads)]
        for t in self.threads:
            t.start()

    # ----------------------------------------------------------------- submit

    def submit(self, subreqs: list[LookupSubrequest]) -> BatchHandle:
        """Schedule (virtual) and dispatch (real) one batch of subrequests.

        Thread-safe; returns immediately with a ``BatchHandle``.  The batch
        virtually arrives at the current frontier (``vstate.now``): submits
        between two ``sync_frontier`` calls are priced as overlapped.
        """
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("submit() on a closed RdmaEnginePool")
            bid = self.batches  # trace correlation key for this batch's WRs
            with self._cond:
                dead = frozenset(
                    t.tid for t in self.threads if t.dead
                )
            if self.latency_mults:
                # Straggler storm (repro.chaos): stamp the per-server
                # multiplier before pricing, so the virtual schedule and
                # the emulate_wire sleep degrade together.
                for wr in subreqs:
                    m = self.latency_mults.get(wr.server)
                    if m is not None:
                        wr.latency_mult = m
            for wr in subreqs:
                # Epoch binding (live reshard): the WR executes against the
                # server object of the map it was cut from, even if a
                # reshard swaps self.servers before it reaches the front of
                # a deque (dual-read handoff window).
                if 0 <= wr.server < len(self.servers):
                    wr.server_obj = self.servers[wr.server]
            plan = plan_schedule(
                subreqs,
                self.num_threads,
                self.timing,
                doorbell_batch=self.doorbell_batch,
                max_inflight=self.max_inflight,
                work_stealing=self.work_stealing,
                affinity=self._affinity,
                state=self.vstate,
                tracer=self.tracer if self.tracer.enabled else None,
                batch_id=bid,
                disabled=dead,
            )
            handle = BatchHandle(
                len(subreqs), plan.makespan, v_end=plan.end
            )
            handle.wrs = list(subreqs)
            self.batches += 1
            self.subrequests += len(subreqs)
            self.wire_response_bytes += sum(r.response_bytes for r in subreqs)
            self.wire_request_bytes += sum(r.request_bytes for r in subreqs)
            for r in subreqs:
                if r.seg_bounds is not None:
                    self.pooled_segment_wrs += 1
                    self.pooled_segments += len(r.seg_bounds) - 1
                    self.pooled_rows += len(r.row_ids)
            self.virtual_latencies.append(plan.makespan)
            self.virtual_busy += np.asarray(plan.busy)
            self.virtual_span = max(self.virtual_span, plan.end)
            self.virtual_steals += plan.steals
            self.virtual_credit_stall_s += plan.credit_stall
            self.doorbells += plan.doorbells
            if self.tracer.enabled and subreqs:
                self.tracer.complete(
                    "lookup_batch", CAT_WIRE, plan.arrival, plan.makespan,
                    pid=PID_VIRTUAL, tid=TID_VBATCH,
                    args={"batch": bid, "wrs": len(subreqs),
                          "steals": plan.steals,
                          "credit_stall_s": plan.credit_stall},
                )
            if subreqs:
                with self._cond:
                    # Real dispatch follows the virtual assignment (affinity
                    # + deterministic steals); threads that finish their
                    # share early still steal the stragglers in real time.
                    alive = [t for t in self.threads if not t.dead]
                    for tid, wrs in enumerate(plan.assignments):
                        tgt = self.threads[tid]
                        if tgt.dead:
                            # A thread died between the plan and this
                            # dispatch: its share goes to a survivor.
                            tgt = alive[tid % len(alive)]
                        tgt.deque.extend((wr, handle) for wr in wrs)
                    self._cond.notify_all()
        return handle

    def sync_frontier(self, handle: BatchHandle) -> None:
        """Advance the virtual clock to a batch the caller blocked on.

        This is the virtual counterpart of a closed-loop wait: the next
        submit arrives no earlier than this batch's completion.  A pipelined
        caller that posts batch N+1 *before* waiting on batch N simply does
        not sync in between, so the model prices the overlap."""
        with self._submit_lock:
            self.vstate.sync(handle.v_end)

    def hedge(self, handle: BatchHandle) -> int:
        """Straggler hedge through the pool: re-issue every unsettled WR of
        ``handle`` as a duplicate on a *different* engine thread than its
        virtual owner, jumping that thread's backlog.  First completion
        settles the slot; the loser is cancelled (skipped before execution,
        or its result dropped).  Returns the number of duplicates issued."""
        with self._cond:
            if self._stopping:
                return 0  # draining: the primaries are guaranteed to land
            n = 0
            alive = [t for t in self.threads if not t.dead]
            for wr in handle.wrs:
                if handle.settled(wr.slot):
                    continue
                if self.retry_policy is not None:
                    # Hedges are re-issued work like any retry: they charge
                    # the same budget, so hedging cannot amplify an
                    # overload past budget_frac of primary traffic.  No
                    # policy (the default) keeps the unbounded hedge.
                    if not self._charge_retry(1):
                        continue
                    with self._retry_lock:
                        self.hedges_charged += 1
                owner = wr.engine if 0 <= wr.engine < self.num_threads \
                    else wr.server % self.num_threads
                others = [t for t in alive if t.tid != owner]
                target = min(
                    others or alive, key=lambda t: (len(t.deque), t.tid)
                )
                # The duplicate takes the healthy path: a storm multiplier
                # on the primary is exactly what the hedge mitigates.
                target.deque.appendleft(
                    (
                        dataclasses.replace(
                            wr, hedge_dup=True, latency_mult=1.0
                        ),
                        handle,
                    )
                )
                # A posted duplicate moves wire bytes like any other WR
                # (a loser cancelled before execution is the lucky case;
                # counting at post keeps the counter an upper bound the
                # same way a real NIC's posted-WR accounting is).
                self.wire_response_bytes += wr.response_bytes
                self.wire_request_bytes += wr.request_bytes
                n += 1
            if n:
                self.hedged += n
                self._cond.notify_all()
        return n

# ------------------------------------------ retry budget & brownout policy

    def _charge_retry(self, n: int = 1) -> bool:
        """Debit the shared retry budget (retries, timeouts, hedges alike).

        The budget is ``budget_frac`` of primary WRs submitted so far — a
        bounded fraction of primary traffic, so recovery work can never
        amplify an overload.  Returns False when exhausted: the caller
        falls back to the non-retry path (fly slow / settle the error /
        skip the hedge) and the denial is counted."""
        policy = self.retry_policy
        if policy is None:
            return True
        with self._retry_lock:
            budget = int(policy.budget_frac * self.subrequests)
            if self.retry_charged + n > budget:
                self.retry_denied += n
                return False
            self.retry_charged += n
            return True

    def degrade_policy_for(self, server: int) -> str:
        """The brownout policy a dropped ``server``'s cold rows get (the
        per-server override if one is set, else the pool default)."""
        return self._degrade_policies.get(server, self.degrade_policy)

    def set_degrade_policy(self, policy: str, server: int | None = None
                           ) -> None:
        """Set the brownout policy — pool-wide, or for one server."""
        if policy not in DEGRADE_POLICIES:
            raise ValueError(
                f"degrade_policy must be one of {DEGRADE_POLICIES}, "
                f"got {policy!r}"
            )
        with self._cond:
            if server is None:
                self.degrade_policy = policy
            else:
                self._degrade_policies[int(server)] = policy

    def retry_summary(self) -> dict:
        """Retry-ladder counters (the ``rdma.retry.*`` namespace)."""
        policy = self.retry_policy
        with self._retry_lock:
            return {
                "enabled": policy is not None,
                "budget_frac": policy.budget_frac if policy else 0.0,
                "budget": (
                    int(policy.budget_frac * self.subrequests)
                    if policy else 0
                ),
                "charged": self.retry_charged,
                "denied": self.retry_denied,
                "attempts": self.retry_attempts,
                "timeouts": self.retry_timeouts,
                "hedges_charged": self.hedges_charged,
                "amplification": (
                    self.retry_charged / max(1, self.subrequests)
                ),
            }

# ------------------------------------------------- faults & elasticity

    def _resolve_server(self, wr: LookupSubrequest):
        """The server object a WR executes against.

        Resolution order: a degraded stand-in for a dropped shard (the
        outage must be visible to in-flight WRs of every epoch), else the
        WR's submit-time epoch binding (live reshard: old WRs read old
        shards), else the current map."""
        srv = self._degraded.get(wr.server)
        if srv is not None:
            return srv
        if wr.server_obj is not None:
            return wr.server_obj
        return self.servers[wr.server]

    def _park(self, wr: LookupSubrequest, handle: BatchHandle) -> bool:
        """Park a cold-row WR of a dropped shard until restore.  Returns
        False if the shard is no longer marked dropped (restored between
        the server's raise and this park) — the caller retries."""
        with self._cond:
            lst = self._parked.get(wr.server)
            if lst is None:
                return False
            lst.append((wr, handle))
            self.wrs_parked += 1
            return True

    def _redeal_locked(self, items: list) -> None:
        """Re-deal (wr, handle) pairs to the least-loaded alive threads.
        Caller holds _cond."""
        alive = [t for t in self.threads if not t.dead]
        for item in items:
            tgt = min(alive, key=lambda t: (len(t.deque), t.tid))
            tgt.deque.append(item)
        self.wrs_redealt += len(items)
        self._cond.notify_all()

    def kill_thread(self, tid: int) -> int:
        """Kill one engine thread mid-flight (fault injection).

        Its queued WRs are re-dealt to the survivors, the thread exits
        after at most its current WR, and every later submit plans around
        it (``plan_schedule(disabled=...)``).  Refuses to kill the last
        alive thread.  Returns the number of WRs re-dealt."""
        with self._cond:
            t = self.threads[tid]
            if t.dead:
                return 0
            if sum(1 for x in self.threads if not x.dead) <= 1:
                raise ValueError("cannot kill the last alive engine thread")
            t.dead = True
            self.killed_threads += 1
            moved = [t.deque.popleft() for _ in range(len(t.deque))]
            self._redeal_locked(moved)
            self._cond.notify_all()
        return len(moved)

    def alive_threads(self) -> int:
        with self._cond:
            return sum(1 for t in self.threads if not t.dead)

    def mark_shard_dropped(self, server: int, degraded) -> None:
        """Drop one shard: ``degraded`` (e.g. ``repro.chaos.DegradedShard``)
        stands in for it — serving cache-replicated hot rows, raising
        ``ShardUnavailableError`` for cold rows, which this pool parks."""
        with self._cond:
            self._degraded[server] = degraded
            self._parked.setdefault(server, [])

    def restore_shard(self, server: int) -> int:
        """End a shard outage: drop the stand-in and re-dispatch the parked
        WRs (the 'cold rows return after shard restore' path).  Returns the
        number of WRs released."""
        with self._cond:
            self._degraded.pop(server, None)
            parked = self._parked.pop(server, [])
            if parked:
                self._redeal_locked(parked)
                self.parked_released += len(parked)
            self._cond.notify_all()
        return len(parked)

    def dropped_shards(self) -> list[int]:
        with self._cond:
            return sorted(self._parked)

    def parked_count(self) -> int:
        with self._cond:
            return sum(len(v) for v in self._parked.values())

    def set_servers(self, servers: Sequence) -> None:
        """Swap the whole shard map (live reshard cutover).  In-flight WRs
        keep their submit-time epoch binding (``wr.server_obj``); only WRs
        cut after this call read the new map."""
        with self._cond:
            if self._degraded:
                raise RuntimeError(
                    "cannot reshard while shards are dropped: restore first"
                )
            self.servers = list(servers)

    def set_server(self, server: int, srv) -> None:
        with self._cond:
            self.servers[server] = srv

    def set_affinity(self, affinity: np.ndarray | None) -> None:
        """Install a shard -> thread dealing table (e.g. ``heat_affinity``
        of the controller's per-shard heat); ``None`` restores ``shard %
        T``.  Takes effect at the next submit — never mid-batch, so the
        schedule stays a pure function of (subrequests, state, table)."""
        if affinity is not None:
            affinity = np.asarray(affinity, np.int64) % self.num_threads
        with self._submit_lock:
            self._affinity = affinity

    def set_heat(self, shard_heat) -> None:
        """Convenience: deal shards by measured heat (see verbs.heat_affinity)."""
        self.set_affinity(
            None if shard_heat is None
            else heat_affinity(shard_heat, self.num_threads)
        )

    def execute(self, subreqs: list[LookupSubrequest]) -> tuple[list, float]:
        """Blocking submit: returns (results in slot order, virtual latency).

        Closed-loop semantics: the frontier advances to this batch's
        completion, so the next submit is priced after it (the pre-pipeline
        model, unchanged)."""
        handle = self.submit(subreqs)
        results = handle.wait()
        self.sync_frontier(handle)
        return results, handle.virtual_latency

    # ------------------------------------------------------------------ stats

    def utilization(self) -> np.ndarray:
        """Per-thread posting occupancy over the virtual timeline [0, 1]."""
        return self.virtual_busy / max(self.virtual_span, 1e-12)

    def latency_percentiles(self, qs=(50.0, 99.0)) -> dict[float, float]:
        lat = np.asarray(self.virtual_latencies or [0.0])
        return {q: float(np.percentile(lat, q)) for q in qs}

    def summary(self) -> dict:
        """One consistent snapshot of the pool's counters.

        Taken under the submit lock *and* the pool condition lock — the same
        order ``submit`` nests them — so the virtual-layer counters, the
        per-thread deque depths, and the per-thread tallies are read
        race-free against live engine threads instead of mid-update.
        """
        with self._submit_lock, self._cond:
            pct = self.latency_percentiles()
            th = self.threads
            return {
                "num_threads": self.num_threads,
                "batches": self.batches,
                "subrequests": self.subrequests,
                "wire_response_bytes": self.wire_response_bytes,
                "wire_request_bytes": self.wire_request_bytes,
                "pooled_segment_wrs": self.pooled_segment_wrs,
                "pooled_segments": self.pooled_segments,
                "pooled_rows": self.pooled_rows,
                "doorbells": self.doorbells,
                "virtual_steals": self.virtual_steals,
                "virtual_credit_stall_s": self.virtual_credit_stall_s,
                "real_steals": sum(t.stolen for t in th),
                "executed": [t.executed for t in th],
                # Per-thread gauges (live engine state at snapshot time):
                "queue_depth": [len(t.deque) for t in th],
                "steals_in": [t.stolen for t in th],
                "steals_out": [t.stolen_from for t in th],
                "hedged": self.hedged,
                "hedge_wins": sum(t.hedge_wins for t in th),
                "hedge_cancelled": sum(t.cancelled for t in th),
                "utilization": self.utilization().tolist(),
                "p50_latency_us": 1e6 * pct[50.0],
                "p99_latency_us": 1e6 * pct[99.0],
                "credit_window": self.gate.summary(),
                # Fault-injection counters (repro.chaos):
                "killed_threads": self.killed_threads,
                "alive_threads": sum(1 for t in th if not t.dead),
                "wrs_redealt": self.wrs_redealt,
                "wrs_parked": self.wrs_parked,
                "parked_now": sum(len(v) for v in self._parked.values()),
                "parked_released": self.parked_released,
                "dropped_shards": sorted(self._parked),
                # Overload response (retry ladder + brownout):
                "degraded_wrs": self.degraded_wrs,
                "degraded_rows": self.degraded_rows,
                "degrade_policy": self.degrade_policy,
                "leaked_threads": self.leaked_threads,
            }

    # ------------------------------------------------------------------ close

    def close(self) -> None:
        """Drain and join: in-flight subrequests complete, then threads exit.

        Idempotent; after close, ``submit`` raises."""
        with self._submit_lock:
            self._closed = True
        with self._cond:
            self._stopping = True
            # Backstop for a shard still dropped at shutdown: parked WRs
            # settle with the outage error so their batches resolve (fail
            # loudly, never hang).  The orderly path is chaos.drain(),
            # which restores shards *before* the server closes the pool.
            for server, parked in self._parked.items():
                for wr, handle in parked:
                    handle._settle(
                        wr.slot,
                        error=ShardUnavailableError(
                            f"shard {server} still down at pool close"
                        ),
                    )
            self._parked.clear()
            self._degraded.clear()
            self._cond.notify_all()
        leaked = 0
        for t in self.threads:
            t.join(timeout=5.0)
            if t.is_alive():
                # The zero-hang ladder (settle-on-close above + chaos
                # watchdog) should make this unreachable; if a worker
                # outlives the join anyway, make the leak visible instead
                # of silently abandoning a daemon thread.
                leaked += 1
                logger.warning(
                    "rdma engine thread %s leaked: still alive 5.0s "
                    "after close()", t.name,
                )
        self.leaked_threads = leaked
