"""Chaos injector: executes a FaultSchedule against a live FlexEMRServer.

The injector is driven by the serving loop itself — ``on_admit`` fires at
every batch admission (before the batch's lookup posts), ``guarded_wait``
wraps the retire-path wait in a watchdog, ``drain`` recovers everything at
shutdown — so fault triggers are counted in *admitted batches* and
virtual-clock seconds, never wall time, and the whole run is a
deterministic function of the schedule's seed.

Determinism contract (pinned by tests/test_torch_chaos.py): the firing log and
every counter in the top level of :meth:`summary` depend only on the
schedule and the traffic; wall-clock quantities (recovery latency, how
many WRs happened to be queued on a killed thread or parked on a dropped
shard — races between the serving thread and the engine threads) are
reported under the ``"wall"`` sub-dict.

Recovery paths, in the order the harness relies on them:

  * a drop/storm with ``duration_batches`` recovers that many admits later;
  * ``guarded_wait`` force-restores every dropped shard if a batch exceeds
    the watchdog (no hung lookups, ever — the zero-hang gate);
  * ``drain`` (called first by ``FlexEMRServer.close``) recovers everything
    so the pipeline drains and the pool closes clean;
  * the pool's own ``close`` settles still-parked WRs with the outage error
    as a last-resort backstop.
"""
from __future__ import annotations

import time

from repro_torch.chaos.faults import (
    FAULT_DROP_SHARD,
    FAULT_KILL_ENGINE,
    FAULT_KINDS,
    FAULT_RESHARD,
    FAULT_STRAGGLER_STORM,
    DegradedShard,
    FaultSchedule,
    FaultSpec,
)
from repro_torch.hotcache.miss_path import resident_rows_in_range
from repro_torch.obs.trace import CAT_CHAOS, NULL_TRACER


class ChaosInjector:
    """Executes one :class:`FaultSchedule` against a bound server."""

    def __init__(
        self,
        schedule: FaultSchedule,
        watchdog_s: float = 30.0,
        wait_step_s: float = 0.25,
        tracer=None,
    ):
        self.schedule = schedule
        self.watchdog_s = watchdog_s
        # First-resort stall probe: with a shard down, the retire wait is
        # sliced at this grain so a pipeline blocked on parked WRs releases
        # *scheduled* recoveries early instead of sitting out the watchdog
        # (batch-time freezes while the serving thread blocks, so an
        # expiry measured in admits can never arrive on its own).
        self.wait_step_s = wait_step_s
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.server = None  # runtime.serving.FlexEMRServer, set by bind()
        self._next = 0  # first un-fired schedule index
        self._admitted = 0
        # shard -> live DegradedShard stand-in
        self._drops: dict[int, DegradedShard] = {}
        # (expire_at_admit, kind, concrete target) for timed drops/storms
        self._expiry: list[tuple[int, str, int]] = []
        # ---- deterministic accounting (seed-stable, see module docstring)
        self.firing_log: list[tuple[int, str, int]] = []  # (batch, kind, tgt)
        self.faults_fired = 0
        self.by_kind = {k: 0 for k in FAULT_KINDS}
        self.faults_skipped = 0  # unfireable (e.g. last engine thread)
        self.rows_re_replicated = 0
        self.reshards = 0
        self.moved_rows = 0
        self.inflight_invalidated = 0
        self.restores = 0
        # ---- wall-clock accounting (racy: engine-thread interleaving)
        self.forced_restores = 0
        self.recovery_s: list[float] = []  # per-outage wall duration
        self._drop_t0: dict[int, float] = {}

    # ------------------------------------------------------------------ wiring

    def bind(self, server) -> None:
        """Attach to a FlexEMRServer (done by the server's __init__)."""
        self.server = server

    @property
    def _pool(self):
        return self.server.service.pool

    def _mark(self, name: str, **args) -> None:
        if self.tracer.enabled:
            self.tracer.instant(
                name, CAT_CHAOS, self.tracer.now(), args=args or None
            )

    # ------------------------------------------------------------------ firing

    def on_admit(self) -> None:
        """One admitted batch: expire due recoveries, then fire due faults.

        Called by the serving loop before the new batch's lookup posts, so
        a fault at ``at_batch=k`` shapes batch ``k``'s own WRs.
        """
        self._admitted += 1
        still = []
        for expire_at, kind, target in self._expiry:
            if self._admitted >= expire_at:
                self._recover(kind, target)
            else:
                still.append((expire_at, kind, target))
        self._expiry = still
        while self._next < len(self.schedule.faults):
            spec = self.schedule.faults[self._next]
            due = (
                self._admitted >= spec.at_batch
                if spec.at_batch is not None
                else self._pool.virtual_span >= spec.at_vtime
            )
            if not due:
                break
            self._next += 1
            self._fire(spec)

    def _fire(self, spec: FaultSpec) -> None:
        fired = getattr(self, f"_fire_{spec.kind}")(spec)
        if not fired:
            self.faults_skipped += 1
            return
        self.faults_fired += 1
        self.by_kind[spec.kind] += 1
        self.firing_log.append((self._admitted, spec.kind, fired - 1))
        if spec.duration_batches > 0 and spec.kind in (
            FAULT_DROP_SHARD,
            FAULT_STRAGGLER_STORM,
        ):
            self._expiry.append(
                (self._admitted + spec.duration_batches, spec.kind,
                 fired - 1)
            )

    # Each _fire_* returns 0 if unfireable, else 1 + the concrete target
    # (so the firing log records what was actually hit).

    def _fire_kill_engine(self, spec: FaultSpec) -> int:
        pool = self._pool
        alive = [t.tid for t in pool.threads if not t.dead]
        if len(alive) <= 1:
            return 0  # never kill the last engine thread
        tid = alive[spec.target % len(alive)]
        moved = pool.kill_thread(tid)
        self._mark("chaos_kill_engine", batch=self._admitted, tid=tid,
                   redealt=moved)
        return 1 + tid

    def _fire_drop_shard(self, spec: FaultSpec) -> int:
        pool = self._pool
        shard = spec.target % self.server.tables.num_shards
        if shard in self._drops:
            return 0  # already down
        rps = self.server.tables.rows_per_shard
        ids, rows = resident_rows_in_range(
            self.server._tiered.cache, shard * rps, (shard + 1) * rps
        )
        degraded = DegradedShard(pool.servers[shard], ids, rows)
        pool.mark_shard_dropped(shard, degraded)
        self._drops[shard] = degraded
        self._drop_t0[shard] = time.perf_counter()
        self.rows_re_replicated += len(ids)
        self._mark("chaos_drop_shard", batch=self._admitted, shard=shard,
                   replica_rows=len(ids))
        return 1 + shard

    def _fire_straggler_storm(self, spec: FaultSpec) -> int:
        shard = spec.target % self.server.tables.num_shards
        self._pool.latency_mults[shard] = spec.latency_mult
        self._mark("chaos_storm_start", batch=self._admitted, shard=shard,
                   mult=spec.latency_mult)
        return 1 + shard

    def _fire_reshard(self, spec: FaultSpec) -> int:
        # A reshard cutover swaps the whole shard map: recover any live
        # outage first so shard indices never straddle two epochs.
        for shard in list(self._drops):
            self._restore_drop(shard)
        new_shards = max(1, spec.target)
        if new_shards == self.server.tables.num_shards:
            return 0
        res = self.server.reshard(new_shards)
        self.reshards += 1
        self.moved_rows += res["moved_rows"]
        self.inflight_invalidated += res["inflight_invalidated"]
        self._mark("chaos_reshard", batch=self._admitted,
                   num_shards=new_shards, moved_rows=res["moved_rows"],
                   invalidated=res["inflight_invalidated"])
        return 1 + new_shards

    # ---------------------------------------------------------------- recovery

    def _restore_drop(self, shard: int) -> None:
        degraded = self._drops.pop(shard, None)
        if degraded is None:
            return
        degraded.restore()  # stale in-flight references now forward
        released = self._pool.restore_shard(shard)
        self.restores += 1
        t0 = self._drop_t0.pop(shard, None)
        dt = 0.0 if t0 is None else time.perf_counter() - t0
        self.recovery_s.append(dt)
        self._mark("chaos_restore_shard", shard=shard, released=released,
                   served_from_replica=degraded.served_rows,
                   recovery_s=round(dt, 6))

    def _recover(self, kind: str, target: int) -> None:
        if kind == FAULT_DROP_SHARD:
            self._restore_drop(target)
        elif kind == FAULT_STRAGGLER_STORM:
            self._pool.latency_mults.pop(target, None)
            self._mark("chaos_storm_end", batch=self._admitted,
                       shard=target)

    # ---------------------------------------------------------------- waiting

    def guarded_wait(self, pending):
        """Watchdog wrapper for the retire-path wait.

        Escalation ladder: (1) with a shard down, a short stall probe —
        a retire blocked on parked WRs means batch-time is frozen, so
        drops with a *scheduled* recovery (``duration_batches``) are
        released early (their restore was coming anyway; only the wall
        timing moves, which is outside the determinism contract);
        (2) past ``watchdog_s``, force-restore everything still down;
        (3) raise instead of hanging if even that cannot resolve it —
        the zero-hang guarantee."""
        if self._drops:
            try:
                return pending.wait(self.wait_step_s)
            except TimeoutError:
                timed = [t for (_, k, t) in self._expiry
                         if k == FAULT_DROP_SHARD]
                if timed:
                    self._expiry = [
                        (e, k, t) for (e, k, t) in self._expiry
                        if k != FAULT_DROP_SHARD
                    ]
                    for shard in timed:
                        self._restore_drop(shard)
        try:
            return pending.wait(self.watchdog_s)
        except TimeoutError:
            self.forced_restores += 1
            self._mark("chaos_watchdog_restore",
                       dropped=sorted(self._drops))
            for shard in list(self._drops):
                self._restore_drop(shard)
            try:
                return pending.wait(self.watchdog_s)
            except TimeoutError:
                raise RuntimeError(
                    "chaos watchdog: batch did not resolve "
                    f"{2 * self.watchdog_s:.0f}s after forced restore"
                ) from None

    def drain(self) -> None:
        """Recover every live fault (called first by FlexEMRServer.close so
        the pipeline drains against healthy shards)."""
        for shard in list(self._drops):
            self._restore_drop(shard)
        self._pool.latency_mults.clear()
        self._expiry.clear()

    # --------------------------------------------------------------- reporting

    def summary(self) -> dict:
        """Registry provider for the ``chaos.`` namespace.

        Top-level counters are deterministic per (schedule, traffic); the
        ``wall`` sub-dict is wall-clock/race-dependent and excluded from
        determinism comparisons.
        """
        pool = self._pool if self.server is not None else None
        return {
            "seed": self.schedule.seed,
            "scheduled": len(self.schedule.faults),
            "faults_fired": self.faults_fired,
            "faults_skipped": self.faults_skipped,
            "by_kind": dict(self.by_kind),
            "firing_log": list(self.firing_log),
            "rows_re_replicated": self.rows_re_replicated,
            "reshards": self.reshards,
            "moved_rows": self.moved_rows,
            "inflight_invalidated": self.inflight_invalidated,
            "restores": self.restores,
            "active_drops": sorted(self._drops),
            "wall": {
                "forced_restores": self.forced_restores,
                "recovery_latency_s": list(self.recovery_s),
                "wrs_redealt": 0 if pool is None else pool.wrs_redealt,
                "wrs_parked": 0 if pool is None else pool.wrs_parked,
                "parked_released": 0 if pool is None
                else pool.parked_released,
            },
        }
