"""Pooled host lookup service: the §3.2 engine behind the miss path.

Paper anchor: §3.2 — concurrent lookup subrequests over the multi-threaded
RDMA engine — and §3.1.1's temporal-locality lever applied at the *wire*
layer: zipf-skewed traffic references the same hot rows many times within a
batch and across pipelined in-flight batches, so the pooled service ships
each distinct row at most once.  ``PooledLookupService`` is a drop-in for
``core.lookup_engine.HostLookupService`` (same ``lookup`` / ``gather_rows``
/ ``network_bytes`` / ``close`` surface, same fan-out plan, same DRAM
shards) whose fan-out executes on a ``repro.rdma.RdmaEnginePool`` instead of
the legacy per-connection engine threads:

  * **subrequest dedup** (``dedup=True``, the default): ONE stable
    ``np.unique`` over the shard-sorted fan-out plan (the *dedup pass*,
    ``HostLookupService._dedup_plan``) yields the unique miss rows + the
    inverse map; subrequests carry only unique rows, each server gathers
    and ships a row once, and the ranker scatters the returned rows back
    through the inverse map into the issue-order float64 merge — outputs
    stay bit-equal with dedup on or off, across thread counts, chunking,
    stealing, hedging, and pipeline depths;
  * **range-coalesced WRs** (``range_coalesce=True``): after dedup the
    unique ids are sorted, so runs of adjacent ids inside a shard span fold
    into *range reads* — one WQE, one contiguous payload with no per-row
    wire tags (``verbs.LookupSubrequest.contiguous``) — and the doorbell
    batching / credit window see fewer, larger WRs (zipf hot heads are
    dense id ranges under a rank-ordered layout, so high skew collapses to
    a handful of range WRs);
  * **in-flight coalescing** (``inflight_coalesce=True``): an in-flight
    row table maps every posted unique row to its pending ``(BatchHandle,
    slot, index)``.  A pipelined batch N+1 whose miss rows are already on
    the wire for batch N *borrows* those fetches instead of re-posting
    them — the BatchHandle slot machinery's first-writer-wins settling
    already guarantees the donor's result lands exactly once, so the
    borrower just scatters from the donor's settled slot at merge time;
  * remaining subrequests are cut to at most ``max_rows_per_subrequest``
    rows — the *subrequest fanout* that gives the pool parallelism to
    exploit even when one shard dominates a batch — and dispatched across
    the engine threads (per-thread QPs, work-stealing, doorbell batching,
    credit window — see repro.rdma.engine);
  * partial results are merged **in subrequest issue order**, in float64 over
    exactly-representable float32 rows.

``lookup_async`` is the pipelined form of the same contract: it posts the
subrequests and returns a future-like ``LookupHandle`` whose ``wait()``
performs the deferred issue-order merge — so a serving loop can post batch
N+1's lookup while batch N's dense stage runs (cross-batch pipelining,
``runtime.serving.FlexEMRServer``).  ``wait`` also arms the straggler
hedge: a batch still unfinished after ``hedge_timeout`` has its unfinished
subrequests re-issued as duplicates on different engine threads
(cancel-the-loser, ``RdmaEnginePool.hedge``) instead of being re-executed
ranker-side.

Invariants:
  * Result invariance: pooled outputs are bit-equal to the legacy
    ``HostLookupService`` and across every pool configuration (thread count,
    chunk size, stealing on/off, affinity table, pipeline depth, hedging).
    The engine changes *when subrequests move*, never *what lookups
    return* — the same contract the hotcache and prefetch tiers
    (repro.hotcache / repro.prefetch) are built on, and it rests on the
    same precondition: per-bag sums of f32 rows must be exact in the f64
    accumulator (true while a bag's values span < ~29 binades, as embedding
    tables do; values engineered to straddle >53 bits of exponent could
    differ in the last ulp across chunk boundaries, exactly as they already
    could across the cache/wire split).  A hedged duplicate computes the
    identical partial and only the first completion settles the slot, so
    hedging cannot perturb the merge either.
  * ``network_bytes`` prices the bytes this service actually moves
    (accounting == movement, pinned by a regression test): with
    ``dedup=False`` the per-(server, bag) partials of Fig 4 / per-hit raw
    rows exactly as the chunked subrequests carry them, and with
    ``dedup=True`` the post-dedup unique-row payloads of the actual WR cut
    (range WRs priced tag-free).  In-flight coalescing moves *fewer* bytes
    than this per-batch quantity — the borrowed rows ride a previous
    batch's WRs — which the tiered miss path accounts by reading the
    handle's ``wire_response_bytes`` (the bytes genuinely posted).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.core.flow_control import CreditGate
from repro_torch.core.lookup_engine import EmbeddingServer, HostLookupService
from repro_torch.core.sharding import FusedTables, RangeRouter
from repro_torch.obs.trace import CAT_HEDGE, CAT_LOOKUP, CAT_WIRE, NULL_TRACER
from repro_torch.rdma.engine import BatchHandle, RdmaEnginePool
from repro_torch.rdma.verbs import LookupSubrequest, VerbsTiming


class LookupHandle:
    """Future of one pooled lookup: subrequests posted, merge deferred.

    ``wait()`` blocks for the batch, optionally hedging stragglers through
    the pool, merges the partials in subrequest issue order (float64 — the
    schedule-independent merge), and finalizes mean normalization.  It is
    idempotent: the merged result is cached, so ``wait`` may be called from
    a pipeline-drain path and again by the retiring caller.
    """

    def __init__(
        self,
        service: "PooledLookupService",
        batch: BatchHandle | None,
        shape: tuple[int, int, int],
        mask: np.ndarray,
        mean_normalize: bool,
        hedge_timeout: float | None = None,
        borrows: list | None = None,
        wire_response_bytes: int = 0,
        wire_request_bytes: int = 0,
    ):
        self._service = service
        self._batch = batch
        self._shape = shape  # (B, F, D)
        self._mask = mask
        self._mean_normalize = mean_normalize
        self.hedge_timeout = hedge_timeout
        self.hedged = 0  # duplicate WRs this handle re-issued
        self._hedge_armed = False  # a wait() retry must not re-duplicate
        self._out: np.ndarray | None = None
        # Brownout (degrade policy): flat bag ids [0, B*F) whose sums are
        # missing dropped-shard cold rows, and how many such rows — from
        # this handle's own WRs AND from borrowed donor slots that settled
        # as partials.  Populated by wait().
        self.degraded_bags: set[int] = set()
        self.degraded_rows = 0
        # Always-recorded merge work (scatter + finalize, excluding the
        # blocking wait for the engine): the serving loop's serve.attr.*
        # decomposition splits its lookup stall into wire vs merge with it.
        self.merge_s = 0.0
        # In-flight coalescing (§3.1.1): rows this lookup borrows from a
        # previous batch's still-pending (or settled) WRs instead of
        # re-posting.  Each record is (donor BatchHandle, donor slot,
        # row indices within the donor WR, bag ids to scatter into, fused
        # ids — the last used for borrow re-registration at submit).
        self._borrows = borrows or []
        # Fused ids this handle's own WRs registered in the service's
        # in-flight row table (purged at wait()).
        self._reg_ids: list[int] = []
        # Response/request bytes genuinely posted for this lookup at SUBMIT
        # time (borrowed rows move zero new bytes) — the movement the miss
        # tier accounts.  Pinned semantics: straggler-hedge duplicates are
        # posted later, inside wait(), and are counted only in the pool's
        # wire counters (engine summary) — they are mitigation overhead of
        # the engine, not part of the batch's transfer size, so per-batch
        # A/Bs stay comparable whether a straggler happened to fire or not.
        self.wire_response_bytes = wire_response_bytes
        self.wire_request_bytes = wire_request_bytes

    @property
    def done(self) -> bool:
        own = self._batch is None or self._batch.done
        return own and all(rec[0].done for rec in self._borrows)

    @property
    def virtual_latency(self) -> float:
        return 0.0 if self._batch is None else self._batch.virtual_latency

    def wait(self, timeout: float | None = None) -> np.ndarray:
        """[B, F, D] pooled result; hedges stragglers, merges in issue order."""
        if self._out is not None:
            return self._out
        B, F, D = self._shape
        out = np.zeros((B * F, D), np.float64)
        bh = self._batch
        tracer = self._service.tracer
        t_merge = tracer.now() if tracer.enabled else 0.0
        t0 = time.monotonic()
        t_work = time.perf_counter()  # re-cut below, after the blocking wait

        def remaining():
            return (
                None if timeout is None
                else max(0.0, timeout - (time.monotonic() - t0))
            )

        if bh is not None:
            if (
                self.hedge_timeout is not None
                and not self._hedge_armed
                and not bh._done.wait(self.hedge_timeout)
            ):
                # Straggler: duplicate the unfinished WRs onto other engine
                # threads; first completion wins (cancel-the-loser).  Armed
                # at most once — a wait() retried after a TimeoutError must
                # not stack further duplicates behind the first set.
                self._hedge_armed = True
                n_hedged = self._service.pool.hedge(bh)
                self.hedged += n_hedged
                if tracer.enabled and n_hedged:
                    tracer.instant(
                        "hedge_arm", CAT_HEDGE, tracer.now(),
                        args={"wrs": n_hedged,
                              "timeout_s": self.hedge_timeout},
                    )
            try:
                # The hedge-arming wait spent part of the caller's budget.
                results = bh.wait(remaining())
            finally:
                # Advance the closed-loop frontier even when the batch
                # failed or timed out: its virtual end is fixed at submit,
                # and a stale frontier would price every later lookup as
                # overlapped with this one.
                self._service.pool.sync_frontier(bh)
                # The fetched rows are now materialized in the settled
                # slots; later batches re-post rather than borrow from a
                # retired lookup, keeping the table bounded by the rows
                # genuinely in flight.
                self._service._unregister(self)
            t_work = time.perf_counter()  # engine done: merge work starts
            for wr, res in zip(bh.wrs, results):  # issue order: f64 merge
                if wr.seg_bounds is not None:
                    # pushdown partial-sum merge: one [D] float64 partial
                    # per segment, added to its destination bag — the same
                    # bits the gather+pool path would have accumulated,
                    # because f32 rows sum exactly in float64 under ANY
                    # partition of a bag into partials
                    np.add.at(out, wr.bag_ids, np.asarray(res))
                elif wr.dedup:
                    # unique-row protocol: scatter each fetched row into
                    # every bag position that referenced it (the same
                    # values the duplicated transfer would have added)
                    np.add.at(out, wr.bag_ids, np.asarray(res)[wr.gather_idx])
                elif self._service.pushdown:
                    out += res  # global combine of partial pools (fig 4b)
                else:
                    rows, bags = res  # ranker-side pooling (fig 4a)
                    np.add.at(out, bags, rows)
            if bh.degraded_rows:
                # Brownout partials (degrade policy): the batch is fully
                # settled here, so the record is complete — no lock needed.
                self.degraded_bags |= bh.degraded_bags
                self.degraded_rows += bh.degraded_rows
        for donor, slot, d_idx, bags, _fids in self._borrows:
            # Borrowed rows: scatter from the donor batch's settled slot.
            # The donor resolves on its own engine threads regardless of
            # who waits first, so this cannot deadlock; in the FIFO serving
            # pipeline the donor has already been retired by now.
            if not donor._done.wait(remaining()):
                raise TimeoutError("coalesced donor batch did not complete")
            rows = donor.results[slot]
            if rows is None:  # the donor WR itself failed
                raise donor.error or RuntimeError(
                    "coalesced donor subrequest failed"
                )
            np.add.at(out, bags, np.asarray(rows)[d_idx])
            missing = donor.degraded_rows_at(slot)
            if missing is not None:
                # The donor slot settled as a brownout partial: any of its
                # zero-filled rows we just scattered degrade OUR bags too.
                hit = np.isin(np.asarray(d_idx), missing)
                if hit.any():
                    self.degraded_bags.update(
                        int(b) for b in np.asarray(bags)[hit]
                    )
                    self.degraded_rows += int(hit.sum())
        # A handle that posted nothing of its own (every row borrowed)
        # still owns table entries via borrow re-registration: purge them
        # now that it is retiring.  Idempotent after the finally above.
        self._service._unregister(self)
        self._out = self._service._finalize(
            out.reshape(B, F, D), self._mask, self._mean_normalize
        )
        self.merge_s = time.perf_counter() - t_work
        if tracer.enabled:
            tracer.complete(
                "merge", CAT_LOOKUP, t_merge, tracer.now() - t_merge,
                args={
                    "wrs": 0 if bh is None else len(bh.wrs),
                    "borrows": len(self._borrows),
                    "hedged": self.hedged,
                },
            )
        return self._out


class PooledLookupService(HostLookupService):
    """HostLookupService whose fan-out runs on the rdma engine pool."""

    def __init__(
        self,
        tables: FusedTables,
        table_array: np.ndarray,
        num_threads: int = 4,
        pushdown: bool = True,
        timing: VerbsTiming | None = None,
        doorbell_batch: int = 8,
        max_inflight: int = 32,
        work_stealing: bool = True,
        max_rows_per_subrequest: int = 64,
        gate: CreditGate | None = None,
        emulate_wire: bool = False,
        dedup: bool = True,
        range_coalesce: bool = True,
        range_min_rows: int = 8,
        inflight_coalesce: bool = True,
        pushdown_segments: bool = False,
        pushdown_min_rows: int = 2,
        tracer=None,
        retry_policy=None,  # verbs.RetryPolicy | None (None: no ladder)
        degrade_policy: str = "strict",
    ):
        self._init_core(tables, table_array, pushdown, dedup=dedup)
        self.tracer = NULL_TRACER if tracer is None else tracer
        if max_rows_per_subrequest <= 0:
            raise ValueError("max_rows_per_subrequest must be positive")
        if range_min_rows < 2:
            raise ValueError("range_min_rows must be >= 2")
        if pushdown_min_rows < 2:
            raise ValueError("pushdown_min_rows must be >= 2")
        self.max_rows_per_subrequest = max_rows_per_subrequest
        # §3.1.1 wire-dedup knobs (all no-ops unless dedup=True):
        self.range_coalesce = range_coalesce
        self.range_min_rows = range_min_rows  # shortest run worth a range WR
        self.inflight_coalesce = inflight_coalesce
        # Near-memory pooling pushdown over the dedup cut: per-(bag, shard)
        # id segments whose rows are *exclusive* to that segment (no other
        # reference in the batch, not borrowable from an in-flight batch)
        # are pooled server-side — one [D] partial per segment crosses the
        # wire instead of one row per id.  Non-exclusive rows keep the
        # dedup unique-row protocol, so the two levers compose: pushdown
        # takes the poolable segments, dedup the remainder.  A segment
        # shorter than pushdown_min_rows moves the same bytes either way,
        # so it stays in the dedup path.
        self.pushdown_segments = pushdown_segments and pushdown
        self.pushdown_min_rows = pushdown_min_rows
        # In-flight row table: fused id -> (owner LookupHandle, fetching
        # BatchHandle, slot, index within that WR's unique row list) for
        # every row some un-retired lookup posted OR borrowed.  The owner
        # is whichever handle most recently posted/borrowed the row — the
        # entry lives until the OWNER retires, so a borrow chain survives
        # its donor's retirement (pipeline depth >= 3).  The data pointer
        # (BatchHandle, slot, idx) always names the original fetcher,
        # whose settled slot outlives its retirement.  Guarded by
        # _coalesce_lock (submissions may come from a drain thread as well
        # as the serving thread).
        self._inflight_rows: dict[
            int, tuple[LookupHandle, BatchHandle, int, int]
        ] = {}
        self._coalesce_lock = threading.Lock()
        # Dedup-layer counters (engine_summary):
        self.deduped_rows = 0  # duplicate row refs removed before posting
        self.coalesced_rows = 0  # rows borrowed from in-flight batches
        self.coalesced_bytes = 0  # response bytes those borrows saved
        self.range_wrs = 0  # WRs posted as contiguous range reads
        self.pool = RdmaEnginePool(
            self.servers,
            num_threads=num_threads,
            timing=timing,
            doorbell_batch=doorbell_batch,
            max_inflight=max_inflight,
            work_stealing=work_stealing,
            gate=gate,
            emulate_wire=emulate_wire,
            tracer=self.tracer,
            retry_policy=retry_policy,
            degrade_policy=degrade_policy,
        )

    # ----------------------------------------------------------------- lookup

    def _shard_subrequests(
        self,
        fused: np.ndarray,
        bag: np.ndarray,
        bounds: np.ndarray,
        num_bags: int,
        entry_bytes: int,
    ) -> list[LookupSubrequest]:
        """Cut the sorted fan-out plan into per-shard WRs (no coalescing).

        The pure per-batch WR cut: dedup + range coalescing when enabled,
        the legacy duplicated chunking otherwise.  ``network_bytes`` prices
        from this same cut, which is what makes accounting == movement.
        In-flight coalescing (a function of live engine state, not of the
        batch) is applied on top by ``lookup_async``.
        """
        if self.dedup:
            subreqs, _, _ = self._dedup_subrequests(
                fused, bag, num_bags, entry_bytes, borrow_table=None
            )
            return subreqs
        chunk = self.max_rows_per_subrequest
        subreqs: list[LookupSubrequest] = []
        if self.pushdown_segments and len(fused):
            # Segment pushdown without the dedup prepass: carve the
            # poolable segments, then chunk the remainder the legacy
            # duplicated way.  The carve returns the remainder sorted by
            # (shard, bag, id) — shard-major — so the per-shard bounds
            # just need recomputing.
            stats = {"pooled_wrs": 0, "pooled_segments": 0,
                     "pooled_rows": 0}
            fused, bag = self._segment_subrequests(
                fused, bag, num_bags, entry_bytes, None, subreqs, stats
            )
            bounds = np.searchsorted(
                fused // self.tables.rows_per_shard,
                np.arange(self.tables.num_shards + 1),
            )
        for s in range(self.tables.num_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            for c0 in range(lo, hi, chunk):
                c1 = min(hi, c0 + chunk)
                bids = bag[c0:c1]
                if self.pushdown:
                    # one <bag, partial> entry per distinct bag in the chunk
                    rbytes = len(np.unique(bids)) * entry_bytes
                else:
                    rbytes = (c1 - c0) * entry_bytes
                subreqs.append(
                    LookupSubrequest(
                        server=s,
                        row_ids=fused[c0:c1],
                        bag_ids=bids,
                        num_bags=num_bags,
                        pushdown=self.pushdown,
                        response_bytes=rbytes,
                        request_bytes=8 * (c1 - c0),  # ids, dups included
                        slot=len(subreqs),
                    )
                )
        return subreqs

    def _segment_subrequests(
        self,
        fused: np.ndarray,
        bag: np.ndarray,
        num_bags: int,
        entry_bytes: int,
        borrow_table: dict | None,
        subreqs: list,
        stats: dict,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Carve poolable per-(bag, shard) segments into pooled-segment WRs.

        A segment is a maximal run of *exclusive* ids — referenced nowhere
        else in the batch (global count 1) and not borrowable from an
        in-flight batch (a borrow moves zero new bytes; a pooled share
        cannot beat that) — belonging to one bag on one shard.  The carve
        sorts each (shard, bag) span by id first, so a zipf workload's hot
        head ids (duplicated, hence non-poolable) cluster away from the
        exclusive tail instead of splintering it: one hot id per bag would
        otherwise halve every segment.  Any ordering is merge-safe — the
        ranker adds partials in f64 over exactly-representable f32 rows,
        so the bag sum is independent of how the bag is partitioned.
        Segments shorter than ``pushdown_min_rows`` stay on the dedup path
        (a 1-row "partial" ships the same bytes as the row).  Poolable
        segments of one shard pack into pooled-segment WRs (each
        ``<= max_rows_per_subrequest`` rows, but a segment is never split:
        its partial must come from exactly one server for the merge to add
        whole-segment partials).  Appends the WRs to ``subreqs`` and
        returns the ``(fused, bag)`` remainder for the dedup machinery.
        """
        rps = self.tables.rows_per_shard
        uniq, inv = np.unique(fused, return_inverse=True)
        counts = np.bincount(inv, minlength=len(uniq))
        exclusive = counts[inv] == 1
        if borrow_table:
            in_table = np.fromiter(
                (int(u) in borrow_table for u in uniq), bool, len(uniq)
            )
            exclusive &= ~in_table[inv]
        order = np.lexsort((fused, bag, fused // rps))
        f2, b2 = fused[order], bag[order]
        s2 = f2 // rps
        e2 = exclusive[order]
        brk = np.flatnonzero(
            (np.diff(b2) != 0) | (np.diff(s2) != 0) | (np.diff(e2) != 0)
        ) + 1
        edges = np.concatenate(([0], brk, [len(f2)]))
        seg_len = np.diff(edges)
        poolable = e2[edges[:-1]] & (seg_len >= self.pushdown_min_rows)
        if not poolable.any():
            return fused, bag
        seg_shard = s2[edges[:-1]]
        seg_bag = b2[edges[:-1]]
        chunk = self.max_rows_per_subrequest
        for s in np.unique(seg_shard[poolable]):
            segs = np.flatnonzero(poolable & (seg_shard == s))
            # Greedy pack: whole segments up to the chunk budget per WR (at
            # least one segment per WR — a segment is never split).
            packs: list[list[int]] = [[]]
            rows_in_pack = 0
            for g in segs:
                n = int(seg_len[g])
                if packs[-1] and rows_in_pack + n > chunk:
                    packs.append([])
                    rows_in_pack = 0
                packs[-1].append(int(g))
                rows_in_pack += n
            for pack in packs:
                row_ids = np.concatenate(
                    [f2[edges[g] : edges[g + 1]] for g in pack]
                )
                sb = np.concatenate(([0], np.cumsum(seg_len[pack])))
                subreqs.append(
                    LookupSubrequest(
                        server=int(s),
                        row_ids=row_ids,
                        bag_ids=seg_bag[pack],
                        num_bags=num_bags,
                        pushdown=True,
                        # one <bag:4B, partial:D*itemsize> entry per segment
                        response_bytes=len(pack) * entry_bytes,
                        # scattered id list in the WQE writes, 8 B per id
                        request_bytes=8 * len(row_ids),
                        slot=len(subreqs),
                        seg_bounds=sb,
                    )
                )
                stats["pooled_wrs"] += 1
                stats["pooled_segments"] += len(pack)
                stats["pooled_rows"] += len(row_ids)
        rest = order[~np.repeat(poolable, seg_len)]
        return fused[rest], bag[rest]

    def _dedup_subrequests(
        self,
        fused: np.ndarray,
        bag: np.ndarray,
        num_bags: int,
        entry_bytes: int,
        borrow_table: dict | None,
    ) -> tuple[list[LookupSubrequest], list, dict]:
        """Unique-row WR cut (+ borrow plan against the in-flight table).

        With ``pushdown_segments`` the poolable per-(bag, shard) segments
        are carved into pooled-segment WRs first (``_segment_subrequests``)
        and the dedup machinery below runs on the remainder.  Runs the
        dedup pass (one stable ``np.unique`` + inverse over the
        shard-sorted plan), drops rows already on the wire for an earlier
        batch (when ``borrow_table`` is given), folds sort-adjacent
        survivors into range WRs, and chunks the scattered rest.  Returns
        ``(subreqs, borrows, stats)`` where ``borrows`` are
        ``(BatchHandle, slot, donor_idx, bag_ids, fused_ids)`` scatter
        records and ``stats`` are the dedup-layer counter deltas.  Pure —
        no service state is touched, so pricing callers (``network_bytes``)
        and posting callers (``lookup_async``, which applies ``stats``)
        share it without racing the counters.
        """
        stats = {
            "deduped_rows": 0,
            "coalesced_rows": 0,
            "coalesced_bytes": 0,
            "range_wrs": 0,
            "pooled_wrs": 0,
            "pooled_segments": 0,
            "pooled_rows": 0,
        }
        subreqs: list[LookupSubrequest] = []
        if self.pushdown_segments and len(fused):
            fused, bag = self._segment_subrequests(
                fused, bag, num_bags, entry_bytes, borrow_table,
                subreqs, stats,
            )
        uniq, inv, ubounds = self._dedup_plan(fused)
        n_u = len(uniq)
        stats["deduped_rows"] = len(fused) - n_u
        row_payload = entry_bytes - 4  # contiguous payload: no per-row tag

        # ---- in-flight coalescing: mark rows an earlier batch is fetching
        owned = np.ones(n_u, bool)
        donor_keys: list[tuple[BatchHandle, int]] = []
        donor_of = np.full(n_u, -1, np.int64)  # index into donor_keys
        donor_idx = np.zeros(n_u, np.int64)  # row index within the donor WR
        if borrow_table:
            key_index: dict[tuple[int, int], int] = {}
            for k in range(n_u):
                ent = borrow_table.get(int(uniq[k]))
                if ent is None:
                    continue
                _owner, bh, slot, idx = ent
                owned[k] = False
                kk = (id(bh), slot)
                j = key_index.get(kk)
                if j is None:
                    j = key_index[kk] = len(donor_keys)
                    donor_keys.append((bh, slot))
                donor_of[k] = j
                donor_idx[k] = idx

        # ---- WR packing over the owned unique rows, shard by shard
        chunk = self.max_rows_per_subrequest
        groups: list[tuple[np.ndarray, bool]] = []  # (uniq positions, range?)
        group_of = np.full(n_u, -1, np.int64)
        idx_in_group = np.zeros(n_u, np.int64)

        def emit(pos: np.ndarray, contiguous: bool) -> None:
            group_of[pos] = len(groups)
            idx_in_group[pos] = np.arange(len(pos))
            groups.append((pos, contiguous))

        for s in range(self.tables.num_shards):
            u0, u1 = int(ubounds[s]), int(ubounds[s + 1])
            pos = np.flatnonzero(owned[u0:u1]) + u0
            if not len(pos):
                continue
            if self.range_coalesce:
                ids = uniq[pos]
                edges = np.concatenate(
                    ([0], np.flatnonzero(np.diff(ids) != 1) + 1, [len(ids)])
                )
                runs = np.stack([edges[:-1], edges[1:]], 1)
                long = (runs[:, 1] - runs[:, 0]) >= self.range_min_rows
                # A long run is ONE range WR however many rows it spans —
                # a single contiguous read has one post and one payload,
                # so chopping it at the chunk size would only manufacture
                # WRs.  Short runs chunk like any scattered ids.
                for r0, r1 in runs[long]:
                    emit(pos[r0:r1], True)
                scattered = np.concatenate(
                    [pos[r0:r1] for r0, r1 in runs[~long]]
                ) if (~long).any() else np.zeros(0, np.int64)
            else:
                scattered = pos
            for c0 in range(0, len(scattered), chunk):
                emit(scattered[c0 : c0 + chunk], False)

        # ---- scatter assignment: every plan entry follows its unique row
        ginv = group_of[inv] if n_u else np.zeros(0, np.int64)
        order = np.argsort(ginv, kind="stable")  # stable: original order
        sorted_g = ginv[order]
        lo_of = np.searchsorted(sorted_g, np.arange(len(groups)))
        hi_of = np.searchsorted(sorted_g, np.arange(len(groups)), side="right")
        for g, (pos, contiguous) in enumerate(groups):
            ent = order[lo_of[g] : hi_of[g]]
            n = len(pos)
            if contiguous:
                rbytes, qbytes = n * row_payload, 16  # (start, len) descriptor
                stats["range_wrs"] += 1
            else:
                rbytes, qbytes = n * entry_bytes, 8 * n
            subreqs.append(
                LookupSubrequest(
                    server=int(uniq[pos[0]]) // self.tables.rows_per_shard,
                    row_ids=uniq[pos],
                    bag_ids=bag[ent],
                    num_bags=num_bags,
                    pushdown=self.pushdown,
                    response_bytes=rbytes,
                    request_bytes=qbytes,
                    slot=len(subreqs),
                    dedup=True,
                    gather_idx=idx_in_group[inv[ent]],
                    contiguous=bool(contiguous),
                )
            )

        # ---- borrow scatter records, grouped per (donor handle, slot)
        borrows: list = []
        if donor_keys:
            bent = np.flatnonzero(ginv == -1)  # plan entries of borrowed rows
            dkey = donor_of[inv[bent]]
            border = bent[np.argsort(dkey, kind="stable")]
            sorted_d = donor_of[inv[border]]
            blo = np.searchsorted(sorted_d, np.arange(len(donor_keys)))
            bhi = np.searchsorted(
                sorted_d, np.arange(len(donor_keys)), side="right"
            )
            for j, (bh, slot) in enumerate(donor_keys):
                ent = border[blo[j] : bhi[j]]
                borrows.append(
                    (bh, slot, donor_idx[inv[ent]], bag[ent], fused[ent])
                )
            n_borrowed = int((~owned).sum())
            stats["coalesced_rows"] = n_borrowed
            stats["coalesced_bytes"] = n_borrowed * entry_bytes
        return subreqs, borrows, stats

    def lookup_async(
        self,
        indices: np.ndarray,
        mask: np.ndarray,
        mean_normalize: bool = True,
        hedge_timeout: float | None = None,
    ) -> LookupHandle:
        """Post one [B,F,nnz] lookup's subrequests; return a ``LookupHandle``.

        The fan-out plan and chunking are identical to ``lookup`` — only
        the merge is deferred to ``handle.wait()``, so the engine threads
        chew the gathers while the caller does something else (the dense
        stage of the previous batch, cache probes of the next one...).
        ``hedge_timeout`` arms the pool-side straggler hedge at wait time.

        With ``dedup`` + ``inflight_coalesce``, rows still pending from an
        earlier un-retired batch are *borrowed* rather than re-posted, and
        the rows this batch does post are registered in the in-flight table
        for the next batch to borrow in turn — the cross-batch half of the
        §3.1.1 temporal-locality lever.
        """
        B, F, _ = indices.shape
        fused, bag, bounds, num_bags, D = self._plan_fanout(indices, mask)
        entry = 4 + D * self.servers[0].rows.dtype.itemsize
        borrows: list = []
        if self.dedup:
            with self._coalesce_lock:
                table = (
                    self._inflight_rows if self.inflight_coalesce else None
                )
                subreqs, borrows, stats = self._dedup_subrequests(
                    fused, bag, num_bags, entry, borrow_table=table
                )
                batch = self.pool.submit(subreqs) if subreqs else None
                handle = LookupHandle(
                    self, batch, (B, F, D), mask, mean_normalize,
                    hedge_timeout=hedge_timeout,
                    borrows=borrows,
                    wire_response_bytes=sum(
                        r.response_bytes for r in subreqs
                    ),
                    wire_request_bytes=sum(
                        r.request_bytes for r in subreqs
                    ),
                )
                if table is not None:
                    reg: list[int] = []
                    if batch is not None:
                        for wr in subreqs:
                            if wr.seg_bounds is not None:
                                # Pooled-segment WRs return [S, D] partials,
                                # not rows: nothing a later batch can borrow.
                                continue
                            for i, fid in enumerate(wr.row_ids):
                                fid = int(fid)
                                self._inflight_rows[fid] = (
                                    handle, batch, wr.slot, i,
                                )
                                reg.append(fid)
                    # Borrow re-registration: a borrowed row stays
                    # borrowable for the NEXT pipelined batch even after
                    # the donor retires — table *ownership* passes to this
                    # handle while the entry keeps pointing at the original
                    # fetcher's (BatchHandle, slot, index), whose settled
                    # slot outlives the donor's retirement.  Without this,
                    # the donor's retire purged the entry and batch N+2
                    # re-posted a row batch N+1 still held (the coalesce
                    # chain broke at pipeline depth >= 3).
                    for dbh, slot, d_idx, _bags, fids in borrows:
                        for i, fid in zip(d_idx, fids):
                            fid = int(fid)
                            self._inflight_rows[fid] = (
                                handle, dbh, int(slot), int(i),
                            )
                            reg.append(fid)
                    handle._reg_ids = reg
                # Counters move only when WRs are actually posted — the
                # pricing path (network_bytes) never touches them.
                self.deduped_rows += stats["deduped_rows"]
                self.coalesced_rows += stats["coalesced_rows"]
                self.coalesced_bytes += stats["coalesced_bytes"]
                self.range_wrs += stats["range_wrs"]
            if self.tracer.enabled:
                if stats["coalesced_rows"]:
                    self.tracer.instant(
                        "inflight_borrow", CAT_WIRE, self.tracer.now(),
                        args={"rows": stats["coalesced_rows"],
                              "bytes": stats["coalesced_bytes"],
                              "donors": len(borrows)},
                    )
                if stats["range_wrs"]:
                    self.tracer.instant(
                        "range_coalesce", CAT_WIRE, self.tracer.now(),
                        args={"range_wrs": stats["range_wrs"],
                              "deduped_rows": stats["deduped_rows"]},
                    )
                if stats["pooled_segments"]:
                    self.tracer.instant(
                        "segment_pushdown", CAT_WIRE, self.tracer.now(),
                        args={"wrs": stats["pooled_wrs"],
                              "segments": stats["pooled_segments"],
                              "rows": stats["pooled_rows"]},
                    )
            return handle
        subreqs = self._shard_subrequests(
            fused, bag, bounds, num_bags, entry
        )
        batch = self.pool.submit(subreqs) if subreqs else None
        return LookupHandle(
            self, batch, (B, F, D), mask, mean_normalize,
            hedge_timeout=hedge_timeout,
            borrows=borrows,
            wire_response_bytes=sum(r.response_bytes for r in subreqs),
            wire_request_bytes=sum(r.request_bytes for r in subreqs),
        )

    def _unregister(self, handle: LookupHandle) -> None:
        """Purge a retired lookup's rows from the in-flight table (entries
        a newer batch has not already taken ownership of, by re-posting or
        by borrow re-registration)."""
        if not handle._reg_ids:
            return
        with self._coalesce_lock:
            for fid in handle._reg_ids:
                ent = self._inflight_rows.get(fid)
                if ent is not None and ent[0] is handle:
                    del self._inflight_rows[fid]
        handle._reg_ids = []

    def lookup(
        self,
        indices: np.ndarray,
        mask: np.ndarray,
        mean_normalize: bool = True,
    ) -> np.ndarray:
        """[B,F,nnz] -> [B,F,D] pooled, through the engine pool.

        Same contract as the legacy service (mean_normalize=False returns
        float64 per-bag sums for exact tier merging); the merge runs in
        subrequest issue order so the result is schedule-independent.
        Closed-loop form of ``lookup_async`` — post, wait, merge.
        """
        return self.lookup_async(indices, mask, mean_normalize).wait()

    # ------------------------------------------------------------- elasticity

    def apply_reshard_live(
        self, new_tables: FusedTables, new_table: np.ndarray
    ) -> int:
        """Quiesce-free shard-map cutover (runtime.elastic reshard).

        Fused ids are invariant across shard counts (``FusedTables`` pads
        the fused space so field offsets never move), so only *ownership*
        changes: the router, the server list, and the pool's shard map are
        swapped atomically while lookups stay in flight.  WRs already
        posted keep their submit-time epoch binding
        (``LookupSubrequest.server_obj``) and read the old shard objects —
        the dual-read handoff window — so nothing drains and nothing
        returns wrong rows.  In-flight coalescing entries for rows whose
        *owning shard* changed are invalidated: a later batch must not
        borrow a row fetched under the old map once its WR retires, because
        the donor slot indexes a retired epoch.  Returns the number of
        in-flight table entries invalidated.
        """
        rps = new_tables.rows_per_shard
        servers = [
            EmbeddingServer(s, s * rps, new_table[s * rps : (s + 1) * rps])
            for s in range(new_tables.num_shards)
        ]
        old_rps = self.tables.rows_per_shard
        with self._coalesce_lock:
            migrated = [
                fid
                for fid in self._inflight_rows
                if fid // old_rps != fid // rps
            ]
            for fid in migrated:
                del self._inflight_rows[fid]
            self.tables = new_tables
            self.router = RangeRouter(new_tables)
            self.servers = servers
            self.pool.set_servers(servers)
        return len(migrated)

    # --------------------------------------------------------------- affinity

    def set_shard_affinity(self, shard_heat) -> None:
        """Skew-aware dealing: install a heat-weighted shard -> engine-thread
        table (``verbs.heat_affinity`` LPT over the controller's per-shard
        heat) so hot shards spread across threads *before* work stealing has
        to rescue them.  ``None`` (or an all-zero heat) falls back to the
        ``shard % T`` modulo dealing."""
        self.pool.set_heat(shard_heat)

    # ------------------------------------------------------------------ stats

    def network_bytes(self, indices: np.ndarray, mask: np.ndarray) -> int:
        """Response bytes this service's WR cut actually moves per batch.

        Accounting == movement: this prices the exact subrequest cut the
        engine would post for this batch — the same cut ``lookup`` issues —
        so it equals the sum of the posted WRs' ``response_bytes`` in every
        wire protocol (pinned by a regression test).  That includes the
        chunked-pushdown subtlety the legacy closed form got wrong here: a
        bag straddling two chunks moves two partial-pool entries, and is
        priced as two.  With ``dedup`` the cut is the unique-row protocol,
        priced in closed form (no WR objects are built on the accounting
        path): one entry per unique valid id, minus the 4-byte per-row tag
        inside every dense run long enough to fold into a range WR — runs
        break at shard boundaries exactly like the per-shard cut, and
        chunk splits never change scattered totals.  Duplicates are priced
        without dedup, because duplicates move.  In-flight coalescing can
        move *less* than this (borrowed rows ride an earlier batch);
        callers accounting a live pipeline should read
        ``LookupHandle.wire_response_bytes`` instead.
        """
        D = self.servers[0].rows.shape[1]
        entry = 4 + D * self.servers[0].rows.dtype.itemsize
        if self.dedup:
            if self.pushdown_segments:
                # Segment pushdown changes the cut per-bag, so there is no
                # bag-free closed form: price from the same pure planner
                # the posting path uses (accounting == movement by
                # construction).  No borrow table — this is the per-batch
                # quantity, independent of live pipeline state.
                fused, bag, _, num_bags, _ = self._plan_fanout(indices, mask)
                subreqs, _, _ = self._dedup_subrequests(
                    fused, bag, num_bags, entry, borrow_table=None
                )
                return sum(r.response_bytes for r in subreqs)
            offs = self.tables.field_offsets_array()
            fused = indices.astype(np.int64) + offs[None, :, None]
            return self.unique_response_bytes(
                np.unique(fused[np.asarray(mask, bool)])
            )
        fused, bag, bounds, num_bags, _ = self._plan_fanout(indices, mask)
        if not self.pushdown:
            return len(fused) * entry  # one raw-row entry per hit
        if self.pushdown_segments:
            # The segment carve changes the chunk composition, so price
            # from the same pure cut the posting path builds.
            subreqs = self._shard_subrequests(
                fused, bag, bounds, num_bags, entry
            )
            return sum(r.response_bytes for r in subreqs)
        # Chunked pushdown: one partial entry per distinct bag per CHUNK —
        # counted in closed form over (shard, chunk, bag) triples, no WR
        # objects on the accounting path.
        shard_of = np.repeat(
            np.arange(self.tables.num_shards), np.diff(bounds)
        )
        local = np.arange(len(fused)) - bounds[shard_of]
        cid = shard_of * (
            len(fused) // self.max_rows_per_subrequest + 2
        ) + local // self.max_rows_per_subrequest
        pairs = np.stack([cid, bag], 1)
        return len(np.unique(pairs, axis=0)) * entry

    def unique_response_bytes(self, uniq: np.ndarray) -> int:
        """Closed-form dedup pricing from a sorted unique id set: one entry
        per unique row, minus the 4-byte per-row tag inside every dense run
        long enough to fold into a range WR (runs break at shard boundaries
        exactly like the per-shard cut; chunk splits never change scattered
        totals, and long runs are never split)."""
        D = self.servers[0].rows.shape[1]
        entry = 4 + D * self.servers[0].rows.dtype.itemsize
        if not self.range_coalesce or len(uniq) == 0:
            return len(uniq) * entry
        rps = self.tables.rows_per_shard
        brk = np.flatnonzero(
            (np.diff(uniq) != 1) | (uniq[1:] // rps != uniq[:-1] // rps)
        ) + 1
        lens = np.diff(np.concatenate(([0], brk, [len(uniq)])))
        long_rows = int(lens[lens >= self.range_min_rows].sum())
        return len(uniq) * entry - 4 * long_rows

    @property
    def virtual_latencies(self):
        """Per-batch virtual lookup latencies (seconds, bounded recent
        window), from the verbs timing model."""
        return self.pool.virtual_latencies

    def retry_summary(self) -> dict:
        """Retry-ladder counters (``rdma.retry.*``), from the engine pool."""
        return self.pool.retry_summary()

    def engine_summary(self) -> dict:
        s = self.pool.summary()
        s.update(
            dedup=self.dedup,
            deduped_rows=self.deduped_rows,
            coalesced_rows=self.coalesced_rows,
            coalesced_bytes=self.coalesced_bytes,
            range_wrs=self.range_wrs,
            segment_pushdown=self.pushdown_segments,
        )
        return s

    # ------------------------------------------------------------------ close

    def close(self) -> None:
        self.pool.close()
        with self._coalesce_lock:
            self._inflight_rows.clear()
