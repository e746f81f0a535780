"""Multi-threaded embedding lookup engine (paper §3.2, T4).

Two layers, mirroring the two places the paper's idea lands on TPU systems:

**Host layer (faithful to the paper's CPU embedding servers).**  Embedding
shards live in host DRAM as numpy arrays (`EmbeddingServer` = one embedding
server).  A pool of `RdmaEngine` I/O threads posts lookup subrequests over
per-server `Connection`s.  The RNIC's limited parallelism units are modeled as
locks: every post must hold its connection's unit.  With the *naive* mapping
(units assigned to connections round-robin at creation, engines unaware),
connections on different engines share units and serialize — the contention of
paper Fig 6 (left).  With the *mapping-aware* assignment, connections are
grouped by unit so each engine owns its units exclusively (Fig 6 right).

**SPMD layer.**  The reference's `chunked_lookup` (field-chunked collectives
overlapped with dense compute) waits for the port's multi-device slice.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.sharding import FusedTables, RangeRouter

# --------------------------------------------------------------------- host


class ShardUnavailableError(RuntimeError):
    """A lookup addressed an embedding shard that is currently down.

    Raised by a degraded shard stand-in (repro.chaos.DegradedShard) for rows
    it cannot serve from its cache-tier replica while the real shard is
    dropped: the lookup *fails fast* at the server boundary instead of
    hanging on a dead host.  The engine pool catches it and parks the work
    request until the shard is restored (repro.rdma.engine), so the batch
    still resolves — late, never wrong."""


class EmbeddingServer:
    """One embedding server: a row-range shard resident in host DRAM."""

    def __init__(self, shard_id: int, start_row: int, rows: np.ndarray):
        self.shard_id = shard_id
        self.start_row = start_row
        self.rows = rows  # [rows_per_shard, D]

    def lookup_rows(self, row_ids: np.ndarray) -> np.ndarray:
        """Fig 4(a): return raw embedding rows (bytes ~ len(row_ids) * D).

        ``row_ids`` may repeat; a repeated id is gathered (and shipped)
        once per occurrence — the duplicate traffic the §3.1.1 wire-dedup
        path (``dedup=True`` services) removes before posting."""
        return self.rows[row_ids - self.start_row]

    def read_range(self, start_row_id: int, n: int) -> np.ndarray:
        """Range read: ``n`` consecutive rows from ``start_row_id`` — the
        server-side of a range-coalesced WR.  A contiguous slice (no gather
        indirection), mirroring a single contiguous RDMA READ."""
        lo = int(start_row_id) - self.start_row
        return self.rows[lo : lo + n]

    def lookup_pooled(
        self, row_ids: np.ndarray, bag_ids: np.ndarray, num_bags: int
    ) -> np.ndarray:
        """Fig 4(b): partial pooling pushed down to the server's CPU.

        Returns [num_bags, D] partial sums (bytes ~ num_bags * D).
        Accumulates in float64 (f32 rows are exactly representable) so the
        pooled result does not depend on how the hotcache/prefetch tier
        splits a bag between servers — see hotcache.miss_path.
        """
        out = np.zeros((num_bags, self.rows.shape[1]), np.float64)
        np.add.at(out, bag_ids, self.rows[row_ids - self.start_row])
        return out

    def pool_segments(
        self, row_ids: np.ndarray, seg_bounds: np.ndarray
    ) -> np.ndarray:
        """Near-memory bag reduction: sum-pool contiguous id *segments*.

        ``seg_bounds`` has S+1 entries; segment ``s`` is
        ``row_ids[seg_bounds[s]:seg_bounds[s+1]]`` — one per-bag id run that
        lives wholly on this shard.  Returns ``[S, D]`` float64 partial sums
        (response bytes ~ S * D instead of rows * D).  Like
        ``lookup_pooled``, f32 rows accumulate exactly in float64, so a bag
        split across shards/tiers merges to the same bits regardless of the
        cut — the partial-sum protocol's bit-equality foundation.
        """
        seg_bounds = np.asarray(seg_bounds, np.int64)
        S = len(seg_bounds) - 1
        out = np.zeros((S, self.rows.shape[1]), np.float64)
        seg_ids = np.repeat(np.arange(S), np.diff(seg_bounds))
        rows = self.rows[np.asarray(row_ids, np.int64) - self.start_row]
        np.add.at(out, seg_ids, rows)
        return out


@dataclasses.dataclass
class Subrequest:
    server: int
    row_ids: np.ndarray
    bag_ids: np.ndarray
    num_bags: int
    pushdown: bool
    result_slot: int
    done: threading.Event
    results: list  # shared list, written at result_slot
    # §3.1.1 wire dedup: when set, row_ids are unique and the ranker
    # scatters the returned rows via rows[gather_idx] aligned with bag_ids.
    gather_idx: np.ndarray | None = None


class Connection:
    """A queue-pair to one embedding server, pinned to an RNIC unit (lock)."""

    def __init__(self, server: EmbeddingServer, unit: threading.Lock):
        self.server = server
        self.unit = unit
        self.pending: queue.SimpleQueue[Subrequest] = queue.SimpleQueue()
        self.posted = 0  # lifetime posts, for load accounting

    def depth(self) -> int:
        return self.pending.qsize()


class RdmaEngine(threading.Thread):
    """One I/O thread draining its connections' subrequest queues."""

    def __init__(self, engine_id: int):
        super().__init__(daemon=True, name=f"rdma-engine-{engine_id}")
        self.engine_id = engine_id
        self.connections: list[Connection] = []
        self._wake = threading.Event()
        self._stop_flag = False
        self._lock = threading.Lock()  # guards self.connections (migration)

    def attach(self, conn: Connection) -> None:
        with self._lock:
            self.connections.append(conn)
        self._wake.set()

    def detach(self, conn: Connection) -> None:
        with self._lock:
            self.connections.remove(conn)

    def submit(self, conn: Connection, req: Subrequest) -> None:
        conn.pending.put(req)
        conn.posted += 1
        self._wake.set()

    def run(self) -> None:
        while not self._stop_flag:
            worked = False
            with self._lock:
                conns = list(self.connections)
            for conn in conns:
                try:
                    req = conn.pending.get_nowait()
                except queue.Empty:
                    continue
                worked = True
                # Posting a work request requires exclusive access to the
                # RNIC parallelism unit. Cross-engine sharing => contention.
                with conn.unit:
                    srv = conn.server
                    if req.gather_idx is not None:
                        # Wire dedup: unique rows once; ranker scatters.
                        res = srv.lookup_rows(req.row_ids)
                    elif req.pushdown:
                        res = srv.lookup_pooled(req.row_ids, req.bag_ids, req.num_bags)
                    else:
                        res = (srv.lookup_rows(req.row_ids), req.bag_ids)
                req.results[req.result_slot] = res
                req.done.set()
            if not worked:
                self._wake.wait(timeout=0.001)
                self._wake.clear()

    def stop(self) -> None:
        self._stop_flag = True
        self._wake.set()


class CompletedLookup:
    """Trivially-completed lookup handle: the result is already materialized.

    The async lookup surface every engine shares is ``lookup_async(...) ->
    handle`` with ``handle.wait() -> [B, F, D]``, ``handle.done``, and
    ``handle.hedged``.  Engines without a genuinely asynchronous path (this
    legacy per-connection engine) resolve at call time and hand back this
    handle, so a pipelined caller (``runtime.serving.FlexEMRServer`` at
    ``pipeline_depth > 1``) degrades gracefully to closed-loop instead of
    needing a separate code path.  The §3.2 pool's real future lives in
    ``repro.rdma.service.LookupHandle``.
    """

    __slots__ = ("_out", "hedged")
    done = True

    def __init__(self, out: np.ndarray):
        self._out = out
        self.hedged = 0

    def wait(self, timeout: float | None = None) -> np.ndarray:
        return self._out


class HostLookupService:
    """The ranker-side lookup frontend over host embedding servers.

    mapping_aware=False reproduces the naive engine: RNIC units are assigned
    to connections round-robin (as NICs do at creation time) and connections
    are dealt to engines round-robin *independently*, so engines contend on
    shared units. mapping_aware=True groups connections by unit onto the same
    engine (FlexEMR).
    """

    def __init__(
        self,
        tables: FusedTables,
        table_array: np.ndarray,
        num_engines: int = 4,
        num_units: int | None = None,
        mapping_aware: bool = True,
        pushdown: bool = True,
        dedup: bool = False,
    ):
        self._init_core(tables, table_array, pushdown, dedup=dedup)
        num_units = num_units or num_engines
        self.units = [threading.Lock() for _ in range(num_units)]
        # RNIC behaviour: units round-robin over connections at creation.
        self.connections = [
            Connection(srv, self.units[i % num_units])
            for i, srv in enumerate(self.servers)
        ]
        self.engines = [RdmaEngine(e) for e in range(num_engines)]
        self.conn_engine: dict[Connection, RdmaEngine] = {}
        if mapping_aware:
            # Group connections by their unit; a unit's group lives on one engine.
            unit_ids = {id(u): i for i, u in enumerate(self.units)}
            for conn in self.connections:
                eng = self.engines[unit_ids[id(conn.unit)] % num_engines]
                eng.attach(conn)
                self.conn_engine[conn] = eng
        else:
            for i, conn in enumerate(self.connections):
                eng = self.engines[i % num_engines]
                eng.attach(conn)
                self.conn_engine[conn] = eng
        for e in self.engines:
            e.start()

    def _init_core(
        self,
        tables: FusedTables,
        table_array: np.ndarray,
        pushdown: bool,
        dedup: bool = False,
    ) -> None:
        """State shared by every engine implementation (legacy + rdma pool):
        the fused-table layout, the range router, and the DRAM shards.

        ``dedup`` selects the §3.1.1 unique-row wire protocol: subrequests
        carry each distinct miss row once (the servers gather and ship it
        once) and the ranker scatters through the inverse map.  It replaces
        the per-subrequest transfer format (including pushdown's per-bag
        partials) for lookups, never their pooled value: the float64
        scatter adds exactly the row values the duplicated transfer would
        have, so outputs are bit-equal with dedup on or off."""
        self.tables = tables
        self.router = RangeRouter(tables)
        self.pushdown = pushdown
        self.dedup = dedup
        rps = tables.rows_per_shard
        self.servers = [
            EmbeddingServer(s, s * rps, table_array[s * rps : (s + 1) * rps])
            for s in range(tables.num_shards)
        ]

    def close(self) -> None:
        for e in self.engines:
            e.stop()
        for e in self.engines:
            e.join(timeout=1.0)

    def _plan_fanout(
        self, indices: np.ndarray, mask: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
        """Flatten one [B,F,nnz] batch into the per-server fan-out plan.

        Returns ``(fused, bag, bounds, num_bags, D)`` with the valid
        (fused id, bag id) pairs sorted stably by owning shard;
        ``bounds[s]:bounds[s+1]`` is shard ``s``'s contiguous span.  Both
        the legacy engine and the rdma pool shard from this exact plan, so
        their merge order — and therefore their pooled bits — agree.
        """
        B, F, NNZ = indices.shape
        offs = self.tables.field_offsets_array()
        fused = (indices.astype(np.int64) + offs[None, :, None]).ravel()
        bag = np.broadcast_to(
            np.arange(B * F).reshape(B, F, 1), (B, F, NNZ)
        ).ravel()
        valid = mask.ravel()
        fused, bag = fused[valid], bag[valid]
        shard = self.router.shard_of(fused)
        order = np.argsort(shard, kind="stable")
        fused, bag, shard = fused[order], bag[order], shard[order]
        bounds = np.searchsorted(shard, np.arange(self.tables.num_shards + 1))
        return fused, bag, bounds, B * F, self.servers[0].rows.shape[1]

    def _dedup_plan(
        self, fused: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The dedup pass: ONE global unique over the shard-sorted plan.

        Returns ``(uniq, inv, ubounds)``: the sorted unique fused ids (a
        sorted id list is automatically shard-contiguous, since an id's
        owning shard is ``id // rows_per_shard``), the inverse map giving
        every plan position its row in ``uniq``, and ``ubounds[s] :
        ubounds[s+1]`` delimiting shard ``s``'s span of ``uniq``.  Both
        engines (legacy + rdma pool) cut their unique-row subrequests from
        this one pass, so their WR contents — and the scatter that makes
        outputs bit-equal to the duplicated transfer — agree exactly.
        """
        uniq, inv = np.unique(fused, return_inverse=True)
        rps = self.tables.rows_per_shard
        ubounds = np.searchsorted(
            uniq, np.arange(self.tables.num_shards + 1) * rps
        )
        return uniq, inv, ubounds

    def _finalize(
        self, out: np.ndarray, mask: np.ndarray, mean_normalize: bool
    ) -> np.ndarray:
        """Shared tail: mean-field normalization over FULL validity counts."""
        if not mean_normalize:
            return out  # f64 raw sums: exact merge with the cache tier
        counts = mask.sum(-1).astype(np.float64)
        mean_mask = np.asarray([s.pooling == "mean" for s in self.tables.specs])
        denom = np.maximum(counts, 1.0)[..., None]
        return np.where(
            mean_mask[None, :, None], out / denom, out
        ).astype(np.float32)

    def lookup(
        self,
        indices: np.ndarray,
        mask: np.ndarray,
        mean_normalize: bool = True,
    ) -> np.ndarray:
        """[B,F,nnz] -> [B,F,D] pooled. Fans subrequests out per server.

        mean_normalize=False returns raw per-bag SUMS (float64 partials so
        tier merging is split-invariant): callers that merge this with
        another tier (the hotcache miss path) must normalize mean fields
        once at the end, over the full validity counts.
        """
        B, F, _ = indices.shape
        fused, bag, bounds, num_bags, D = self._plan_fanout(indices, mask)
        if self.dedup:
            uniq, inv, ubounds = self._dedup_plan(fused)

        reqs: list[Subrequest] = []
        results: list = [None] * self.tables.num_shards
        for s in range(self.tables.num_shards):
            lo, hi = bounds[s], bounds[s + 1]
            if lo == hi:
                continue
            if self.dedup:
                # Unique-row wire protocol: each distinct miss row of this
                # shard crosses the wire once; the scatter map rebuilds the
                # duplicated view at merge time.
                u0, u1 = int(ubounds[s]), int(ubounds[s + 1])
                row_ids, gather_idx = uniq[u0:u1], inv[lo:hi] - u0
            else:
                row_ids, gather_idx = fused[lo:hi], None
            req = Subrequest(
                server=s,
                row_ids=row_ids,
                bag_ids=bag[lo:hi],
                num_bags=num_bags,
                pushdown=self.pushdown,
                result_slot=s,
                done=threading.Event(),
                results=results,
                gather_idx=gather_idx,
            )
            conn = self.connections[s]
            self.conn_engine[conn].submit(conn, req)
            reqs.append(req)
        for r in reqs:
            r.done.wait()

        out = np.zeros((num_bags, D), np.float64)
        for req in reqs:
            res = results[req.result_slot]
            if res is None:
                continue
            if req.gather_idx is not None:
                # dedup scatter: the same row values the duplicated
                # transfer would have added, through the inverse map
                np.add.at(out, req.bag_ids, res[req.gather_idx])
            elif self.pushdown:
                out += res  # global combine of partial pools (fig 4b)
            else:
                rows, bags = res  # ranker-side pooling (fig 4a)
                np.add.at(out, bags, rows)
        # Mean-pool fields divide by their valid counts.
        return self._finalize(out.reshape(B, F, D), mask, mean_normalize)

    def lookup_async(
        self,
        indices: np.ndarray,
        mask: np.ndarray,
        mean_normalize: bool = True,
        hedge_timeout: float | None = None,
    ) -> CompletedLookup:
        """Async-surface fallback: executes synchronously, returns a
        ``CompletedLookup``.  ``hedge_timeout`` is accepted for signature
        parity and ignored — this engine has no pool to hedge through."""
        return CompletedLookup(self.lookup(indices, mask, mean_normalize))

    def gather_rows(self, row_ids: np.ndarray) -> np.ndarray:
        """Raw rows by fused id — the hotcache swap-in fetch (off the serving
        hot path, so it reads the shards directly rather than via engines)."""
        row_ids = np.asarray(row_ids, np.int64)
        D = self.servers[0].rows.shape[1]
        out = np.zeros((len(row_ids), D), self.servers[0].rows.dtype)
        shard = self.router.shard_of(row_ids)
        for s in range(self.tables.num_shards):
            sel = shard == s
            if sel.any():
                out[sel] = self.servers[s].lookup_rows(row_ids[sel])
        return out

    def network_bytes(self, indices: np.ndarray, mask: np.ndarray) -> int:
        """Response bytes on the wire (the paper's Fig-4 quantity).

        **Contract: accounting == movement.**  This prices exactly the
        response payloads this service's subrequests carry for this batch
        (pinned by a regression test against the per-WR ``response_bytes``
        actually posted):

          * fig 4(a) raw mode (``dedup=False, pushdown=False``): one
            <bag_id:4B, vector:D*itemsize> entry per *row hit* — duplicate
            ids are shipped once per occurrence, so duplicates are priced;
          * fig 4(b) pushdown (``dedup=False, pushdown=True``): one entry
            per (server, bag) partial pool with >= 1 hit;
          * §3.1.1 wire dedup (``dedup=True``): one entry per *unique*
            miss row — the deduplicated transfer, priced post-dedup.  (The
            rdma pool's range-coalesced WRs additionally drop the per-row
            tag inside a dense run; its ``network_bytes`` override prices
            those from the actual WR cut.)

        Request-direction id bytes are tracked separately by the engine
        pool (``wire_request_bytes`` in the summary), keeping this quantity
        comparable with the Fig-4 response-byte A/Bs.

        The model prices vectors at the table itemsize (f32): a production
        deployment quantizes partial pools back to the row dtype on the
        wire.  Inside this host-process reproduction the partials keep the
        f64 accumulator precision end to end — that implementation detail
        (not a wire property) is what upgrades the hotcache/prefetch
        result-invariance from allclose to bit-equal.
        """
        B, F, _ = indices.shape
        D = self.servers[0].rows.shape[1]
        entry = 4 + D * self.servers[0].rows.dtype.itemsize
        offs = self.tables.field_offsets_array()
        fused = indices.astype(np.int64) + offs[None, :, None]
        if self.dedup:
            return self.unique_response_bytes(np.unique(fused[mask]))
        shard = np.where(mask, self.router.shard_of(fused), -1)
        if self.pushdown:
            bag = np.broadcast_to(
                np.arange(B * F).reshape(B, F, 1), shard.shape
            )
            pairs = np.stack([shard.ravel(), bag.ravel()], 1)[mask.ravel()]
            return len(np.unique(pairs, axis=0)) * entry
        return int(mask.sum()) * entry

    def unique_response_bytes(self, uniq: np.ndarray) -> int:
        """Dedup-protocol pricing from a precomputed sorted unique id set —
        the closed form behind ``network_bytes`` when ``dedup=True``,
        callable directly by tiers that already hold the dedup prepass
        (``miss_path`` reuses its ``collect_unique`` pass here instead of
        re-running ``np.unique`` for byte accounting)."""
        D = self.servers[0].rows.shape[1]
        return len(uniq) * (4 + D * self.servers[0].rows.dtype.itemsize)
