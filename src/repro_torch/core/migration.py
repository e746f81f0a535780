"""Live connection migration + elastic resharding (paper §3.2, T5).

Two mechanisms, one goal — rebalancing skewed embedding traffic:

* **Engine-level** (host serving path): periodically inspect per-connection
  queue depths; when a connection is overloaded relative to its engine's
  peers, migrate it to the least-loaded engine.  The FlexEMR twist the paper
  insists on: the migrated connection must be *re-associated with the target
  engine's resource domain* (here: its parallelism-unit lock), otherwise the
  cross-engine contention the mapping-aware design removed comes right back.

* **Shard-level** (SPMD path): connections cannot be migrated between chips,
  but row ranges can be re-partitioned.  `plan_reshard` turns measured
  per-shard load into new range boundaries (via core.sharding.rebalance_ranges)
  and `apply_reshard` materializes the re-partitioned table — executed at
  checkpoint boundaries by the elastic trainer/server.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lookup_engine import Connection, HostLookupService, RdmaEngine
from repro_torch.core.sharding import FusedTables, rebalance_ranges


@dataclasses.dataclass
class MigrationEvent:
    connection_server: int
    src_engine: int
    dst_engine: int
    reassociated: bool


class ConnectionMigrator:
    """Monitors a HostLookupService and live-migrates hot connections."""

    def __init__(
        self,
        service: HostLookupService,
        imbalance_threshold: float = 2.0,
        reassociate: bool = True,  # False reproduces the naive strawman
    ):
        self.service = service
        self.threshold = imbalance_threshold
        self.reassociate = reassociate
        self.events: list[MigrationEvent] = []
        self._last_posted = {c: 0 for c in service.connections}

    def engine_load(self) -> dict[RdmaEngine, int]:
        loads: dict[RdmaEngine, int] = {e: 0 for e in self.service.engines}
        for conn, eng in self.service.conn_engine.items():
            loads[eng] += conn.posted - self._last_posted[conn]
        return loads

    def rebalance_once(self) -> list[MigrationEvent]:
        """One monitoring tick: move the hottest connection off the hottest
        engine if the imbalance exceeds the threshold."""
        loads = self.engine_load()
        engines = sorted(loads, key=lambda e: loads[e])
        coldest, hottest = engines[0], engines[-1]
        new_events: list[MigrationEvent] = []
        if loads[hottest] > self.threshold * max(1, loads[coldest]):
            with hottest._lock:
                candidates = sorted(
                    hottest.connections,
                    key=lambda c: c.posted - self._last_posted[c],
                    reverse=True,
                )
            if candidates:
                conn = candidates[0]
                self._migrate(conn, hottest, coldest)
                new_events.append(
                    MigrationEvent(
                        connection_server=conn.server.shard_id,
                        src_engine=hottest.engine_id,
                        dst_engine=coldest.engine_id,
                        reassociated=self.reassociate,
                    )
                )
        for conn in self.service.connections:
            self._last_posted[conn] = conn.posted
        self.events.extend(new_events)
        return new_events

    def _migrate(self, conn: Connection, src: RdmaEngine, dst: RdmaEngine) -> None:
        src.detach(conn)
        if self.reassociate:
            # Re-associate with the destination engine's resource domain:
            # adopt a unit already owned by dst so no cross-engine sharing
            # appears (the paper's detach/attach of resource domains).
            with dst._lock:
                dst_units = {id(c.unit): c.unit for c in dst.connections}
            if dst_units:
                conn.unit = next(iter(dst_units.values()))
            # else: dst has no connections; conn keeps its unit, which is now
            # exclusive to dst anyway.
        dst.attach(conn)
        self.service.conn_engine[conn] = dst


# ----------------------------------------------------------------- SPMD side


@dataclasses.dataclass
class ReshardPlan:
    """A re-partition of the fused table: boundaries[i] .. boundaries[i+1]
    is the global-row range owned by shard i after the reshard."""

    boundaries: np.ndarray  # [num_shards + 1]
    expected_imbalance_before: float
    expected_imbalance_after: float


def plan_reshard(load_per_shard: np.ndarray, tables: FusedTables) -> ReshardPlan:
    load = np.asarray(load_per_shard, np.float64)
    boundaries = rebalance_ranges(load, tables)
    before = float(load.max() / max(load.mean(), 1e-9))
    # After: load redistributes along uniform within-shard density.
    density = np.repeat(load / tables.rows_per_shard, tables.rows_per_shard)
    new_loads = np.add.reduceat(density, boundaries[:-1].astype(int))
    after = float(new_loads.max() / max(new_loads.mean(), 1e-9))
    return ReshardPlan(boundaries=boundaries, expected_imbalance_before=before,
                       expected_imbalance_after=after)


def apply_reshard(table: np.ndarray, plan: ReshardPlan, tables: FusedTables) -> np.ndarray:
    """Materialize the resharded table on host (checkpoint-boundary op).

    The new layout stores shard i's rows contiguously; a row-permutation map
    is returned implicitly by `permutation(plan, tables)` so the router can
    translate old global row ids to new ones.
    """
    if len(table) != tables.total_rows:
        raise ValueError(
            f"table has {len(table)} rows, fused layout expects "
            f"{tables.total_rows}"
        )
    perm = permutation(plan, tables)
    return table[perm]


def permutation(plan: ReshardPlan, tables: FusedTables) -> np.ndarray:
    """old-global-row order for the new layout (concatenated new shards).

    Validates that the plan's ranges are a contiguous, exhaustive cover of
    the fused row space — a malformed plan (wrong boundary count, gaps,
    overlaps, or a short/long cover) would silently drop or duplicate rows
    in ``apply_reshard``, so it is rejected loudly instead.
    """
    b = np.asarray(plan.boundaries, np.int64)
    if len(b) != tables.num_shards + 1:
        raise ValueError(
            f"plan has {len(b) - 1} ranges for {tables.num_shards} shards"
        )
    if b[0] != 0 or b[-1] != tables.total_rows:
        raise ValueError(
            f"plan covers [{b[0]}, {b[-1]}), fused table is "
            f"[0, {tables.total_rows})"
        )
    if (np.diff(b) < 0).any():
        raise ValueError("plan boundaries must be non-decreasing")
    parts = [np.arange(b[s], b[s + 1]) for s in range(tables.num_shards)]
    perm = np.concatenate(parts)
    # Contiguous non-decreasing ranges from 0 to total_rows are exhaustive
    # by construction; the checks above make that a guarantee, not a hope.
    return perm
