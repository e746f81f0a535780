"""Fault taxonomy + seeded schedules for the chaos harness.

The paper's economic case for disaggregation (and DisaggRec's headline
argument, PAPERS.md) is that the memory tier can grow, shrink, and *fail*
independently of compute.  This module defines the failure vocabulary the
rest of ``repro_torch.chaos`` injects into the live serving stack:

  * :data:`FAULT_KILL_ENGINE` — an engine thread dies mid-batch; its queued
    WRs are re-dealt to the survivors (``RdmaEnginePool.kill_thread``) and
    every later submit plans around it.
  * :data:`FAULT_DROP_SHARD` — an embedding shard becomes unreachable.  A
    :class:`DegradedShard` stands in: rows re-replicated from the cache
    tier are served bit-identically (cache rows are exact f32 copies of
    the DRAM rows), cold rows fail fast with ``ShardUnavailableError`` and
    the engine pool parks them until restore.
  * :data:`FAULT_STRAGGLER_STORM` — per-server latency multipliers slow a
    shard's WRs on both the virtual schedule and the emulated wire,
    stressing the hedge path (duplicates take the healthy 1x path).
  * :data:`FAULT_RESHARD` — live elasticity *as* a fault: the shard count
    changes under traffic (``FlexEMRServer.reshard``), exercising the
    dual-read handoff window and in-flight dedup invalidation.

Everything is seeded and deterministic: a :class:`FaultSchedule` is a pure
function of its seed (``FaultSchedule.generate``), triggers are admitted-
batch counts and virtual-clock marks — never wall time — so the same seed
replays the same fault sequence run after run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lookup_engine import EmbeddingServer, ShardUnavailableError

FAULT_KILL_ENGINE = "kill_engine"
FAULT_DROP_SHARD = "drop_shard"
FAULT_STRAGGLER_STORM = "straggler_storm"
FAULT_RESHARD = "reshard"

FAULT_KINDS = (
    FAULT_KILL_ENGINE,
    FAULT_DROP_SHARD,
    FAULT_STRAGGLER_STORM,
    FAULT_RESHARD,
)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    Exactly one of ``at_batch`` / ``at_vtime`` triggers it: the fault fires
    at the first admit where the admitted-batch count reaches ``at_batch``,
    or where the engine pool's virtual timeline has passed ``at_vtime``
    seconds.  ``target`` is kind-dependent: an engine-thread index (kill),
    a shard index (drop / storm), or the NEW shard count (reshard).
    ``duration_batches`` auto-recovers a drop or storm that many admits
    later (0 = until ``drain``/watchdog).
    """

    kind: str
    at_batch: int | None = None
    at_vtime: float | None = None
    target: int = 0
    duration_batches: int = 0
    latency_mult: float = 1.0  # straggler storms only

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if (self.at_batch is None) == (self.at_vtime is None):
            raise ValueError("exactly one of at_batch/at_vtime must be set")
        if self.latency_mult < 1.0:
            raise ValueError("latency_mult must be >= 1.0")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An ordered, seeded fault plan (pure data — the injector executes it)."""

    faults: tuple[FaultSpec, ...]
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    @classmethod
    def generate(
        cls,
        seed: int,
        num_batches: int,
        num_engines: int,
        num_shards: int,
        n_faults: int = 4,
        kinds: tuple[str, ...] = FAULT_KINDS,
        storm_mult: float = 8.0,
    ) -> "FaultSchedule":
        """A random schedule that is a pure function of ``seed``.

        Triggers land in ``[1, num_batches)``, spaced so recoveries get
        batches to play out; same seed -> identical schedule, different
        seed -> (overwhelmingly) different.
        """
        if num_batches < 2:
            raise ValueError("num_batches must be >= 2")
        rng = np.random.default_rng(seed)
        n = min(n_faults, max(1, num_batches - 1))
        at = np.sort(
            rng.choice(np.arange(1, num_batches), size=n, replace=False)
        )
        faults = []
        for k in range(n):
            kind = kinds[int(rng.integers(len(kinds)))]
            dur = int(rng.integers(1, 4))
            if kind == FAULT_KILL_ENGINE:
                target = int(rng.integers(num_engines))
            elif kind == FAULT_RESHARD:
                grow = bool(rng.integers(2))
                target = num_shards * 2 if grow else max(1, num_shards // 2)
            else:
                target = int(rng.integers(num_shards))
            faults.append(
                FaultSpec(
                    kind=kind,
                    at_batch=int(at[k]),
                    target=target,
                    duration_batches=dur,
                    latency_mult=storm_mult
                    if kind == FAULT_STRAGGLER_STORM
                    else 1.0,
                )
            )
        return cls(faults=tuple(faults), seed=seed)


class DegradedShard:
    """Stand-in for a dropped embedding shard.

    Serves the rows re-replicated from the cache tier *bit-identically*
    (cache rows are exact f32 copies of the DRAM rows, and the pooled path
    uses the same f64 ``np.add.at`` merge as the real server), and raises
    :class:`ShardUnavailableError` for anything colder — failing fast at
    the server boundary so the engine pool can park the WR instead of
    hanging on a dead host.  After :meth:`restore` every call forwards to
    the real server, so stale references held by in-flight WRs stay safe.
    """

    def __init__(
        self,
        real: EmbeddingServer,
        replica_ids: np.ndarray,
        replica_rows: np.ndarray,
    ):
        self.real = real
        self.shard_id = real.shard_id
        self.start_row = real.start_row
        self._index = {int(i): k for k, i in enumerate(replica_ids)}
        self._rows = replica_rows
        self._restored = False
        self.served_rows = 0  # hot rows served from the replica while down
        self.refused = 0  # lookups refused for cold rows while down
        self.degraded_rows = 0  # cold rows answered with zeros (brownout)

    @property
    def replica_rows(self) -> int:
        return len(self._index)

    def restore(self) -> None:
        self._restored = True

    def _gather(self, row_ids: np.ndarray) -> np.ndarray:
        idx = np.empty(len(row_ids), np.int64)
        for k, rid in enumerate(row_ids):
            j = self._index.get(int(rid))
            if j is None:
                self.refused += 1
                raise ShardUnavailableError(
                    f"shard {self.shard_id} down: row {int(rid)} not in "
                    f"cache replica ({len(self._index)} rows re-replicated)"
                )
            idx[k] = j
        self.served_rows += len(row_ids)
        return self._rows[idx]

    def gather_partial(
        self, row_ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Brownout gather: ``(rows, present)`` with zero rows for cold ids.

        The ``degrade`` policy's data path (``RdmaEnginePool``): replica
        rows are served bit-identically, truly absent rows come back as
        zero vectors with ``present=False`` so the engine can flag the
        affected bags instead of parking the WR.  After restore everything
        forwards to the real shard (all present).
        """
        row_ids = np.asarray(row_ids)
        if self._restored:
            return (
                self.real.lookup_rows(row_ids),
                np.ones(len(row_ids), bool),
            )
        rows = np.zeros((len(row_ids), self._rows.shape[1]),
                        self._rows.dtype)
        present = np.zeros(len(row_ids), bool)
        for k, rid in enumerate(row_ids):
            j = self._index.get(int(rid))
            if j is not None:
                rows[k] = self._rows[j]
                present[k] = True
        n_hit = int(present.sum())
        self.served_rows += n_hit
        self.degraded_rows += len(row_ids) - n_hit
        return rows, present

    # -- EmbeddingServer surface ------------------------------------------

    def lookup_rows(self, row_ids: np.ndarray) -> np.ndarray:
        if self._restored:
            return self.real.lookup_rows(row_ids)
        return self._gather(np.asarray(row_ids))

    def read_range(self, start_row_id: int, n: int) -> np.ndarray:
        if self._restored:
            return self.real.read_range(start_row_id, n)
        return self._gather(np.arange(int(start_row_id),
                                      int(start_row_id) + n))

    def lookup_pooled(
        self, row_ids: np.ndarray, bag_ids: np.ndarray, num_bags: int
    ) -> np.ndarray:
        if self._restored:
            return self.real.lookup_pooled(row_ids, bag_ids, num_bags)
        rows = self._gather(np.asarray(row_ids))
        out = np.zeros((num_bags, rows.shape[1]), np.float64)
        np.add.at(out, bag_ids, rows)
        return out

    def pool_segments(
        self, row_ids: np.ndarray, seg_bounds: np.ndarray
    ) -> np.ndarray:
        if self._restored:
            return self.real.pool_segments(row_ids, seg_bounds)
        seg_bounds = np.asarray(seg_bounds, np.int64)
        rows = self._gather(np.asarray(row_ids))
        S = len(seg_bounds) - 1
        out = np.zeros((S, rows.shape[1]), np.float64)
        np.add.at(out, np.repeat(np.arange(S), np.diff(seg_bounds)), rows)
        return out
