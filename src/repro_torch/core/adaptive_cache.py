"""Adaptive embedding cache controller (paper §3.1.1).

The paper's control loop, reproduced structurally:

  1. **Tracing temporal dynamics** — a sliding window over recent request
     batch sizes decides whether the system is under high load.
  2. **Adjusting cache size** — an *NN-memory model* estimates the memory the
     dense model needs for the current batch; the ideal cache size is the
     HBM capacity minus that reservation.  Swap-in fetches hot rows from the
     embedding shards (async on real hardware; here a jitted gather);
     swap-out evicts by LRU/low-frequency.

On TPU the contended memory is per-chip HBM (16 GiB on v5e): replicated hot
rows compete with activation memory exactly like the paper's GPU cache
competes with NN batch memory.  The controller additionally decides
*field-level replication* — fields whose whole vocab fits the budget are
replicated outright, which shrinks the lookup collective statically.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.sharding import TableSpec

HBM_BYTES_V5E = 16 * 1024**3


@dataclasses.dataclass
class MemoryModel:
    """Estimates per-chip memory for the dense model at a given batch size.

    `bytes_per_sample` covers activations of the NN stack (bottom MLP,
    interaction, top MLP / transformer activations) per sample on this chip;
    `fixed_bytes` covers weights + optimizer + workspace.  Both are measured
    once from a compiled step's memory_analysis() and then reused, which is
    exactly the "build a model to estimate the memory size required by NN
    computation" step of §3.1.1.
    """

    fixed_bytes: int
    bytes_per_sample: int
    hbm_bytes: int = HBM_BYTES_V5E
    reserve_frac: float = 0.08  # XLA workspace / fragmentation headroom

    def nn_bytes(self, batch_size: int) -> int:
        return self.fixed_bytes + self.bytes_per_sample * batch_size

    def cache_budget_bytes(self, batch_size: int) -> int:
        usable = int(self.hbm_bytes * (1.0 - self.reserve_frac))
        return max(0, usable - self.nn_bytes(batch_size))

    def max_batch_given_cache(self, cache_bytes: int) -> int:
        usable = int(self.hbm_bytes * (1.0 - self.reserve_frac))
        room = usable - self.fixed_bytes - cache_bytes
        return max(0, room // max(1, self.bytes_per_sample))


class SlidingWindowLoadMonitor:
    """§3.1.1 'Tracing temporal dynamics': load level from recent batch sizes."""

    def __init__(self, window: int = 64, high_frac: float = 0.8):
        self.window = collections.deque(maxlen=window)
        self.high_frac = high_frac

    def observe(self, batch_size: int) -> None:
        self.window.append(int(batch_size))

    @property
    def smoothed_batch(self) -> float:
        return float(np.mean(self.window)) if self.window else 0.0

    def is_high_load(self, max_batch: int) -> bool:
        return bool(self.window) and self.smoothed_batch >= self.high_frac * max_batch


class EmaFrequencyTracker:
    """Decayed access counts per fused row id — the hot-set estimator.

    Tracks only rows seen so far (sparse dict of numpy accumulators would be
    slow in pure python for large batches; we aggregate with np.unique).
    """

    def __init__(self, decay: float = 0.96):
        self.decay = decay
        self._ids = np.zeros((0,), np.int64)
        self._score = np.zeros((0,), np.float64)

    def update(self, row_ids: np.ndarray) -> None:
        """Fold one batch of row references into the decayed counts.

        **Per-touch semantics (pinned):** a row referenced k times in one
        batch earns k counts, not 1.  Heat measures *reference* frequency,
        not fetch frequency: a cached row saves work on every reference
        (cache-pool scatter, pushdown partials, or — with the §3.1.1 wire
        dedup — the one unique fetch per batch it keeps appearing in), and
        within-batch multiplicity under zipf traffic is exactly the
        temporal-locality signal that predicts cross-batch recurrence.
        Deduplicating here would flatten hot rows' scores toward the long
        tail and starve LFU admission of its ranking signal.
        """
        ids, counts = np.unique(np.asarray(row_ids).ravel(), return_counts=True)
        self.update_unique(ids, counts)

    def update_unique(self, ids: np.ndarray, counts: np.ndarray) -> None:
        """``update`` for callers that already hold the batch's unique ids
        and per-touch counts — e.g. the serving loop reusing the §3.1.1
        wire-dedup pass instead of re-running ``np.unique`` on the hot
        path.  ``ids`` must be sorted unique; ``counts`` aligned."""
        ids = np.asarray(ids, np.int64)
        counts = np.asarray(counts)
        self._score *= self.decay
        merged_ids = np.union1d(self._ids, ids)
        score = np.zeros(merged_ids.shape, np.float64)
        score[np.searchsorted(merged_ids, self._ids)] = self._score
        score[np.searchsorted(merged_ids, ids)] += counts
        self._ids, self._score = merged_ids, score
        # Bound the tracker's own memory: keep the top 4M rows.
        if len(self._ids) > 4_000_000:
            keep = np.argsort(self._score)[-2_000_000:]
            keep.sort()
            self._ids, self._score = self._ids[keep], self._score[keep]

    def top_k(self, k: int) -> np.ndarray:
        if k <= 0 or len(self._ids) == 0:
            return np.zeros((0,), np.int64)
        k = min(k, len(self._ids))
        top = np.argpartition(self._score, -k)[-k:]
        return self._ids[top]

    def top_k_with_scores(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(ids, decayed scores) of the k hottest rows, hottest first."""
        if k <= 0 or len(self._ids) == 0:
            return np.zeros((0,), np.int64), np.zeros((0,), np.float64)
        k = min(k, len(self._ids))
        top = np.argpartition(self._score, -k)[-k:]
        order = np.argsort(-self._score[top])
        top = top[order]
        return self._ids[top], self._score[top]

    def hot_fraction_covered(self, k: int) -> float:
        """Fraction of (decayed) traffic the top-k rows would absorb."""
        if len(self._ids) == 0:
            return 0.0
        total = self._score.sum()
        if total <= 0:
            return 0.0
        k = min(k, len(self._ids))
        top = np.partition(self._score, -k)[-k:]
        return float(top.sum() / total)


@dataclasses.dataclass
class CachePlan:
    """Output of the controller: what the lookup layer should replicate.

    The hash-table fields size the repro.hotcache open-addressing cache: the
    controller now resizes ``hash_slots`` (a power of two holding
    ``capacity_rows`` at ``load_factor``) instead of a flat slab, and hands
    the miss path an LFU ``admission_threshold`` derived from the coldest row
    that still made the hot set."""

    capacity_rows: int  # row-level hot cache size (0 = disabled)
    hot_ids: np.ndarray  # fused row ids to pin (len <= capacity_rows)
    replicated_fields: tuple[int, ...]  # fields whose whole vocab is replicated
    reason: str = ""
    hash_slots: int = 0  # open-addressing table slots (pow2; 0 = disabled)
    hot_freqs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64)
    )  # LFU seeds aligned with hot_ids
    admission_threshold: float = 1.0  # miss-path admission floor
    prefetch_budget_bytes: int = 0  # per-refresh piggyback cap (repro.prefetch)


class AdaptiveCacheController:
    """Combines monitor + memory model + tracker into the §3.1.1 policy."""

    def __init__(
        self,
        specs: Sequence[TableSpec],
        dim: int,
        memory_model: MemoryModel,
        bytes_per_row: int | None = None,
        monitor: SlidingWindowLoadMonitor | None = None,
        tracker: EmaFrequencyTracker | None = None,
        min_rows: int = 0,
        max_rows: int = 2_000_000,
        field_replication: bool = True,
        load_factor: float = 0.7,
        prefetch_frac: float = 0.25,
    ):
        self.specs = tuple(specs)
        self.dim = dim
        self.memory_model = memory_model
        self.bytes_per_row = bytes_per_row or dim * 4
        self.monitor = monitor or SlidingWindowLoadMonitor()
        self.tracker = tracker or EmaFrequencyTracker()
        self.min_rows = min_rows
        self.max_rows = max_rows
        self.field_replication = field_replication
        if not 0.0 < load_factor <= 1.0:
            raise ValueError("load_factor must be in (0, 1]")
        self.load_factor = load_factor  # hash-table fill target (probe cost)
        if not 0.0 <= prefetch_frac <= 1.0:
            raise ValueError("prefetch_frac must be in [0, 1]")
        # Share of the swap-in channel the §3.1.2 spatial prefetcher may
        # piggyback on per refresh (0 disables prefetch budgeting).
        self.prefetch_frac = prefetch_frac

    def observe(
        self,
        batch_size: int,
        row_ids: np.ndarray | None = None,
        *,
        unique: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> None:
        """Feed one batch into the load monitor + frequency tracker.

        Pass either ``row_ids`` (raw references; an ``np.unique`` runs
        here) or ``unique=(ids, counts)`` — the §3.1.1 dedup pass's unique
        ids and per-touch counts, reused so the serving hot path does not
        recompute the aggregation it already paid for.  The two paths feed
        identical tracker state (asserted by a regression test), so
        ``shard_heat`` — and therefore the engine pool's heat dealing — is
        unchanged by which one the caller uses.
        """
        self.monitor.observe(batch_size)
        if unique is not None:
            self.tracker.update_unique(*unique)
        elif row_ids is not None:
            self.tracker.update(row_ids)

    def shard_heat(
        self, rows_per_shard: int, num_shards: int
    ) -> np.ndarray:
        """Decayed traffic per row-range shard — the §3.2 skew signal.

        Sums the frequency tracker's per-row scores by owning shard (fused
        id // rows_per_shard, the core.sharding.RangeRouter layout).  The
        rdma engine pool's heat-weighted shard->thread dealing
        (``repro.rdma.heat_affinity``) consumes this so hot shards spread
        across engine threads before work stealing has to rescue them.
        All-zero while the tracker is empty (callers keep the modulo deal).
        """
        if rows_per_shard <= 0 or num_shards <= 0:
            raise ValueError("rows_per_shard and num_shards must be positive")
        heat = np.zeros(num_shards, np.float64)
        ids, scores = self.tracker._ids, self.tracker._score
        if len(ids):
            shard = np.clip(ids // rows_per_shard, 0, num_shards - 1)
            np.add.at(heat, shard, scores)
        return heat

    def plan(self, current_batch: int) -> CachePlan:
        budget = self.memory_model.cache_budget_bytes(
            max(current_batch, int(self.monitor.smoothed_batch))
        )
        rows_budget = budget // self.bytes_per_row

        replicated: list[int] = []
        if self.field_replication:
            # Greedily replicate the smallest-vocab fields: whole-field
            # replication removes those fields from the collective entirely
            # (static win), so small fields are the best bytes-per-benefit.
            order = sorted(range(len(self.specs)), key=lambda i: self.specs[i].vocab)
            for i in order:
                need = self.specs[i].vocab
                if need <= rows_budget // 2:  # spend at most half budget on fields
                    replicated.append(i)
                    rows_budget -= need
                else:
                    break

        capacity = int(np.clip(rows_budget, self.min_rows, self.max_rows))
        # Round to a lane-friendly multiple; keep 0 if starved.
        capacity = (capacity // 128) * 128
        hot, scores = self.tracker.top_k_with_scores(capacity)
        # Hash-table sizing: hold `capacity` rows at the target load factor.
        # (slots <= 2x capacity/load_factor since next_pow2 at most doubles;
        # the budget accounting stays row-based because vacant slots carry no
        # embedding payload worth mentioning: 8B/slot vs dim*4B/row.)
        from repro_torch.hotcache.table import next_pow2

        hash_slots = next_pow2(int(np.ceil(capacity / self.load_factor))) if capacity else 0
        # A missed row earns admission once it is as hot as the coldest row
        # that made the cut (floor 1: everything qualifies while warming up).
        # Floored so the plan's own hot_freqs (also floored) always clear it.
        admission = float(np.floor(scores[-1])) if len(scores) else 1.0
        admission = max(1.0, admission)
        # Spatial-prefetch piggyback budget: a fraction of one refresh's
        # worth of swap-in bytes.  The channel is shared with demand misses,
        # so under high load speculation is throttled hard (§3.1.1's
        # swap-in rate limit extends to §3.1.2's prefetch traffic).  "High"
        # is judged against the cache-LESS system ceiling — a fixed point of
        # the memory model — not against the batch the budget was derived
        # from (which would tautologically always read as high).
        pf_budget = int(self.prefetch_frac * capacity * self.bytes_per_row)
        if capacity and self.monitor.is_high_load(
            self.memory_model.max_batch_given_cache(0)
        ):
            pf_budget //= 4
        reason = (
            f"budget={budget>>20}MiB rows={capacity} slots={hash_slots} "
            f"adm={admission:.1f} rep_fields={replicated} "
            f"load={self.monitor.smoothed_batch:.0f} "
            f"pf_budget={pf_budget>>10}KiB"
        )
        return CachePlan(
            capacity_rows=capacity,
            hot_ids=hot,
            replicated_fields=tuple(sorted(replicated)),
            reason=reason,
            hash_slots=hash_slots,
            hot_freqs=np.maximum(scores, 1.0).astype(np.int64),
            admission_threshold=admission,
            prefetch_budget_bytes=pf_budget,
        )
