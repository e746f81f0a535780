"""Piggybacked spatial prefetch over the hotcache swap-in channel.

Port of ``repro/prefetch/prefetcher.py`` (numpy, copied with its imports
rewritten).  The miner it drives selects neighbors through kernel K5
(``prefetch.kernels``) when it was built with ``device="cuda"``.

Paper anchor: §3.1.2 — spatial locality: rows that co-occur in lookups are
fetched together, so one demand swap-in pre-warms the cache for its likely
companions before they individually miss.

The hotcache's demand path already pays for a host-service ``gather_rows``
round trip every refresh (legacy HostLookupService or the §3.2 rdma-pooled
service — the prefetcher is engine-agnostic).  The prefetcher rides that
channel: for each row being swapped in, it asks the co-occurrence miner for
the row's strongest partners and appends them to the same fetch, under a
hard byte budget the controller sets per plan (the swap-in channel is
shared with misses, so piggyback traffic must be bounded and must shrink
under load).

Invariants:
  * Result invariance (bit-equal): prefetch changes *when bytes move*,
    never *what lookups return* — fetched rows are bit-identical to the
    authoritative shard rows, so any pooled result is unchanged whether a
    row arrived by demand swap-in, by piggyback, or over the wire
    (asserted in tests/test_prefetch.py and, for this package against the
    reference, tests/test_torch_prefetch.py).
  * Cache discipline: prefetched rows do not bypass admission — they enter
    through the same LFU ``HostHashCache.insert`` rules, with their
    (discounted) co-occurrence score as the admission evidence, so an
    inaccurate prefetch loses the slot auction to genuinely hot incumbents
    instead of polluting the cache.
  * Bounded speculation: piggybacked bytes never exceed the policy's byte
    budget per refresh, and candidates that cannot clear the admission
    floor are dropped *before* spending wire bytes.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.prefetch.cooccur import CooccurrenceMiner

if TYPE_CHECKING:  # annotation-only; keeps the import graph acyclic
    from repro_torch.core.lookup_engine import HostLookupService  # noqa: F401
    from repro_torch.hotcache.miss_path import HostHashCache  # noqa: F401


@dataclasses.dataclass(frozen=True)
class PrefetchPolicy:
    """Knobs of the piggyback channel.

    k_neighbors — partners fetched per swapped-in trigger row.
    byte_budget — hard cap on piggybacked bytes per refresh (the controller
        overwrites this from CachePlan.prefetch_budget_bytes).
    min_score — co-occurrence strength floor: weaker edges are noise.
    admission_discount — prefetched rows enter the LFU auction with
        `score * discount` as their frequency: speculative evidence is worth
        less than an observed miss, so prefetch can't evict hotter rows.
    admission_floor — the admission threshold prefetch inserts run under.
        Deliberately *below* the demand path's: §3.1.2's whole point is to
        admit a co-occurring row before it has individually proven itself
        (it lags the trigger by construction — e.g. it sits deeper in the
        bags), so speculation may claim vacant or colder slots on pair
        evidence alone; the LFU eviction rule still protects hotter
        incumbents from it.
    """

    k_neighbors: int = 4
    byte_budget: int = 1 << 16
    min_score: float = 1.0
    admission_discount: float = 0.5
    admission_floor: float = 1.0


@dataclasses.dataclass
class PrefetchStats:
    issued: int = 0  # rows fetched speculatively
    admitted: int = 0  # ...that won a cache slot
    bytes_prefetch: int = 0  # piggybacked wire bytes
    triggers: int = 0  # swap-in rows that offered neighbors

    def summary(self) -> dict:
        return dataclasses.asdict(self)


class PrefetchEngine:
    """Mines the lookup stream and piggybacks neighbors onto swap-ins."""

    def __init__(
        self,
        miner: CooccurrenceMiner | None = None,
        policy: PrefetchPolicy | None = None,
    ):
        self.miner = miner or CooccurrenceMiner()
        self.policy = policy or PrefetchPolicy()
        self.stats = PrefetchStats()

    # ------------------------------------------------------------- observing

    def observe(self, fused: np.ndarray, mask: np.ndarray) -> None:
        """Feed one lookup batch to the co-occurrence miner."""
        self.miner.observe(fused, mask)

    def decay(self) -> None:
        self.miner.decay()

    def set_byte_budget(self, byte_budget: int) -> None:
        """Controller hook: CachePlan.prefetch_budget_bytes lands here."""
        self.policy = dataclasses.replace(
            self.policy, byte_budget=max(0, int(byte_budget))
        )

    # ------------------------------------------------------------ piggyback

    def candidates(
        self, trigger_ids: np.ndarray, resident_keys: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Deduped, budget-trimmed neighbor ids (+scores), strongest first.

        Candidates whose discounted score cannot clear the prefetch
        admission floor are dropped *before* the fetch — a row the cache is
        certain to reject must not spend piggyback bytes.
        """
        trigger_ids = np.asarray(trigger_ids, np.int64)
        if len(trigger_ids) == 0 or self.policy.byte_budget <= 0:
            return np.zeros((0,), np.int64), np.zeros((0,), np.float64)
        nbr, score = self.miner.neighbors(
            trigger_ids, self.policy.k_neighbors, self.policy.min_score
        )
        ids, sc = nbr.ravel(), score.ravel()
        keep = ids >= 0
        keep &= np.maximum(
            sc * self.policy.admission_discount, 1.0
        ) >= self.policy.admission_floor
        keep &= ~np.isin(ids, trigger_ids)  # already on the demand fetch
        if len(resident_keys):
            keep &= ~np.isin(ids, resident_keys)  # already cached
        ids, sc = ids[keep], sc[keep]
        if len(ids) == 0:
            return ids, sc
        # Dedupe to the strongest edge per row, then strongest-first order.
        order = np.lexsort((-sc, ids))
        ids, sc = ids[order], sc[order]
        first = np.ones(len(ids), bool)
        first[1:] = ids[1:] != ids[:-1]
        ids, sc = ids[first], sc[first]
        order = np.argsort(-sc, kind="stable")
        return ids[order], sc[order]

    def piggyback(
        self,
        trigger_ids: np.ndarray,
        cache: "HostHashCache",
        service: "HostLookupService",
    ) -> int:
        """Fetch trigger rows' neighbors under the byte budget and admit them
        through the cache's LFU rules at the prefetch admission floor
        (marked as prefetched for attribution).  Returns #rows admitted."""
        self.stats.triggers += len(np.asarray(trigger_ids).ravel())
        ids, scores = self.candidates(trigger_ids, cache.keys)
        if len(ids) == 0:
            return 0
        entry = 4 + cache.rows.shape[1] * cache.rows.dtype.itemsize
        max_rows = self.policy.byte_budget // entry
        ids, scores = ids[:max_rows], scores[:max_rows]
        if len(ids) == 0:
            return 0
        rows = service.gather_rows(ids)
        self.stats.issued += len(ids)
        self.stats.bytes_prefetch += len(ids) * entry
        freqs = np.maximum(scores * self.policy.admission_discount, 1.0)
        n = cache.insert(
            ids, rows, freqs, self.policy.admission_floor, prefetched=True
        )
        self.stats.admitted += n
        return n
