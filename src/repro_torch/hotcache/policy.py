"""Frequency-aware admission/eviction policy for the hot cache.

In the spirit of FreqCacheEmbedding (and RecShard's observation that hot/cold
row skew is extreme *and statistically stable*), admission is earned, not
granted: a missed row must accumulate enough decayed frequency before it is
swapped in, and an incumbent is only evicted for a strictly hotter challenger
(see table.cache_insert rules).  This replaces the seed's pure
capacity-based top-k replication, which thrashed under drift: every refresh
rebuilt the whole slab even when 99% of the hot set was unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Knobs of the tiered cache's swap-in loop.

    admission_threshold — min decayed access count before a missed row may
        claim a cache slot (rule 2 of table.cache_insert).
    max_swap_in — per-refresh bound on admitted rows: swap-in traffic shares
        the NIC with misses, so it must be rate-limited (§3.1.1's async
        swap-in, host analogue).
    decay — per-refresh EMA decay of the miss counters; hot sets drift
        diurnally (Fig 5), stale heat must fade.
    """

    admission_threshold: float = 2.0
    max_swap_in: int = 512
    decay: float = 0.95


def select_admissions(
    ids: np.ndarray,
    scores: np.ndarray,
    policy: AdmissionPolicy,
    cached_keys: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pick the rows worth swapping in: hottest first, already-cached skipped.

    Returns (ids, scores) of at most ``policy.max_swap_in`` candidates whose
    decayed score clears the admission threshold.
    """
    ids = np.asarray(ids)
    scores = np.asarray(scores, np.float64)
    keep = scores >= policy.admission_threshold
    if cached_keys is not None and len(cached_keys):
        keep &= ~np.isin(ids, cached_keys)
    ids, scores = ids[keep], scores[keep]
    if len(ids) > policy.max_swap_in:
        top = np.argpartition(scores, -policy.max_swap_in)[-policy.max_swap_in:]
        ids, scores = ids[top], scores[top]
    order = np.argsort(-scores)  # hottest first: they win window conflicts
    return ids[order], scores[order]
