"""Tiered miss path: cache-first lookup with misses batched to the servers.

Paper anchor: §3.1.1 — "shrink the lookup": a hot-row cache in front of the
disaggregated embedding servers so wire bytes scale with the *miss* rate,
not the request rate.  This module is the host-side half of the pillar; the
device-resident half (HashCacheState + kernels K3/K4) lives in table.py /
kernels.py.

``HostHashCache`` is the host-side mirror of table.HashCacheState — same
open-addressing layout, same hash/probe geometry (table.hash_slots_np), in
numpy — the form the serving runtime (which lives outside jit) consumes.

``TieredLookupService`` stacks it in front of a host lookup service (the
legacy ``core.lookup_engine.HostLookupService`` or the §3.2
``repro.rdma.PooledLookupService`` — the serving runtime defaults to the
latter, so tier-1 subrequests ride the multi-threaded rdma engine pool):

  tier 0  hash-cache probe       — hits resolve locally, zero network bytes
  tier 1  miss subrequests       — ONLY cache misses are fanned out to the
                                   embedding servers, through the engine the
                                   injected service wraps
  refresh LFU swap-in            — decayed miss counters admit rows past the
                                   admission threshold (policy.py); swap-in
                                   fetch bytes are tracked separately

The lookup is split into two phases around an asynchronous miss handle
(cross-batch pipelining, §3.2): ``lookup_begin`` probes the cache, pools the
hits, and *posts* the miss subrequests (returning a ``PendingTieredLookup``);
``wait`` blocks on the remote handle and performs the float64 tier merge.  A
pipelined serving loop calls ``lookup_begin`` for batch N+1 while batch N's
misses are still on the wire — the probe and the fetch overlap.  ``lookup``
is the closed-loop composition (begin + wait) and is unchanged in behaviour.

Invariants:
  * Result invariance (bit-equal): all tier merging accumulates in float64
    over the (exactly representable) float32 rows, so *where* a row is
    served from — cache, wire, or prefetch, and on whichever engine thread —
    does not perturb the pooled result.  The repro.prefetch and repro.rdma
    invariance contracts both rest on this.
  * Mean-pooled fields are normalized exactly once, at the end, over the
    FULL validity counts, so splitting a bag between cache hits and server
    misses is exact.
  * Byte accounting is conserved: bytes_saved is defined as bytes_no_cache
    - bytes_network - bytes_swap_in - bytes_prefetch, so every wire byte is
    attributed to exactly one channel (miss, swap-in, or speculation).

When a ``repro_torch.prefetch.PrefetchEngine`` is attached, the tier also becomes
the spatial-locality prefetch channel (§3.1.2): every lookup feeds the
co-occurrence miner, every refresh's swap-in fetch piggybacks the admitted
rows' top-k partners under the engine's byte budget, and hits served by a
prefetched row before its first touch are attributed in the stats.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.adaptive_cache import EmaFrequencyTracker
from repro_torch.hotcache.policy import AdmissionPolicy, select_admissions
from repro_torch.obs.trace import CAT_CACHE, CAT_LOOKUP, CAT_PREFETCH, NULL_TRACER

if TYPE_CHECKING:  # annotation-only: a runtime import would close the cycle
    from repro_torch.core.lookup_engine import HostLookupService  # noqa: F401
    from repro_torch.prefetch.prefetcher import PrefetchEngine  # noqa: F401
    # core.embedding -> hotcache -> miss_path -> lookup_engine -> core.embedding
from repro_torch.hotcache.table import EMPTY_KEY, hash_slots_np, next_pow2


class HostHashCache:
    """Open-addressing (linear probe) cache of embedding rows, in host memory."""

    def __init__(self, num_slots: int, dim: int, max_probes: int = 8):
        num_slots = next_pow2(num_slots) if num_slots else 0
        self.num_slots = num_slots
        self.max_probes = max_probes
        self.keys = np.full((num_slots,), EMPTY_KEY, np.int64)
        self.rows = np.zeros((num_slots, dim), np.float32)
        self.freq = np.zeros((num_slots,), np.float64)
        # Prefetch attribution: True while a slot holds a speculatively
        # fetched row that has not yet served a hit (repro.prefetch).
        self.prefetched = np.zeros((num_slots,), bool)
        self.prefetch_evicted = 0  # prefetched rows evicted before any hit

    # ------------------------------------------------------------------ read

    def probe(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """ids [...] -> (slot [...], hit [...]). Vectorized, read-only."""
        if self.num_slots == 0:
            z = np.zeros(np.shape(ids), np.int64)
            return z, np.zeros(np.shape(ids), bool)
        home = hash_slots_np(ids, self.num_slots)
        offs = np.arange(self.max_probes)
        slots = (home[..., None] + offs) & (self.num_slots - 1)
        match = (self.keys[slots] == np.asarray(ids)[..., None]) & (
            np.asarray(ids) != EMPTY_KEY
        )[..., None]
        hit = match.any(axis=-1)
        sel = np.argmax(match, axis=-1)
        slot = np.take_along_axis(slots, sel[..., None], axis=-1)[..., 0]
        return slot, hit

    def lookup(
        self, ids: np.ndarray, credit: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        """ids [...] -> (rows [..., D], hit [...]); miss rows are zero.

        credit=True bumps the hit slots' LFU counters, so resident-hot rows
        keep defending their slots against decay + challengers (without it,
        only the *miss* path feeds frequencies and a 100%-hit row would decay
        to an easy eviction victim).  The device HashCacheState lookup stays
        a pure read; crediting is a host-mirror privilege."""
        if self.num_slots == 0:
            return (
                np.zeros(np.shape(ids) + (self.rows.shape[1],), np.float32),
                np.zeros(np.shape(ids), bool),
            )
        slot, hit = self.probe(ids)
        rows = self.rows[slot] * hit[..., None]
        if credit and hit.any():
            np.add.at(self.freq, slot[hit], 1.0)
        return rows, hit

    @property
    def occupancy(self) -> int:
        return int((self.keys != EMPTY_KEY).sum())

    # ----------------------------------------------------------------- write

    def insert(
        self, ids: np.ndarray, rows: np.ndarray, freqs: np.ndarray,
        admission_threshold: float = 1.0, prefetched: bool = False,
    ) -> int:
        """Batch insert under the table.cache_insert rules; returns #admitted.

        ``prefetched=True`` marks the admitted slots for hit attribution
        (repro.prefetch); a demand insert refreshing a still-untouched
        prefetched row clears the mark — the demand path would have fetched
        it anyway, so the prefetch earns no credit.
        """
        if self.num_slots == 0:
            return 0
        admitted = 0
        home = hash_slots_np(ids, self.num_slots)
        for i in range(len(ids)):
            id_i = int(ids[i])
            if id_i == EMPTY_KEY:
                continue
            window = (home[i] + np.arange(self.max_probes)) & (self.num_slots - 1)
            kw = self.keys[window]
            match = np.flatnonzero(kw == id_i)
            if len(match):
                t = window[match[0]]
                self.rows[t] = rows[i]
                self.freq[t] += freqs[i]
                self.prefetched[t] &= prefetched
                admitted += 1
                continue
            if freqs[i] < admission_threshold:
                continue
            vacant = np.flatnonzero(kw == EMPTY_KEY)
            if len(vacant):
                t = window[vacant[0]]
            else:
                t = window[np.argmin(self.freq[window])]
                if freqs[i] <= self.freq[t]:
                    continue  # incumbent is at least as hot: keep it
                if self.prefetched[t]:
                    self.prefetch_evicted += 1  # speculation lost the slot
            self.keys[t] = id_i
            self.rows[t] = rows[i]
            self.freq[t] = freqs[i]
            self.prefetched[t] = prefetched
            admitted += 1
        return admitted

    def decay(self, factor: float) -> None:
        self.freq *= factor


def resident_rows_in_range(
    cache: HostHashCache, lo: int, hi: int
) -> tuple[np.ndarray, np.ndarray]:
    """Cached (fused id, row) pairs whose id falls in ``[lo, hi)``.

    The chaos layer's shard-drop recovery source: when an embedding shard
    goes down, the rows of that shard still resident in the cache tier are
    exact f32 copies of the DRAM rows (inserts copy ``table_np[ids]``), so
    re-replicating them into a degraded stand-in serves hot traffic
    bit-identically through the outage.
    """
    if cache.num_slots == 0:
        return (
            np.zeros(0, np.int64),
            np.zeros((0, cache.rows.shape[1]), cache.rows.dtype),
        )
    sel = (cache.keys != EMPTY_KEY) & (cache.keys >= lo) & (cache.keys < hi)
    return cache.keys[sel].copy(), cache.rows[sel].copy()


@dataclasses.dataclass
class TieredStats:
    lookups: int = 0  # valid (id, slot) pairs probed
    hits: int = 0
    batches: int = 0
    bytes_no_cache: int = 0  # what the wire would carry without the cache
    bytes_network: int = 0  # what it actually carried (misses only)
    bytes_request: int = 0  # request-direction bytes (scattered id lists /
    # range descriptors posted by the miss WRs) — the channel segment
    # pushdown makes the next bottleneck; NOT part of bytes_saved, which
    # conserves response-direction bytes only.
    bytes_swap_in: int = 0  # refresh-path fetches
    admitted: int = 0
    # repro.prefetch attribution (all zero when no engine is attached):
    bytes_prefetch: int = 0  # piggybacked speculative fetch bytes
    prefetch_issued: int = 0  # rows fetched speculatively
    prefetch_admitted: int = 0  # ...that won a cache slot
    prefetch_hits: int = 0  # hits served by a prefetched, untouched row
    prefetch_evicted: int = 0  # prefetched rows evicted before any hit

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.lookups)

    @property
    def bytes_saved(self) -> int:
        return (
            self.bytes_no_cache
            - self.bytes_network
            - self.bytes_swap_in
            - self.bytes_prefetch
        )

    @property
    def prefetch_useful_rate(self) -> float:
        """Fraction of speculative fetches that served a hit first-touch."""
        return self.prefetch_hits / max(1, self.prefetch_issued)

    def summary(self) -> dict:
        return {
            "hit_rate": self.hit_rate,
            "bytes_no_cache": self.bytes_no_cache,
            "bytes_network": self.bytes_network,
            "bytes_request": self.bytes_request,
            "bytes_swap_in": self.bytes_swap_in,
            "bytes_prefetch": self.bytes_prefetch,
            "bytes_saved": self.bytes_saved,
            "admitted": self.admitted,
            "prefetch_issued": self.prefetch_issued,
            "prefetch_admitted": self.prefetch_admitted,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_evicted": self.prefetch_evicted,
            "prefetch_useful_rate": self.prefetch_useful_rate,
        }


class PendingTieredLookup:
    """One in-flight tiered lookup: cache hits pooled, misses posted.

    Produced by ``TieredLookupService.lookup_begin``; ``wait()`` blocks on
    the remote handle, folds the miss sums into the hit sums (float64 — the
    split-invariant tier merge), normalizes mean fields once over the full
    counts, and runs the deferred LFU refresh if this batch was due one.
    Idempotent: the merged result is cached.
    """

    def __init__(self, tier: "TieredLookupService", sums: np.ndarray,
                 mask: np.ndarray, remote, do_refresh: bool,
                 unique_ids: np.ndarray | None = None,
                 unique_counts: np.ndarray | None = None):
        self._tier = tier
        self._sums = sums
        self._mask = mask
        self._remote = remote  # async-handle surface or None (no misses)
        self._do_refresh = do_refresh
        self._out: np.ndarray | None = None
        # Per-stage attribution (always recorded — the serving loop's
        # serve.attr.* decomposition reads these; the tracer spans, when on,
        # are cut from the same work):  probe_s/post_s are the two halves of
        # lookup_begin; merge_s is wait()'s post-wire work (tier merge +
        # the pool handle's own merge, when the remote exposes one).
        self.probe_s = 0.0
        self.post_s = 0.0
        self.merge_s = 0.0
        # The §3.1.1 dedup prepass over this batch's VALID ids (sorted
        # unique fused ids + per-touch counts), computed at admit time when
        # ``collect_unique`` is on.  The serving loop feeds these to the
        # adaptive-cache controller (``observe(unique=...)``) instead of
        # re-running np.unique over the raw references at retire time.
        self.unique_ids = unique_ids
        self.unique_counts = unique_counts

    @property
    def done(self) -> bool:
        return self._out is not None or self._remote is None \
            or self._remote.done

    @property
    def hedged(self) -> int:
        """Duplicate subrequests the miss handle's straggler hedge issued."""
        return 0 if self._remote is None else getattr(self._remote, "hedged", 0)

    @property
    def degraded_bags(self) -> set:
        """Flat bag ids [0, B*F) answered as brownout partials (degrade
        policy under a dropped shard) — empty unless ``wait`` has run and
        the miss path actually degraded.  Cache-hit sums are never
        degraded: only the remote handle contributes."""
        if self._remote is None:
            return set()
        return getattr(self._remote, "degraded_bags", set())

    @property
    def degraded_rows(self) -> int:
        """Dropped-shard cold rows answered as zero vectors for this batch."""
        if self._remote is None:
            return 0
        return getattr(self._remote, "degraded_rows", 0)

    def wait(self, timeout: float | None = None) -> np.ndarray:
        if self._out is not None:
            return self._out
        tracer = self._tier.tracer
        if self._remote is not None:
            self._sums += np.asarray(self._remote.wait(timeout), np.float64)
        t_m = time.perf_counter()
        t_merge = tracer.now() if tracer.enabled else 0.0
        out = self._tier._mean_normalize(self._sums, self._mask)
        self._out = out.astype(np.float32)
        if tracer.enabled:
            tracer.complete(
                "tier_merge", CAT_LOOKUP, t_merge, tracer.now() - t_merge,
                args={"remote": self._remote is not None,
                      "hedged": self.hedged},
            )
        if self._do_refresh:
            self._tier.refresh()
        self.merge_s = (time.perf_counter() - t_m) + (
            0.0 if self._remote is None
            else getattr(self._remote, "merge_s", 0.0)
        )
        return self._out


class TieredLookupService:
    """Hash-cache tier in front of a HostLookupService (see module docstring).

    ``remote_fn(indices, cold_mask) -> [B, F, D] unnormalized sums`` may be
    injected (a synchronous miss executor — it runs eagerly at
    ``lookup_begin`` time, so it serializes with the probe); the pipelined
    alternative is ``remote_async_fn(indices, cold_mask) -> handle`` whose
    ``handle.wait()`` yields the same sums (the serving runtime passes the
    pool-hedged ``PooledLookupService.lookup_async``).  With neither
    injected, the tier uses ``service.lookup_async`` when the engine offers
    it and falls back to the eager ``service.lookup`` otherwise.

    ``refresh_every=0`` disables the self-driven LFU refresh: an external
    controller (runtime.serving + core.adaptive_cache) owns the swap-in
    schedule instead.  ``track_bytes=False`` skips the per-batch wire-byte
    accounting (an O(batch) np.unique per call) for latency-critical callers
    that don't consume the stats.

    ``prefetcher`` (a repro_torch.prefetch.PrefetchEngine) turns the refresh
    fetch into the §3.1.2 piggyback channel; see the module docstring.
    """

    def __init__(
        self,
        service: "HostLookupService",
        num_slots: int,
        policy: AdmissionPolicy | None = None,
        max_probes: int = 8,
        refresh_every: int = 8,
        remote_fn=None,
        remote_async_fn=None,
        track_bytes: bool = True,
        prefetcher: "PrefetchEngine | None" = None,
        collect_unique: bool = False,
        tracer=None,
    ):
        if remote_fn is not None and remote_async_fn is not None:
            raise ValueError("pass remote_fn OR remote_async_fn, not both")
        self.service = service
        self.tracer = NULL_TRACER if tracer is None else tracer
        dim = service.servers[0].rows.shape[1]
        self.cache = HostHashCache(num_slots, dim, max_probes=max_probes)
        self.policy = policy or AdmissionPolicy()
        self.refresh_every = refresh_every
        self.track_bytes = track_bytes
        # collect_unique=True: lookup_begin runs the dedup prepass (one
        # np.unique over the batch's valid fused ids) and publishes
        # (unique_ids, per-touch counts) on the pending handle, so a
        # serving loop's controller can consume heat without recomputing
        # the aggregation at retire time.
        self.collect_unique = collect_unique
        self.prefetcher = prefetcher
        self.remote_fn = remote_fn or (
            lambda idx, cold: service.lookup(idx, cold, mean_normalize=False)
        )
        self.remote_async_fn = remote_async_fn
        self._remote_injected = remote_fn is not None
        self.tracker = EmaFrequencyTracker(decay=self.policy.decay)
        self.stats = TieredStats()
        self._offsets = service.tables.field_offsets_array()
        self._pf_evicted_seen = 0  # cache-counter baseline (survives rebuilds)

    # ---------------------------------------------------------------- lookup

    def _remote_begin(self, indices: np.ndarray, cold: np.ndarray):
        """Post (or eagerly run) the miss tier; returns an async handle."""
        if self.remote_async_fn is not None:
            return self.remote_async_fn(indices, cold)
        if not self._remote_injected and hasattr(self.service, "lookup_async"):
            return self.service.lookup_async(
                indices, cold, mean_normalize=False
            )
        # Deferred import: a module-level one would close the
        # core.embedding -> hotcache -> lookup_engine cycle (see top).
        from repro_torch.core.lookup_engine import CompletedLookup

        return CompletedLookup(
            np.asarray(self.remote_fn(indices, cold), np.float64)
        )

    def lookup_begin(
        self, indices: np.ndarray, mask: np.ndarray
    ) -> PendingTieredLookup:
        """Probe + post phase of one [B,F,nnz] lookup (pipelined form).

        Probes the cache, pools the hits in float64, posts the miss
        subrequests through the engine, and returns a
        ``PendingTieredLookup`` whose ``wait()`` performs the merge.  All
        cache/tracker mutation happens here on the calling thread — the
        engine threads only gather from the immutable shards — so a serving
        loop may begin batch N+1 while batch N is still pending without any
        tier-level locking.
        """
        tracer = self.tracer
        t_begin = time.perf_counter()
        t_probe = tracer.now() if tracer.enabled else 0.0
        mask = np.asarray(mask, bool)
        fused = indices.astype(np.int64) + self._offsets[None, :, None]
        self.stats.batches += 1
        self.stats.lookups += int(mask.sum())
        do_refresh = bool(self.refresh_every) and \
            self.stats.batches % self.refresh_every == 0
        uniq = counts = None
        if self.collect_unique:
            uniq, counts = np.unique(fused[mask], return_counts=True)
        if self.track_bytes:
            if (
                uniq is not None
                and getattr(self.service, "dedup", False)
                and not getattr(self.service, "pushdown_segments", False)
            ):
                # Reuse the dedup prepass for the no-cache price too — the
                # closed form needs exactly this sorted unique id set, so
                # the batch pays ONE aggregation for heat + accounting.
                # (Segment pushdown prices through the fan-out planner —
                # the unique set alone can't see segment cuts — so it takes
                # the network_bytes path below.)
                self.stats.bytes_no_cache += \
                    self.service.unique_response_bytes(uniq)
            else:
                self.stats.bytes_no_cache += \
                    self.service.network_bytes(indices, mask)
        if self.prefetcher is not None:
            self.prefetcher.observe(fused, mask)  # mine co-occurrence online
            self._sync_prefetch_evictions()  # incl. external plan inserts

        slot, hit = self.cache.probe(np.where(mask, fused, EMPTY_KEY))
        hit &= mask
        self.stats.hits += int(hit.sum())
        if hit.any():
            # LFU credit (the cache.lookup(credit=True) semantics) ...
            np.add.at(self.cache.freq, slot[hit], 1.0)
            # ... plus prefetch attribution: a hit on a still-marked slot is
            # a prefetched-before-first-touch row doing its job.  Counted
            # per unique slot (one credit per prefetched ROW, even if its
            # first-touch batch references it in several bags) so
            # prefetch_hits <= prefetch_issued always.
            pf_hit = hit & self.cache.prefetched[slot]
            if pf_hit.any():
                touched = np.unique(slot[pf_hit])
                self.stats.prefetch_hits += len(touched)
                self.cache.prefetched[touched] = False
        # float64 accumulation over exactly-representable f32 rows: the bag
        # sum is independent of the cache/wire split (prefetch invariance).
        if self.cache.num_slots:
            rows = self.cache.rows[slot] * hit[..., None]
            out = rows.sum(axis=2, dtype=np.float64)
        else:  # probe of a 0-slot cache (pre-first-plan serving) hits nothing
            out = np.zeros(mask.shape[:2] + (self.cache.rows.shape[1],),
                           np.float64)

        probe_s = time.perf_counter() - t_begin
        if tracer.enabled:
            tracer.complete(
                "probe", CAT_CACHE, t_probe, tracer.now() - t_probe,
                args={"batch": self.stats.batches,
                      "probed": int(mask.sum()), "hits": int(hit.sum())},
            )
        remote = None
        cold = mask & ~hit
        if cold.any():
            t_post = tracer.now() if tracer.enabled else 0.0
            remote = self._remote_begin(indices, cold)
            if tracer.enabled:
                tracer.complete(
                    "post", CAT_LOOKUP, t_post, tracer.now() - t_post,
                    args={"batch": self.stats.batches,
                          "misses": int(cold.sum())},
                )
            if self.track_bytes:
                # Accounting == movement: a dedup-capable handle reports
                # the response bytes its WRs genuinely posted (borrowed
                # in-flight rows move zero new bytes); other executors fall
                # back to the service's per-batch closed form.
                wrb = getattr(remote, "wire_response_bytes", None)
                self.stats.bytes_network += (
                    wrb if wrb is not None
                    else self.service.network_bytes(indices, cold)
                )
                self.stats.bytes_request += getattr(
                    remote, "wire_request_bytes", 0
                )
            if self.refresh_every:
                # The tier-local LFU tracker only feeds the self-driven
                # refresh; with refresh_every=0 an external controller owns
                # admissions (and runs its own tracker), so updating here
                # would be pure serial overhead on the pipelined hot path.
                # PER-TOUCH admission semantics (pinned): a row referenced
                # k times in this batch earns k counts — see
                # EmaFrequencyTracker.update for why dedup must NOT apply
                # to the heat signal even though it applies to the wire.
                self.tracker.update(fused[cold])
        pending = PendingTieredLookup(
            self, out, mask, remote, do_refresh,
            unique_ids=uniq, unique_counts=counts,
        )
        pending.probe_s = probe_s
        # Everything after the probe — miss posting, byte accounting, LFU
        # feed — is the post half (a superset of the "post" tracer span,
        # which covers only the remote posting call).
        pending.post_s = time.perf_counter() - t_begin - probe_s
        return pending

    def lookup(self, indices: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """[B,F,nnz] -> [B,F,D] pooled; only cache misses hit the network.

        Closed-loop composition of ``lookup_begin`` + ``wait``."""
        return self.lookup_begin(indices, mask).wait()

    def _mean_normalize(self, sums: np.ndarray, mask: np.ndarray) -> np.ndarray:
        counts = mask.sum(-1).astype(np.float64)
        mean_mask = np.asarray(
            [s.pooling == "mean" for s in self.service.tables.specs]
        )
        denom = np.maximum(counts, 1.0)[..., None]
        return np.where(mean_mask[None, :, None], sums / denom, sums)

    # --------------------------------------------------------------- refresh

    def refresh(self) -> int:
        """LFU swap-in: admit miss ids that cleared the admission threshold.

        With a prefetcher attached, the swap-in fetch doubles as the §3.1.2
        piggyback channel: the admitted rows' top-k co-occurring partners
        ride along under the engine's byte budget, through the same LFU
        admission rules (marked for hit attribution).
        """
        if self.cache.num_slots == 0:
            return 0
        cand_ids, scores = self.tracker.top_k_with_scores(
            self.policy.max_swap_in * 4
        )
        if len(cand_ids) == 0:
            return 0
        ids, freqs = select_admissions(cand_ids, scores, self.policy, self.cache.keys)
        if not len(ids):
            self._decay()
            return 0
        tracer = self.tracer
        t_swap = tracer.now() if tracer.enabled else 0.0
        rows = self.service.gather_rows(ids)
        entry = 4 + rows.shape[1] * rows.dtype.itemsize
        self.stats.bytes_swap_in += len(ids) * entry
        n = self.cache.insert(ids, rows, freqs, self.policy.admission_threshold)
        self.stats.admitted += n
        if tracer.enabled:
            tracer.complete(
                "swap_in", CAT_CACHE, t_swap, tracer.now() - t_swap,
                args={"candidates": len(ids), "admitted": n,
                      "bytes": len(ids) * entry},
            )
        if self.prefetcher is not None:
            issued0 = self.prefetcher.stats.issued
            bytes0 = self.prefetcher.stats.bytes_prefetch
            n_pf = self.prefetcher.piggyback(ids, self.cache, self.service)
            self.stats.prefetch_admitted += n_pf
            issued = self.prefetcher.stats.issued - issued0
            self.stats.prefetch_issued += issued
            pf_bytes = self.prefetcher.stats.bytes_prefetch - bytes0
            self.stats.bytes_prefetch += pf_bytes
            if tracer.enabled and issued:
                tracer.instant(
                    "prefetch_piggyback", CAT_PREFETCH, tracer.now(),
                    args={"issued": issued, "admitted": n_pf,
                          "bytes": pf_bytes},
                )
            self._sync_prefetch_evictions()
        self._decay()
        return n

    def _sync_prefetch_evictions(self) -> None:
        """Fold the cache's eviction counter into the cumulative stats.
        The cache object may be rebuilt (controller resize) which resets its
        counter; a decrease means a fresh cache, so re-baseline at zero."""
        seen = self._pf_evicted_seen
        if self.cache.prefetch_evicted < seen:
            seen = 0
        self.stats.prefetch_evicted += self.cache.prefetch_evicted - seen
        self._pf_evicted_seen = self.cache.prefetch_evicted

    def _decay(self) -> None:
        self.cache.decay(self.policy.decay)
        if self.prefetcher is not None:
            self.prefetcher.decay()  # co-occurrence fades with the hot set
