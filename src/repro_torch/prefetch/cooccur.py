"""Online row-co-occurrence mining from the lookup stream (paper §3.1.2).

FlexEMR's *spatial* locality: rows that appear together in one multi-hot bag
(or one request) tend to appear together again — `data.synthetic` plants
exactly this structure via its shared pattern pools.  The miner turns the
raw lookup stream into a bounded co-occurrence index the prefetcher can
query at swap-in time:

  CountMinSketch      — sub-linear pair-frequency estimator: every observed
                        (lo, hi) id pair bumps `depth` hashed counters; the
                        min over the rows upper-bounds nothing and
                        over-counts only on hash collisions.  This is the
                        global evidence store — O(depth * width) memory no
                        matter how many distinct pairs flow past.
  CooccurrenceMiner   — per-row top-`list_len` neighbor lists refreshed from
                        the sketch, for at most `max_rows` tracked rows
                        (coldest tracked row evicted first).  Lists and the
                        sketch decay so stale affinities fade with the
                        workload (Fig-5 drift), mirroring the LFU decay of
                        the hotcache itself.

Port of ``repro/prefetch/cooccur.py``: the miner lives on the host next to
the miss path and is numpy, copied, except for one step.  The top-k
*selection* over the gathered neighbor scores in ``neighbors`` runs through
``prefetch.kernels.topk_neighbor_select`` on the miner's ``device``: kernel
K5 on the card, its plain version (``prefetch.ref``) on the CPU.  The scores
stay f64 on both, so the choice is the one ``topk_select_np`` makes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.prefetch.kernels import topk_neighbor_select
from repro_torch.utils import resolve_device

# Odd multiplicative constants (Knuth-style) — one hash per sketch row.
_CM_MULTS = (
    0x9E3779B1,
    0x85EBCA77,
    0xC2B2AE3D,
    0x27D4EB2F,
    0x165667B1,
    0xD3A2646D,
)

_NO_NEIGHBOR = np.int64(-1)


def _pair_keys(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Pack an ordered id pair into one uint64 key (ids must be < 2^32)."""
    return (lo.astype(np.uint64) << np.uint64(32)) | hi.astype(np.uint64)


class CountMinSketch:
    """Conservative fixed-memory frequency estimator over uint64 keys."""

    def __init__(self, width: int = 1 << 14, depth: int = 4):
        if width & (width - 1):
            raise ValueError(f"width must be a power of two, got {width}")
        if not 1 <= depth <= len(_CM_MULTS):
            raise ValueError(f"depth must be in [1, {len(_CM_MULTS)}]")
        self.width = width
        self.depth = depth
        self.counts = np.zeros((depth, width), np.float64)

    def _slots(self, keys: np.ndarray, row: int) -> np.ndarray:
        h = keys.astype(np.uint64) * np.uint64(_CM_MULTS[row])
        h ^= h >> np.uint64(29)
        return (h & np.uint64(self.width - 1)).astype(np.int64)

    def add(self, keys: np.ndarray, amounts: np.ndarray) -> None:
        keys = np.asarray(keys, np.uint64)
        amounts = np.asarray(amounts, np.float64)
        for r in range(self.depth):
            np.add.at(self.counts[r], self._slots(keys, r), amounts)

    def query(self, keys: np.ndarray) -> np.ndarray:
        """Point estimate per key: min over the depth hashed counters."""
        keys = np.asarray(keys, np.uint64)
        est = np.full(keys.shape, np.inf)
        for r in range(self.depth):
            est = np.minimum(est, self.counts[r][self._slots(keys, r)])
        return est

    def decay(self, factor: float) -> None:
        self.counts *= factor


class CooccurrenceMiner:
    """Bounded per-row top-k co-occurring-neighbor index, fed online.

    ``observe`` consumes lookup batches (fused ids + validity mask) and
    maintains, for up to ``max_rows`` rows, the ``list_len`` strongest
    co-occurrence partners by decayed pair count.  ``neighbors`` answers the
    prefetcher's query: the top-k partners of each trigger row, selected on
    ``device`` (``"cuda"`` unless the caller passes ``"cpu"``; a CUDA device
    with no GPU present raises).
    """

    def __init__(
        self,
        list_len: int = 8,
        max_rows: int = 4096,
        cm_width: int = 1 << 14,
        cm_depth: int = 4,
        decay: float = 0.97,
        max_pairs_per_observe: int = 1 << 16,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.list_len = list_len
        self.max_rows = max_rows
        self.sketch = CountMinSketch(cm_width, cm_depth)
        self.decay_factor = decay
        self.max_pairs_per_observe = max_pairs_per_observe
        self._rng = np.random.default_rng(seed)
        self._pos: dict[int, int] = {}  # row id -> index into the arrays below
        self._row_ids = np.full((max_rows,), _NO_NEIGHBOR, np.int64)
        self._nbr = np.full((max_rows, list_len), _NO_NEIGHBOR, np.int64)
        self._score = np.zeros((max_rows, list_len), np.float64)
        self._heat = np.zeros((max_rows,), np.float64)  # tracked-row activity
        self.pairs_observed = 0

    # ------------------------------------------------------------- observing

    def observe(self, fused: np.ndarray, mask: np.ndarray) -> None:
        """Mine co-occurrence pairs from one batch: fused/mask [B, F, nnz].

        Pairs are formed *within a bag* (one sample's one field): that is the
        granularity at which data.synthetic plants pattern pools and at which
        a swap-in's neighbors are most likely to be co-requested again.
        """
        fused = np.asarray(fused, np.int64)
        mask = np.asarray(mask, bool)
        nnz = fused.shape[-1]
        if nnz < 2:
            return
        bags = fused.reshape(-1, nnz)
        bmask = mask.reshape(-1, nnz)
        iu, ju = np.triu_indices(nnz, k=1)
        a, b = bags[:, iu].ravel(), bags[:, ju].ravel()
        ok = (bmask[:, iu] & bmask[:, ju]).ravel()
        a, b = a[ok], b[ok]
        ok = a != b  # self-pairs carry no spatial information
        a, b = a[ok], b[ok]
        if len(a) == 0:
            return
        if len(a) > self.max_pairs_per_observe:  # bound the per-batch work
            sel = self._rng.choice(len(a), self.max_pairs_per_observe, False)
            a, b = a[sel], b[sel]
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        keys, counts = np.unique(_pair_keys(lo, hi), return_counts=True)
        self.pairs_observed += int(counts.sum())
        self.sketch.add(keys, counts)
        est = self.sketch.query(keys)  # decayed global pair strength
        lo = (keys >> np.uint64(32)).astype(np.int64)
        hi = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
        # Both directions: lo gains hi as a neighbor and vice versa.  Groups
        # sorted by row with scores descending inside each group, so the
        # per-row partner cap below keeps the strongest edges.
        rows = np.concatenate([lo, hi])
        partners = np.concatenate([hi, lo])
        scores = np.concatenate([est, est])
        order = np.lexsort((-scores, rows))
        rows, partners, scores = rows[order], partners[order], scores[order]
        uniq, starts = np.unique(rows, return_index=True)
        bounds = np.append(starts, len(rows))
        self._merge_updates(uniq, partners, scores, bounds)

    def _acquire_batch(self, new_rows: np.ndarray, incoming: np.ndarray):
        """Start tracking a batch of new rows (hottest first): free slots
        are claimed outright; once full, the batch's hottest newcomers are
        matched against the coldest tracked rows and evict only strictly
        colder ones.  One argpartition for the whole batch instead of an
        argmin per row — this sits on the observe hot path."""
        order = np.argsort(-incoming, kind="stable")
        new_rows, incoming = new_rows[order], incoming[order]
        free = self.max_rows - len(self._pos)
        claimed = []
        for r in new_rows[:free]:
            pos = len(self._pos)
            self._pos[int(r)] = pos
            self._row_ids[pos] = r
            claimed.append(pos)
        rest, rest_in = new_rows[free:], incoming[free:]
        if not len(rest):
            return
        # Slots claimed this call still carry zero heat (it lands in
        # _merge_updates); shield them so a colder newcomer can't evict a
        # hotter one admitted a moment ago.
        heat = self._heat
        if claimed:
            heat = heat.copy()
            heat[claimed] = np.inf
        n = min(len(rest), self.max_rows)
        cold = np.argpartition(heat, n - 1)[:n]
        cold = cold[np.argsort(heat[cold], kind="stable")]
        accept = rest_in[:n] > heat[cold]  # hottest new vs coldest old
        victims, winners = cold[accept], rest[:n][accept]
        if not len(victims):
            return
        for slot, old, new in zip(
            victims, self._row_ids[victims], winners
        ):
            del self._pos[int(old)]
            self._pos[int(new)] = int(slot)
        self._row_ids[victims] = winners
        self._nbr[victims] = _NO_NEIGHBOR
        self._score[victims] = 0.0
        self._heat[victims] = 0.0

    # Per-row fresh-partner cap per observe call: bounds the merge matrix
    # width.  Hub rows can exceed it in one batch; groups arrive
    # score-descending, so the trim drops only their weakest fresh edges.
    _MAX_FRESH = 64

    def _merge_updates(
        self,
        uniq: np.ndarray,
        partners: np.ndarray,
        scores: np.ndarray,
        bounds: np.ndarray,
    ) -> None:
        """Vectorized top-k list refresh for all of a batch's rows at once
        (this sits on the per-lookup hot path via observe).

        The sketch score is the *global* pair strength, so a partner already
        listed is re-scored, not accumulated (the sketch accumulates); the
        stored score and the fresh estimate decay on the same cadence, so
        max-over-duplicates lets the fresh estimate dominate whenever the
        pair was actually re-observed.
        """
        counts = np.diff(bounds)
        incoming = np.add.reduceat(scores, bounds[:-1])
        # Track new rows first (may evict cold tracked rows), then resolve
        # every position afresh so updates to just-evicted rows are dropped.
        is_new = np.array([int(r) not in self._pos for r in uniq], bool)
        if is_new.any():
            self._acquire_batch(uniq[is_new], incoming[is_new])
        pos = np.array([self._pos.get(int(r), -1) for r in uniq], np.int64)
        keep = pos >= 0
        if not keep.any():
            return
        pos, counts, incoming = pos[keep], counts[keep], incoming[keep]
        M = int(min(self._MAX_FRESH, counts.max()))
        gather = bounds[:-1][keep, None] + np.arange(M)[None, :]
        valid = np.arange(M)[None, :] < np.minimum(counts, M)[:, None]
        gather = np.minimum(gather, len(partners) - 1)
        new_ids = np.where(valid, partners[gather], _NO_NEIGHBOR)
        new_sc = np.where(valid, scores[gather], -np.inf)

        cur_ids = self._nbr[pos]
        cur_sc = np.where(cur_ids == _NO_NEIGHBOR, -np.inf, self._score[pos])
        ids = np.concatenate([cur_ids, new_ids], axis=1)  # [R, L+M]
        sc = np.concatenate([cur_sc, new_sc], axis=1)
        # Dedupe to max score per id, rowwise: order columns score-desc,
        # then stable-sort by id so each id's best copy leads its run; mask
        # the rest and take the global top list_len.
        o = np.argsort(-sc, axis=1, kind="stable")
        ids, sc = np.take_along_axis(ids, o, 1), np.take_along_axis(sc, o, 1)
        o = np.argsort(ids, axis=1, kind="stable")
        ids, sc = np.take_along_axis(ids, o, 1), np.take_along_axis(sc, o, 1)
        dup = np.zeros(sc.shape, bool)
        dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
        sc = np.where(dup, -np.inf, sc)
        top = np.argsort(-sc, axis=1, kind="stable")[:, : self.list_len]
        best_sc = np.take_along_axis(sc, top, 1)
        best_ids = np.take_along_axis(ids, top, 1)
        live = np.isfinite(best_sc)
        k = top.shape[1]
        self._nbr[pos, :k] = np.where(live, best_ids, _NO_NEIGHBOR)
        self._score[pos, :k] = np.where(live, best_sc, 0.0)
        if k < self.list_len:  # shorter merge result: clear the tail
            self._nbr[pos, k:] = _NO_NEIGHBOR
            self._score[pos, k:] = 0.0
        self._heat[pos] += incoming

    # -------------------------------------------------------------- querying

    def decay(self) -> None:
        """Fade stale affinity (call on the same cadence as cache decay)."""
        self.sketch.decay(self.decay_factor)
        self._score *= self.decay_factor
        self._heat *= self.decay_factor

    @property
    def tracked_rows(self) -> int:
        return len(self._pos)

    def neighbor_lists(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Full candidate lists per id: (nbr [M, L] int64, score [M, L]).

        Untracked ids yield all -1 / 0 rows.  This is the gather stage; the
        top-k *select* over it is `neighbors` (kernel K5 on the card)."""
        ids = np.asarray(ids, np.int64).ravel()
        nbr = np.full((len(ids), self.list_len), _NO_NEIGHBOR, np.int64)
        score = np.zeros((len(ids), self.list_len), np.float64)
        for i, r in enumerate(ids):
            pos = self._pos.get(int(r))
            if pos is not None:
                nbr[i] = self._nbr[pos]
                score[i] = self._score[pos]
        return nbr, score

    def neighbors(
        self, ids: np.ndarray, k: int, min_score: float = 0.0
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k partners per trigger id: (nbr [M, k] int64, score [M, k]).

        Entries below `min_score` (or missing) come back as id -1, score 0.
        """
        nbr, score = self.neighbor_lists(ids)
        k = min(k, self.list_len)
        cand = torch.from_numpy(np.where(nbr == _NO_NEIGHBOR, -np.inf, score))
        sel_score, sel_idx = topk_neighbor_select(cand.to(self.device), k)
        # One copy back and one synchronisation: the f64 scores' bits and the
        # int32 indices side by side in one int32 tensor.
        both = torch.cat([sel_score.view(torch.int32), sel_idx], dim=1).cpu().numpy()
        sel_score = np.ascontiguousarray(both[:, :2 * k]).view(np.float64)
        out_ids = np.take_along_axis(nbr, both[:, 2 * k:].astype(np.int64), axis=1)
        ok = np.isfinite(sel_score) & (sel_score >= min_score)
        return (
            np.where(ok, out_ids, _NO_NEIGHBOR),
            np.where(ok, sel_score, 0.0),
        )


def topk_select_np(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Numpy twin of kernels.topk_neighbor_select: per-row top-k, ties by
    lowest column index.  Returns (values [M, k], indices [M, k] int32)."""
    scores = np.asarray(scores)
    if k > scores.shape[1]:
        raise ValueError(f"k={k} exceeds candidate width {scores.shape[1]}")
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, order, axis=1)
    return vals, order.astype(np.int32)
