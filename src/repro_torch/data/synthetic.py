"""Synthetic workload generators shaped like the paper's traces.

The paper synthesizes inference workloads from MLPerf + Meta's production
embedding-lookup traces [41]: zipfian index popularity (a 10-15% hot set
absorbing most traffic, §2.4), co-occurring subrequests, and diurnal load
(Fig 5).  We reproduce those statistical properties:

  * `zipf_indices` — power-law row popularity with a configurable hot mass.
  * `cooccurrence`  — a fraction of multi-hot bags reuse a shared pattern pool
    (the embedding co-occurrence FlexEMR exploits).
  * `diurnal_batches` — sinusoidal + bursty request-rate trace (Fig 5 shape)
    driving the adaptive-cache controller benchmarks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sharding import TableSpec


def zipf_indices(
    rng: np.random.Generator,
    vocab: int,
    size,
    alpha: float = 1.05,
) -> np.ndarray:
    """Zipf-ish draws in [0, vocab): rank r sampled w.p. ∝ (r+1)^-alpha.

    Uses the inverse-CDF power-law approximation (fast, vectorized); popular
    ids are the small ones, matching a rank-ordered table layout.
    """
    u = rng.random(size)
    if alpha <= 1.0 + 1e-6:
        # near-harmonic: use exponential-of-log trick
        ranks = np.exp(u * np.log(vocab)) - 1.0
    else:
        # inverse CDF of p(r) ∝ r^-alpha on [1, vocab]
        a1 = 1.0 - alpha
        ranks = (u * (vocab**a1 - 1.0) + 1.0) ** (1.0 / a1) - 1.0
    return np.clip(ranks.astype(np.int64), 0, vocab - 1)


def recsys_batch(
    rng: np.random.Generator,
    tables: tuple[TableSpec, ...],
    batch: int,
    n_dense: int = 0,
    alpha: float = 1.05,
    cooccur_frac: float = 0.3,
    pool_size: int = 512,
    max_nnz: int | None = None,
) -> dict:
    """One training/serving batch: indices [B,F,nnz], mask, dense, labels."""
    F = len(tables)
    nnz = max_nnz or max(t.nnz for t in tables)
    indices = np.zeros((batch, F, nnz), np.int32)
    mask = np.zeros((batch, F, nnz), bool)
    for f, t in enumerate(tables):
        k = t.nnz
        draws = zipf_indices(rng, t.vocab, (batch, k), alpha)
        if k > 1 and cooccur_frac > 0:
            # co-occurrence: some bags reuse patterns from a small pool
            pool = zipf_indices(rng, t.vocab, (pool_size, k), alpha)
            reuse = rng.random(batch) < cooccur_frac
            pick = rng.integers(0, pool_size, batch)
            draws = np.where(reuse[:, None], pool[pick], draws)
        indices[:, f, :k] = draws
        # variable bag fill: 1..k valid entries
        fill = rng.integers(1, k + 1, batch) if k > 1 else np.ones(batch, np.int64)
        mask[:, f, :k] = np.arange(k)[None, :] < fill[:, None]
    out = {"indices": indices, "mask": mask,
           "labels": rng.integers(0, 2, batch).astype(np.float32)}
    if n_dense:
        out["dense"] = rng.normal(size=(batch, n_dense)).astype(np.float32)
    return out


@dataclasses.dataclass
class CooccurrenceWorkload:
    """Stateful batch stream with a *persistent* co-occurrence pattern pool.

    ``recsys_batch`` redraws its pattern pool per call, so its spatial
    structure lives only within one batch.  Real traces repeat item bundles
    across requests for hours (the §3.1.2 locality FlexEMR prefetches on);
    this generator keeps one pool per multi-hot field for its lifetime, with
    zipf-skewed *pattern* popularity (some bundles are hot) and optional
    churn: every ``drift_every`` batches a ``drift_frac`` of patterns is
    redrawn — the regime where co-occurrence prefetching keeps paying after
    warmup, because the demand cache must re-learn every new bundle member
    by member while the miner maps it after a few sightings.

    Bags not reusing a pattern fall back to independent zipf draws, and bag
    fill is variable exactly as in ``recsys_batch``.
    """

    tables: tuple[TableSpec, ...]
    batch: int = 64
    alpha: float = 1.05
    cooccur_frac: float = 0.5
    pool_size: int = 256
    pattern_alpha: float = 1.1  # zipf skew over patterns (hot bundles)
    drift_every: int = 0  # batches between pool churn events (0 = static)
    drift_frac: float = 0.1  # fraction of patterns redrawn per churn
    n_dense: int = 0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._pools = {
            f: zipf_indices(self._rng, t.vocab, (self.pool_size, t.nnz),
                            self.alpha)
            for f, t in enumerate(self.tables) if t.nnz > 1
        }
        self._batches_emitted = 0

    def drift(self) -> int:
        """Churn the pools: redraw ``drift_frac`` of each field's patterns."""
        n = max(1, int(self.pool_size * self.drift_frac))
        for f, pool in self._pools.items():
            victims = self._rng.choice(self.pool_size, n, replace=False)
            pool[victims] = zipf_indices(
                self._rng, self.tables[f].vocab, (n, pool.shape[1]), self.alpha
            )
        return n

    def next_batch(self) -> dict:
        rng = self._rng
        if (
            self.drift_every
            and self._batches_emitted
            and self._batches_emitted % self.drift_every == 0
        ):
            self.drift()
        self._batches_emitted += 1
        F = len(self.tables)
        nnz = max(t.nnz for t in self.tables)
        indices = np.zeros((self.batch, F, nnz), np.int32)
        mask = np.zeros((self.batch, F, nnz), bool)
        for f, t in enumerate(self.tables):
            k = t.nnz
            draws = zipf_indices(rng, t.vocab, (self.batch, k), self.alpha)
            if f in self._pools and self.cooccur_frac > 0:
                reuse = rng.random(self.batch) < self.cooccur_frac
                pick = zipf_indices(rng, self.pool_size, (self.batch,),
                                    self.pattern_alpha)
                draws = np.where(reuse[:, None], self._pools[f][pick], draws)
            indices[:, f, :k] = draws
            fill = (rng.integers(1, k + 1, self.batch) if k > 1
                    else np.ones(self.batch, np.int64))
            mask[:, f, :k] = np.arange(k)[None, :] < fill[:, None]
        out = {"indices": indices, "mask": mask,
               "labels": rng.integers(0, 2, self.batch).astype(np.float32)}
        if self.n_dense:
            out["dense"] = rng.normal(
                size=(self.batch, self.n_dense)
            ).astype(np.float32)
        return out


def mind_batch(rng, item_vocab: int, batch: int, hist_len: int, alpha=1.05) -> dict:
    hist = zipf_indices(rng, item_vocab, (batch, hist_len), alpha).astype(np.int32)
    lens = rng.integers(hist_len // 4, hist_len + 1, batch)
    hist_mask = np.arange(hist_len)[None, :] < lens[:, None]
    target = zipf_indices(rng, item_vocab, (batch,), alpha).astype(np.int32)
    return {"hist": hist, "hist_mask": hist_mask, "target": target,
            "labels": np.ones((batch,), np.float32)}


def lm_batch(rng, vocab: int, batch: int, seq: int) -> dict:
    tokens = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
    return {
        "tokens": tokens[:, :-1].astype(np.int32),
        "labels": tokens[:, 1:].astype(np.int32),
    }


def random_graph(
    rng, n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
    power_law: bool = True,
) -> dict:
    """Edge list with power-law-ish degree distribution + features/labels."""
    if power_law:
        dst = zipf_indices(rng, n_nodes, (n_edges,), alpha=1.2)
    else:
        dst = rng.integers(0, n_nodes, n_edges)
    src = rng.integers(0, n_nodes, n_edges)
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    return {
        "edges": edges,
        "edge_mask": np.ones((n_edges,), bool),
        "feats": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        "labels": rng.integers(0, n_classes, n_nodes).astype(np.int32),
    }


def diurnal_batches(
    rng, steps: int, base: int = 512, peak: int = 4096, burst_prob: float = 0.05
) -> np.ndarray:
    """Fig-5-shaped load trace: sinusoidal daily cycle + random bursts."""
    t = np.arange(steps) / steps * 2 * np.pi
    load = base + (peak - base) * 0.5 * (1 + np.sin(t * 3 - np.pi / 2))
    bursts = (rng.random(steps) < burst_prob) * rng.integers(0, peak, steps)
    sizes = np.clip(load + bursts, 32, 2 * peak).astype(np.int64)
    return (np.ceil(sizes / 32) * 32).astype(np.int64)  # pad to batch buckets
