"""DisaggEmbedding — FlexEMR's disaggregated embedding layer, single device.

Port of ``repro/core/embedding.py`` for one device: the fused table layout
(``core.sharding``), per-field sum/mean pooling, field replication into a
second fused table, the plain oracle ``lookup_reference``, ``gather_rows``
and ``lookup``, which pools through kernel K1 (``kernels.ops.bag_lookup``)
on the card.

Adaptive caching (§3.1.1) on the device: ``lookup(..., cache=...)`` serves
the sharded fields' hot rows from a replicated cache and pools only the cold
residue from the table, computing what the reference's one-shard
hierarchical ``lookup(mesh=..., cache=...)`` computes (``_shard_local`` +
``_combine``).  Two cache structures are accepted: the flat sorted
``HotCacheState`` slab (binary search, plain torch) and the
``hotcache.HashCacheState`` open-addressing table, whose probe + gather +
pool + miss mask is kernel K3 on the card.  Replicated fields never use the
cache.

The sharded lookup modes (baseline / hierarchical / mesh2d over a device
mesh) and ``lookup_rows`` wait for the port's multi-device slice.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.sharding import FusedTables, TableSpec, make_fused_tables
from repro_torch.hotcache import kernels as HK
from repro_torch.hotcache.table import (
    DEFAULT_MAX_PROBES,
    EMPTY_KEY,
    HashCacheState,
    cache_insert,
    empty_hash_cache,
)
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device

ROW_ID_PAD = np.iinfo(np.int32).max  # fused row ids are < 2^31 for all configs


@dataclasses.dataclass(frozen=True)
class HotCacheState:
    """Replicated hot-row cache (paper §3.1.1). ids are sorted fused row ids."""

    ids: torch.Tensor  # [K] int32, sorted ascending, padded with ROW_ID_PAD
    rows: torch.Tensor  # [K, D]

    @property
    def capacity(self) -> int:
        return int(self.ids.shape[0])


def empty_cache(capacity: int, dim: int, dtype=torch.float32,
                device="cuda") -> HotCacheState:
    """An empty flat cache on ``device`` (raises for CUDA without a GPU)."""
    dev = resolve_device(device)
    return HotCacheState(
        ids=torch.full((capacity,), ROW_ID_PAD, dtype=torch.int32, device=dev),
        rows=torch.zeros((capacity, dim), dtype=dtype, device=dev),
    )


@dataclasses.dataclass
class DisaggEmbedding:
    """Fused, field-pooled embedding bag.

    Args:
      specs: one TableSpec per sparse field (order defines the F axis).
      dim: embedding dim (shared — fused-table requirement).
      num_shards: number of embedding servers the fused table is padded for.
      replicated_fields: indices into `specs` kept in a second fused table.
      param_dtype: table storage dtype.

    The reference's ``mode`` and ``comm_dtype`` steer its sharded lookups and
    come back with the multi-device slice.
    """

    specs: Sequence[TableSpec]
    dim: int
    num_shards: int
    replicated_fields: tuple[int, ...] = ()
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.specs = tuple(self.specs)
        rep = set(self.replicated_fields)
        if not rep.issubset(range(len(self.specs))):
            raise ValueError("replicated_fields out of range")
        self.sharded_idx = tuple(
            i for i in range(len(self.specs)) if i not in rep
        )
        self.replicated_idx = tuple(sorted(rep))
        self.sharded: FusedTables | None = (
            make_fused_tables(
                [self.specs[i] for i in self.sharded_idx], self.dim, self.num_shards
            )
            if self.sharded_idx
            else None
        )
        self.replicated: FusedTables | None = (
            make_fused_tables(
                [self.specs[i] for i in self.replicated_idx], self.dim, 1
            )
            if self.replicated_idx
            else None
        )
        # Static per-field pooling selector and output permutation.
        order = list(self.sharded_idx) + list(self.replicated_idx)
        self._inv_perm = np.argsort(np.asarray(order))  # group-order -> F order
        self._mean_mask = np.asarray(
            [s.pooling == "mean" for s in self.specs], dtype=bool
        )

    # ------------------------------------------------------------------ params

    @property
    def num_fields(self) -> int:
        return len(self.specs)

    def _groups(self):
        """(fused tables, params key, field ids) of each non-empty group."""
        for tables, key, fields in (
            (self.sharded, "table", self.sharded_idx),
            (self.replicated, "rep_table", self.replicated_idx),
        ):
            if tables is not None:
                yield tables, key, fields

    def init(self, gen: torch.Generator, scale: float = 0.01,
             device="cuda") -> dict:
        """N(0, scale^2) tables, drawn in place on ``device`` (a table of
        tens of GB is never staged on the host)."""
        params = {}
        for tables, key, _ in self._groups():
            t = torch.empty((tables.total_rows, self.dim),
                            dtype=self.param_dtype, device=device)
            params[key] = t.normal_(0.0, scale, generator=gen)
        return params

    # ------------------------------------------------------------- local math

    def _fused_rows(self, tables: FusedTables, idx_group: torch.Tensor) -> torch.Tensor:
        """Per-field indices -> fused global row ids. idx_group: [B, Fg, nnz]."""
        offs = torch.as_tensor(
            tables.field_offsets_array().astype(np.int32), device=idx_group.device
        )
        return idx_group.to(torch.int32) + offs[None, :, None]

    @staticmethod
    def _gather_masked(table: torch.Tensor, local: torch.Tensor,
                       hit: torch.Tensor) -> torch.Tensor:
        """Gather rows for in-range hits; zeros elsewhere. local: [B,Fg,nnz]."""
        rows = table[local.clamp(0, table.shape[0] - 1).long()]  # [B,Fg,nnz,D]
        return torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))

    def _pool(self, summed: torch.Tensor, counts: torch.Tensor, field_ids) -> torch.Tensor:
        """Apply per-field sum/mean. summed [B,Fg,D], counts [B,Fg]."""
        mean_mask = torch.as_tensor(
            self._mean_mask[np.asarray(field_ids)], device=summed.device
        )
        denom = counts.clamp_min(1.0)[..., None]
        return torch.where(mean_mask[None, :, None], summed / denom, summed)

    def _unpermute(self, out: torch.Tensor) -> torch.Tensor:
        if np.array_equal(self._inv_perm, np.arange(self.num_fields)):
            return out
        return out[:, torch.as_tensor(self._inv_perm, device=out.device), :]

    # ---------------------------------------------------------------- lookups

    def lookup_reference(self, params: dict, indices: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
        """Dense single-device oracle: plain gather + pool. [B,F,nnz] -> [B,F,D]."""
        out_groups = []
        for tables, key, fields in self._groups():
            idx_g = indices[:, list(fields), :]
            m_g = mask[:, list(fields), :]
            fused = self._fused_rows(tables, idx_g)
            rows = self._gather_masked(params[key], fused, m_g)
            summed = rows.sum(dim=2)
            counts = m_g.sum(dim=2).to(summed.dtype)
            out_groups.append(self._pool(summed, counts, fields))
        out = torch.cat(out_groups, dim=1) if len(out_groups) > 1 else out_groups[0]
        return self._unpermute(out)

    def lookup(self, params: dict, indices: torch.Tensor, mask: torch.Tensor,
               cache: HotCacheState | HashCacheState | None = None) -> torch.Tensor:
        """[B, F, nnz] int indices + bool mask -> [B, F, D] f32 pooled
        embeddings; each group's gather + pool is one launch of kernel K1
        in its masked mode.

        As the reference's masked gather, a masked slot adds exactly 0 and
        its row is never read (K1 skips zero-weight slots and clamps ids
        into the table); the mask rides as the 0/1 slot weights, and mean
        fields are divided by their counts after the sum (folding 1/count
        into the weights would round differently).

        With a ``cache``, the sharded fields' hot rows come from it and K1
        pools only the cold residue: a hit's table row is not read.  The hot
        sum is added to the cold one in f32 and mean fields divide by the
        counts of the original mask."""
        out_groups = []
        for tables, key, fields in self._groups():
            table = params[key]
            idx_g = indices[:, list(fields), :]
            m_g = mask[:, list(fields), :]
            fused = self._fused_rows(tables, idx_g)
            counts = m_g.sum(dim=2).to(torch.float32)
            hot = None
            if key == "table" and cache is not None:
                hot, m_g = self._cache_split(cache, fused, m_g)
            summed = ops.bag_lookup(table, fused, m_g, masked=True)
            if hot is not None:
                summed = summed + hot
            out_groups.append(self._pool(summed, counts, fields))
        out = torch.cat(out_groups, dim=1) if len(out_groups) > 1 else out_groups[0]
        return self._unpermute(out)

    @staticmethod
    def _cache_split(cache, fused: torch.Tensor, m_g: torch.Tensor):
        """(pooled hot sum [B,Fg,D] f32 or None, cold-residue mask).

        A ``HashCacheState`` goes through kernel K3 (query ``where(mask,
        fused, EMPTY_KEY)``, weights = mask); the flat slab through a binary
        search (``torch.searchsorted``) and a masked gather."""
        B, Fg, nnz = fused.shape
        if isinstance(cache, HashCacheState):
            if cache.num_slots == 0:
                return None, m_g
            query = torch.where(m_g, fused, EMPTY_KEY).reshape(-1).contiguous()
            w = m_g.reshape(-1).to(torch.float32).contiguous()
            hot, miss = HK.probe_gather_pool(cache.keys, cache.rows, query, w,
                                             B * Fg, DEFAULT_MAX_PROBES)
            return hot.reshape(B, Fg, -1), m_g & miss.reshape(m_g.shape)
        if cache.capacity == 0:
            return None, m_g
        pos = torch.searchsorted(cache.ids, fused).clamp_(0, cache.capacity - 1)
        is_hot = (cache.ids[pos] == fused) & m_g
        rows = cache.rows[pos].to(torch.float32)
        hot = torch.where(is_hot[..., None], rows, torch.zeros((), device=rows.device))
        return hot.sum(dim=2), m_g & ~is_hot

    # ----------------------------------------------------------- cache refresh

    def gather_rows(self, params: dict, row_ids: torch.Tensor) -> torch.Tensor:
        """Fused-table rows by global id (used to materialize the cache).

        row_ids: [K] (ids >= total_rows, e.g. INT_MAX padding, give zero rows)."""
        tables = self.sharded
        if tables is None:
            raise ValueError("no sharded table to gather from")
        table = params["table"]
        valid = row_ids < tables.total_rows
        rows = table[row_ids.clamp(0, tables.total_rows - 1).long()]
        return torch.where(valid[:, None], rows,
                           torch.zeros((), dtype=rows.dtype, device=rows.device))


def _gather_hot(emb: DisaggEmbedding, params: dict, ids: np.ndarray) -> torch.Tensor:
    """Rows of fused ids ``ids`` (int32) from the sharded table; ids past the
    table give zero rows."""
    ids_t = torch.from_numpy(ids).to(params["table"].device)
    return emb.gather_rows(params, ids_t)


def make_hash_cache_from_table(
    emb: DisaggEmbedding,
    params: dict,
    hot_ids: np.ndarray,
    num_slots: int,
    freqs: np.ndarray | None = None,
    admission_threshold: int = 1,
    max_probes: int = DEFAULT_MAX_PROBES,
    device="cuda",
) -> HashCacheState:
    """A ``HashCacheState`` on ``device`` holding ``hot_ids`` (fused ids).

    Rows come from the authoritative table (``gather_rows``), so cached
    lookups stay equal to uncached ones.  ``freqs`` seeds the LFU counters
    (default: rank order, the hottest id gets the largest counter, so window
    conflicts resolve the right way).  The rows are written by kernel K4."""
    hot_ids = np.asarray(hot_ids)[:num_slots]
    if freqs is None:
        freqs = np.arange(len(hot_ids), 0, -1, dtype=np.int32)
    state = empty_hash_cache(num_slots, emb.dim, emb.param_dtype, device)
    if len(hot_ids) == 0:
        return state
    ids = hot_ids.astype(np.int32)
    state, _ = cache_insert(state, ids, _gather_hot(emb, params, ids),
                            np.asarray(freqs).astype(np.int32),
                            admission_threshold, max_probes)
    return state


def make_cache_from_table(
    emb: DisaggEmbedding,
    params: dict,
    hot_ids: np.ndarray,
    capacity: int,
    device="cuda",
) -> HotCacheState:
    """A flat ``HotCacheState`` on ``device`` holding ``hot_ids`` (fused row
    ids), sorted and padded with ROW_ID_PAD."""
    dev = resolve_device(device)
    ids = np.full((capacity,), ROW_ID_PAD, dtype=np.int32)
    k = min(capacity, len(hot_ids))
    ids[:k] = np.sort(np.asarray(hot_ids)[:k]).astype(np.int32)
    rows = _gather_hot(emb, params, ids)
    return HotCacheState(ids=torch.from_numpy(ids).to(dev), rows=rows.to(dev))
