"""DisaggEmbedding — FlexEMR's disaggregated embedding layer.

Port of ``repro/core/embedding.py``.  The fused table (``core.sharding``)
plays the paper's *embedding servers*: row-range shards on the ``model``
mesh axis own disjoint row ranges, the range routing table of
``core.sharding``.  Per-field sum/mean pooling, field replication into a
second fused table, the plain oracle ``lookup_reference`` and the lookups:

``mesh=None``            one device: each group's gather + pool is kernel
                         K1 in its masked mode.
``mode="baseline"``      Fig 4(a) under a ``launch.mesh.Mesh``: every shard
                         contributes the *raw rows* it owns (indexing and
                         ``torch.where``); the row-level ``[B, F, nnz, D]``
                         tensor crosses the network (one all-reduce over
                         ``model``) and the ranker pools it.
``mode="hierarchical"``  Fig 4(b): every shard pools its own rows first
                         (kernel K1, masked, on the shard) and only
                         ``[B, F, D]`` partials cross the network, an
                         ``nnz``-fold reduction in collective bytes.
``mode="mesh2d"``        rows sharded over the whole mesh (every row exists
                         once): indices all-gathered over the data axes,
                         each rank pools its rows for the global batch (K1)
                         and chained reduce-scatters hand every rank its
                         slice of the dense stage's batch.

Under a mesh each rank passes its own block: the table rows it owns and its
slice of the batch over the data axes (``launch.mesh``, SPMD).

Adaptive caching (§3.1.1): ``lookup(..., cache=...)`` serves the sharded
fields' hot rows from a replicated cache and pools only the cold residue
from the table; the hot sum is added after the collective.  Two cache
structures are accepted: the flat sorted ``HotCacheState`` slab (binary
search, plain torch) and the ``hotcache.HashCacheState`` open-addressing
table, whose probe + gather + pool + miss mask is kernel K3 on the card.
Replicated fields never use the cache.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.sharding import (
    AXIS_DATA,
    AXIS_MODEL,
    FusedTables,
    PartitionSpec as P,
    TableSpec,
    make_fused_tables,
)
from repro_torch.hotcache import kernels as HK
from repro_torch.hotcache.table import (
    DEFAULT_MAX_PROBES,
    EMPTY_KEY,
    HashCacheState,
    cache_insert,
    empty_hash_cache,
)
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.utils import resolve_device

MODES = ("baseline", "hierarchical", "mesh2d")

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


def _mesh2d_rows_refusal(what: str) -> str:
    """Why ``what`` under a mesh reads the paper layout only."""
    return (f"{what}(mesh=...) reads the paper layout: the reference's mesh2d {what} is not "
            f"its one-device {what} (its shard_map offsets ids by mesh2d's rows_per_shard "
            "after GSPMD reshards the table over model only), so it has no mesh2d result to "
            "port")


@dataclasses.dataclass
class DisaggEmbedding:
    """Sharded, cached, pooling-pushdown embedding bag.

    Args:
      specs: one TableSpec per sparse field (order defines the F axis).
      dim: embedding dim (shared — fused-table requirement).
      num_shards: number of embedding servers: the ``model`` axis's size
        (``mesh2d``: the whole mesh's).
      mode: 'baseline' | 'hierarchical' | 'mesh2d' (see module docstring).
      replicated_fields: indices into `specs` kept whole on every rank.
      comm_dtype: optional dtype of the cross-shard partials (None: the
        partials' own dtype).
      param_dtype: table storage dtype.
    """

    specs: Sequence[TableSpec]
    dim: int
    num_shards: int
    mode: str = "hierarchical"
    replicated_fields: tuple[int, ...] = ()
    comm_dtype: torch.dtype | None = None
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown lookup mode {self.mode!r}")
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
        tens of GB is never staged on the host; ``meta`` tensors hold no
        numbers and draw none)."""
        params = {}
        for tables, key, _ in self._groups():
            t = torch.empty((tables.total_rows, self.dim),
                            dtype=self.param_dtype, device=device)
            params[key] = t if t.is_meta else t.normal_(0.0, scale, generator=gen)
        return params

    def param_specs(self, batch_axes=(AXIS_DATA,)) -> dict:
        """PartitionSpecs: the fused table row-sharded on ``model`` (paper
        layout) or over the whole mesh (``mesh2d``, where every row exists
        once, so table gradients stay on their shard); ``rep_table`` whole."""
        specs = {}
        if self.sharded is not None:
            if self.mode == "mesh2d":
                specs["table"] = P(tuple(batch_axes) + (AXIS_MODEL,), None)
            else:
                specs["table"] = P(AXIS_MODEL, None)
        if self.replicated is not None:
            specs["rep_table"] = P(None, None)
        return specs

    def abstract_params(self) -> dict:
        """The params' global shapes and dtypes as tensors on the ``meta``
        device (no memory)."""
        return {key: torch.empty((tables.total_rows, self.dim), dtype=self.param_dtype,
                                 device="meta")
                for tables, key, _ in self._groups()}

    def output_axes(self, batch_axes=(AXIS_DATA,)) -> tuple[str, ...]:
        """The mesh axes a mesh lookup's output batch is split over."""
        if self.mode == "mesh2d":
            return tuple(batch_axes) + (AXIS_MODEL,)
        return tuple(batch_axes)

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
               mesh: M.Mesh | None = None,
               cache: HotCacheState | HashCacheState | None = None,
               batch_axes: tuple[str, ...] = (AXIS_DATA,),
               num_chunks: int = 1) -> torch.Tensor:
        """[B, F, nnz] int indices + bool mask -> [B, F, D] f32 pooled
        embeddings.

        Without a mesh each group's gather + pool is one launch of kernel
        K1 in its masked mode.  As the reference's masked gather, a masked
        slot adds exactly 0 and its row is never read (K1 skips zero-weight
        slots and clamps ids into the table); the mask rides as the 0/1
        slot weights, and mean fields are divided by their counts after the
        sum (folding 1/count into the weights would round differently).

        With a ``mesh`` this rank passes its block (``params``: the rows it
        owns; ``indices``/``mask``: its slice of the batch over
        ``batch_axes``) and gets its block of the output: its batch slice,
        whole over ``model`` (``mesh2d``: its slice over ``batch_axes`` x
        ``model``, ``output_axes``).  ``num_chunks`` > 1 splits the sharded
        fields into that many lookups, one collective each.

        With a ``cache``, the sharded fields' hot rows come from it and the
        table pools only the cold residue: a hit's table row is not read.
        The hot sum is added to the cold one in f32 (under a mesh, after the
        collective) and mean fields divide by the counts of the original
        mask."""
        if mesh is not None and self.mode == "mesh2d":
            if cache is not None:
                raise NotImplementedError(
                    "mesh2d takes no hot-row cache (the reference's mesh2d lookup drops it)")
            return self._lookup_mesh2d(params, indices, mask, mesh, batch_axes)
        out_groups = []
        for tables, key, fields in self._groups():
            table = params[key]
            if mesh is not None and key == "table":
                out_groups.append(self._lookup_sharded(table, indices, mask, mesh, cache,
                                                       num_chunks))
                continue
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

    # --------------------------------------------------------- sharded lookup

    def _shard_local(self, table_shard: torch.Tensor, idx_g: torch.Tensor,
                     m_g: torch.Tensor, cache, offsets: np.ndarray, shard: int):
        """Per-shard compute for (a chunk of) the sharded field group.

        ``offsets`` are the parent fused-table row offsets of the chunk's
        fields, so chunked lookups keep the parent routing geometry.
        Returns (to_reduce, hot, counts): the tensor that crosses the
        network (raw rows in baseline, K1's pooled partials otherwise),
        the pooled hot-cache sum (replicated) or None, and the per-(B, Fg)
        valid counts."""
        rps = self.sharded.rows_per_shard
        offs = torch.as_tensor(offsets.astype(np.int32), device=idx_g.device)
        fused = idx_g.to(torch.int32) + offs[None, :, None]
        counts = m_g.sum(dim=2).to(torch.float32)
        hot = None
        if cache is not None:
            hot, m_g = self._cache_split(cache, fused, m_g)
        local = fused - shard * rps
        hit = (local >= 0) & (local < rps) & m_g
        if self.mode == "baseline":
            to_reduce = self._gather_masked(table_shard, local, hit)  # fig 4(a)
        else:
            to_reduce = ops.bag_lookup(table_shard, local, hit, masked=True)  # fig 4(b)
        if self.comm_dtype is not None:
            to_reduce = to_reduce.to(self.comm_dtype)
        return to_reduce, hot, counts

    def _combine(self, reduced: torch.Tensor, hot, counts: torch.Tensor,
                 fields) -> torch.Tensor:
        """Ranker-side combine after the collective."""
        summed = reduced.to(torch.float32)
        if self.mode == "baseline":
            summed = summed.sum(dim=2)
        if hot is not None:
            summed = summed + hot.to(torch.float32)
        return self._pool(summed, counts, fields)

    def _check_shard(self, table_shard: torch.Tensor) -> None:
        """A rank's table block must be one shard of this layout's rows."""
        if table_shard.shape[0] != self.sharded.rows_per_shard:
            raise ValueError(f"table shard of {table_shard.shape[0]} rows; this layout's "
                             f"shards hold {self.sharded.rows_per_shard} "
                             f"({self.sharded.total_rows} rows / {self.num_shards})")

    def _lookup_sharded(self, table_shard, indices, mask, mesh, cache, num_chunks):
        """The sharded group's lookup under the paper layout, one model-axis
        all-reduce per chunk of fields."""
        self._check_shard(table_shard)
        fields = np.asarray(self.sharded_idx)
        all_offs = self.sharded.field_offsets_array()
        shard = mesh.coords[AXIS_MODEL]
        nchunk = max(1, min(num_chunks, len(fields)))
        outs = []
        for pos in np.array_split(np.arange(len(fields)), nchunk):
            sub = list(fields[pos])
            to_reduce, hot, counts = self._shard_local(
                table_shard, indices[:, sub, :], mask[:, sub, :], cache, all_offs[pos], shard)
            reduced = M.all_reduce(to_reduce, AXIS_MODEL, mesh)
            outs.append(self._combine(reduced, hot, counts, tuple(sub)))
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    def _lookup_mesh2d(self, params: dict, indices: torch.Tensor, mask: torch.Tensor,
                       mesh: M.Mesh, batch_axes: tuple[str, ...]) -> torch.Tensor:
        """Beyond-paper layout: rows sharded over the whole mesh (every row
        exists once).  Indices (int32, and the mask as one byte a slot) are
        all-gathered across the data axes, inner axis first; every rank
        pools the rows it owns for the *global* batch (K1) and a chain of
        reduce-scatters, outer axis first as ``P(all_axes)`` orders the
        blocks, leaves each rank its slice of the pooled batch.

        Collective bytes per step: the index all-gather + the [B,F,D]
        reduce-scatters (+ their all-gather transposes in backward); the
        table-sized data-parallel gradient all-reduce of the paper layout
        disappears because gradients land in locally owned rows only."""
        if self.replicated is not None:
            raise NotImplementedError("mesh2d: plain sharded fields only")
        tables = self.sharded
        self._check_shard(params["table"])
        all_axes = tuple(batch_axes) + (AXIS_MODEL,)
        idx, m = indices, mask.to(torch.uint8)
        for ax in reversed(batch_axes):  # the global batch, inner axes first
            idx = M.all_gather(idx, ax, mesh)
            m = M.all_gather(m, ax, mesh)
        m = m.bool()
        fused = self._fused_rows(tables, idx)
        local = fused - mesh.index(all_axes) * tables.rows_per_shard
        hit = (local >= 0) & (local < tables.rows_per_shard) & m
        partial = ops.bag_lookup(params["table"], local, hit, masked=True)  # [B, F, D]
        if self.comm_dtype is not None:
            partial = partial.to(self.comm_dtype)
        counts = m.sum(dim=2).to(torch.float32)
        for ax in all_axes:  # outer to inner: matches P(all_axes)
            partial = M.reduce_scatter(partial, ax, mesh)
            n = counts.shape[0] // mesh.shape[ax]
            counts = counts[mesh.coords[ax] * n:(mesh.coords[ax] + 1) * n]
        return self._pool(partial.to(torch.float32), counts, self.sharded_idx)

    def lookup_rows(self, params: dict, indices: torch.Tensor, mask: torch.Tensor,
                    mesh: M.Mesh | None = None,
                    batch_axes: tuple[str, ...] = (AXIS_DATA,)) -> torch.Tensor:
        """Unpooled lookup: [B, F, nnz] -> [B, F, nnz, D] raw rows (masked
        slots are zero): the fig-4(a) traffic pattern, for models that need
        per-item embeddings (sequence/interest models like MIND).  Under a
        mesh (paper layout) each shard gathers the rows it owns and one
        all-reduce over ``model`` assembles them; ``batch_axes`` is the
        reference's and names the batch's split."""
        if self.replicated is not None:
            raise NotImplementedError("lookup_rows with replicated fields")
        tables = self.sharded
        fused = self._fused_rows(tables, indices)
        if mesh is None:
            return self._gather_masked(params["table"], fused, mask)
        if self.mode == "mesh2d":
            raise NotImplementedError(_mesh2d_rows_refusal("lookup_rows"))
        self._check_shard(params["table"])
        local = fused - mesh.coords[AXIS_MODEL] * tables.rows_per_shard
        hit = (local >= 0) & (local < tables.rows_per_shard) & mask
        rows = self._gather_masked(params["table"], local, hit)
        return M.all_reduce(rows, AXIS_MODEL, mesh)

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

    def gather_rows(self, params: dict, row_ids: torch.Tensor,
                    mesh: M.Mesh | None = None) -> torch.Tensor:
        """Fused-table rows by global id (used to materialize the cache).

        row_ids: [K], the same on every rank (ids >= total_rows, e.g.
        INT_MAX padding, give zero rows).  Under a mesh (paper layout) each
        shard gathers the rows it owns and one all-reduce over ``model``
        assembles them on every rank."""
        tables = self.sharded
        if tables is None:
            raise ValueError("no sharded table to gather from")
        table = params["table"]
        zero = torch.zeros((), dtype=table.dtype, device=table.device)
        valid = row_ids < tables.total_rows
        if mesh is None:
            rows = table[row_ids.clamp(0, tables.total_rows - 1).long()]
            return torch.where(valid[:, None], rows, zero)
        if self.mode == "mesh2d":
            raise NotImplementedError(_mesh2d_rows_refusal("gather_rows"))
        self._check_shard(table)
        rps = tables.rows_per_shard
        local = row_ids - mesh.coords[AXIS_MODEL] * rps
        hit = (local >= 0) & (local < rps) & valid
        rows = torch.where(hit[:, None], table[local.clamp(0, rps - 1).long()], zero)
        return M.all_reduce(rows, AXIS_MODEL, mesh)


def _gather_hot(emb: DisaggEmbedding, params: dict, ids: np.ndarray,
                mesh: M.Mesh | None = None) -> torch.Tensor:
    """Rows of fused ids ``ids`` (int32) from the sharded table; ids past the
    table give zero rows."""
    ids_t = torch.from_numpy(ids).to(params["table"].device)
    return emb.gather_rows(params, ids_t, mesh)


def make_hash_cache_from_table(
    emb: DisaggEmbedding,
    params: dict,
    hot_ids: np.ndarray,
    num_slots: int,
    freqs: np.ndarray | None = None,
    admission_threshold: int = 1,
    mesh: M.Mesh | None = None,
    max_probes: int = DEFAULT_MAX_PROBES,
    device="cuda",
) -> HashCacheState:
    """A ``HashCacheState`` on ``device`` holding ``hot_ids`` (fused ids).

    Rows come from the authoritative table (``gather_rows``; under a
    ``mesh`` each rank passes its shard and gets the whole, replicated
    cache), so cached lookups stay equal to uncached ones.  ``freqs`` seeds
    the LFU counters (default: rank order, the hottest id gets the largest
    counter, so window conflicts resolve the right way).  The rows are
    written by kernel K4."""
    hot_ids = np.asarray(hot_ids)[:num_slots]
    if freqs is None:
        freqs = np.arange(len(hot_ids), 0, -1, dtype=np.int32)
    state = empty_hash_cache(num_slots, emb.dim, emb.param_dtype, device)
    if len(hot_ids) == 0:
        return state
    ids = hot_ids.astype(np.int32)
    state, _ = cache_insert(state, ids, _gather_hot(emb, params, ids, mesh),
                            np.asarray(freqs).astype(np.int32),
                            admission_threshold, max_probes)
    return state


def make_cache_from_table(
    emb: DisaggEmbedding,
    params: dict,
    hot_ids: np.ndarray,
    capacity: int,
    mesh: M.Mesh | None = None,
    device="cuda",
) -> HotCacheState:
    """A flat ``HotCacheState`` on ``device`` holding ``hot_ids`` (fused row
    ids), sorted and padded with ROW_ID_PAD (under a ``mesh``, from this
    rank's shard: replicated)."""
    dev = resolve_device(device)
    ids = np.full((capacity,), ROW_ID_PAD, dtype=np.int32)
    k = min(capacity, len(hot_ids))
    ids[:k] = np.sort(np.asarray(hot_ids)[:k]).astype(np.int32)
    rows = _gather_hot(emb, params, ids, mesh)
    return HotCacheState(ids=torch.from_numpy(ids).to(dev), rows=rows.to(dev))
