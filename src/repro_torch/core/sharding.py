"""Range-based routing + row-wise sharding of fused embedding tables.

This is FlexEMR's routing layer (§3.1.2 of the paper): a *range-based routing
table* that maps every sparse feature index to the embedding server (here: the
`model`-axis shard) that owns it.  We fuse all logical tables of equal dim into
one `[total_rows, dim]` parameter (FBGEMM "table-batched embedding" layout);
each logical field occupies the contiguous row range
``[offsets[f], offsets[f+1])``.  The fused table is sharded **row-wise** across
the `model` mesh axis, so the routing rule is pure arithmetic::

    global_row = offsets[field] + index
    shard      = global_row // rows_per_shard        # the paper's <(start,end) -> server>

In SPMD the routing table *is* the sharding rule — placement and routing cannot
drift apart, which is the property the paper's range table is designed for.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.utils import round_up

# Canonical mesh axis names used across the framework.
AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_MODEL = "model"


class PartitionSpec(tuple):
    """The mesh axes of each dimension of an array (a name, a tuple of
    names, or None), as ``jax.sharding.PartitionSpec`` holds them: the
    layout of a leaf under a ``launch.mesh.Mesh``, and what a checkpoint
    records for it.  Dimensions past the spec's length are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes_of(self, dim: int) -> tuple[str, ...]:
        """The mesh axes dimension ``dim`` is split over, outer first."""
        if dim >= len(self) or self[dim] is None:
            return ()
        el = self[dim]
        return tuple(el) if isinstance(el, (tuple, list)) else (el,)

    def mesh_axes(self) -> tuple[str, ...]:
        """Every mesh axis the spec splits a dimension over."""
        return tuple(a for d in range(len(self)) for a in self.axes_of(d))


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One logical embedding table (one sparse field)."""

    name: str
    vocab: int
    nnz: int = 1  # max multi-hot indices per sample for this field
    pooling: str = "sum"  # 'sum' | 'mean'

    def __post_init__(self):
        if self.vocab <= 0:
            raise ValueError(f"table {self.name}: vocab must be positive")
        if self.nnz <= 0:
            raise ValueError(f"table {self.name}: nnz must be positive")
        if self.pooling not in ("sum", "mean"):
            raise ValueError(f"table {self.name}: pooling must be sum|mean")


@dataclasses.dataclass(frozen=True)
class FusedTables:
    """All same-dim tables fused into one row-sharded parameter."""

    specs: tuple[TableSpec, ...]
    dim: int
    num_shards: int
    # Derived (set in __post_init__ via object.__setattr__):
    offsets: tuple[int, ...] = ()
    total_rows: int = 0  # padded to a multiple of num_shards
    rows_per_shard: int = 0

    def __post_init__(self):
        offs = [0]
        for s in self.specs:
            offs.append(offs[-1] + s.vocab)
        raw_rows = offs[-1]
        # Pad so the row dim divides evenly across shards (and stays
        # 8-row aligned for TPU sublane friendliness).
        total = round_up(max(raw_rows, self.num_shards), self.num_shards * 8)
        object.__setattr__(self, "offsets", tuple(offs))
        object.__setattr__(self, "total_rows", total)
        object.__setattr__(self, "rows_per_shard", total // self.num_shards)

    @property
    def num_fields(self) -> int:
        return len(self.specs)

    @property
    def raw_rows(self) -> int:
        return self.offsets[-1]

    @property
    def max_nnz(self) -> int:
        return max(s.nnz for s in self.specs)

    def field_offsets_array(self) -> np.ndarray:
        """[F] int64 row offset of each field inside the fused table."""
        return np.asarray(self.offsets[:-1], dtype=np.int64)

    def size_bytes(self, itemsize: int = 4) -> int:
        return self.total_rows * self.dim * itemsize


def make_fused_tables(
    specs: Sequence[TableSpec], dim: int, num_shards: int
) -> FusedTables:
    return FusedTables(specs=tuple(specs), dim=dim, num_shards=num_shards)


class RangeRouter:
    """FlexEMR's range-based routing table, in arithmetic form.

    Host-side object used by the serving runtime (to route lookup subrequests
    to per-shard queues) and by tests; the SPMD lookup paths apply the same
    rule with jnp inside shard_map.
    """

    def __init__(self, tables: FusedTables):
        self.tables = tables
        self._offsets = tables.field_offsets_array()

    def global_rows(self, field: np.ndarray, index: np.ndarray) -> np.ndarray:
        """Fused global row ids for (field, index) pairs."""
        field = np.asarray(field)
        index = np.asarray(index)
        vocab = np.asarray([s.vocab for s in self.tables.specs], dtype=np.int64)
        if np.any(index < 0) or np.any(index >= vocab[field]):
            raise IndexError("sparse index out of the field's vocab range")
        return self._offsets[field] + index

    def shard_of(self, global_row: np.ndarray) -> np.ndarray:
        """Which `model` shard (embedding server) owns each global row."""
        return np.asarray(global_row) // self.tables.rows_per_shard

    def ranges_for_shard(self, shard: int) -> tuple[int, int]:
        """The contiguous [start, end) global-row range owned by a shard."""
        rps = self.tables.rows_per_shard
        return shard * rps, (shard + 1) * rps

    def routing_table(self) -> list[tuple[tuple[int, int], int]]:
        """The explicit <(start,end), server> list the paper describes."""
        return [
            (self.ranges_for_shard(s), s) for s in range(self.tables.num_shards)
        ]


def rebalance_ranges(
    load_per_shard: np.ndarray, tables: FusedTables
) -> np.ndarray:
    """Elastic resharding hint (paper §3.2 live migration, SPMD analogue).

    Given measured per-shard load, return new shard *boundaries* (global row
    ids) that equalize load, assuming load is uniform within a shard.  Used by
    core.migration to plan a re-partition; the SPMD layer applies it by
    remapping rows at checkpoint-restore time.
    """
    load = np.asarray(load_per_shard, dtype=np.float64)
    if load.shape != (tables.num_shards,):
        raise ValueError("load vector must have one entry per shard")
    load = np.maximum(load, 1e-9)
    density = np.repeat(load / tables.rows_per_shard, tables.rows_per_shard)
    cum = np.cumsum(density)
    total = cum[-1]
    targets = total * np.arange(1, tables.num_shards) / tables.num_shards
    boundaries = np.searchsorted(cum, targets)
    return np.concatenate([[0], boundaries, [tables.total_rows]])
