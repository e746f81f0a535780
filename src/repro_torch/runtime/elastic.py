"""Elastic scaling of the embedding tier (T1/T5 at fleet scale).

The paper's core economic claim is that disaggregation lets the memory tier
scale independently of compute.  This module provides the mechanism:
re-partition the fused table across a NEW number of shards (grow/shrink the
embedding tier) at a checkpoint boundary, preserving every logical row.

With range sharding the remap is pure arithmetic: the fused array is padded
to the new shard count and re-split; the RangeRouter derived from the new
FusedTables is immediately consistent (routing == placement, §3.1.2).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sharding import FusedTables, TableSpec, make_fused_tables


@dataclasses.dataclass
class ReshardResult:
    tables: FusedTables
    table: np.ndarray  # [new_total_rows, D]
    moved_rows: int = 0  # logical rows whose owning shard changed


def reshard_tables(
    old: FusedTables, table: np.ndarray, new_num_shards: int
) -> ReshardResult:
    """Re-partition to `new_num_shards` embedding servers losslessly.

    Fused row ids are invariant (``make_fused_tables`` pads at the END, so
    field offsets never move); only ownership — ``rows_per_shard`` and the
    range split — changes.  ``moved_rows`` counts the logical rows a live
    migration would actually have to copy between servers.
    """
    new = make_fused_tables(list(old.specs), table.shape[1], new_num_shards)
    rows = np.zeros((new.total_rows, table.shape[1]), table.dtype)
    n = min(old.raw_rows, new.raw_rows)
    rows[:n] = table[:n]
    ids = np.arange(n, dtype=np.int64)
    moved = int(
        (ids // old.rows_per_shard != ids // new.rows_per_shard).sum()
    )
    return ReshardResult(tables=new, table=rows, moved_rows=moved)


def reshard_params(
    old: FusedTables, params: dict, new_num_shards: int
) -> tuple[FusedTables, dict]:
    """Reshard a DisaggEmbedding params dict (and rowwise-adagrad state shapes
    follow automatically because state is per-row).  The re-split table is
    a tensor on the old table's device, in its dtype."""
    table = params["table"]
    res = reshard_tables(old, table.detach().cpu().numpy(), new_num_shards)
    out = dict(params)
    out["table"] = torch.from_numpy(res.table).to(table.device)
    return res.tables, out
