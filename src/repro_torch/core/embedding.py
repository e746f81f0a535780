"""DisaggEmbedding — FlexEMR's disaggregated embedding layer, single device.

Port of ``repro/core/embedding.py`` for one device: the fused table layout
(``core.sharding``), per-field sum/mean pooling, field replication into a
second fused table, the plain oracle ``lookup_reference`` and ``lookup``,
which pools through kernel K1 (``kernels.ops.bag_lookup``) on the card.

The sharded lookup modes (baseline / hierarchical / mesh2d over a device
mesh), the device hot caches (``HotCacheState``, ``HashCacheState`` and
kernels K3/K4) and ``lookup_rows`` / ``gather_rows`` wait for the port's
multi-device and device-cache slices.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.sharding import FusedTables, TableSpec, make_fused_tables
from repro_torch.kernels import ops

ROW_ID_PAD = np.iinfo(np.int32).max  # fused row ids are < 2^31 for all configs


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

    def lookup(self, params: dict, indices: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        """[B, F, nnz] int indices + bool mask -> [B, F, D] f32 pooled
        embeddings; each group's gather + pool is one launch of kernel K1.

        Masked ids are clamped into the table first, as the reference's
        masked gather does; the mask rides as the 0/1 slot weights, and mean
        fields are divided by their counts after the sum (folding 1/count
        into the weights would round differently)."""
        out_groups = []
        for tables, key, fields in self._groups():
            table = params[key]
            idx_g = indices[:, list(fields), :]
            m_g = mask[:, list(fields), :]
            fused = self._fused_rows(tables, idx_g).clamp_(0, table.shape[0] - 1)
            summed = ops.bag_lookup(table, fused, m_g)
            counts = m_g.sum(dim=2).to(torch.float32)
            out_groups.append(self._pool(summed, counts, fields))
        out = torch.cat(out_groups, dim=1) if len(out_groups) > 1 else out_groups[0]
        return self._unpermute(out)
