"""Plain PyTorch versions of the hot-cache kernels K3 and K4.

Port of ``repro/hotcache/ref.py``: the semantics are defined here once.  The
CPU tests hold them against the reference, ``chip_smoke.py`` holds the CUDA
kernels against them on the card, and ``hotcache.kernels`` takes them only
for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.hotcache import table


def probe_gather_pool_ref(
    keys: torch.Tensor,  # [C] int32
    values: torch.Tensor,  # [C, D]
    ids: torch.Tensor,  # [N] int32 fused row ids (EMPTY_KEY = inactive slot)
    weights: torch.Tensor,  # [N] f32 (0.0 masks; 1/count for mean pooling)
    num_bags: int,
    max_probes: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pooled [num_bags, D] f32, miss [N] bool).

    miss[i] is True whenever ids[i] is not found, inactive (EMPTY_KEY) slots
    included; callers mask with their validity mask.  A hit is pooled once,
    at the first matching probe, even when C < max_probes repeats slots."""
    C = keys.shape[0]
    slots = table.probe_slots(ids, C, max_probes)  # [N, P]
    match = (keys[slots] == ids[:, None]) & (ids != table.EMPTY_KEY)[:, None]
    found = match.any(dim=1)
    sel = match.to(torch.uint8).argmax(dim=1, keepdim=True)  # first match
    slot = slots.gather(1, sel)[:, 0]
    rows = values[slot].to(torch.float32)
    rows = rows * (found.to(torch.float32) * weights)[:, None]
    nnz = ids.shape[0] // num_bags
    return rows.reshape(num_bags, nnz, -1).sum(dim=1), ~found


def scatter_update_ref(
    values: torch.Tensor,  # [C, D], updated in place
    slots: torch.Tensor,  # [K] int32 target slots
    rows: torch.Tensor,  # [K, D] replacement rows
) -> torch.Tensor:
    """Swap-in: ``values`` with rows written at slots, the last write to a
    slot winning; slots outside [0, C) are skipped.  Repeated indices in one
    ``index_copy_``/``values[slots] = rows`` have no defined order in
    PyTorch (nor in XLA's ``.at[].set``), so only each slot's last write is
    kept before the copy."""
    C = values.shape[0]
    idx = torch.arange(slots.shape[0], device=slots.device)
    valid = (slots >= 0) & (slots < C)
    slots, idx = slots[valid].long(), idx[valid]
    last = torch.full((C,), -1, dtype=torch.int64, device=slots.device)
    last.scatter_reduce_(0, slots, idx, reduce="amax")
    keep = last[slots] == idx
    values[slots[keep]] = rows[idx[keep]].to(values.dtype)
    return values
