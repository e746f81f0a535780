"""Plain PyTorch versions of the hand-written kernels.

The CPU tests and ``chip_smoke.py`` hold the kernels against these; a kernel
wrapper takes them only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(
    table: torch.Tensor,  # [V, D]
    indices: torch.Tensor,  # [N] int32 row ids (N = num_bags * nnz)
    weights: torch.Tensor,  # [N] f32 per-slot weights (0.0 masks a slot)
    num_bags: int,
) -> torch.Tensor:
    """[num_bags, D] f32 weighted sums over fixed-nnz bags (FBGEMM TBE
    semantics): rows upcast to f32, every row multiplied by its weight."""
    rows = table.index_select(0, indices.long()).to(torch.float32)
    rows = rows * weights.to(torch.float32)[:, None]
    nnz = indices.shape[0] // num_bags
    return rows.reshape(num_bags, nnz, -1).sum(dim=1)


def dot_interaction_ref(x: torch.Tensor) -> torch.Tensor:
    """[B, F, D] -> [B, F, F] pairwise dot (gram) matrix, f32 accumulation."""
    xf = x.to(torch.float32)
    return torch.bmm(xf, xf.transpose(1, 2))
