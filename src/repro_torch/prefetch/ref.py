"""Plain PyTorch version of kernel K5, the prefetcher's top-k select.

Port of ``repro/prefetch/ref.py``.  The selection order is total: score
descending, equal scores to the lowest column (a stable sort), so this,
kernel K5 and ``cooccur.topk_select_np`` agree on every input with repeated
scores and -inf.  ``torch.topk`` promises no order among ties, so it is not
used.  As in the reference, the sort key is ``-scores`` ascending (NaN then
sorts last, where numpy puts it).
"""
from __future__ import annotations

import torch


def topk_neighbor_select_ref(
    scores: torch.Tensor,  # [M, L] f32 | f64 candidate scores (-inf = absent)
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k by score, ties to the lowest index.

    Returns (values [M, k] in the scores' dtype, indices [M, k] int32)."""
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds candidate width {scores.shape[-1]}")
    idx = torch.sort(-scores, dim=-1, stable=True).indices[:, :k]
    return scores.gather(-1, idx), idx.to(torch.int32)
