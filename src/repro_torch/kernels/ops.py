"""Public kernel entry points, dispatched by the tensor's device.

A CUDA tensor goes to the hand-written kernel (``embedding_bag.py``,
``dot_interaction.py``), a CPU tensor to the plain version in ``ref.py``;
any other device raises.  There is no switch and no fallback: on the card
the plain version is never taken, and a failed build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dot_interaction as K2
from repro_torch.kernels import embedding_bag as K1
from repro_torch.kernels import ref


def _is_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} (cuda | cpu)")


def embedding_bag(table, indices, weights, num_bags):
    if _is_cuda(table):
        return K1.embedding_bag(table, indices, weights, num_bags)
    return ref.embedding_bag_ref(table, indices, weights, num_bags)


def bag_lookup(
    table: torch.Tensor,
    indices: torch.Tensor,  # [B, F, nnz], ids already in range
    mask: torch.Tensor,  # [B, F, nnz] bool
) -> torch.Tensor:
    """[B,F,nnz] multi-hot lookup -> [B,F,D] f32 sum-pooled, via kernel K1."""
    B, F, nnz = indices.shape
    flat_idx = indices.reshape(-1).to(torch.int32).contiguous()
    flat_w = mask.reshape(-1).to(torch.float32).contiguous()
    out = embedding_bag(table, flat_idx, flat_w, B * F)
    return out.reshape(B, F, table.shape[1])


def dot_interaction_triu(x: torch.Tensor) -> torch.Tensor:
    """[B,F,D] -> [B, F*(F+1)/2] upper-triangle (incl. diag) pairwise dots,
    row-major as ``np.triu_indices(F)`` orders them; the gram matrix comes
    from kernel K2."""
    prods = K2.dot_interaction(x) if _is_cuda(x) else ref.dot_interaction_ref(x)
    F = x.shape[1]
    iu, ju = torch.triu_indices(F, F, device=x.device)
    return prods[:, iu, ju]
