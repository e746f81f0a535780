"""Gradient / payload compression for cross-replica traffic: port of
``repro/optim/grad_compress.py``.

  * ``compress_psum`` — an all-reduce over mesh axes with the payload cast
    to ``comm_dtype`` (bf16 halves the bytes of an f32 tensor); the
    master copy stays in its own dtype.  ``DisaggEmbedding``'s
    ``comm_dtype`` knob does the same to the lookup's partials.
  * ``int8 + error feedback`` — per-row-scaled int8 encode/decode with a
    residual buffer, for payloads that are gathered rather than reduced
    (cache refreshes, parameter broadcasts, checkpoint streaming): a
    reduction in int8 would overflow.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch import mesh as M


def compress_psum(x: torch.Tensor, axes, mesh: M.Mesh,
                  comm_dtype=torch.bfloat16) -> torch.Tensor:
    """All-reduce over ``axes`` with the payload cast to ``comm_dtype``."""
    return M.all_reduce(x.to(comm_dtype), axes, mesh).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Int8Coded:
    q: torch.Tensor  # int8 payload, same shape as the source
    scale: torch.Tensor  # [rows] f32 per-leading-row scales


def int8_encode(x: torch.Tensor, residual: torch.Tensor | None = None):
    """Per-row int8 quantization with error feedback.

    Returns (coded, new_residual): ``coded`` carries 1/4 the bytes; the
    quantization error accumulates in ``residual`` and is added back into
    the next call, so compression bias vanishes over steps (Seide et al.).
    Rounding is half to even, as ``jnp.round``."""
    if residual is not None:
        x = x + residual
    flat = x.reshape(x.shape[0], -1)
    scale = flat.abs().amax(dim=1) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.round(flat / scale[:, None]).clamp(-127, 127).to(torch.int8)
    deq = (q.to(torch.float32) * scale[:, None]).reshape(x.shape)
    return Int8Coded(q=q.reshape(x.shape), scale=scale), x - deq


def int8_decode(coded: Int8Coded) -> torch.Tensor:
    flat = coded.q.reshape(coded.q.shape[0], -1).to(torch.float32)
    return (flat * coded.scale[:, None]).reshape(coded.q.shape)


def compressed_bytes(x: torch.Tensor) -> int:
    """Wire bytes for the int8 coding of x (payload + scales)."""
    return int(x.numel()) + x.shape[0] * 4
