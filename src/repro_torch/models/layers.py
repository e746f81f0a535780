"""Shared dense layers: MLPs, RMS norm, rotary, GQA attention (prefill and
decode), the KV-cache write and the token embedding.

Port of ``repro/models/layers.py``: ``constrain`` (this rank's block of
a layout under a ``launch.mesh.Mesh``), ``dense_init``,
``mlp_params``, ``mlp_apply``, ``rms_norm``, ``rope_frequencies``,
``apply_rope``, ``gqa_prefill_attention`` (kernel K6 on the card),
``flash_decode_shard`` (kernel K7 on the card; no cross-shard combine yet),
``kv_cache_update_shard`` (no shard offset yet) and ``sharded_vocab_embed``
(``mesh=None`` only).  ``layer_norm`` waits for a model that uses it.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.sharding import PartitionSpec
from repro_torch.kernels import ops
from repro_torch.launch.mesh import block_slices

# --------------------------------------------------------------------- utils


def constrain(x: torch.Tensor, spec: PartitionSpec | None, mesh=None,
              have: PartitionSpec | None = None) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (the reference's
    ``with_sharding_constraint``): ``x`` is already split as ``have``
    (default: whole on every rank), and each dimension is cut further
    along the axes ``spec`` adds, a view.  The identity without a mesh or
    a spec; its gradient is zero outside the block."""
    if mesh is None or spec is None:
        return x
    return x[block_slices(x.shape, spec, mesh, have)]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    """[d_in, d_out] weight, uniform in +-1/sqrt(d_in)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=dtype, device=device)
    return w if w.is_meta else w.uniform_(-scale, scale, generator=gen)


def mlp_params(gen: torch.Generator, sizes: Sequence[int], dtype=torch.float32,
               device="cuda", bias: bool = True) -> dict:
    """Plain MLP stack parameters: sizes = [d_in, h1, ..., d_out]."""
    params = {}
    for i in range(len(sizes) - 1):
        params[f"w{i}"] = dense_init(gen, sizes[i], sizes[i + 1], dtype, device)
        if bias:
            params[f"b{i}"] = torch.zeros((sizes[i + 1],), dtype=dtype,
                                          device=device)
    return params


def mlp_apply(
    params: dict,
    x: torch.Tensor,
    act: Callable = torch.relu,
    final_act: bool = False,
) -> torch.Tensor:
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"].to(x.dtype)
        if f"b{i}" in params:
            x = x + params[f"b{i}"].to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last dim, computed in f32 and cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------- rotary


def rope_frequencies(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64) / d_head))


@functools.lru_cache(maxsize=None)
def _rope_freqs_f32(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    """The f32 frequencies on ``device``, copied there once: a copy from
    pageable host memory waits for the stream, which a decode loop must not."""
    return torch.from_numpy(rope_frequencies(d_head, theta).astype(np.float32)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., T, H, dh]; positions: broadcastable to [..., T].  Half-split
    rotation (not interleaved); frequencies from numpy f64 cast to f32,
    angles formed in f32."""
    dh = x.shape[-1]
    freqs = _rope_freqs_f32(dh, float(theta), x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [..., T, dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention


def gqa_prefill_attention(
    q: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,  # [B, S, Hkv, dh]
    v: torch.Tensor,  # [B, S, Hkv, dh]
    causal: bool = True,
) -> torch.Tensor:
    """Exact GQA attention over the whole sequence: kernel K6 on the card,
    the plain version (chunked over queries) on the CPU.  KV is read by
    index, never repeated."""
    return ops.flash_attention(q, k, v, causal=causal)


def flash_decode_shard(
    q: torch.Tensor,  # [B, H, dh]
    k_local: torch.Tensor,  # [B, S, Hkv, dh]
    v_local: torch.Tensor,
    cache_len: torch.Tensor,  # [] int32: valid prefix length
    shard_start: int = 0,
    combine_axes: tuple[str, ...] = (),
) -> torch.Tensor:
    """One query token per head against the whole cache: kernel K7 on the
    card.  Only the single-device case is ported (``shard_start`` 0, no
    ``combine_axes``); the sequence-sharded combine waits for the
    multi-device slice."""
    if combine_axes or shard_start != 0:
        raise NotImplementedError(
            "flash_decode_shard: only the single-device case (shard_start=0, "
            "combine_axes=()) is ported; the sequence-sharded combine waits"
        )
    return ops.flash_decode(q, k_local, v_local, cache_len)


def kv_cache_update_shard(
    cache: torch.Tensor,  # [B, S, Hkv, dh]
    new_kv: torch.Tensor,  # [B, Hkv, dh]
    pos: torch.Tensor,  # [] int32 write position, on the cache's device
) -> torch.Tensor:
    """Write one token into the cache at ``pos`` **in place** and return the
    cache; a position outside [0, S) leaves it as it was (the reference's
    clamped dynamic_update_slice of the current value): five tensor ops, no
    host sync.  Only the single-device case is ported: the owner-shard
    offset (``shard_start``) comes back with the sequence-sharded decode."""
    idx = pos.clamp(0, cache.shape[1] - 1).reshape(1)
    row = torch.where(idx == pos, new_kv.to(cache.dtype), cache[:, idx][:, 0])
    cache[:, idx] = row[:, None]
    return cache


# --------------------------------------------------- vocab embedding


def sharded_vocab_embed(
    table: torch.Tensor,  # [V_padded, D]
    tokens: torch.Tensor,  # [B, S]
    mesh=None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Token embedding: a row gather (the reference's ``jnp.take``) cast to
    ``out_dtype``.  Only ``mesh=None`` is ported; the psum-combined sharded
    lookup waits for the multi-device slice."""
    if mesh is not None:
        raise NotImplementedError("sharded_vocab_embed: only mesh=None is ported")
    flat = table.index_select(0, tokens.reshape(-1).to(torch.int64))
    return flat.reshape(*tokens.shape, table.shape[1]).to(out_dtype)
