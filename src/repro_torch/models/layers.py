"""Shared dense layers: MLPs, RMS and layer norm, rotary, GQA attention
(prefill and decode), the KV-cache write and the token embedding.

Port of ``repro/models/layers.py``: ``constrain`` (this rank's block of
a layout under a ``launch.mesh.Mesh``), ``dense_init``,
``mlp_params``, ``mlp_apply``, ``rms_norm``, ``layer_norm``,
``rope_frequencies``, ``apply_rope``, ``gqa_prefill_attention`` (kernel K6
on the card), ``flash_decode_shard`` (kernel K7 on the card; on a sequence
shard its shard mode, then the combine across ``combine_axes``),
``kv_cache_update_shard`` and ``sharded_vocab_embed`` (with and without a
mesh).  Under a mesh each rank holds its own blocks and the reference's
``shard_map`` collectives become ``launch.mesh``'s.

The reference's GSPMD tensor, sequence and FSDP parallelism of the LM is
made explicit here as pairs of collectives whose backward is the forward's
transpose (every rank holds a replicated activation's whole cotangent):
``into_model`` before the column-parallel products (identity with an
all-reduce backward, or under ``seq_shard`` an all-gather along the
sequence with a reduce-scatter backward), ``out_of_model`` after the
row-parallel ones (all-reduce with an identity backward, or a
reduce-scatter along the sequence with an all-gather backward),
``fsdp_gather`` (a weight's rows all-gathered at use, reduce-scattered
backward) and ``vocab_parallel_nll`` (cross entropy over logits split by
vocab).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.sharding import AXIS_MODEL, PartitionSpec
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last dim (biased variance), computed in f32 and
    cast back to x's dtype; ``bias`` may be None."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


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
    q: torch.Tensor,  # [B, H, dh]: whole heads
    k_local: torch.Tensor,  # [B, S_loc, Hkv, dh]: this rank's sequence shard
    v_local: torch.Tensor,
    cache_len: torch.Tensor,  # [] int32: valid prefix length of the whole cache
    shard_start: torch.Tensor | int = 0,  # [] int32: global position of row 0
    combine_axes: tuple[str, ...] = (),
    mesh=None,
) -> torch.Tensor:
    """Flash decoding: one query token per head against the cache.

    With ``shard_start`` 0 and no ``combine_axes`` the cache is whole and
    kernel K7 returns the output.  Otherwise the cache is one sequence
    shard: K7's shard mode gives the shard's partial softmax (its row max,
    sum and un-normalised output, in f32), and the partials combine across
    the ranks of ``combine_axes`` on ``mesh`` with the reference's algebra
    (src/repro/models/layers.py:209-219): a max all-reduce of the row maxima,
    then one all-reduce of the output and sum scaled by exp(max - global
    max), 0 on a shard with no valid row; out = sum / max(l, 1e-30) in q's
    dtype.  Each rank reduces what it owns; only [B, H, dh + 1] partials
    cross the network (hierarchical pooling applied to attention)."""
    if combine_axes and mesh is None:
        raise ValueError("flash_decode_shard: combine_axes need the mesh they name")
    if not combine_axes and isinstance(shard_start, int) and shard_start == 0:
        return ops.flash_decode(q, k_local, v_local, cache_len)
    if isinstance(shard_start, int):
        shard_start = torch.full((), shard_start, dtype=torch.int32, device=q.device)
    o, m, l_sum = ops.flash_decode_partial(q, k_local, v_local, cache_len, shard_start)
    g_max = M.all_reduce_max(m, combine_axes, mesh) if combine_axes else m
    scale = torch.where(torch.isfinite(m), torch.exp(m - g_max), 0.0)
    ol = torch.cat([o * scale[..., None], (l_sum * scale)[..., None]], dim=-1)
    if combine_axes:
        ol = M.all_reduce(ol, combine_axes, mesh)
    dh = q.shape[-1]
    return (ol[..., :dh] / torch.clamp_min(ol[..., dh:], 1e-30)).to(q.dtype)


def kv_cache_update_shard(
    cache: torch.Tensor,  # [B, S_loc, Hkv, dh]: this rank's shard
    new_kv: torch.Tensor,  # [B, Hkv, dh]
    pos: torch.Tensor,  # [] int32 global write position, on the cache's device
    shard_start: torch.Tensor | int = 0,  # [] int32: global position of row 0
) -> torch.Tensor:
    """Write one token into the owner shard at ``pos - shard_start`` **in
    place** and return the cache; a position outside the shard leaves it as
    it was (the reference's clamped dynamic_update_slice of the current
    value), so every rank of a sequence-sharded cache can call it: tensor
    ops only, no host sync."""
    local = pos if isinstance(shard_start, int) and shard_start == 0 else pos - shard_start
    idx = local.clamp(0, cache.shape[1] - 1).reshape(1)
    row = torch.where(idx == local, new_kv.to(cache.dtype), cache[:, idx][:, 0])
    cache[:, idx] = row[:, None]
    return cache


# --------------------------------------------------- vocab embedding


def sharded_vocab_embed(
    table: torch.Tensor,  # [V_padded, D], or this rank's row block of it under a mesh
    tokens: torch.Tensor,  # [B, S]: this rank's batch block under a mesh
    mesh=None,
    out_dtype=torch.bfloat16,
    scatter_dim: int | None = None,
) -> torch.Tensor:
    """Token embedding: a row gather (the reference's ``jnp.take``) cast to
    ``out_dtype``.  Under a mesh, the table is split by rows over `model`
    and this is the disaggregated lookup with nnz 1 (the paper's
    hierarchical combine): each rank gathers the rows it owns, in
    ``out_dtype``, zeroes the others and all-reduces over `model` (each
    rank then holds the whole embedding, and its whole cotangent).  With
    ``scatter_dim`` the sum is a reduce-scatter along that dim instead, and
    each rank keeps its block of it (the sequence-sharded residual)."""
    if mesh is None:
        flat = table.index_select(0, tokens.reshape(-1).to(torch.int64))
        return flat.reshape(*tokens.shape, table.shape[1]).to(out_dtype)
    rows = table.shape[0]
    local = tokens.to(torch.int64) - mesh.coords[AXIS_MODEL] * rows
    hit = (local >= 0) & (local < rows)
    emb = table.index_select(0, local.clamp(0, rows - 1).reshape(-1)).to(out_dtype)
    emb = torch.where(hit.reshape(-1, 1), emb, 0).reshape(*tokens.shape, table.shape[1])
    if scatter_dim is not None:
        return M.reduce_scatter(emb, (AXIS_MODEL,), mesh, dim=scatter_dim)
    return M.reduce_from(emb, (AXIS_MODEL,), mesh)


# ------------------------------------------- tensor and sequence parallelism


def into_model(h: torch.Tensor, mesh, seq_shard: bool, dim: int = 1) -> torch.Tensor:
    """The whole activation for the column-parallel products of a rank of
    `model`: under ``seq_shard`` the blocks along ``dim`` all-gathered over
    `model` (reduce-scatter backward), else ``h`` itself, replicated over
    `model`, whose ranks' partial cotangents all-reduce backward.  The
    identity without a mesh."""
    if mesh is None:
        return h
    if seq_shard:
        return M.all_gather(h, (AXIS_MODEL,), mesh, dim=dim)
    return M.copy_to(h, (AXIS_MODEL,), mesh)


def out_of_model(y: torch.Tensor, mesh, seq_shard: bool, dim: int = 1) -> torch.Tensor:
    """The sum over `model` of a row-parallel product's partials, laid out
    as the residual stream: under ``seq_shard`` reduce-scattered along
    ``dim`` (all-gather backward), else all-reduced (identity backward).
    The identity without a mesh."""
    if mesh is None:
        return y
    if seq_shard:
        return M.reduce_scatter(y, (AXIS_MODEL,), mesh, dim=dim)
    return M.reduce_from(y, (AXIS_MODEL,), mesh)


def fsdp_gather(w: torch.Tensor, axes: tuple[str, ...], mesh, dim: int) -> torch.Tensor:
    """A weight whose ``dim`` is split over the FSDP ``axes``, all-gathered
    whole along it at its use; the backward reduce-scatters the gradient,
    which sums it over those axes (the reference's ``grad_specs``).  Under
    remat the gather runs again in the recomputation.  ``w`` itself without
    axes."""
    if not axes:
        return w
    return M.all_gather(w, axes, mesh, dim=dim)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, mesh,
                       batch_axes: tuple[str, ...]) -> torch.Tensor:
    """The mean causal-LM cross entropy over the global batch, in f32, from
    this rank's block of the logits ``[B_l, S, Vp / tp]`` (vocab split over
    `model`, batch over ``batch_axes``) and its labels ``[B_l, S]`` (global
    ids, -1 masked): the row max and the sum of exponentials all-reduced
    over `model`, the label's logit taken on the rank that owns it and
    all-reduced over `model`, then the masked NLL's sum and the count of
    unmasked labels all-reduced over ``batch_axes``.  Every rank returns
    the same loss and holds its whole cotangent."""
    lf = logits.to(torch.float32)
    vl = lf.shape[-1]
    mask = labels >= 0
    row_max = M.all_reduce_max(lf.detach().amax(-1), (AXIS_MODEL,), mesh)
    sum_exp = M.reduce_from(torch.exp(lf - row_max[..., None]).sum(-1), (AXIS_MODEL,), mesh)
    lse = row_max + torch.log(sum_exp)
    local = labels.to(torch.int64) - mesh.coords[AXIS_MODEL] * vl
    own = (local >= 0) & (local < vl)
    picked = lf.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    picked = M.reduce_from(torch.where(own, picked, 0.0), (AXIS_MODEL,), mesh)
    nll = ((lse - picked) * mask).sum()
    count = mask.sum().to(torch.float32)
    if batch_axes:
        nll = M.reduce_from(nll, batch_axes, mesh)
        count = M.all_reduce(count, batch_axes, mesh)
    return nll / count.clamp_min(1)
