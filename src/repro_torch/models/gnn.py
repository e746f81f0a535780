"""GraphSAGE (mean aggregator) by gather and segment-sum message passing.

Port of ``repro/models/gnn.py``.  The reference aggregates with XLA's
``jnp.take`` and ``jax.ops.segment_sum`` (no Pallas kernel), so the port
does too, in plain PyTorch: ``index_select`` of the messages, an in-place
weighting, ``index_add_`` into the destination rows; the products are
``torch.matmul``.  One autograd function (``_GatherScatter``) holds one
message buffer of at most ``EDGE_CHUNK`` edges at a time, in the forward
and in the backward, so a graph of ogb_products' 61.9M edges trains on
one card.

The reference's index semantics hold at the edges, computed explicitly
(``torch.index_select`` and ``index_add_`` raise on such ids):
  * a source id in ``[-N, 0)`` wraps, as numpy's; one outside ``[-N, N)``
    gathers a row of NaN (``jnp.take``'s fill), which the weight cannot
    cancel (NaN x 0 is NaN);
  * a message whose destination lies outside ``[0, N)`` is dropped
    (``segment_sum``), and so is its count;
  * counts come from the edge mask alone.
Their gradients are the reference's: nothing flows to or from a dropped or
filled message.

Three input regimes (matching the assigned shapes):
  full graph    — node features [N, d], edge list [E, 2] (+ edge mask pad).
  minibatch     — layered sampled subgraph from ``data.graph_sampler``.
  molecule      — batched small graphs [G, n, d] with per-graph edge lists,
                  one batched pass with node offsets (the reference's vmap).

Under a ``launch.mesh.Mesh`` (one rank a device, SPMD):
  * ``forward_full_graph(mesh=...)`` is the paper's hierarchical pooling
    applied to neighbour aggregation: each rank holds its block of the
    edges over every mesh axis and the node states whole, aggregates its
    edges' messages into all N rows, and one all-reduce of the sums a
    layer (``launch.mesh.reduce_from``) combines the partials; the counts,
    the same for every layer, are all-reduced once a forward (the
    reference's compiled program computes them once too).
    The node states enter the aggregation through ``launch.mesh.copy_to``,
    whose backward sums the ranks' partial cotangents, so every rank holds
    the whole gradient of the replicated loss;
  * ``forward_full_graph_partitioned`` shards the node states instead: one
    all-gather of h a layer in ``comm_dtype``, then a local segment sum over
    the edges whose destination the rank owns;
  * the minibatch and molecule cells (``configs.graphsage_reddit``) split
    their batch over the mesh and sum each rank's share of the loss and
    gradients with :func:`loss_and_grads`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.sharding import AXIS_DATA, AXIS_MODEL, PartitionSpec as P
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.utils import (numpy_to_tensor, resolve_device, tree_flatten_with_path,
                               tree_map, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    aggregator: str = "mean"
    sample_sizes: tuple[int, ...] = (25, 10)
    readout: str | None = None  # 'mean' for graph-level tasks
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32


# ------------------------------------------------------------------- params


def init_params(cfg: GNNConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters with the reference's tree, shapes and scales
    (``dense_init``: uniform in +-1/sqrt(fan in); biases 0), drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed`` (raises when
    ``device`` is CUDA and no GPU is present).  The numbers differ from the
    reference's ``jax.random``; parity tests carry its weights across with
    :func:`params_from_numpy`."""
    dev = resolve_device(device)
    # meta tensors (abstract_params) hold no numbers and take no generator
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.param_dtype
    layers = []
    d = cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append({
            "w_self": L.dense_init(gen, d, cfg.d_hidden, dt, dev),
            "w_neigh": L.dense_init(gen, d, cfg.d_hidden, dt, dev),
            "b": torch.zeros((cfg.d_hidden,), dtype=dt, device=dev),
        })
        d = cfg.d_hidden
    return {"layers": layers, "out": L.dense_init(gen, d, cfg.n_classes, dt, dev)}


def abstract_params(cfg: GNNConfig) -> dict:
    """The params' shapes and dtypes as ``meta`` tensors."""
    return init_params(cfg, device="meta")


def param_specs(cfg: GNNConfig) -> dict:
    """Every leaf replicated (the weights are a few MB)."""
    return tree_map(lambda leaf: P(*([None] * leaf.ndim)), abstract_params(cfg))


def params_from_numpy(np_params: dict, device) -> dict:
    """The reference's ``{"layers": [{w_self, w_neigh, b}, ...], "out"}``
    (``np.asarray`` on each leaf) as this package's tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: numpy_to_tensor(np.asarray(a)).to(dev), np_params)


# -------------------------------------------------------------- aggregation


class _Edges(NamedTuple):
    """One edge list in the form the aggregation takes, built once a
    forward: every index in range and int32."""

    src: torch.Tensor  # gathered rows (an out-of-range source reads row 0)
    dst: torch.Tensor  # destination rows; n_out collects the dropped messages
    w: torch.Tensor  # the mask in the compute dtype: the counts' terms
    w_msg: torch.Tensor  # w, NaN where the source is out of range (the forward)
    w_grad: torch.Tensor  # w, 0 where the source is out of range (the backward)
    n_out: int


def _src_rows(src: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jnp.take``'s rows of a table of ``n``: ids in ``[-n, 0)`` wrap, as
    numpy's; returns (rows, in range), an out-of-range id reading row 0."""
    src = src.to(torch.int64)
    src = torch.where(src < 0, src + n, src)
    ok = (src >= 0) & (src < n)
    return torch.where(ok, src, 0), ok


def _dst_rows(dst: torch.Tensor, n: int) -> torch.Tensor:
    """``segment_sum``'s rows of ``n`` segments: an id outside ``[0, n)``
    goes to row ``n``, which the aggregation drops."""
    dst = dst.to(torch.int64)
    return torch.where((dst >= 0) & (dst < n), dst, n)


def _edges(src_rows, src_ok, dst_rows, edge_mask, n_out: int, dtype) -> _Edges:
    w = edge_mask.to(dtype)
    nan = torch.full((), float("nan"), dtype=dtype, device=w.device)
    return _Edges(src_rows.to(torch.int32), dst_rows.to(torch.int32), w,
                  torch.where(src_ok, w, nan), torch.where(src_ok, w, 0), n_out)


def edge_terms(src, dst, edge_mask, n_src: int, n_out: int, dtype) -> _Edges:
    """An edge list (``src`` into a table of ``n_src`` rows, ``dst`` into
    ``n_out`` segments) in the reference's semantics."""
    rows, ok = _src_rows(src, n_src)
    return _edges(rows, ok, _dst_rows(dst, n_out), edge_mask, n_out, dtype)


# Edges a message buffer holds: [2^22, 128] f32 is 2.1 GB.  Whole, ogb_products'
# [E, 128] buffer is 31.7 GB, and the caching allocator, splitting a freed
# buffer of one width for the next, ran out of the card's 80 GB between two
# forwards (an H100 80GB HBM3 at 700 W).  index_add_ adds with atomics in
# no fixed order, so the chunks change no semantics.
EDGE_CHUNK = 1 << 22


class _GatherScatter(torch.autograd.Function):
    """``out[dst[e]] += h[src[e]] * w_msg[e]`` into ``n_out + 1`` rows (the
    last collects the dropped messages), EDGE_CHUNK edges at a time: the
    gathered rows weighted in place and added into the output; the
    backward gathers the output's cotangent by ``dst``, weights it by
    ``w_grad`` in place and adds it into h's rows by ``src``.  Saves only
    the index and weight vectors."""

    @staticmethod
    def forward(ctx, h, src, dst, w_msg, w_grad, n_out):
        out = h.new_zeros((n_out + 1, h.shape[1]))
        for i in range(0, src.numel(), EDGE_CHUNK):
            sl = slice(i, i + EDGE_CHUNK)
            msg = h.index_select(0, src[sl])
            msg.mul_(w_msg[sl, None])
            out.index_add_(0, dst[sl], msg)
        ctx.save_for_backward(src, dst, w_grad)
        ctx.n_in = h.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        src, dst, w_grad = ctx.saved_tensors
        g_h = g.new_zeros((ctx.n_in, g.shape[1]))
        for i in range(0, src.numel(), EDGE_CHUNK):
            sl = slice(i, i + EDGE_CHUNK)
            g_msg = g.index_select(0, dst[sl])
            g_msg.mul_(w_grad[sl, None])
            g_h.index_add_(0, src[sl], g_msg)
        return g_h, None, None, None, None, None


def _sums(h: torch.Tensor, e: _Edges) -> torch.Tensor:
    """[n_out, d]: the sum of ``e``'s messages from ``h`` into each row."""
    return _GatherScatter.apply(h, e.src, e.dst, e.w_msg, e.w_grad, e.n_out)[:e.n_out]


def _counts(e: _Edges) -> torch.Tensor:
    """[n_out]: the sum of ``e``'s mask into each row."""
    return e.w.new_zeros((e.n_out + 1,)).index_add_(0, e.dst, e.w)[:e.n_out]


def _aggregate_dense(h, src, dst, edge_mask, n_nodes):
    """Partial neighbour mean for an edge shard: returns (sums, counts)."""
    e = edge_terms(src, dst, edge_mask, h.shape[0], n_nodes, h.dtype)
    return _sums(h, e), _counts(e)


def _mean(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    return sums / torch.clamp_min(counts, 1.0)[:, None]


def sage_layer(lp, h, neigh_mean):
    out = h @ lp["w_self"] + neigh_mean @ lp["w_neigh"] + lp["b"]
    out = torch.relu(out)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-6)


# ------------------------------------------------------------------ forward


def forward_full_graph(
    cfg: GNNConfig,
    params: dict,
    feats: torch.Tensor,  # [N, d_in]
    edges: torch.Tensor,  # [E, 2] (src, dst), padded; under a mesh this rank's block
    edge_mask: torch.Tensor,  # [E]; likewise
    mesh=None,
) -> torch.Tensor:
    """Full-batch GraphSAGE.  Under a ``mesh`` the edges are this rank's
    block over every mesh axis and the node states replicated (they fit:
    <= 2.5M x 128 f32); the logits are whole on every rank."""
    dt = cfg.compute_dtype
    h = feats.to(dt)
    N = feats.shape[0]
    e = edge_terms(edges[:, 0], edges[:, 1], edge_mask, N, N, dt)
    # the counts are the same every layer: XLA computes (and all-reduces) them once
    counts = _counts(e)
    if mesh is not None:
        axes = tuple(mesh.axis_names)
        counts = M.reduce_from(counts, axes, mesh)
    for lp in params["layers"]:
        if mesh is None:
            sums = _sums(h, e)
        else:
            sums = M.reduce_from(_sums(M.copy_to(h, axes, mesh), e), axes, mesh)
        h = sage_layer(lp, h, _mean(sums, counts))
    return h @ params["out"]


def forward_full_graph_partitioned(
    cfg: GNNConfig,
    params: dict,
    feats: torch.Tensor,  # this rank's [N_pad / n_dev, d_in] block of the nodes
    edges: torch.Tensor,  # this rank's block of [E, 2], PRE-PARTITIONED by dst owner
    edge_mask: torch.Tensor,
    mesh,
    comm_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Beyond-baseline layout: node states sharded over the mesh; each rank
    owns the edges whose dst lands in its node range, so the segment sum is
    local; the only collective is one all-gather of h a layer in
    ``comm_dtype``, replacing the baseline's full-size f32 all-reduce of
    replicated node buffers.  A destination outside the rank's range is
    clipped into it, as the reference clips it.  Returns this rank's block
    of the logits."""
    all_axes = tuple(mesh.axis_names)
    n_loc = feats.shape[0]
    n = n_loc * mesh.axis_size(all_axes)
    dt = cfg.compute_dtype
    dst = edges[:, 1].to(torch.int64) - mesh.index(all_axes) * n_loc
    e = edge_terms(edges[:, 0], dst.clamp(0, n_loc - 1), edge_mask, n, n_loc, dt)
    counts = _counts(e)
    h = feats.to(dt)
    for lp in params["layers"]:
        h_full = M.all_gather(h.to(comm_dtype), all_axes, mesh).to(dt)
        h = sage_layer(lp, h, _mean(_sums(h_full, e), counts))
    return h @ params["out"]


def forward_minibatch(
    cfg: GNNConfig,
    params: dict,
    feats: torch.Tensor,  # [N_sub, d_in] features of all sampled nodes
    hop_edges: list,  # per layer: [E_i, 2] indices into N_sub
    hop_masks: list,
    n_targets: int,
) -> torch.Tensor:
    """Sampled-subgraph GraphSAGE (layered: hop_edges[i] feeds layer i).
    The sampled block is per data shard (the sampler runs per host), so
    under a mesh each rank computes its own blocks locally (the reference's
    ``mesh`` and ``batch_axes`` arguments are unused there too)."""
    dt = cfg.compute_dtype
    h = feats.to(dt)
    N = feats.shape[0]
    for lp, ed, m in zip(params["layers"], hop_edges, hop_masks):
        sums, counts = _aggregate_dense(h, ed[:, 0], ed[:, 1], m, N)
        h = sage_layer(lp, h, _mean(sums, counts))
    return h[:n_targets] @ params["out"]


def model_block(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block over `model` of the graphs it holds over the batch
    axes (dim 0): blocks of ceil(G / model) graphs, the last ranks' short
    or empty where `model` does not divide G (the molecule cell's 128
    graphs on the 16x16 pod are 8 a data rank, one on each of the first 8
    model ranks; the reference's GSPMD pads such a split and places the
    graphs otherwise, for the same sums).  An even split is
    ``L.constrain``'s."""
    G = x.shape[0]
    step = -(-G // mesh.axis_size(AXIS_MODEL))
    i = mesh.index(AXIS_MODEL)
    return x[min(i * step, G):min((i + 1) * step, G)]


def forward_molecule(
    cfg: GNNConfig,
    params: dict,
    feats: torch.Tensor,  # [G, n, d_in]
    edges: torch.Tensor,  # [G, e, 2]
    edge_mask: torch.Tensor,  # [G, e]
    mesh=None,
    batch_axes: tuple[str, ...] = (AXIS_DATA,),
) -> torch.Tensor:
    """Batched small graphs; graph-level prediction via mean readout.  One
    pass over all G graphs: graph g's nodes are rows [g n, (g + 1) n) and
    its ids keep their per-graph semantics.  Under a ``mesh`` the inputs
    are this rank's graphs over ``batch_axes``; the output is its block over
    (batch_axes x model), as the reference lays it out, and only those
    graphs are computed."""
    if mesh is not None:
        feats, edges, edge_mask = (model_block(x, mesh) for x in (feats, edges, edge_mask))
    dt = cfg.compute_dtype
    G, n, d = feats.shape
    h = feats.reshape(G * n, d).to(dt)
    off = torch.arange(G, device=feats.device)[:, None] * n
    rows, ok = _src_rows(edges[..., 0], n)
    dst = _dst_rows(edges[..., 1], n)
    dst = torch.where(dst < n, dst + off, G * n)
    e = _edges((rows + off).reshape(-1), ok.reshape(-1), dst.reshape(-1),
               edge_mask.reshape(-1), G * n, dt)
    counts = _counts(e)
    for lp in params["layers"]:
        h = sage_layer(lp, h, _mean(_sums(h, e), counts))
    return h.reshape(G, n, h.shape[-1]).mean(dim=1) @ params["out"]


# ----------------------------------------------------------------- training


def node_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy in f32."""
    logits = logits.to(torch.float32)
    picked = torch.gather(logits, -1, labels.to(torch.int64)[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - picked


def node_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    nll = node_nll(logits, labels)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1)
    return nll.mean()


def loss_and_grads(loss_fn: Callable, params: dict, batch: dict, mesh=None,
                   axes: tuple[str, ...] = ()):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the reference's
    ``jax.value_and_grad``.  Under a ``mesh`` with ``axes``, ``loss_fn``
    returns this rank's share of the global batch's loss (its rows' sum over
    the global count) and the loss and every gradient are summed over
    ``axes``; with no ``axes`` the loss is replicated and each rank's
    gradients are already whole."""
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in tree_flatten_with_path(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = list(torch.autograd.grad(loss, leaves))
    loss = loss.detach()
    if mesh is not None and axes:
        loss = M.all_reduce(loss, axes, mesh)
        grads = [M.all_reduce(g, axes, mesh) for g in grads]
    return loss, tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, optimizer, mesh=None, axes: tuple[str, ...] = ()):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss"})``:
    :func:`loss_and_grads`, then ``optimizer.update``."""

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(loss_fn, params, batch, mesh, axes)
        new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss}

    return step


def make_train_step_full(cfg: GNNConfig, optimizer, mesh=None):
    """The full-graph train step: node cross entropy (over ``label_mask``
    when the batch has one) of :func:`forward_full_graph`; under a ``mesh``
    the batch's edges are this rank's block."""

    def loss_fn(p, batch):
        logits = forward_full_graph(cfg, p, batch["feats"], batch["edges"], batch["edge_mask"],
                                    mesh)
        return node_ce_loss(logits, batch["labels"], batch.get("label_mask"))

    return make_train_step(loss_fn, optimizer)


def full_graph_ring_bytes(cfg: GNNConfig, n_nodes: int, group: int) -> float:
    """Bytes one rank's edge-sharded forward all-reduces over ``group``
    ranks (ring model): every layer's f32 sums and, once, the counts."""
    widths = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
    return sum(M.ring_bytes("all_reduce", n_nodes * d * 4, group) for d in widths) + \
        M.ring_bytes("all_reduce", n_nodes * 4, group)


def partitioned_ring_bytes(cfg: GNNConfig, n_nodes: int, group: int, comm_dtype) -> float:
    """Bytes one rank's partitioned forward all-gathers over ``group``
    ranks (ring model): every layer's h in ``comm_dtype``."""
    item = torch.empty((), dtype=comm_dtype).element_size()
    widths = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
    return sum(M.ring_bytes("all_gather", n_nodes * d * item, group) for d in widths)
