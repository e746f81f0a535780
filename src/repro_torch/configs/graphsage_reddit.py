"""graphsage-reddit [gnn]: 2 layers, d_hidden=128, mean aggregator,
sample_sizes=25-10.  [arXiv:1706.02216]

Port of ``repro/configs/graphsage_reddit.py``.  Four shape regimes
(assigned):
  full_graph_sm  — Cora-sized full batch: 2,708 nodes / 10,556 edges / d=1433.
  minibatch_lg   — Reddit: 232,965 nodes / 114.6M edges; layered neighbour
                   sampling, batch_nodes=1024, fanout 15-10 (shape spec
                   overrides the arch default 25-10), blocks sharded over the
                   whole mesh.
  ogb_products   — full-batch large: 2,449,029 nodes / 61.86M edges / d=100.
  molecule       — 128 batched small graphs (30 nodes / 64 edges), regression.

Message passing = segment sum over edge shards + all-reduce (hierarchical
pooling applied to neighbour aggregation).

A cell's arguments are ``meta`` tensors of the global shapes and its
in_shardings the reference's ``PartitionSpec`` trees.  Under a
``launch.mesh.Mesh`` each rank calls the cell's step on its blocks of the
batch: the full-graph step on its block of the edges (``models.gnn``'s
edge-sharded forward), the minibatch step on its sampled blocks and the
molecule step on its graphs, each summing its share of the global batch's
loss and gradients over the mesh.  ``mesh=None`` builds the one-device
cell (one sampled block of ``batch_nodes`` targets).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ArchDef, CellBuild, register
from repro_torch.core.sharding import AXIS_DATA, AXIS_POD, PartitionSpec as P
from repro_torch.data import graph_sampler as GS
from repro_torch.data import synthetic as syn
from repro_torch.models import gnn as G
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim import sharding_rules as opt_specs
from repro_torch.utils import resolve_device, round_up

SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556, d_feat=1433,
                          n_classes=7),
    "minibatch_lg": dict(kind="minibatch", n_nodes=232965, batch_nodes=1024,
                         fanout=(15, 10), d_feat=602, n_classes=41),
    "ogb_products": dict(kind="full", n_nodes=2449029, n_edges=61859140,
                         d_feat=100, n_classes=47),
    "molecule": dict(kind="molecule", n_nodes=30, n_edges=64, batch=128,
                     d_feat=32, n_classes=1),
}


def _cfg(info) -> G.GNNConfig:
    return G.GNNConfig(
        name="graphsage-reddit",
        n_layers=2,
        d_in=info["d_feat"],
        d_hidden=128,
        n_classes=info["n_classes"],
        aggregator="mean",
        sample_sizes=info.get("fanout", (25, 10)),
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _group(mesh, axes) -> int:
    return mesh.axis_size(axes) if mesh is not None and axes else 1


def minibatch_loss(cfg: G.GNNConfig, n_targets: int, mesh=None, axes: tuple[str, ...] = ()):
    """``loss_fn(params, batch)`` of the minibatch cell: node cross entropy
    of the first ``n_targets`` nodes of every sampled block in the batch
    (leading dim: the blocks), summed over the global batch's targets (the
    batch's over the ranks along ``axes`` under a ``mesh``): this rank's
    share of the global mean."""

    def loss_fn(p, batch):
        nll = torch.cat([
            G.node_nll(G.forward_minibatch(
                cfg, p, batch["feats"][r], [batch["edges1"][r], batch["edges2"][r]],
                [batch["mask1"][r], batch["mask2"][r]], n_targets), batch["labels"][r])
            for r in range(batch["feats"].shape[0])])
        return nll.sum() / (nll.numel() * _group(mesh, axes))

    return loss_fn


def molecule_loss(cfg: G.GNNConfig, mesh=None, batch_axes: tuple[str, ...] = (AXIS_DATA,)):
    """``loss_fn(params, batch)`` of the molecule cell: squared error of the
    graph-level outputs, summed over the global batch's graphs.  Under a
    ``mesh`` the batch holds this rank's graphs over ``batch_axes`` and the
    forward computes its block over (batch_axes x model)."""
    def loss_fn(p, batch):
        out = G.forward_molecule(cfg, p, batch["feats"], batch["edges"], batch["edge_mask"],
                                 mesh, batch_axes)[:, 0]
        labels = batch["labels"]
        n_graphs = labels.shape[0] * _group(mesh, batch_axes)
        if mesh is not None:
            labels = G.model_block(labels, mesh)
        return torch.sum((out - labels) ** 2) / n_graphs

    return loss_fn


def build_cell(shape: str, mesh, multi_pod: bool) -> CellBuild:
    info = SHAPES[shape]
    cfg = _cfg(info)
    all_axes = tuple(mesh.axis_names) if mesh is not None else ()
    n_dev = int(np.prod([mesh.shape[a] for a in all_axes])) if all_axes else 1
    batch_axes = (AXIS_POD, AXIS_DATA) if multi_pod else (AXIS_DATA,)
    optimizer = opt_lib.make_adam(1e-3)
    pshapes = G.abstract_params(cfg)
    pspecs = G.param_specs(cfg)
    sshapes = optimizer.init(pshapes)
    sspecs = opt_specs.adam_state_specs(pspecs, pshapes)

    if info["kind"] == "full":
        N = info["n_nodes"]
        E = round_up(info["n_edges"], 512)
        batch_abs = {
            "feats": _meta((N, cfg.d_in), torch.float32),
            "edges": _meta((E, 2), torch.int32),
            "edge_mask": _meta((E,), torch.bool),
            "labels": _meta((N,), torch.int32),
        }
        bspecs = {
            "feats": P(None, None),
            "edges": P(all_axes, None),
            "edge_mask": P(all_axes),
            "labels": P(None),
        }
        step = G.make_train_step_full(cfg, optimizer, mesh)
        return CellBuild("train_step", step, (pshapes, sshapes, batch_abs),
                         (pspecs, sspecs, bspecs), donate_argnums=(0, 1))

    if info["kind"] == "minibatch":
        R_shards = n_dev  # one sampled block per device
        tgt = info["batch_nodes"] // R_shards
        sizes = GS.block_sizes(tgt, info["fanout"], cfg.d_in)
        n_sub = sizes["n_sub"]
        e1, e2 = sizes["hop_edges"]
        batch_abs = {
            "feats": _meta((R_shards, n_sub, cfg.d_in), torch.float32),
            "edges1": _meta((R_shards, e1, 2), torch.int32),
            "mask1": _meta((R_shards, e1), torch.bool),
            "edges2": _meta((R_shards, e2, 2), torch.int32),
            "mask2": _meta((R_shards, e2), torch.bool),
            "labels": _meta((R_shards, tgt), torch.int32),
        }
        shard = P(all_axes, None, None)
        bspecs = {
            "feats": shard,
            "edges1": shard,
            "mask1": P(all_axes, None),
            "edges2": shard,
            "mask2": P(all_axes, None),
            "labels": P(all_axes, None),
        }
        step = G.make_train_step(minibatch_loss(cfg, tgt, mesh, all_axes), optimizer, mesh,
                                 all_axes)
        return CellBuild("train_step", step, (pshapes, sshapes, batch_abs),
                         (pspecs, sspecs, bspecs), donate_argnums=(0, 1))

    # molecule: batched small graphs, graph-level regression
    Gb = info["batch"]
    batch_abs = {
        "feats": _meta((Gb, info["n_nodes"], cfg.d_in), torch.float32),
        "edges": _meta((Gb, info["n_edges"], 2), torch.int32),
        "edge_mask": _meta((Gb, info["n_edges"]), torch.bool),
        "labels": _meta((Gb,), torch.float32),
    }
    bspecs = {
        "feats": P(batch_axes, None, None),
        "edges": P(batch_axes, None, None),
        "edge_mask": P(batch_axes, None),
        "labels": P(batch_axes),
    }
    step = G.make_train_step(molecule_loss(cfg, mesh, batch_axes), optimizer, mesh, all_axes)
    return CellBuild("train_step", step, (pshapes, sshapes, batch_abs),
                     (pspecs, sspecs, bspecs), donate_argnums=(0, 1))


def smoke(device="cuda") -> dict:
    """A tiny GraphSAGE on ``device`` (the card unless the caller passes
    "cpu"): one full-graph Adam step on a random graph (finite loss), then
    the minibatch forward over a block from the real sampler."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cfg = G.GNNConfig(name="sage-smoke", d_in=16, d_hidden=8, n_classes=5)
    params = G.init_params(cfg, seed=0, device=dev)
    optimizer = opt_lib.make_adam(1e-3)
    state = optimizer.init(params)
    g = syn.random_graph(rng, 64, 256, 16, 5)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
    params, state, metrics = G.make_train_step_full(cfg, optimizer, None)(params, state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"{cfg.name} smoke: loss {loss}")
    # minibatch path via the real sampler
    csr = GS.edges_to_csr(g["edges"], 64, g["feats"], g["labels"])
    blk = GS.sample_block(csr, rng, np.arange(4), (3, 2))
    with torch.no_grad():
        out = G.forward_minibatch(
            cfg, params, torch.from_numpy(blk.feats).to(dev),
            [torch.from_numpy(e).to(dev) for e in blk.hop_edges],
            [torch.from_numpy(m).to(dev) for m in blk.hop_masks], blk.n_targets)
    if out.shape != (4, 5) or not bool(torch.isfinite(out).all()):
        raise FloatingPointError(f"{cfg.name} smoke: logits {tuple(out.shape)} not finite")
    return {"loss": loss, "logits_shape": tuple(out.shape)}


register(
    ArchDef(
        id="graphsage-reddit",
        kind="gnn",
        shapes=tuple(SHAPES),
        build_cell=build_cell,
        smoke=smoke,
        notes="minibatch_lg fanout follows the shape spec (15-10); the arch "
        "default 25-10 is kept in GNNConfig.sample_sizes for full-graph runs.",
    )
)
