"""The DLRM recsys model on top of the disaggregated embedding core.

Port of ``repro/models/recsys.py`` for ``arch="dlrm"``: the paper's Fig-1
reference model — bottom MLP on dense features, embedding bags
(``core.embedding.DisaggEmbedding.lookup``, kernel K1 on the card, with the
hot-row cache's kernel K3 in front when ``forward`` is given a cache),
pairwise dot interaction (kernel K2 on the card), top MLP, and its training
step (``make_train_step``: torch autograd, whose backward runs K1' and K2'
on the card).  The other archs (wide_deep, autoint, mind, two_tower, dcn,
deepfm) and retrieval wait for ROADMAP queue 1, item 3.

Under a mesh (``launch.mesh``, one rank a device, SPMD) each rank holds its
block of every parameter (``param_specs``, ``shard_params``) and its slice of
the batch over the data axes.  The lookup runs in the config's ``mode``;
the dense stage runs on this rank's 1/(data x model) slice of the batch
(``dense_shard``), as under GSPMD, so each rank's cotangent covers only its
own rows.  ``forward`` returns this rank's slice of the scores
(``gather_scores`` assembles them); the train step sums each gradient over
the mesh axes its parameter is replicated on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.embedding import DisaggEmbedding
from repro_torch.core.sharding import AXIS_DATA, AXIS_MODEL, PartitionSpec as P
from repro_torch.core.sharding import TableSpec, is_spec
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.utils import (keystr, numpy_to_tensor, resolve_device,
                               tree_flatten_with_path, tree_map, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """The reference's config cut to the fields the dlrm path reads; the
    other archs' fields come back with the slices that port them."""

    name: str
    arch: str  # only "dlrm" is ported (the others: ROADMAP queue 1, item 3)
    tables: tuple[TableSpec, ...]
    embed_dim: int
    n_dense: int = 0
    mlp: tuple[int, ...] = (1024, 512, 256)
    bottom_mlp: tuple[int, ...] = (512, 256, 64)
    # lookup strategy (the paper's knobs)
    mode: str = "hierarchical"
    num_chunks: int = 1
    replicated_fields: tuple[int, ...] = ()
    comm_dtype: Any = None
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    def __post_init__(self):
        if self.arch != "dlrm":
            raise NotImplementedError(
                f"arch {self.arch!r} is not ported yet (ROADMAP queue 1, item 3)"
            )
        if self.bottom_mlp[-1] != self.embed_dim:
            raise ValueError(
                "dlrm: bottom_mlp must end at embed_dim so the dense vector "
                "joins the dot interaction"
            )

    @property
    def num_fields(self) -> int:
        return len(self.tables)

    def num_shards_for(self, mesh) -> int:
        """The embedding servers of ``mesh``: the ``model`` axis (``mesh2d``:
        every device); 1 without a mesh."""
        if mesh is None:
            return 1
        if self.mode == "mesh2d":
            return math.prod(mesh.shape.values())
        return mesh.shape[AXIS_MODEL]

    @property
    def max_nnz(self) -> int:
        return max(s.nnz for s in self.tables)

    def embedding(self, num_shards: int = 1) -> DisaggEmbedding:
        return DisaggEmbedding(
            specs=self.tables,
            dim=self.embed_dim,
            num_shards=num_shards,
            mode=self.mode,
            replicated_fields=self.replicated_fields,
            comm_dtype=self.comm_dtype,
            param_dtype=self.param_dtype,
        )

    def num_embedding_rows(self) -> int:
        return sum(t.vocab for t in self.tables)


def dense_shard(x: torch.Tensor, batch_axes: tuple[str, ...], mesh=None,
                have: tuple[str, ...] | None = None) -> torch.Tensor:
    """This rank's slice of the batch over (data x model) for the dense-NN
    stage, from ``x`` split over ``have`` (default ``batch_axes``) along its
    first dim.  The identity without a mesh."""
    if mesh is None:
        return x
    axes = tuple(batch_axes) + (AXIS_MODEL,)
    have = tuple(batch_axes) if have is None else tuple(have)
    return L.constrain(x, P(axes), mesh, P(have))


# ------------------------------------------------------------------- params


def init_params(cfg: RecsysConfig, seed: int = 0, num_shards: int = 1,
                device="cuda") -> dict:
    """Random DLRM parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (raises when ``device`` is CUDA and no GPU is
    present): the whole arrays, laid out for ``num_shards`` embedding
    servers (``shard_params`` cuts a rank's blocks).  The numbers differ
    from the reference's ``jax.random`` init; parity tests copy the
    reference's params with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    # meta tensors (abstract_params) hold no numbers and take no generator
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.param_dtype
    params: dict = {"emb": cfg.embedding(num_shards).init(gen, device=dev)}
    n_vecs = cfg.num_fields + 1  # field embeddings + bottom-MLP vector
    n_pairs = n_vecs * (n_vecs + 1) // 2  # upper triangle incl. diagonal
    params["bottom"] = L.mlp_params(gen, (cfg.n_dense,) + cfg.bottom_mlp, dt, dev)
    top_in = n_pairs + cfg.bottom_mlp[-1]
    params["top"] = L.mlp_params(gen, (top_in,) + cfg.mlp + (1,), dt, dev)
    return params


def abstract_params(cfg: RecsysConfig, num_shards: int = 1) -> dict:
    """The params' global shapes and dtypes as ``meta`` tensors."""
    return init_params(cfg, 0, num_shards, device="meta")


def param_specs(cfg: RecsysConfig, num_shards: int,
                batch_axes: tuple[str, ...] = (AXIS_DATA,)) -> dict:
    """Embedding tables row-sharded on ``model`` (paper layout) or over the
    whole mesh (``mesh2d``); ``rep_table`` and the dense params replicated."""
    emb_specs = cfg.embedding(num_shards).param_specs(batch_axes)
    shapes = abstract_params(cfg, num_shards)
    return {k: ({n: emb_specs[n] for n in v} if k == "emb"
                else tree_map(lambda leaf: P(*([None] * leaf.ndim)), v))
            for k, v in shapes.items()}


def shard_params(tree: Any, specs: Any, mesh) -> Any:
    """This rank's block of every leaf of ``tree`` (whole arrays) under
    ``specs``: views, no copies."""
    spec_leaves = [s for _, s in tree_flatten_with_path(specs, is_spec)]
    leaves = [x for _, x in tree_flatten_with_path(tree)]
    return tree_unflatten(tree, [L.constrain(x, s, mesh) for x, s in zip(leaves, spec_leaves)])


def params_from_numpy(np_params: dict, device) -> dict:
    """The reference package's params (``np.asarray`` on each leaf) as this
    package's nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: numpy_to_tensor(np.asarray(a)).to(dev), np_params)


# ------------------------------------------------------------------ forward


def dot_interaction(vecs: torch.Tensor) -> torch.Tensor:
    """DLRM pairwise dots: [B, F, D] -> [B, F*(F+1)/2], upper triangle incl.
    the diagonal (FB's variant); the gram matrix is kernel K2 on the card."""
    return ops.dot_interaction_triu(vecs)


def dense_forward(cfg: RecsysConfig, params: dict, pooled: torch.Tensor,
                  dense: torch.Tensor) -> torch.Tensor:
    """The ranker stage: pooled [B,F,D] + dense [B,n_dense] -> scores [B]."""
    dt = cfg.compute_dtype
    bot = L.mlp_apply(params["bottom"], dense.to(dt), final_act=True)  # [B, D]
    inter = dot_interaction(
        torch.cat([bot[:, None, :], pooled.to(dt)], dim=1)
    ).to(dt)
    return L.mlp_apply(params["top"], torch.cat([inter, bot], dim=-1))[:, 0]


def forward(cfg: RecsysConfig, params: dict, batch: dict, mesh=None,
            batch_axes: tuple[str, ...] = (AXIS_DATA,), cache=None) -> torch.Tensor:
    """Per-sample scores.  batch: indices [B,F,nnz] int32, mask [B,F,nnz]
    bool, dense [B,n_dense], all on the params' device.  ``cache`` (a
    ``HashCacheState`` or ``HotCacheState``) serves the hot rows of the
    sharded fields.

    Under a ``mesh`` the params are this rank's blocks (``shard_params``)
    and the batch its slice over ``batch_axes``; the result is this rank's
    slice of the scores over ``batch_axes`` x ``model`` (``gather_scores``)."""
    emb = cfg.embedding(cfg.num_shards_for(mesh))
    pooled = emb.lookup(params["emb"], batch["indices"], batch["mask"], mesh=mesh,
                        cache=cache, batch_axes=batch_axes, num_chunks=cfg.num_chunks)
    pooled = dense_shard(pooled, batch_axes, mesh, have=emb.output_axes(batch_axes))
    return dense_forward(cfg, params, pooled, dense_shard(batch["dense"], batch_axes, mesh))


def gather_scores(scores: torch.Tensor, mesh=None,
                  batch_axes: tuple[str, ...] = (AXIS_DATA,)) -> torch.Tensor:
    """The whole batch's scores from every rank's slice (``forward``'s
    result), on every rank; the identity without a mesh."""
    if mesh is None:
        return scores
    return M.all_gather(scores, tuple(batch_axes) + (AXIS_MODEL,), mesh)


# -------------------------------------------------------------------- loss


def _bce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(_bce_terms(logits, labels))


# ------------------------------------------------------------------ training


def _reduce_grads(cfg: RecsysConfig, grads: dict, mesh,
                  batch_axes: tuple[str, ...]) -> dict:
    """Each gradient summed over the mesh axes its parameter is replicated
    on: the dense leaves (and ``rep_table``) over the whole mesh, the table
    over the data axes in the paper layout and nowhere in ``mesh2d``, where
    each row exists once."""
    specs = param_specs(cfg, cfg.num_shards_for(mesh), batch_axes)
    spec_of = {keystr(p): s for p, s in tree_flatten_with_path(specs, is_spec)}
    out = []
    for path, g in tree_flatten_with_path(grads):
        split = set(spec_of[keystr(path)].mesh_axes())
        axes = tuple(a for a in mesh.axis_names if a not in split)
        out.append(M.all_reduce(g, axes, mesh) if axes else g)
    return tree_unflatten(grads, out)


def loss_and_grads(cfg: RecsysConfig, params: dict, batch: dict, mesh=None,
                   batch_axes: tuple[str, ...] = (AXIS_DATA,)):
    """``(loss, grads)``: the BCE loss of ``forward`` on ``batch`` (indices,
    mask, dense and labels on the params' device) as a 0-dim f32 tensor, and
    its gradient with respect to every leaf of ``params``, shaped as
    ``params`` (the reference's ``jax.value_and_grad``).  On the card the
    lookup's and the interaction's backward are kernels K1' and K2'; a leaf
    the loss does not reach raises (``torch.autograd.grad``).

    Under a ``mesh`` (blocks as ``forward`` takes them) each rank's loss is
    the sum over its slice of the batch divided by the global batch, so the
    ranks' losses sum to the mean; the loss returned is that sum (on every
    rank) and the gradients are this rank's blocks of the whole batch's."""
    leaves = [leaf.detach().requires_grad_(True)
              for _, leaf in tree_flatten_with_path(params)]
    with torch.enable_grad():
        scores = forward(cfg, tree_unflatten(params, leaves), batch, mesh, batch_axes)
        if mesh is None:
            loss = bce_loss(scores, batch["labels"])
        else:
            labels = dense_shard(batch["labels"], batch_axes, mesh)
            global_b = batch["labels"].shape[0] * mesh.axis_size(batch_axes)
            loss = _bce_terms(scores, labels).sum() / global_b
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    if mesh is None:
        return loss.detach(), grads
    return (M.all_reduce(loss.detach(), mesh.axis_names, mesh),
            _reduce_grads(cfg, grads, mesh, batch_axes))


def make_train_step(cfg: RecsysConfig, optimizer, mesh=None,
                    batch_axes: tuple[str, ...] = (AXIS_DATA,)):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": loss})``, the reference's ``make_train_step`` for dlrm:
    :func:`loss_and_grads`, then ``optimizer.update``.  Under a ``mesh``
    each rank steps its blocks of the params and of the optimizer state
    (``optim.sharding_rules``) with its blocks of the reduced gradients.
    Nothing waits for the device."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, mesh, batch_axes)
        new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss}

    return train_step
