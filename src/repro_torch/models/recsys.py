"""The DLRM recsys model on top of the disaggregated embedding core.

Port of ``repro/models/recsys.py`` for ``arch="dlrm"`` on one device: the
paper's Fig-1 reference model — bottom MLP on dense features, embedding bags
(``core.embedding.DisaggEmbedding.lookup``, kernel K1 on the card, with the
hot-row cache's kernel K3 in front when ``forward`` is given a cache),
pairwise dot interaction (kernel K2 on the card), top MLP, and its training
step (``make_train_step``: torch autograd, whose backward runs K1' and K2'
on the card).  The other archs (wide_deep, autoint, mind, two_tower, dcn,
deepfm) and retrieval wait for ROADMAP queue 1, item 3; the mesh paths for
item 2.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.embedding import DisaggEmbedding
from repro_torch.core.sharding import TableSpec
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.utils import (numpy_to_tensor, resolve_device, tree_flatten_with_path,
                               tree_map, tree_unflatten)


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
    replicated_fields: tuple[int, ...] = ()
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

    @property
    def max_nnz(self) -> int:
        return max(s.nnz for s in self.tables)

    def embedding(self, num_shards: int = 1) -> DisaggEmbedding:
        return DisaggEmbedding(
            specs=self.tables,
            dim=self.embed_dim,
            num_shards=num_shards,
            replicated_fields=self.replicated_fields,
            param_dtype=self.param_dtype,
        )

    def num_embedding_rows(self) -> int:
        return sum(t.vocab for t in self.tables)


# ------------------------------------------------------------------- params


def init_params(cfg: RecsysConfig, seed: int = 0, num_shards: int = 1,
                device="cuda") -> dict:
    """Random DLRM parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (raises when ``device`` is CUDA and no GPU is
    present).  The numbers differ from the reference's ``jax.random`` init;
    parity tests copy the reference's params with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.param_dtype
    params: dict = {"emb": cfg.embedding(num_shards).init(gen, device=dev)}
    n_vecs = cfg.num_fields + 1  # field embeddings + bottom-MLP vector
    n_pairs = n_vecs * (n_vecs + 1) // 2  # upper triangle incl. diagonal
    params["bottom"] = L.mlp_params(gen, (cfg.n_dense,) + cfg.bottom_mlp, dt, dev)
    top_in = n_pairs + cfg.bottom_mlp[-1]
    params["top"] = L.mlp_params(gen, (top_in,) + cfg.mlp + (1,), dt, dev)
    return params


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


def forward(cfg: RecsysConfig, params: dict, batch: dict,
            cache=None) -> torch.Tensor:
    """Per-sample scores.  batch: indices [B,F,nnz] int32, mask [B,F,nnz]
    bool, dense [B,n_dense], all on the params' device.  ``cache`` (a
    ``HashCacheState`` or ``HotCacheState``) serves the hot rows of the
    sharded fields, as the reference's ``forward(mesh=..., cache=...)``."""
    pooled = cfg.embedding().lookup(params["emb"], batch["indices"], batch["mask"],
                                    cache=cache)
    return dense_forward(cfg, params, pooled, batch["dense"])


# -------------------------------------------------------------------- loss


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return torch.mean(
        logits.clamp_min(0) - logits * labels
        + torch.log1p(torch.exp(-logits.abs()))
    )


# ------------------------------------------------------------------ training


def loss_and_grads(cfg: RecsysConfig, params: dict, batch: dict):
    """``(loss, grads)``: the BCE loss of ``forward`` on ``batch`` (indices,
    mask, dense and labels on the params' device) as a 0-dim f32 tensor, and
    its gradient with respect to every leaf of ``params``, shaped as
    ``params`` (the reference's ``jax.value_and_grad``).  On the card the
    lookup's and the interaction's backward are kernels K1' and K2'; a leaf
    the loss does not reach raises (``torch.autograd.grad``)."""
    leaves = [leaf.detach().requires_grad_(True)
              for _, leaf in tree_flatten_with_path(params)]
    with torch.enable_grad():
        loss = bce_loss(forward(cfg, tree_unflatten(params, leaves), batch),
                        batch["labels"])
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: RecsysConfig, optimizer, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": loss})``, the reference's ``make_train_step`` for dlrm on one
    device: :func:`loss_and_grads`, then ``optimizer.update``.  Nothing
    waits for the device."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...) is not ported yet (ROADMAP queue 1, item 2)")

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch)
        new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss}

    return train_step
