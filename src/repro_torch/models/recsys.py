"""The DLRM recsys model on top of the disaggregated embedding core.

Port of ``repro/models/recsys.py`` for ``arch="dlrm"`` on one device: the
paper's Fig-1 reference model — bottom MLP on dense features, embedding bags
(``core.embedding.DisaggEmbedding.lookup``, kernel K1 on the card), pairwise
dot interaction (kernel K2 on the card), top MLP.  The other archs
(wide_deep, autoint, mind, two_tower, dcn, deepfm), the mesh paths, training
steps and retrieval wait for later slices of the port.
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
from repro_torch.utils import resolve_device, tree_map


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """The reference's config cut to the fields the dlrm path reads; the
    other archs' fields come back with the slices that port them."""

    name: str
    arch: str  # only "dlrm" is ported (ROADMAP queue 1, item 13)
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
                f"arch {self.arch!r} is not ported yet (ROADMAP queue 1, item 13)"
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


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: jax leaves are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(np_params: dict, device) -> dict:
    """The reference package's params (``np.asarray`` on each leaf) as this
    package's nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(np.asarray(a)).to(dev), np_params)


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


def forward(cfg: RecsysConfig, params: dict, batch: dict) -> torch.Tensor:
    """Per-sample scores.  batch: indices [B,F,nnz] int32, mask [B,F,nnz]
    bool, dense [B,n_dense], all on the params' device."""
    pooled = cfg.embedding().lookup(params["emb"], batch["indices"], batch["mask"])
    return dense_forward(cfg, params, pooled, batch["dense"])


# -------------------------------------------------------------------- loss


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return torch.mean(
        logits.clamp_min(0) - logits * labels
        + torch.log1p(torch.exp(-logits.abs()))
    )
