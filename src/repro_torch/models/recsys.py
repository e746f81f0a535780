"""The recsys model family on top of the disaggregated embedding core.

Port of ``repro/models/recsys.py``.  Seven architectures, the paper's own
workload class:

  dlrm       the paper's Fig-1 reference model: bottom MLP on the dense
             features, embedding bags, pairwise dot interaction (kernel K2
             on the card), top MLP;
  wide_deep  Wide&Deep: a linear ("wide") table, its own dim-8 table or 8
             extra columns of the main one (``fuse_wide``), beside a deep MLP
             over the embeddings;
  autoint    self-attention feature interaction over the field embeddings;
  mind       multi-interest capsule routing over user behaviour sequences
             (raw rows: ``DisaggEmbedding.lookup_rows``, a gather);
  two_tower  dual-encoder retrieval with an in-batch sampled softmax;
  dcn        DCN-v2: low-rank cross layers beside a deep tower;
  deepfm     FM first order (a dim-8 wide table) and second order over the
             shared field embeddings, plus a deep MLP.

Every arch but mind pools its bags through ``DisaggEmbedding.lookup``
(kernel K1 on the card, with the hot-row cache's kernel K3 in front when
``forward`` is given a cache); training is torch autograd, whose backward
of K1 is kernel K1' on the card.  Attention, capsule routing and the
retrieval top-k are PyTorch calls, as the reference computes them in plain
jnp.  Retrieval: ``retrieval_topk`` (two_tower) and ``mind_retrieval``.

Under a mesh (``launch.mesh``, one rank a device, SPMD) each rank holds its
block of every parameter (``param_specs``, ``shard_params``) and its slice of
the batch over the data axes.  The lookup runs in the config's ``mode``;
the dense stage runs on this rank's 1/(data x model) slice of the batch
(``dense_shard``), as under GSPMD, so each rank's cotangent covers only its
own rows.  ``forward`` returns this rank's slice of the scores
(``gather_scores`` assembles them); the train step sums each gradient over
the mesh axes its parameter is replicated on.  The losses that read the
whole batch (two_tower's in-batch softmax, mind's BPR against the previous
sample) gather what they need across the ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.embedding import DisaggEmbedding
from repro_torch.core.sharding import AXIS_DATA, AXIS_MODEL, PartitionSpec as P
from repro_torch.core.sharding import TableSpec, is_spec
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.utils import (keystr, numpy_to_tensor, resolve_device,
                               tree_flatten_with_path, tree_map, tree_unflatten)

ARCHS = ("dlrm", "wide_deep", "autoint", "mind", "two_tower", "dcn", "deepfm")
WIDE_DIM = 8  # the wide table's rows: 8 wide keep the layout lane-aligned; col 0 used


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    arch: str  # one of ARCHS
    tables: tuple[TableSpec, ...]
    embed_dim: int
    n_dense: int = 0
    mlp: tuple[int, ...] = (1024, 512, 256)
    bottom_mlp: tuple[int, ...] = (512, 256, 64)
    # autoint
    attn_layers: int = 3
    attn_heads: int = 2
    d_attn: int = 32
    # mind
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    # two-tower: how many leading tables belong to the user tower
    user_tables: int = 2
    # dcn-v2
    n_cross: int = 3
    cross_rank: int = 64
    # lookup strategy (the paper's knobs)
    mode: str = "hierarchical"
    num_chunks: int = 1
    replicated_fields: tuple[int, ...] = ()
    comm_dtype: Any = None
    use_wide: bool = False
    # fold the wide table into extra columns of the main fused table: one
    # lookup (one index all-gather + one reduce-scatter) serves both halves
    fuse_wide: bool = False
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"unknown arch {self.arch!r}; known: {ARCHS}")
        if self.arch == "dlrm" and self.bottom_mlp[-1] != self.embed_dim:
            raise ValueError(
                "dlrm: bottom_mlp must end at embed_dim so the dense vector "
                "joins the dot interaction"
            )

    @property
    def num_fields(self) -> int:
        return len(self.tables)

    def num_shards_for(self, mesh) -> int:
        """The embedding servers of ``mesh`` (a ``launch.mesh.Mesh`` or
        ``AbstractMesh``): the ``model`` axis (``mesh2d``: every device); 1
        without a mesh."""
        if mesh is None:
            return 1
        if self.mode == "mesh2d":
            return math.prod(mesh.shape.values())
        return mesh.shape[AXIS_MODEL]

    @property
    def max_nnz(self) -> int:
        return max(s.nnz for s in self.tables)

    @property
    def fused_wide(self) -> bool:
        """The wide table rides as 8 extra columns of the main one."""
        return self.use_wide and self.fuse_wide

    def embedding(self, num_shards: int = 1) -> DisaggEmbedding:
        return DisaggEmbedding(
            specs=self.tables,
            dim=self.embed_dim + (WIDE_DIM if self.fused_wide else 0),
            num_shards=num_shards,
            mode=self.mode,
            replicated_fields=self.replicated_fields,
            comm_dtype=self.comm_dtype,
            param_dtype=self.param_dtype,
        )

    def wide_embedding(self, num_shards: int = 1) -> DisaggEmbedding:
        """The separate wide table (wide_deep without ``fuse_wide``, deepfm)."""
        return DisaggEmbedding(
            specs=self.tables,
            dim=WIDE_DIM,
            num_shards=num_shards,
            mode=self.mode,
            param_dtype=self.param_dtype,
        )

    @property
    def separate_wide(self) -> bool:
        """The params hold a ``wide`` table of their own."""
        return self.arch == "deepfm" or (
            self.arch == "wide_deep" and self.use_wide and not self.fuse_wide)

    def num_embedding_rows(self) -> int:
        return sum(t.vocab for t in self.tables)


def dense_axes(batch_axes) -> tuple[str, ...]:
    return tuple(batch_axes) + (AXIS_MODEL,)


def dense_shard(x: torch.Tensor, batch_axes: tuple[str, ...], mesh=None,
                have: tuple[str, ...] | None = None) -> torch.Tensor:
    """This rank's slice of the batch over (data x model) for the dense-NN
    stage, from ``x`` split over ``have`` (default ``batch_axes``) along its
    first dim.  The identity without a mesh."""
    if mesh is None:
        return x
    have = tuple(batch_axes) if have is None else tuple(have)
    return L.constrain(x, P(dense_axes(batch_axes)), mesh, P(have))


# ------------------------------------------------------------------- params


def init_params(cfg: RecsysConfig, seed: int = 0, num_shards: int = 1,
                device="cuda") -> dict:
    """Random parameters of ``cfg.arch`` drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (raises when ``device`` is CUDA and
    no GPU is present): the whole arrays, laid out for ``num_shards``
    embedding servers (``shard_params`` cuts a rank's blocks), with the
    reference's leaf names and shapes.  The numbers differ from the
    reference's ``jax.random`` init; parity tests copy the reference's
    params with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    # meta tensors (abstract_params) hold no numbers and take no generator
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.param_dtype
    params: dict = {"emb": cfg.embedding(num_shards).init(gen, device=dev)}
    Fn, D = cfg.num_fields, cfg.embed_dim

    def mlp(sizes):
        return L.mlp_params(gen, sizes, dt, dev)

    def dense(d_in, d_out):
        return L.dense_init(gen, d_in, d_out, dt, dev)

    if cfg.separate_wide:
        params["wide"] = cfg.wide_embedding(num_shards).init(gen, device=dev)
    if cfg.arch == "dlrm":
        n_vecs = Fn + 1  # field embeddings + bottom-MLP vector
        n_pairs = n_vecs * (n_vecs + 1) // 2  # upper triangle incl. diagonal
        params["bottom"] = mlp((cfg.n_dense,) + cfg.bottom_mlp)
        params["top"] = mlp((n_pairs + cfg.bottom_mlp[-1],) + cfg.mlp + (1,))
    elif cfg.arch == "wide_deep":
        params["deep"] = mlp((Fn * D + cfg.n_dense,) + cfg.mlp + (1,))
        if cfg.n_dense:
            params["dense_lin"] = dense(cfg.n_dense, 1)
    elif cfg.arch == "autoint":
        lyrs, d_in = [], D
        for _ in range(cfg.attn_layers):
            lyrs.append({w: dense(d_in, cfg.d_attn) for w in ("wq", "wk", "wv", "wres")})
            d_in = cfg.d_attn
        params["attn"] = lyrs
        params["out"] = dense(Fn * d_in, 1)
    elif cfg.arch == "mind":
        params["bilinear"] = dense(D, D)
        params["out_mlp"] = mlp((D, D))
    elif cfg.arch == "two_tower":
        Fu = cfg.user_tables
        params["user_mlp"] = mlp((Fu * D,) + cfg.mlp)
        params["item_mlp"] = mlp(((Fn - Fu) * D,) + cfg.mlp)
        params["temp"] = torch.full((), 0.05, dtype=dt, device=dev)
    elif cfg.arch == "dcn":
        # DCN-v2, low-rank cross: x_{l+1} = x0 * (U_l (V_l^T x_l) + b_l) + x_l
        d0 = Fn * D + cfg.n_dense
        params["cross"] = [{"u": dense(cfg.cross_rank, d0), "v": dense(d0, cfg.cross_rank),
                            "b": torch.zeros((d0,), dtype=dt, device=dev)}
                           for _ in range(cfg.n_cross)]
        params["deep"] = mlp((d0,) + cfg.mlp)
        params["out"] = dense(d0 + cfg.mlp[-1], 1)
    elif cfg.arch == "deepfm":
        params["deep"] = mlp((Fn * D + cfg.n_dense,) + cfg.mlp + (1,))
    return params


def abstract_params(cfg: RecsysConfig, num_shards: int = 1) -> dict:
    """The params' global shapes and dtypes as ``meta`` tensors."""
    return init_params(cfg, 0, num_shards, device="meta")


def param_specs(cfg: RecsysConfig, num_shards: int,
                batch_axes: tuple[str, ...] = (AXIS_DATA,), like: dict | None = None) -> dict:
    """Embedding tables (``emb`` and ``wide``) row-sharded on ``model``
    (paper layout) or over the whole mesh (``mesh2d``); ``rep_table`` and
    the dense params replicated.  ``like``, a tree of the params' structure
    and leaf ranks (a rank's blocks or its gradients), spares building
    ``abstract_params``: a step takes its specs so and allocates nothing
    for them, not even on ``meta`` (the dry run counts meta storages)."""
    tables = {"emb": cfg.embedding(num_shards)}
    if cfg.separate_wide:
        tables["wide"] = cfg.wide_embedding(num_shards)
    shapes = abstract_params(cfg, num_shards) if like is None else like
    out = {}
    for k, v in shapes.items():
        if k in tables:
            specs = tables[k].param_specs(batch_axes)
            out[k] = {n: specs[n] for n in v}
        else:
            out[k] = tree_map(lambda leaf: P(*([None] * leaf.ndim)), v)
    return out


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


def dense_stage(cfg: RecsysConfig, params: dict, pooled: torch.Tensor,
                dense: torch.Tensor | None = None,
                wide: torch.Tensor | None = None) -> torch.Tensor:
    """The ranker stage of every arch but mind: pooled [B, F, D'] (D' adds
    the 8 wide columns under ``fuse_wide``), ``dense`` [B, n_dense] (archs
    with dense features) and ``wide`` [B, F, 8] (the separate wide table's
    lookup) -> scores [B]."""
    dt = cfg.compute_dtype
    pooled = pooled.to(dt)
    B = pooled.shape[0]
    dense = dense.to(dt) if cfg.n_dense else None
    feats = [pooled.reshape(B, -1)] + ([dense] if cfg.n_dense else [])

    if cfg.arch == "dlrm":
        bot = L.mlp_apply(params["bottom"], dense, final_act=True)  # [B, D]
        inter = dot_interaction(torch.cat([bot[:, None, :], pooled], dim=1)).to(dt)
        return L.mlp_apply(params["top"], torch.cat([inter, bot], dim=-1))[:, 0]

    if cfg.arch == "wide_deep":
        D = cfg.embed_dim
        if cfg.fused_wide:
            wide = pooled[:, :, D:]
            feats[0] = pooled[:, :, :D].reshape(B, -1)
        logit = torch.zeros((B,), dtype=dt, device=pooled.device)
        if cfg.n_dense:
            logit = logit + (dense @ params["dense_lin"].to(dt))[:, 0]
        deep = L.mlp_apply(params["deep"], torch.cat(feats, -1))[:, 0]
        if cfg.use_wide:
            logit = logit + wide[..., 0].sum(dim=1).to(dt)
        return deep + logit

    if cfg.arch == "autoint":
        x = pooled  # [B, F, D]
        H = cfg.attn_heads
        dh = cfg.d_attn // H
        for lp in params["attn"]:
            q, k, v = ((x @ lp[w].to(dt)).reshape(B, -1, H, dh) for w in ("wq", "wk", "wv"))
            scores = torch.einsum("bfhd,bghd->bhfg", q.float(), k.float())
            probs = torch.softmax(scores / math.sqrt(dh), dim=-1)
            o = torch.einsum("bhfg,bghd->bfhd", probs.to(dt), v)
            o = o.reshape(B, x.shape[1], cfg.d_attn)
            x = torch.relu(o + x @ lp["wres"].to(dt))
        return (x.reshape(B, -1) @ params["out"].to(dt))[:, 0]

    if cfg.arch == "two_tower":
        u, v = two_tower_encode(cfg, params, pooled)
        return torch.sum(u * v, dim=-1) / params["temp"].to(dt)

    if cfg.arch == "dcn":
        x0 = torch.cat(feats, -1)
        x = x0
        for lp in params["cross"]:
            low = x @ lp["v"].to(dt)  # [B, r]
            x = x0 * (low @ lp["u"].to(dt) + lp["b"].to(dt)) + x
        deep = L.mlp_apply(params["deep"], x0, final_act=True)
        return (torch.cat([x, deep], -1) @ params["out"].to(dt))[:, 0]

    if cfg.arch == "deepfm":
        # FM 2nd order: 0.5 * ((sum_f v_f)^2 - sum_f v_f^2), summed over dim
        s = pooled.sum(dim=1)
        fm2 = 0.5 * (s * s - (pooled * pooled).sum(dim=1)).sum(dim=-1)
        fm1 = wide[..., 0].sum(dim=1).to(dt)
        deep = L.mlp_apply(params["deep"], torch.cat(feats, -1))[:, 0]
        return fm1 + fm2.to(dt) + deep

    raise ValueError(f"{cfg.arch}: no dense stage (mind: mind_dense_stage)")


def dense_forward(cfg: RecsysConfig, params: dict, pooled: torch.Tensor,
                  dense: torch.Tensor) -> torch.Tensor:
    """The serving tier's ranker stage: pooled [B,F,D] + dense [B,n_dense]
    -> scores [B].  dlrm only, as the reference server's dense stage; the
    other archs serve through ``forward``."""
    if cfg.arch != "dlrm":
        raise NotImplementedError(f"the server's dense stage is dlrm's, not {cfg.arch!r}")
    return dense_stage(cfg, params, pooled, dense)


def _wide_lookup(cfg: RecsysConfig, params: dict, batch: dict, mesh=None,
                 batch_axes: tuple[str, ...] = (AXIS_DATA,)) -> torch.Tensor:
    """The separate wide table's pooled lookup [B, F, 8] (this rank's dense
    slice under a mesh), no cache, as the reference's."""
    emb = cfg.wide_embedding(cfg.num_shards_for(mesh))
    wide = emb.lookup(params["wide"], batch["indices"], batch["mask"], mesh=mesh,
                      batch_axes=batch_axes,
                      num_chunks=cfg.num_chunks if cfg.arch == "wide_deep" else 1)
    return dense_shard(wide, batch_axes, mesh, have=emb.output_axes(batch_axes))


def forward(cfg: RecsysConfig, params: dict, batch: dict, mesh=None,
            batch_axes: tuple[str, ...] = (AXIS_DATA,), cache=None) -> torch.Tensor:
    """Per-sample scores.  batch: indices [B,F,nnz] int32, mask [B,F,nnz]
    bool, dense [B,n_dense] (archs with dense features); mind: hist [B,H],
    hist_mask [B,H], target [B]; all on the params' device.  ``cache`` (a
    ``HashCacheState`` or ``HotCacheState``) serves the hot rows of the main
    table's sharded fields (not mind's, not the wide table's).

    Under a ``mesh`` the params are this rank's blocks (``shard_params``)
    and the batch its slice over ``batch_axes``; the result is this rank's
    slice of the scores over ``batch_axes`` x ``model`` (``gather_scores``)."""
    emb = cfg.embedding(cfg.num_shards_for(mesh))
    if cfg.arch == "mind":
        rows, tgt, hist_mask = mind_lookup(cfg, emb, params, batch, mesh, batch_axes)
        return mind_dense_stage(cfg, params, rows, tgt, hist_mask)
    pooled = emb.lookup(params["emb"], batch["indices"], batch["mask"], mesh=mesh,
                        cache=cache, batch_axes=batch_axes, num_chunks=cfg.num_chunks)
    pooled = dense_shard(pooled, batch_axes, mesh, have=emb.output_axes(batch_axes))
    dense = dense_shard(batch["dense"], batch_axes, mesh) if cfg.n_dense else None
    wide = _wide_lookup(cfg, params, batch, mesh, batch_axes) if cfg.separate_wide else None
    return dense_stage(cfg, params, pooled, dense, wide)


def gather_scores(scores: torch.Tensor, mesh=None,
                  batch_axes: tuple[str, ...] = (AXIS_DATA,)) -> torch.Tensor:
    """The whole batch's scores from every rank's slice (``forward``'s
    result), on every rank; the identity without a mesh."""
    if mesh is None:
        return scores
    return M.all_gather(scores, dense_axes(batch_axes), mesh)


def two_tower_encode(cfg: RecsysConfig, params: dict, pooled: torch.Tensor):
    """pooled [B, F, D] -> (user [B, d], item [B, d]), both L2-normalized."""
    B = pooled.shape[0]
    Fu = cfg.user_tables
    u = L.mlp_apply(params["user_mlp"], pooled[:, :Fu].reshape(B, -1))
    v = L.mlp_apply(params["item_mlp"], pooled[:, Fu:].reshape(B, -1))
    return _l2_normalize(u), _l2_normalize(v)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-6)


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def mind_lookup(cfg, emb, params, batch, mesh, batch_axes):
    """(history rows [B, H, D], target rows [B, D], hist_mask [B, H]): raw
    rows of the item table (``lookup_rows``, a gather; no K1), each this
    rank's dense slice under a mesh."""
    dt = cfg.compute_dtype
    hist, hist_mask, target = batch["hist"], batch["hist_mask"], batch["target"]
    B = hist.shape[0]
    rows = emb.lookup_rows(params["emb"], hist[:, None, :], hist_mask[:, None, :],
                           mesh=mesh, batch_axes=batch_axes)[:, 0]
    ones = torch.ones((B, 1, 1), dtype=torch.bool, device=target.device)
    tgt = emb.lookup_rows(params["emb"], target[:, None, None], ones, mesh=mesh,
                          batch_axes=batch_axes)[:, 0, 0]
    return (dense_shard(rows.to(dt), batch_axes, mesh), dense_shard(tgt.to(dt), batch_axes, mesh),
            dense_shard(hist_mask, batch_axes, mesh))


def mind_interests(cfg: RecsysConfig, params: dict, rows: torch.Tensor,
                    hist_mask: torch.Tensor) -> torch.Tensor:
    """B2I capsule routing: history rows [B, H, D] -> interests [B, K, D]
    after the output MLP; the routing logits and their softmax in f32."""
    dt = cfg.compute_dtype
    eW = rows @ params["bilinear"].to(dt)  # [B, H, D]
    b = torch.zeros((rows.shape[0], rows.shape[1], cfg.n_interests), dtype=torch.float32,
                    device=rows.device)
    c = None
    for _ in range(cfg.capsule_iters):  # the reference's lax.scan
        w = torch.softmax(b, dim=-1) * hist_mask[..., None]
        c = _squash(torch.einsum("bhk,bhd->bkd", w.to(dt), eW))  # [B, K, D]
        b = b + torch.einsum("bhd,bkd->bhk", eW, c).float()
    return L.mlp_apply(params["out_mlp"], c, act=torch.relu)


def mind_dense_stage(cfg: RecsysConfig, params: dict, rows: torch.Tensor, tgt: torch.Tensor,
                     hist_mask: torch.Tensor) -> torch.Tensor:
    """MIND after its lookup: capsule routing -> K interests -> label-aware
    attention (softmax in f32) against the target item -> scores [B]."""
    dt = cfg.compute_dtype
    interests = mind_interests(cfg, params, rows, hist_mask)
    att = torch.softmax((torch.einsum("bkd,bd->bk", interests, tgt) * 2.0).float(), dim=-1)
    user = torch.einsum("bk,bkd->bd", att.to(dt), interests)
    return torch.sum(user * tgt, dim=-1)


# -------------------------------------------------------------------- loss


def _bce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(_bce_terms(logits, labels))


def _gather(x: torch.Tensor, axes: tuple[str, ...], mesh) -> torch.Tensor:
    """``x``'s blocks over ``axes`` concatenated along dim 0 (x itself
    without a mesh or axes)."""
    return M.all_gather(x, axes, mesh) if mesh is not None and axes else x


class _InBatchLogSumExp(torch.autograd.Function):
    """Row-wise ``logsumexp(u @ v.T - lq[None, :])`` in f32, computed a
    block of rows at a time; the backward recomputes each block's logits,
    so no [B, B] tensor outlives its block (at the train batch of 65,536 a
    whole one is 17.2 GB of f32, and autograd of the plain formula keeps
    one and makes two more in its backward)."""

    @staticmethod
    def _logits(u, v, lq, sl):
        lg = (u[sl] @ v.T).to(torch.float32)
        return lg if lq is None else lg - lq[None, :]

    @staticmethod
    def forward(ctx, u, v, lq, rows):
        blocks = [slice(i, i + rows) for i in range(0, u.shape[0], rows)]
        out = torch.cat([torch.logsumexp(_InBatchLogSumExp._logits(u, v, lq, sl), dim=-1)
                         for sl in blocks])
        ctx.save_for_backward(u, v, lq, out)
        ctx.blocks = blocks
        return out

    @staticmethod
    def backward(ctx, g):
        u, v, lq, out = ctx.saved_tensors
        gu, gv = torch.empty_like(u), torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for sl in ctx.blocks:
            logits = _InBatchLogSumExp._logits(u, v, lq, sl)
            p = torch.exp(logits - out[sl, None]) * g[sl, None]  # softmax times the grad
            gu[sl] = p.to(u.dtype) @ v
            gv += p.T @ u[sl].to(torch.float32)
        return gu, gv.to(v.dtype), None, None


LSE_ROWS = 4096  # rows of the in-batch logits held at once: 1 GB of f32 at B = 65,536


def in_batch_softmax_loss(cfg: RecsysConfig, params: dict, pooled: torch.Tensor,
                          log_q: torch.Tensor | None = None, mesh=None,
                          batch_axes: tuple[str, ...] = (AXIS_DATA,)) -> torch.Tensor:
    """Two-tower training loss: in-batch sampled softmax with logQ
    correction, logits and softmax in f32.  The temperature divides the
    user vectors before the product, each row's own logit is its own dot
    product and the logsumexp runs ``LSE_ROWS`` rows at a time, so the
    [B, B] logits are never held whole.

    Under a ``mesh``, ``pooled`` is this rank's dense slice
    (``dense_shard``) and ``log_q`` its slice over ``batch_axes``: the item
    vectors and ``log_q`` are all-gathered (differentiably) into the global
    batch, the rank computes its own rows of the global [B, B] logits, and
    returns its rows' sum divided by the global batch (the ranks' losses
    sum to the reference's mean)."""
    u, v = two_tower_encode(cfg, params, pooled)
    u = u / params["temp"].to(u.dtype)
    v_all = _gather(v, dense_axes(batch_axes), mesh)
    own = torch.sum(u * v, dim=-1).to(torch.float32)  # row i's logit at column i
    lq = None
    if log_q is not None:
        lq = _gather(log_q, tuple(batch_axes), mesh).to(torch.float32)
        own = own - dense_shard(log_q, batch_axes, mesh)
    terms = _InBatchLogSumExp.apply(u, v_all, lq, LSE_ROWS) - own
    return terms.sum() / v_all.shape[0]


def _bpr_terms(scores: torch.Tensor, mesh, batch_axes) -> torch.Tensor:
    """mind's BPR terms: each positive against the previous sample's score
    (``roll(logits, 1)`` over the global batch).  Under a mesh the first
    negative of this rank's slice is the previous rank's last score."""
    if mesh is None:
        neg = torch.roll(scores, 1)
    else:
        axes = dense_axes(batch_axes)
        lasts = M.all_gather(scores[-1:], axes, mesh)  # every rank's last score
        prev = lasts[(mesh.index(axes) - 1) % lasts.shape[0]]
        neg = torch.cat([prev[None], scores[:-1]])
    return -F.logsigmoid((scores - neg).to(torch.float32))


def _loss(cfg: RecsysConfig, params: dict, batch: dict, mesh, batch_axes) -> torch.Tensor:
    """The reference's three losses; under a mesh this rank's share (its
    rows' sum over the global batch)."""
    if cfg.arch == "two_tower":  # the lookup and the towers, no forward
        emb = cfg.embedding(cfg.num_shards_for(mesh))
        pooled = emb.lookup(params["emb"], batch["indices"], batch["mask"], mesh=mesh,
                            batch_axes=batch_axes, num_chunks=cfg.num_chunks)
        pooled = dense_shard(pooled.to(cfg.compute_dtype), batch_axes, mesh,
                             have=emb.output_axes(batch_axes))
        return in_batch_softmax_loss(cfg, params, pooled, batch.get("log_q"), mesh, batch_axes)
    scores = forward(cfg, params, batch, mesh, batch_axes)
    if cfg.arch == "mind":  # BPR: positive target vs the previous sample's
        terms = _bpr_terms(scores, mesh, batch_axes)
    else:
        terms = _bce_terms(scores, dense_shard(batch["labels"], batch_axes, mesh))
    if mesh is None:
        return torch.mean(terms)
    return terms.sum() / (terms.shape[0] * mesh.axis_size(dense_axes(batch_axes)))


# ------------------------------------------------------------------ training


def _reduce_grads(cfg: RecsysConfig, grads: dict, mesh,
                  batch_axes: tuple[str, ...]) -> dict:
    """Each gradient summed over the mesh axes its parameter is replicated
    on: the dense leaves (and ``rep_table``) over the whole mesh, the tables
    over the data axes in the paper layout and nowhere in ``mesh2d``, where
    each row exists once."""
    specs = param_specs(cfg, cfg.num_shards_for(mesh), batch_axes, like=grads)
    spec_of = {keystr(p): s for p, s in tree_flatten_with_path(specs, is_spec)}
    out = []
    for path, g in tree_flatten_with_path(grads):
        split = set(spec_of[keystr(path)].mesh_axes())
        axes = tuple(a for a in mesh.axis_names if a not in split)
        out.append(M.all_reduce(g, axes, mesh) if axes else g)
    return tree_unflatten(grads, out)


def loss_and_grads(cfg: RecsysConfig, params: dict, batch: dict, mesh=None,
                   batch_axes: tuple[str, ...] = (AXIS_DATA,)):
    """``(loss, grads)``: the arch's loss on ``batch`` (on the params'
    device) as a 0-dim f32 tensor, and its gradient with respect to every
    leaf of ``params``, shaped as ``params`` (the reference's
    ``jax.value_and_grad``).  The losses: BCE of ``forward`` against
    ``labels``; two_tower's in-batch softmax over the lookup (with
    ``log_q`` when the batch has it); mind's BPR against the previous
    sample.  On the card the lookup's backward is kernel K1' (dlrm's
    interaction: K2'); a leaf the loss does not reach raises
    (``torch.autograd.grad``).

    Under a ``mesh`` (blocks as ``forward`` takes them) each rank's loss is
    the sum over its slice of the batch divided by the global batch, so the
    ranks' losses sum to the mean; the loss returned is that sum (on every
    rank) and the gradients are this rank's blocks of the whole batch's."""
    leaves = [leaf.detach().requires_grad_(True)
              for _, leaf in tree_flatten_with_path(params)]
    with torch.enable_grad():
        loss = _loss(cfg, tree_unflatten(params, leaves), batch, mesh, batch_axes)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    if mesh is None:
        return loss.detach(), grads
    return (M.all_reduce(loss.detach(), mesh.axis_names, mesh),
            _reduce_grads(cfg, grads, mesh, batch_axes))


def make_train_step(cfg: RecsysConfig, optimizer, mesh=None,
                    batch_axes: tuple[str, ...] = (AXIS_DATA,)):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": loss})``, the reference's ``make_train_step``:
    :func:`loss_and_grads`, then ``optimizer.update``.  Under a ``mesh``
    each rank steps its blocks of the params and of the optimizer state
    (``optim.sharding_rules``) with its blocks of the reduced gradients.
    Nothing waits for the device."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, mesh, batch_axes)
        new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss}

    return train_step


# --------------------------------------------------------------- retrieval


def topk(scores: torch.Tensor, k: int, mesh=None,
         axes: tuple[str, ...] = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the ``k`` largest along dim 1 of
    ``scores`` [B, n], largest first, as ``jax.lax.top_k`` gives them.
    Under a ``mesh`` with ``axes``, ``scores`` holds this rank's block of
    the candidates, split over ``axes``: a local top-k of ``min(k, n)``,
    its positions made global by the rank's block, both all-gathered over
    ``axes`` (the positions as int32, the reference's bytes) and a top-k of
    those; the result is the same on every rank.  ``torch.topk`` promises
    no order among ties."""
    if mesh is None or not axes:
        val, idx = torch.topk(scores, k, dim=-1)
        return val, idx.to(torch.int32)
    n_loc = scores.shape[1]
    val, pos = torch.topk(scores, min(k, n_loc), dim=-1)
    gpos = (pos + mesh.index(axes) * n_loc).to(torch.int32)
    vals = M.all_gather(val, axes, mesh, dim=1)
    poss = M.all_gather(gpos, axes, mesh, dim=1)
    gval, gidx = torch.topk(vals, k, dim=-1)
    return gval, torch.gather(poss, 1, gidx)


def mind_user_interests(cfg: RecsysConfig, params: dict, batch: dict, mesh=None,
                        batch_axes: tuple[str, ...] = (AXIS_DATA,)) -> torch.Tensor:
    """hist [B,H] -> interest capsules [B, K, D] (shared with forward)."""
    emb = cfg.embedding(cfg.num_shards_for(mesh))
    hist, hist_mask = batch["hist"], batch["hist_mask"]
    rows = emb.lookup_rows(params["emb"], hist[:, None, :], hist_mask[:, None, :],
                           mesh=mesh, batch_axes=batch_axes)[:, 0].to(cfg.compute_dtype)
    return mind_interests(cfg, params, rows, hist_mask)


def mind_retrieval(cfg: RecsysConfig, params: dict, batch: dict, k: int = 100, mesh=None,
                   batch_axes: tuple[str, ...] = (AXIS_DATA,)):
    """Score one user's interests against N candidate items; top-k.

    batch: hist [1, H], hist_mask, cand_ids [N] (under a ``mesh``, this
    rank's block of the candidates over ``batch_axes``; the history whole).
    A candidate's score is the max over interests of <e_cand, interest>;
    each rank takes a local top-k of its block (a partial reduce where the
    data lives, §3.1.2), then the global one (:func:`topk`)."""
    interests = mind_user_interests(cfg, params, batch, mesh, ())  # [1, K, D]
    emb = cfg.embedding(cfg.num_shards_for(mesh))
    cand = batch["cand_ids"]
    N = cand.shape[0]
    ones = torch.ones((N, 1, 1), dtype=torch.bool, device=cand.device)
    rows = emb.lookup_rows(params["emb"], cand[:, None, None], ones, mesh=mesh,
                           batch_axes=batch_axes)[:, 0, 0].to(cfg.compute_dtype)  # [N, D]
    scores = torch.einsum("nd,bkd->bnk", rows, interests).amax(dim=-1)  # [1, N]
    return topk(scores, k, mesh, tuple(batch_axes) if mesh is not None else ())


def retrieval_topk(cfg: RecsysConfig, params: dict, batch: dict,
                   candidates: torch.Tensor, k: int = 100, mesh=None,
                   batch_axes: tuple[str, ...] = (AXIS_DATA,)):
    """Score one (or few) user queries against N candidates (precomputed
    item-tower embeddings [N, d]) and return the top-k.

    Under a ``mesh`` the candidates are this rank's block of them, split
    over every mesh axis, and the queries' batch its slice over
    ``batch_axes``: each rank scores every query against its block and only
    [k]-sized partials are gathered (:func:`topk`), the retrieval analogue of
    hierarchical pooling."""
    emb = cfg.embedding(cfg.num_shards_for(mesh))
    pooled = emb.lookup(params["emb"], batch["indices"], batch["mask"], mesh=mesh,
                        batch_axes=batch_axes)
    if mesh is not None:  # every query on every rank
        pooled = _gather(pooled, emb.output_axes(batch_axes), mesh)
    B = pooled.shape[0]
    u = L.mlp_apply(params["user_mlp"], pooled[:, :cfg.user_tables].reshape(B, -1))
    scores = _l2_normalize(u) @ candidates.T
    return topk(scores, k, mesh, tuple(mesh.axis_names) if mesh is not None else ())
