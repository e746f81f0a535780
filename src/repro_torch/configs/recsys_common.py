"""Shared cell builder for the recsys architectures (the paper's workload).

Port of ``repro/configs/recsys_common.py``.  Shapes: train_batch (65,536),
serve_p99 (512), serve_bulk (262,144), retrieval_cand (1 query x 1,000,000
candidates, padded to 1,000,448 = 512 x 1954 so the candidate set divides
both meshes).

Training uses the production optimizer mix: rowwise AdaGrad on the
embedding tables (state is O(rows)) + Adam on the dense NN, composed via
``optim.make_composite``.

A cell's arguments are ``meta`` tensors of the global shapes and its
in_shardings the port's ``PartitionSpec`` trees; under a mesh each rank
passes its blocks of them (``CellBuild.blocks``) to the step.  A spec over
no axes (``P((), None)``, the two_tower retrieval batch) is replicated.
With ``mesh=None`` the cell is one device's: its specs split nothing.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs import ArchDef, CellBuild, register
from repro_torch.core.sharding import AXIS_DATA, AXIS_POD, PartitionSpec as P
from repro_torch.data import synthetic as syn
from repro_torch.models import recsys as R
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim import sharding_rules as opt_specs
from repro_torch.utils import resolve_device

N_CANDIDATES = 1_000_448  # 1e6 padded to divide 512 devices
RETRIEVAL_K = 100

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=N_CANDIDATES),
}

OPT_RULES = [("emb|wide", "rowwise"), (".*", "adam")]


def make_recsys_optimizer() -> opt_lib.Optimizer:
    return opt_lib.make_composite(
        [("emb|wide", opt_lib.make_rowwise_adagrad(0.05)),
         (".*", opt_lib.make_adam(1e-3))]
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_abstract(cfg: R.RecsysConfig, batch: int, batch_axes, train: bool):
    """(meta tensors, PartitionSpecs) of one batch of ``cfg.arch``."""
    F, nnz = cfg.num_fields, cfg.max_nnz
    if cfg.arch == "mind":
        abs_ = {
            "hist": _meta((batch, cfg.hist_len), torch.int32),
            "hist_mask": _meta((batch, cfg.hist_len), torch.bool),
            "target": _meta((batch,), torch.int32),
        }
        specs = {
            "hist": P(batch_axes, None),
            "hist_mask": P(batch_axes, None),
            "target": P(batch_axes),
        }
    else:
        abs_ = {
            "indices": _meta((batch, F, nnz), torch.int32),
            "mask": _meta((batch, F, nnz), torch.bool),
        }
        specs = {
            "indices": P(batch_axes, None, None),
            "mask": P(batch_axes, None, None),
        }
        if cfg.n_dense:
            abs_["dense"] = _meta((batch, cfg.n_dense), torch.float32)
            specs["dense"] = P(batch_axes, None)
    if train:
        abs_["labels"] = _meta((batch,), torch.float32)
        specs["labels"] = P(batch_axes)
    return abs_, specs


def build_recsys_cell(cfg: R.RecsysConfig, shape: str, mesh, multi_pod: bool) -> CellBuild:
    info = RECSYS_SHAPES[shape]
    batch_axes = (AXIS_POD, AXIS_DATA) if multi_pod else (AXIS_DATA,)
    num_shards = cfg.num_shards_for(mesh)
    B = info["batch"]

    pshapes = R.abstract_params(cfg, num_shards)
    pspecs = R.param_specs(cfg, num_shards, batch_axes)

    if info["kind"] == "train":
        optimizer = make_recsys_optimizer()
        sshapes = optimizer.init(pshapes)
        sspecs = opt_specs.composite_state_specs(OPT_RULES, pspecs, pshapes)
        batch_abs, bspecs = batch_abstract(cfg, B, batch_axes, train=True)
        step = R.make_train_step(cfg, optimizer, mesh, batch_axes)
        return CellBuild("train_step", step, (pshapes, sshapes, batch_abs),
                         (pspecs, sspecs, bspecs), donate_argnums=(0, 1))

    if info["kind"] == "serve":
        batch_abs, bspecs = batch_abstract(cfg, B, batch_axes, train=False)

        def serve_step(params, batch):
            return R.forward(cfg, params, batch, mesh, batch_axes)

        return CellBuild("serve_step", serve_step, (pshapes, batch_abs), (pspecs, bspecs))

    # retrieval_cand
    N = info["n_candidates"]
    if cfg.arch == "two_tower":
        batch_abs, bspecs = batch_abstract(cfg, 8, (), train=False)
        cand_abs = _meta((N, cfg.mlp[-1]), torch.float32)
        cand_spec = P(tuple(mesh.axis_names) if mesh is not None else None, None)

        def retrieval_step(params, batch, candidates):
            return R.retrieval_topk(cfg, params, batch, candidates, k=RETRIEVAL_K, mesh=mesh,
                                    batch_axes=())

        return CellBuild("retrieval", retrieval_step, (pshapes, batch_abs, cand_abs),
                         (pspecs, bspecs, cand_spec))

    if cfg.arch == "mind":
        batch_abs = {
            "hist": _meta((1, cfg.hist_len), torch.int32),
            "hist_mask": _meta((1, cfg.hist_len), torch.bool),
            "cand_ids": _meta((N,), torch.int32),
        }
        bspecs = {
            "hist": P(None, None),
            "hist_mask": P(None, None),
            "cand_ids": P(batch_axes),
        }

        def retrieval_step(params, batch):
            return R.mind_retrieval(cfg, params, batch, k=RETRIEVAL_K, mesh=mesh,
                                    batch_axes=batch_axes)

        return CellBuild("retrieval", retrieval_step, (pshapes, batch_abs), (pspecs, bspecs))

    # ranking archs: retrieval = bulk-score N candidates through the full model
    batch_abs, bspecs = batch_abstract(cfg, N, batch_axes, train=False)

    def retrieval_step(params, batch):
        scores = R.forward(cfg, params, batch, mesh, batch_axes)
        vals, idx = R.topk(scores[None, :], RETRIEVAL_K, mesh,
                           R.dense_axes(batch_axes) if mesh is not None else ())
        return vals[0], idx[0]

    return CellBuild("retrieval", retrieval_step, (pshapes, batch_abs), (pspecs, bspecs))


def recsys_smoke(cfg_fn, device="cuda") -> dict:
    """Reduced config (tiny vocabs, the first 4 tables): one train step and
    one forward on ``device`` (the card unless the caller passes "cpu")."""
    cfg = cfg_fn()
    tables = tuple(
        dataclasses.replace(t, vocab=max(32, t.vocab % 97 + 32))
        for t in cfg.tables[:4]
    )
    cfg = dataclasses.replace(cfg, tables=tables)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    params = R.init_params(cfg, seed=0, num_shards=1, device=dev)
    optimizer = make_recsys_optimizer()
    state = optimizer.init(params)
    if cfg.arch == "mind":
        host = syn.mind_batch(rng, tables[0].vocab, 8, cfg.hist_len)
    else:
        host = syn.recsys_batch(rng, tables, 8, n_dense=cfg.n_dense)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    step = R.make_train_step(cfg, optimizer, None)
    params, state, metrics = step(params, state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"{cfg.name} smoke: loss {loss}")
    with torch.no_grad():
        scores = R.forward(cfg, params, batch, None)
    if scores.shape != (8,) or not bool(torch.isfinite(scores).all()):
        raise FloatingPointError(f"{cfg.name} smoke: scores {tuple(scores.shape)} not finite")
    return {"loss": loss, "scores_shape": tuple(scores.shape)}


def register_recsys(arch_id: str, cfg_fn, notes: str = "") -> ArchDef:
    return register(
        ArchDef(
            id=arch_id,
            kind="recsys",
            shapes=tuple(RECSYS_SHAPES),
            build_cell=functools.partial(_build, cfg_fn=cfg_fn),
            smoke=functools.partial(recsys_smoke, cfg_fn),
            notes=notes,
        )
    )


def _build(shape, mesh, multi_pod, *, cfg_fn):
    return build_recsys_cell(cfg_fn(), shape, mesh, multi_pod)
