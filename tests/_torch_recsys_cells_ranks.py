"""The port's side of tests/test_torch_recsys_cells_mesh.py: one rank of a
(data 2, model 4) mesh over gloo on the CPU.  ``run`` reads the inputs the
test wrote (a .npz whose ``meta`` entry is the JSON of sizes and ids), and
for each recsys registry id and shape builds the cell with
``recsys_common._build`` (the registry's ``build_cell``) on the capped
config, takes this rank's blocks of its global arguments by the cell's
``in_shardings`` (``CellBuild.blocks``) and calls ``cell.step_fn`` under
the real mesh.  A train cell's step runs once more with an optimizer that
returns the gradients.  The rank writes its blocks of every output to
``<out_dir>/rank<r>.npz`` and returns its coordinates and the bytes and
calls each cell counted.

It imports torch and the port only (no jax), so it starts quickly in a
spawned process."""
from __future__ import annotations

import dataclasses
import importlib
import json
import os

import numpy as np
import torch

from repro_torch.configs import recsys_common as RC
from repro_torch.core.sharding import AXIS_DATA
from repro_torch.launch import mesh as M
from repro_torch.models import recsys as R

from _torch_sharded_ranks import flat_np, grads_of, nest

BATCH_AXES = (AXIS_DATA,)


def capped_config(arch_id: str, row_cap: int) -> R.RecsysConfig:
    """The registry's config of ``arch_id`` at its published widths, each
    table's rows capped at ``row_cap``."""
    cfg = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_")).make_config()
    return dataclasses.replace(cfg, tables=tuple(
        dataclasses.replace(t, vocab=min(t.vocab, row_cap)) for t in cfg.tables))


def patch_shapes(meta: dict) -> None:
    """The cells' batches and candidate count cut to the test's sizes (the
    reference's side patches its own module the same way)."""
    for shape, batch in meta["batches"].items():
        RC.RECSYS_SHAPES[shape]["batch"] = batch
    RC.N_CANDIDATES = meta["n_candidates"]
    RC.RECSYS_SHAPES["retrieval_cand"]["n_candidates"] = meta["n_candidates"]


def build(arch_id: str, shape: str, mesh, meta: dict):
    """(config, cell) of ``arch_id`` x ``shape`` under ``mesh``."""
    cfg = capped_config(arch_id, meta["row_cap"])
    return cfg, RC._build(shape, mesh, False, cfg_fn=lambda: cfg)


def cell_args(d: dict, arch_id: str, shape: str, cell, params: dict) -> tuple:
    """The cell's global arguments: the params, a train cell's optimizer
    state (``make_recsys_optimizer().init`` of them), the batch, and the
    two-tower retrieval's candidates."""
    batch = nest(d, f"batch|{arch_id}|{shape}")
    if cell.step_name == "train_step":
        return params, RC.make_recsys_optimizer().init(params), batch
    if len(cell.args) == 3:
        return params, batch, torch.from_numpy(d[f"cands|{arch_id}"])
    return params, batch


def _since(before: dict, now: dict) -> dict:
    return {op: v - before.get(op, 0) for op, v in now.items() if v != before.get(op, 0)}


def run(rank: int, world: int, inputs_path: str, out_dir: str) -> dict:
    torch.set_num_threads(1)
    d = dict(np.load(inputs_path))
    meta = json.loads(str(d["meta"]))
    patch_shapes(meta)
    mesh = M.make_debug_mesh(*meta["mesh"])
    res: dict = {}
    counted: dict = {"coords": dict(mesh.coords), "bytes": {}, "calls": {}}
    for arch_id in meta["ids"]:
        params = nest(d, f"params|{arch_id}")
        for shape in meta["shapes"]:
            cfg, cell = build(arch_id, shape, mesh, meta)
            args = cell.blocks(cell_args(d, arch_id, shape, cell, params), mesh)
            key = f"{arch_id}|{shape}"
            if cell.step_name == "train_step":
                grads, _, met = R.make_train_step(cfg, grads_of(), mesh, BATCH_AXES)(
                    args[0], (), args[2])
                res[f"grads_loss|{key}"] = met["loss"].numpy()
                for k, v in flat_np(grads).items():
                    res[f"grads|{key}|{k}"] = v
            b0, c0 = M.comm_bytes(), M.comm_calls()
            with torch.set_grad_enabled(cell.step_name == "train_step"):
                out = cell.step_fn(*args)
            counted["bytes"][key] = _since(b0, M.comm_bytes())
            counted["calls"][key] = _since(c0, M.comm_calls())
            if cell.step_name == "train_step":
                new_p, new_s, met = out
                res[f"loss|{key}"] = met["loss"].numpy()
                for k, v in flat_np(new_p).items():
                    res[f"params|{key}|{k}"] = v
                for k, v in flat_np(new_s).items():
                    res[f"state|{key}|{k}"] = v
            elif cell.step_name == "serve_step":
                res[f"scores|{key}"] = out.numpy()
            else:
                res[f"values|{key}"], res[f"indices|{key}"] = (t.numpy() for t in out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    return counted
