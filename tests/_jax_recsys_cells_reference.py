"""The reference's side of tests/test_torch_recsys_cells_mesh.py, run as a
script:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_jax_recsys_cells_reference.py inputs.npz outputs.npz

Reads the inputs the test wrote (a .npz whose ``meta`` entry is the JSON of
sizes and ids), patches ``recsys_common.RECSYS_SHAPES`` and
``N_CANDIDATES`` to the test's sizes, and for each recsys registry id and
shape builds the cell with ``recsys_common._build`` (the registry's
``build_cell``) on the config whose tables are capped to the test's rows,
under the (data 2, model 4) mesh.  Each cell is jitted with its
``in_shardings``, compiled, and run on the test's params and batch; a train
cell also runs its step with an optimizer that returns the gradients.
Outputs are the whole logical arrays, with the collective bytes and calls
``analyze`` reads from each compiled cell (its replica groups written out
by ``explicit_groups``)."""
from __future__ import annotations

import dataclasses
import importlib
import json
import sys

import jax
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh
from repro.configs import recsys_common as JRC
from repro.launch.hlo_analysis import analyze
from repro.models import recsys as JR
from repro.optim import optimizers as O

from _jax_sharded_reference import explicit_groups, flat_np, nest


def capped_config(arch_id: str, row_cap: int) -> JR.RecsysConfig:
    """The registry's config of ``arch_id`` at its published widths, each
    table's rows capped at ``row_cap``."""
    cfg = importlib.import_module("repro.configs." + arch_id.replace("-", "_")).make_config()
    return dataclasses.replace(cfg, tables=tuple(
        dataclasses.replace(t, vocab=min(t.vocab, row_cap)) for t in cfg.tables))


def main(inputs_path: str, outputs_path: str) -> None:
    d = dict(np.load(inputs_path))
    meta = json.loads(str(d["meta"]))
    for shape, batch in meta["batches"].items():
        JRC.RECSYS_SHAPES[shape]["batch"] = batch
    JRC.N_CANDIDATES = meta["n_candidates"]
    JRC.RECSYS_SHAPES["retrieval_cand"]["n_candidates"] = meta["n_candidates"]
    mesh = make_mesh(tuple(meta["mesh"]), ("data", "model"))
    grads_of = O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))

    def shardings(specs):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    out: dict = {}
    for arch_id in meta["ids"]:
        cfg = capped_config(arch_id, meta["row_cap"])
        params = nest(d, f"params|{arch_id}")
        for shape in meta["shapes"]:
            cell = JRC._build(shape, mesh, False, cfg_fn=lambda cfg=cfg: cfg)
            key = f"{arch_id}|{shape}"
            batch = nest(d, f"batch|{arch_id}|{shape}")
            if cell.step_name == "train_step":
                args = (params, JRC.make_recsys_optimizer().init(params), batch)
            elif len(cell.args) == 3:
                args = (params, batch, np.asarray(d[f"cands|{arch_id}"]))
            else:
                args = (params, batch)
            fn = jax.jit(cell.step_fn, in_shardings=shardings(cell.in_shardings))
            c = fn.lower(*args).compile()
            terms = analyze(explicit_groups(c.as_text()), 8)
            out[f"hlo_bytes|{key}"] = np.float64(terms.collective_bytes_per_device)
            for op, n in terms.collective_counts.items():
                out[f"hlo_calls|{key}|{op}"] = np.int64(n)
            res = c(*args)
            if cell.step_name == "train_step":
                new_p, new_s, met = res
                out[f"loss|{key}"] = np.asarray(met["loss"])
                for k, v in flat_np(new_p).items():
                    out[f"params|{key}|{k}"] = v
                for k, v in flat_np(new_s).items():
                    out[f"state|{key}|{k}"] = v
                step = jax.jit(JR.make_train_step(cfg, grads_of, mesh, ("data",)),
                               in_shardings=shardings((cell.in_shardings[0], (),
                                                       cell.in_shardings[2])))
                grads, _, met = step(params, (), batch)
                out[f"grads_loss|{key}"] = np.asarray(met["loss"])
                for k, v in flat_np(grads).items():
                    out[f"grads|{key}|{k}"] = v
            elif cell.step_name == "serve_step":
                out[f"scores|{key}"] = np.asarray(res)
            else:
                out[f"values|{key}"], out[f"indices|{key}"] = (np.asarray(x) for x in res)
    np.savez(outputs_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
