"""Elastic embedding-tier scaling on the PyTorch port (the paper's §2.2
economic claim): train, checkpoint, re-partition the tables 4 -> 8
embedding servers, restore, and verify the model's scores do not move.

  PYTHONPATH=src python examples/torch_elastic_reshard.py                # on the GPU
  PYTHONPATH=src python examples/torch_elastic_reshard.py --device cpu

On the GPU each train step launches K1 (masked) and K1' for the lookup and
its table gradient, and K2 and K2' for the dot interaction; each scoring
forward launches K1 and K2 once.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core.sharding import TableSpec
from repro_torch.data import synthetic as syn
from repro_torch.models import recsys as R
from repro_torch.optim import optimizers as O
from repro_torch.runtime.elastic import reshard_params
from repro_torch.utils import resolve_device

TABLES = (
    TableSpec("big", 50_000, nnz=4),
    TableSpec("mid", 8_000, nnz=1),
    TableSpec("small", 500, nnz=1),
)
CFG = R.RecsysConfig(
    name="elastic-demo", arch="dlrm", tables=TABLES, embed_dim=32,
    n_dense=13, bottom_mlp=(128, 32), mlp=(128, 64),
)
STEPS, SHARDS, RESHARD_TO, MAX_DRIFT = 10, 4, 8, 1e-5


def init_params(device) -> dict:
    """The demo's seeded DLRM params on ``device``, laid out for 4 servers."""
    return R.init_params(CFG, 0, num_shards=SHARDS, device=device)


def run(device="cuda", params: dict | None = None) -> dict:
    """Print the demo's lines and return their values.  ``params`` (the
    reference's leaf names, numpy arrays, laid out for 4 servers)
    replaces ``init_params``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    opt = O.make_composite(
        [("emb", O.make_rowwise_adagrad(0.05)), (".*", O.make_adam(1e-3))]
    )
    params = init_params(dev) if params is None else R.params_from_numpy(params, dev)
    state = opt.init(params)
    step = R.make_train_step(CFG, opt, None)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             syn.recsys_batch(rng, TABLES, 128, n_dense=13).items()}
    for _ in range(STEPS):
        params, state, m = step(params, state, batch)
    loss = float(m["loss"])
    print(f"trained {STEPS} steps, loss {loss:.4f}")

    with torch.no_grad():
        scores_before = R.forward(CFG, params, batch, None)

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(STEPS, params, extra={"step": STEPS}, blocking=True)
        restored, _ = mgr.restore(R.abstract_params(CFG, SHARDS), device=dev)

    emb4 = CFG.embedding(SHARDS)
    new_tables, new_emb = reshard_params(emb4.sharded, restored["emb"], RESHARD_TO)
    print(f"resharded {SHARDS} -> {RESHARD_TO} servers; rows {emb4.sharded.total_rows} -> "
          f"{new_tables.total_rows}")
    restored["emb"] = {"table": new_emb["table"]}
    with torch.no_grad():
        scores_after = R.forward(CFG, restored, batch, None)
    err = float((scores_before - scores_after).abs().max())
    print(f"max score drift across reshard: {err:.2e}")
    if not err < MAX_DRIFT:
        raise AssertionError(f"score drift {err} across the reshard, over {MAX_DRIFT}")
    print("elastic reshard is lossless")
    return {"loss": loss, "rows": [emb4.sharded.total_rows, new_tables.total_rows],
            "max_score_drift": err, "scores": scores_after.cpu()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises with no GPU present) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
