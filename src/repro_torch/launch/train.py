"""End-to-end trainer of the DLRM and the small LM: port of
``repro/launch/train.py`` on one device.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --model dlrm --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20 --batch 32
  PYTHONPATH=src python -m repro_torch.launch.train --steps 40 --resume \\
      --ckpt-dir /tmp/ck   # kill it mid-run, rerun: it restarts
  PYTHONPATH=src python -m repro_torch.launch.train --model lm --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --model lm --device cpu --steps 6 \\
      --batch 8 --seq 16

Features exercised: synthetic zipf pipeline with prefetch, composite
optimizer (rowwise adagrad + adam), async checkpointing with restart,
elastic embedding-tier resharding (--reshard-at), loss logging.  On the card
the step's lookup runs K1 (masked mode) and K2 forward and K1' and K2'
backward.  A checkpoint written by the reference's trainer resumes here and
the reverse: the batch of step s comes from ``default_rng(seed * 100_003 +
s)`` in both.  ``--model lm`` trains ``make_lm_small`` (4 layers,
d_model 256, head dim 32, f32 compute) with Adam on ``lm_batch``es seeded
``seed * 999 + step``, as the reference's ``train_lm``; on the card its
attention runs K6 (with the row logsumexp) forward and K6' backward.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import lm_common
from repro_torch.core.sharding import TableSpec
from repro_torch.data import synthetic as syn
from repro_torch.data.pipeline import PrefetchIterator
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as opt_lib
from repro_torch.runtime.elastic import reshard_params
from repro_torch.utils import logger, resolve_device, tree_num_params


def make_dlrm_100m() -> R.RecsysConfig:
    """~100M-parameter DLRM (example-scale version of dlrm-flexemr)."""
    tables = (
        [TableSpec(f"big_{i}", 300_000, nnz=4) for i in range(2)]
        + [TableSpec(f"mid_{i}", 80_000, nnz=1) for i in range(8)]
        + [TableSpec(f"small_{i}", 2_000, nnz=1) for i in range(16)]
    )
    return R.RecsysConfig(
        name="dlrm-100m",
        arch="dlrm",
        tables=tuple(tables),
        embed_dim=64,
        n_dense=13,
        bottom_mlp=(512, 256, 64),
        mlp=(512, 256),
    )


def make_lm_small() -> T.TransformerConfig:
    return T.TransformerConfig(
        name="lm-small",
        n_layers=4,
        d_model=256,
        n_heads=8,
        n_kv_heads=4,
        d_ff=1024,
        vocab=8192,
        d_head=32,
        compute_dtype=torch.float32,
        remat_groups=2,
    )


def make_optimizer() -> opt_lib.Optimizer:
    """The production mix: rowwise Adagrad on the tables, Adam elsewhere."""
    return opt_lib.make_composite(
        [("emb", opt_lib.make_rowwise_adagrad(0.05)), (".*", opt_lib.make_adam(1e-3))]
    )


def train_recsys(args) -> dict:
    """Train dlrm-100m for steps [start, args.steps); returns the first and
    final loss, the steps run and the wall time of each (host clock; each
    step ends in reading its loss, which waits for the device)."""
    dev = resolve_device(args.device)
    cfg = make_dlrm_100m()
    optimizer = make_optimizer()
    params = R.init_params(cfg, seed=args.seed, device=dev)
    logger.info("dlrm params: %.1fM on %s", tree_num_params(params) / 1e6, dev)
    state = optimizer.init(params)
    start_step = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        (params, state), extra = ckpt.restore((params, state))
        start_step = extra["step"] + 1
        logger.info("resumed from step %d", start_step)

    def make_batch(step):  # on the prefetch thread: host arrays only
        r = np.random.default_rng(args.seed * 100_003 + step)
        return syn.recsys_batch(r, cfg.tables, args.batch, n_dense=cfg.n_dense)

    it = PrefetchIterator(make_batch, start_step)
    step_fn = R.make_train_step(cfg, optimizer, None)
    losses, step_seconds = [], []
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            t_step = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
            params, state, metrics = step_fn(params, state, batch)
            if args.reshard_at and step == args.reshard_at:
                emb = cfg.embedding(1)
                tables, _ = reshard_params(emb.sharded, params["emb"], 4)
                logger.info("elastic reshard 1 -> 4 embedding servers: %s rows",
                            tables.total_rows)
            loss = float(metrics["loss"])
            step_seconds.append(time.perf_counter() - t_step)
            losses.append(loss)
            if step % args.log_every == 0:
                logger.info("step %d loss %.4f (%.2f s/step)", step, loss,
                            (time.time() - t0) / max(1, step - start_step + 1))
            if ckpt and step % args.ckpt_every == 0 and step > start_step:
                ckpt.save(step, (params, state), extra={"step": step})
    finally:
        it.close()
    if ckpt:
        ckpt.save(args.steps - 1, (params, state), extra={"step": args.steps - 1},
                  blocking=True)
    return {"final_loss": losses[-1], "first_loss": losses[0], "steps": len(losses),
            "device": str(dev), "step_seconds": step_seconds}


def train_lm(args) -> dict:
    """Train lm-small for ``args.steps`` steps of ``args.batch`` sequences of
    ``args.seq`` tokens with the LM cells' Adam (3e-4, in place:
    ``lm_common.make_optimizer``) from ``init_params`` seeded
    ``args.seed``; returns the first and final loss, every step's loss, the
    steps run and the wall time of each (host clock; each step ends in
    reading its loss)."""
    dev = resolve_device(args.device)
    cfg = make_lm_small()
    optimizer, _ = lm_common.make_optimizer("adam")
    params = T.init_params(cfg, seed=args.seed, device=dev)
    logger.info("lm params: %.1fM on %s", tree_num_params(params) / 1e6, dev)
    state = optimizer.init(params)

    def make_batch(step):  # on the prefetch thread: host arrays only
        r = np.random.default_rng(args.seed * 999 + step)
        return syn.lm_batch(r, cfg.vocab, args.batch, args.seq)

    it = PrefetchIterator(make_batch, 0)
    step_fn = T.make_train_step(cfg, optimizer, None)
    losses, step_seconds = [], []
    try:
        for step in range(args.steps):
            t_step = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
            params, state, metrics = step_fn(params, state, batch)
            losses.append(float(metrics["loss"]))
            step_seconds.append(time.perf_counter() - t_step)
            if step % args.log_every == 0:
                logger.info("step %d loss %.4f", step, losses[-1])
    finally:
        it.close()
    return {"final_loss": losses[-1], "first_loss": losses[0], "losses": losses,
            "steps": len(losses), "device": str(dev), "step_seconds": step_seconds}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["dlrm", "lm"], default="dlrm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128, help="tokens a sequence (--model lm)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reshard-at", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = train_recsys(args) if args.model == "dlrm" else train_lm(args)
    logger.info("done: %s", {k: v for k, v in out.items() if k not in ("step_seconds", "losses")})
    if not out["final_loss"] < out["first_loss"]:
        raise AssertionError(f"loss must improve: {out['first_loss']} -> {out['final_loss']}")
    return out


if __name__ == "__main__":
    main()
