"""Elastic embedding tier under live traffic, on the PyTorch port (the
paper's §2.2 economic claim: the memory tier scales apart from compute):
serve open-loop Poisson arrivals through ``repro_torch``'s FlexEMRServer,
re-partition the tables from 8 to 12 embedding servers partway through
without pausing, and verify the reshard is lossless.

  PYTHONPATH=src python examples/torch_elastic_serve.py               # on the GPU
  PYTHONPATH=src python examples/torch_elastic_serve.py --device cpu --scale 0.05
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core.sharding import make_fused_tables
from repro_torch.data import synthetic as syn
from repro_torch.launch.serve import make_serving_dlrm
from repro_torch.loadgen import (
    OpenLoopDriver,
    OpenLoopGenerator,
    RecsysPayloadFactory,
    constant,
)
from repro_torch.models import recsys as R
from repro_torch.runtime.serving import FlexEMRServer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--qps", type=float, default=300.0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--reshard-to", type=int, default=12)
    args = ap.parse_args()

    cfg = make_serving_dlrm(args.scale)
    params = R.init_params(cfg, 0, device=args.device)
    server = FlexEMRServer(
        cfg, params, make_fused_tables(cfg.tables, cfg.embed_dim, args.shards),
        device=args.device,
    )
    events = OpenLoopGenerator(
        constant(args.qps, args.duration),
        RecsysPayloadFactory(cfg.tables, cfg.n_dense), seed=0,
    ).events()
    probe = syn.recsys_batch(np.random.default_rng(1), cfg.tables, 64)
    state = {"reshard": None, "nonfinite": 0}

    def on_output(res):
        state["nonfinite"] += int((~np.isfinite(res["scores"])).sum())
        if state["reshard"] is None and server.metrics.requests >= len(events) // 2:
            before = server.service.lookup(probe["indices"], probe["mask"])
            state["reshard"] = server.reshard(args.reshard_to)
            after = server.service.lookup(probe["indices"], probe["mask"])
            # fused row ids survive a reshard: only ownership moves
            np.testing.assert_array_equal(after, before)

    try:
        stats = OpenLoopDriver().run(server, events, on_output=on_output)
        summary = server.metrics.summary()
    finally:
        server.close()
    assert state["reshard"] is not None, "the run ended before the reshard"
    assert summary["requests"] == stats["submitted"] - stats["shed"]
    assert state["nonfinite"] == 0
    print(json.dumps({
        "device": str(server.device), "arrivals": stats["submitted"],
        "offered_qps": stats["offered_qps"], "achieved_qps": stats["achieved_qps"],
        "p50_latency_ms": summary["p50_latency_ms"],
        "p99_latency_ms": summary["p99_latency_ms"],
        "shards": [args.shards, server.tables.num_shards],
        "reshard": state["reshard"],
    }, indent=1))
    print(f"resharded {args.shards} -> {args.reshard_to} servers under traffic; "
          "the tier's pooled sums are bit-equal across the cutover")


if __name__ == "__main__":
    main()
