"""Prefetch demo on the PyTorch port: the §3.1.2 spatial-locality pillar,
end to end.

Serves a co-occurrence-structured stream (persistent pattern pool with
periodic churn) through two identical tiered lookup stacks — one
demand-only, one with the co-occurrence miner + piggybacked prefetcher —
and prints what spatial prefetch buys at equal cache capacity: the hit-rate
lift, the miss-path wire bytes it strips, how many speculative rows
actually served a hit, and proof of the invariance contract (outputs are
*bit-equal* with prefetch on and off: prefetch moves bytes earlier, it
never changes results).  The miner selects each row's neighbors on
``--device``: on the GPU with kernel K5, which is bit-equal to its plain
version, so every count printed is the same on both devices.

  PYTHONPATH=src python examples/torch_prefetch_demo.py                # on the GPU
  PYTHONPATH=src python examples/torch_prefetch_demo.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import DisaggEmbedding, HostLookupService, TableSpec, make_fused_tables
from repro_torch.data.synthetic import CooccurrenceWorkload
from repro_torch.hotcache import AdmissionPolicy, TieredLookupService
from repro_torch.prefetch import CooccurrenceMiner, PrefetchEngine, PrefetchPolicy
from repro_torch.models.recsys import params_from_numpy
from repro_torch.utils import resolve_device

SPECS = (
    TableSpec("history", 40_000, nnz=8),
    TableSpec("item", 10_000, nnz=4),
)
DIM, SHARDS = 32, 4
STAT_FIELDS = ("hits", "lookups", "bytes_network", "bytes_swap_in", "bytes_prefetch",
               "prefetch_issued", "prefetch_hits", "admitted")


def serve(tables, table_np, batches, prefetcher):
    svc = HostLookupService(tables, table_np)
    tiered = TieredLookupService(
        svc,
        num_slots=4096,
        policy=AdmissionPolicy(admission_threshold=3.0, max_swap_in=1024),
        refresh_every=2,
        prefetcher=prefetcher,
    )
    try:
        outs = [tiered.lookup(b["indices"], b["mask"]) for b in batches]
    finally:
        svc.close()
    return tiered.stats, outs


def init_params(device) -> dict:
    """The demo's seeded table on ``device``."""
    dev = resolve_device(device)
    return DisaggEmbedding(specs=SPECS, dim=DIM, num_shards=SHARDS).init(
        torch.Generator(device=dev).manual_seed(0), device=dev)


def run(device="cuda", params: dict | None = None) -> dict:
    """Print the demo's lines and return their values.  ``params``
    (``{"table": array}``) replaces ``init_params``."""
    dev = resolve_device(device)
    emb = DisaggEmbedding(specs=SPECS, dim=DIM, num_shards=SHARDS)
    params = init_params(dev) if params is None else params_from_numpy(params, dev)
    tables = make_fused_tables(SPECS, DIM, SHARDS)
    table_np = params["table"].cpu().numpy()

    workload = CooccurrenceWorkload(
        SPECS, batch=64, alpha=1.03, cooccur_frac=0.7, pool_size=256,
        pattern_alpha=1.15, drift_every=8, drift_frac=0.15, seed=7,
    )
    batches = [workload.next_batch() for _ in range(60)]
    print("serving 60 batches of a drifting pattern-pool workload, twice...")

    base, out_base = serve(tables, table_np, batches, None)
    engine = PrefetchEngine(
        CooccurrenceMiner(list_len=16, max_rows=16_384, decay=0.99, device=dev),
        PrefetchPolicy(k_neighbors=12, byte_budget=1 << 18, min_score=1.0),
    )
    pf, out_pf = serve(tables, table_np, batches, engine)

    if not all(np.array_equal(a, b) for a, b in zip(out_base, out_pf)):
        raise AssertionError("pooled outputs differ with prefetch on and off")
    print("invariance holds: pooled outputs bit-equal with prefetch on/off ✓")
    with torch.no_grad():
        ref = emb.lookup_reference(
            params, torch.from_numpy(batches[-1]["indices"]).to(dev),
            torch.from_numpy(batches[-1]["mask"]).to(dev),
        ).cpu().numpy()
    np.testing.assert_allclose(out_pf[-1], ref, rtol=1e-4, atol=1e-5)
    print("and both equal the single-device oracle ✓\n")

    print(f"              {'demand-only':>12} {'with prefetch':>14}")
    print(f"hit rate      {base.hit_rate:>12.3f} {pf.hit_rate:>14.3f}")
    print(f"miss bytes    {base.bytes_network:>12} {pf.bytes_network:>14}")
    print(f"swap-in bytes {base.bytes_swap_in:>12} {pf.bytes_swap_in:>14}")
    print(f"prefetch bytes{base.bytes_prefetch:>12} {pf.bytes_prefetch:>14}")
    print(
        f"\nmined {engine.miner.tracked_rows} rows' neighbor lists from "
        f"{engine.miner.pairs_observed} co-occurrence pairs; "
        f"{pf.prefetch_issued} rows prefetched, {pf.prefetch_hits} served a "
        f"hit before first touch ({pf.prefetch_useful_rate:.0%} useful)"
    )
    print(
        f"miss-path wire bytes: {base.bytes_network >> 10} KiB -> "
        f"{pf.bytes_network >> 10} KiB "
        f"({base.bytes_network / max(1, pf.bytes_network):.2f}x reduction "
        f"at equal cache capacity)"
    )
    return {"demand_only": {f: getattr(base, f) for f in STAT_FIELDS},
            "with_prefetch": {f: getattr(pf, f) for f in STAT_FIELDS},
            "tracked_rows": engine.miner.tracked_rows,
            "pairs_observed": engine.miner.pairs_observed,
            "oracle_max_err": float(np.abs(out_pf[-1] - ref).max())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises with no GPU present) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
