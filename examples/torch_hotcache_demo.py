"""Hotcache demo on the PyTorch port: the §3.1.1 temporal-locality pillar,
end to end.

Serves zipf-skewed traffic through the tiered lookup stack and prints what
the cache buys: the hit rate the LFU admission policy converges to, the wire
bytes with and without the cache, and proof that caching is *transparent*
(results equal the single-device oracle).  The tier (``TieredLookupService``
over ``HostLookupService``) is host numpy and the oracle is the plain
``lookup_reference``: this demo launches no hand-written kernel on either
device; the table and the oracle live on ``--device``.

  PYTHONPATH=src python examples/torch_hotcache_demo.py                # on the GPU
  PYTHONPATH=src python examples/torch_hotcache_demo.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import DisaggEmbedding, HostLookupService, TableSpec, make_fused_tables
from repro_torch.data import synthetic as syn
from repro_torch.hotcache import AdmissionPolicy, TieredLookupService
from repro_torch.models.recsys import params_from_numpy
from repro_torch.utils import resolve_device

SPECS = (
    TableSpec("history", 100_000, nnz=8),
    TableSpec("item", 20_000, nnz=4),
    TableSpec("geo", 512, nnz=1, pooling="mean"),
)
DIM, SHARDS = 32, 4


def init_params(device) -> dict:
    """The demo's seeded table on ``device``."""
    dev = resolve_device(device)
    return DisaggEmbedding(specs=SPECS, dim=DIM, num_shards=SHARDS).init(
        torch.Generator(device=dev).manual_seed(0), device=dev)


def run(device="cuda", params: dict | None = None) -> dict:
    """Print the demo's lines and return their values.  ``params``
    (``{"table": array}``) replaces ``init_params``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    emb = DisaggEmbedding(specs=SPECS, dim=DIM, num_shards=SHARDS)
    params = init_params(dev) if params is None else params_from_numpy(params, dev)
    tables = make_fused_tables(SPECS, DIM, SHARDS)
    svc = HostLookupService(tables, params["table"].cpu().numpy())
    tiered = TieredLookupService(
        svc,
        num_slots=16_384,
        policy=AdmissionPolicy(admission_threshold=1.5, max_swap_in=8192),
        refresh_every=2,
    )
    res: dict = {"steps": []}
    try:
        print("serving 30 zipf-skewed batches (B=128, alpha=1.3)...")
        for step in range(30):
            b = syn.recsys_batch(rng, SPECS, 128, alpha=1.3)
            out = tiered.lookup(b["indices"], b["mask"])
            if step % 10 == 9:
                s = tiered.stats
                res["steps"].append({
                    "step": step + 1, "hits": s.hits, "lookups": s.lookups,
                    "cached": tiered.cache.occupancy, "bytes_network": s.bytes_network,
                    "bytes_no_cache": s.bytes_no_cache})
                print(
                    f"  step {step + 1:3d}  hit_rate={s.hit_rate:.2f}  "
                    f"cached={tiered.cache.occupancy}  "
                    f"wire={s.bytes_network >> 10}KiB  "
                    f"no-cache={s.bytes_no_cache >> 10}KiB"
                )
        # transparency: the tiered result equals the oracle
        with torch.no_grad():
            ref = emb.lookup_reference(params, torch.from_numpy(b["indices"]).to(dev),
                                       torch.from_numpy(b["mask"]).to(dev))
        ref = ref.cpu().numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
        res["oracle_max_err"] = float(np.abs(out - ref).max())
        s = tiered.stats
        moved = s.bytes_network + s.bytes_swap_in
        print(f"\ncaching is transparent (allclose vs oracle) ✓")
        print(
            f"bytes through HostLookupService: {moved >> 10} KiB vs "
            f"{s.bytes_no_cache >> 10} KiB without the cache "
            f"({s.bytes_no_cache / max(1, moved):.2f}x reduction, "
            f"{s.admitted} rows admitted over {s.batches} batches)"
        )
        res.update(bytes_network=s.bytes_network, bytes_swap_in=s.bytes_swap_in,
                   bytes_no_cache=s.bytes_no_cache, admitted=s.admitted,
                   batches=s.batches, hits=s.hits, lookups=s.lookups,
                   cached=tiered.cache.occupancy)
    finally:
        svc.close()
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises with no GPU present) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
