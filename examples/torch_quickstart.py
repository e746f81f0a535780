"""Quickstart on the PyTorch port: the disaggregated embedding core.

  PYTHONPATH=src python examples/torch_quickstart.py                 # on the GPU
  PYTHONPATH=src python examples/torch_quickstart.py --ranks 4       # 4 ranks of the GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --ranks 8

Builds a sharded embedding, compares the paper's two lookup paths, attaches
a hot-row cache, and shows the range routing table; then the same lookup
through the multi-threaded rdma engine pool.  By default the lookups run on
one device; ``--ranks N`` runs them on N gloo ranks (``launch.mesh.spawn``)
at mesh (data 2, model N // 2), each rank holding its rows of the table and
its slice of the batch.  On the GPU each lookup is one launch of kernel K1
in its masked mode (under a mesh: hierarchical and cached, not baseline's
raw-row path), and the cached lookup's flat hot-row slab is searched with
``torch.searchsorted``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import (
    DisaggEmbedding,
    RangeRouter,
    TableSpec,
    make_cache_from_table,
    make_fused_tables,
)
from repro_torch.core.sharding import PartitionSpec as P
from repro_torch.data import synthetic as syn
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models.recsys import params_from_numpy
from repro_torch.rdma import PooledLookupService
from repro_torch.utils import resolve_device

# Three sparse fields: one multi-hot history, two categorical ids.
SPECS = (
    TableSpec("history", 100_000, nnz=8),
    TableSpec("user_geo", 5_000, nnz=1),
    TableSpec("item_cat", 300, nnz=1, pooling="mean"),
)
DIM, BATCH, HOT = 32, 32, 256
MODES = ("baseline", "hierarchical")
BATCH_AXES = ("data",)


def lookup_launches() -> dict:
    """This process's launches of the kernels a lookup can reach: K1 (all,
    and in its masked mode), K3 and K4."""
    from repro_torch.hotcache import kernels as HK
    from repro_torch.kernels import embedding_bag as K1

    return {"embedding_bag": K1.launches, "embedding_bag_masked": K1.launches_masked,
            "probe_gather_pool": HK.launches[HK.PROBE],
            "scatter_update": HK.launches[HK.SCATTER]}


def embedding(shards: int, mode: str = "hierarchical") -> DisaggEmbedding:
    return DisaggEmbedding(specs=SPECS, dim=DIM, num_shards=shards, mode=mode)


def lookups(shards: int, params: dict, idx: torch.Tensor, msk: torch.Tensor,
            mesh=None) -> dict:
    """Each mode's pooled lookup and the cached one, on ``params``' device
    (under a ``mesh``: this rank's block of each)."""
    out = {}
    with torch.no_grad():
        for mode in MODES:
            out[mode] = embedding(shards, mode).lookup(params, idx, msk, mesh=mesh,
                                                       batch_axes=BATCH_AXES)
        emb = embedding(shards)
        # the adaptive controller usually picks these ids: zipf-hot rows are the small ids
        cache = make_cache_from_table(emb, params, np.arange(HOT), HOT, mesh=mesh,
                                      device=params["table"].device)
        out["cached"] = emb.lookup(params, idx, msk, mesh=mesh, cache=cache,
                                   batch_axes=BATCH_AXES)
    return out


def mesh_rank(rank: int, world: int, params: dict, idx: torch.Tensor,
              msk: torch.Tensor) -> dict:
    """One rank of ``--ranks`` (spawned by ``launch.mesh.spawn``): its blocks
    of the lookups as host arrays, its coordinates and its kernel launches."""
    mesh = M.make_debug_mesh(2, world // 2)
    shards = mesh.shape["model"]
    specs = embedding(shards).param_specs(BATCH_AXES)
    local = {k: L.constrain(v, specs[k], mesh) for k, v in params.items()}
    before = lookup_launches()
    out = lookups(shards, local, L.constrain(idx, P(BATCH_AXES), mesh),
                  L.constrain(msk, P(BATCH_AXES), mesh), mesh)
    after = lookup_launches()
    return {"coords": dict(mesh.coords),
            "outputs": {k: v.cpu().numpy() for k, v in out.items()},
            "launches": {k: after[k] - before[k] for k in after}}


def init_params(device, shards: int = 1) -> dict:
    """The demo's seeded table on ``device``, laid out for ``shards`` servers."""
    dev = resolve_device(device)
    return embedding(shards).init(torch.Generator(device=dev).manual_seed(0), device=dev)


def run(device="cuda", ranks: int | None = None, params: dict | None = None) -> dict:
    """Print the quickstart's lines and return their values.  ``params``
    (``{"table": array}``, laid out for this run's shard count)
    replaces ``init_params``; ``ranks`` runs the lookups on that many gloo
    ranks."""
    dev = resolve_device(device)
    res: dict = {}
    if ranks:
        if ranks < 2 or ranks % 2:
            raise ValueError(f"--ranks takes an even count of at least 2, not {ranks}")
        shape = {"data": 2, "model": ranks // 2}
        print(f"mesh: {shape}")
        res["mesh"] = shape
        shards = shape["model"]
    else:
        print("single device -> one-device path (--ranks N for a mesh of N gloo ranks)")
        shards = 1

    emb = embedding(shards)
    params = init_params(dev, shards) if params is None else params_from_numpy(params, dev)
    batch = syn.recsys_batch(np.random.default_rng(0), SPECS, BATCH)
    idx = torch.from_numpy(batch["indices"]).to(dev)
    msk = torch.from_numpy(batch["mask"]).to(dev)

    if ranks:
        per_rank = M.spawn(mesh_rank, ranks, (params, idx, msk))
        # the output is split over data and whole over model: take model 0's blocks
        blocks = sorted((r["coords"]["data"], r["outputs"]) for r in per_rank
                        if r["coords"]["model"] == 0)
        pooled = {k: torch.from_numpy(np.concatenate([b[k] for _, b in blocks])).to(dev)
                  for k in blocks[0][1]}
        res["rank_launches"] = [r["launches"] for r in per_rank]
    else:
        pooled = lookups(shards, params, idx, msk)
    for mode in MODES:
        x = pooled[mode]
        res[mode] = {"shape": tuple(x.shape), "abs_mean": float(x.abs().mean())}
        print(f"{mode:13s}: pooled {tuple(x.shape)}, |x|={res[mode]['abs_mean']:.4f}")

    with torch.no_grad():
        plain = emb.lookup_reference(params, idx, msk)
    res["cached_max_err"] = float((pooled["cached"] - plain).abs().max())
    print("cached path max err vs oracle:", res["cached_max_err"])
    res["pooled"] = {k: v.cpu() for k, v in pooled.items()}

    # The paper's range routing table.
    tables = make_fused_tables(SPECS, DIM, max(shards, 4))
    res["routing_table"] = RangeRouter(tables).routing_table()[:4]
    print("routing table <(start,end) -> server>:")
    for rng_, srv in res["routing_table"]:
        print(f"  {rng_} -> server {srv}")

    # §3.2: the same lookup through the multi-threaded rdma engine pool —
    # host-DRAM embedding servers, per-thread queue pairs, work stealing.
    # Pooled outputs are bit-equal at every thread count; only the (virtual)
    # latency moves.
    table_np = params["table"].cpu().numpy()[: tables.total_rows]
    if len(table_np) < tables.total_rows:  # pad to the fused layout
        table_np = np.pad(table_np, ((0, tables.total_rows - len(table_np)), (0, 0)))
    idx_np, msk_np = batch["indices"], batch["mask"]
    by_threads, res["rdma"] = {}, {}
    for n_threads in (1, 4):
        svc = PooledLookupService(tables, table_np, num_threads=n_threads)
        try:
            by_threads[n_threads] = svc.lookup(idx_np, msk_np)
            s = svc.engine_summary()
        finally:
            svc.close()
        res["rdma"][n_threads] = {k: s[k] for k in ("p99_latency_us", "subrequests",
                                                    "virtual_steals")}
        print(
            f"rdma pool x{n_threads}: p99 lookup {s['p99_latency_us']:.1f}us "
            f"(virtual), {s['subrequests']} subrequests, "
            f"{s['virtual_steals']} steals"
        )
    res["pool_bit_equal"] = bool(np.array_equal(by_threads[1], by_threads[4]))
    print("engine-pool invariance (1 vs 4 threads): bit_equal =", res["pool_bit_equal"])

    # Cross-batch pipelining: lookup_async posts the subrequests and hands
    # back a future-like handle; post batch N+1 before waiting on batch N
    # and the pool overlaps the two (the serving loop's pipeline_depth).
    # The deferred merge is identical, so the bits never move.
    svc = PooledLookupService(tables, table_np, num_threads=4)
    try:
        h0 = svc.lookup_async(idx_np, msk_np)  # batch N posted...
        h1 = svc.lookup_async(idx_np, msk_np)  # ...N+1 posted before N waits
        overlapped = [h0.wait(), h1.wait()]
    finally:
        svc.close()
    res["pipelined_bit_equal"] = all(np.array_equal(o, by_threads[4]) for o in overlapped)
    print("pipelined lookup_async (2 in flight): bit_equal =", res["pipelined_bit_equal"])
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises with no GPU present) or cpu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="run the lookups on this many gloo ranks, mesh (data 2, "
                    "model ranks // 2)")
    args = ap.parse_args(argv)
    return run(args.device, args.ranks)


if __name__ == "__main__":
    main()
