"""Disaggregated serving driver: replay a diurnal trace through FlexEMRServer.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 2000

Port of ``repro/launch/serve.py``.  The dense stage runs on ``--device``
(default ``cuda``; ``cpu`` runs everything on the host, and ``cuda`` with no
GPU present raises); the embedding tier stays in host DRAM behind the §3.2
rdma engine pool (``--engine legacy`` for the pre-pool per-connection
threads) with pooling pushdown, cross-batch pipelining (``--pipeline-depth``,
default 2: batch N+1's lookup is posted before batch N's dense stage; 1
restores the closed loop), the adaptive cache controller resizing against
the load trace, and pool-hedged stragglers.  The summary includes the pool's
virtual p50/p99, utilization, steal and hedge counts under ``rdma_engine``.

Observability (docs/OBSERVABILITY.md): ``--trace out.json`` records every
batch's journey as Chrome-trace JSON; ``--metrics-out metrics.json`` saves
the unified registry snapshot.

Load injection (``--arrival``): the default ``closed`` mode replays the
diurnal trace in lockstep — the client waits for the server, so queueing
delay is invisible.  ``--arrival poisson --qps 2000 --duration 10`` drives
the server open-loop with seeded Poisson arrivals at the offered rate
(requests are stamped with their intended arrival time, so queue wait is
charged to latency even when the server falls behind); ``--arrival trace
--qps-trace sched.json`` replays a piecewise-linear QPS schedule (JSON list
of ``[t_seconds, qps]`` breakpoints).  All modes attach an ``SloMonitor``
(``--slo-target-ms``, optional ``--deadline-ms``) and print its summary —
good fraction, burn rates, goodput vs raw throughput, alert count — at
exit under the ``slo.`` registry namespace.

Fault injection (``--chaos-seed``, ``--chaos-faults``, ``--reshard-to``):
a seeded ``chaos.FaultSchedule`` kills an engine thread, drops and restores
a shard, slows the pool with a straggler storm, and live-reshards the
embedding tier under traffic; ``out["chaos"]`` reports what fired.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core.adaptive_cache import (
    AdaptiveCacheController,
    MemoryModel,
)
from repro_torch.core.sharding import TableSpec, make_fused_tables
from repro_torch.data import synthetic as syn
from repro_torch.loadgen import (
    OpenLoopDriver,
    OpenLoopGenerator,
    RecsysPayloadFactory,
    constant,
)
from repro_torch.loadgen import trace as qps_schedule_trace
from repro_torch.models import recsys as R
from repro_torch.obs import SloMonitor, SloObjective, Tracer, get_registry
from repro_torch.runtime.admission import AdmissionController, ShedError
from repro_torch.runtime.serving import FlexEMRServer
from repro_torch.utils import logger


def make_serving_dlrm(scale: float = 1.0) -> R.RecsysConfig:
    tables = (
        [TableSpec(f"big_{i}", int(200_000 * scale), nnz=4) for i in range(2)]
        + [TableSpec(f"mid_{i}", int(50_000 * scale), nnz=1) for i in range(6)]
        + [TableSpec(f"small_{i}", 2_000, nnz=1) for i in range(8)]
    )
    return R.RecsysConfig(
        name="dlrm-serve",
        arch="dlrm",
        tables=tuple(tables),
        embed_dim=64,
        n_dense=13,
        bottom_mlp=(256, 64),
        mlp=(256, 128),
    )


def _build_chaos(args, tables, tracer):
    """--chaos-seed / --reshard-to -> a bound-ready ChaosInjector (or None)."""
    chaos_seed, reshard_to = args.chaos_seed, args.reshard_to
    if chaos_seed is None and reshard_to is None:
        return None
    from repro_torch.chaos import (
        FAULT_RESHARD,
        ChaosInjector,
        FaultSchedule,
        FaultSpec,
    )

    # Triggers are admitted-batch counts; approximate the batch budget from
    # the request budget and the mean diurnal burst (~32 requests/batch —
    # the batcher cuts variable buckets, so this only shapes *where* in
    # the run faults land; the exit summary reports what actually fired).
    n_batches = max(4, args.requests // 32)
    faults = ()
    if chaos_seed is not None:
        faults = FaultSchedule.generate(
            chaos_seed, num_batches=n_batches,
            num_engines=args.num_engines,
            num_shards=tables.num_shards,
            n_faults=args.chaos_faults,
        ).faults
    if reshard_to is not None:
        faults = faults + (FaultSpec(
            FAULT_RESHARD, at_batch=max(1, n_batches // 2),
            target=reshard_to,
        ),)
    schedule = FaultSchedule(
        faults=tuple(sorted(faults, key=lambda f: f.at_batch)),
        seed=chaos_seed if chaos_seed is not None else 0,
    )
    logger.info(
        "chaos armed: %d faults over ~%d batches (%s)",
        len(schedule.faults), n_batches,
        ", ".join(f"{f.kind}@{f.at_batch}" for f in schedule.faults),
    )
    return ChaosInjector(schedule, tracer=tracer)


def run(args) -> dict:
    cfg = make_serving_dlrm(args.scale)
    rng = np.random.default_rng(args.seed)
    params = R.init_params(cfg, args.seed, device=args.device)
    tables = make_fused_tables(cfg.tables, cfg.embed_dim, args.num_servers)
    controller = AdaptiveCacheController(
        cfg.tables,
        cfg.embed_dim,
        MemoryModel(
            fixed_bytes=2 << 28, bytes_per_sample=1 << 14, hbm_bytes=1 << 30
        ),
        max_rows=args.cache_rows,
        field_replication=False,
    )
    tracer = Tracer() if args.trace else None
    registry = get_registry()
    slo = SloMonitor(SloObjective(
        latency_target_s=1e-3 * args.slo_target_ms,
    ))
    chaos = _build_chaos(args, tables, tracer)
    admission = (
        AdmissionController(max_queue=args.admission_queue)
        if args.admission else None
    )
    retry_policy = None
    if args.retry_budget is not None:
        from repro_torch.rdma.verbs import RetryPolicy

        retry_policy = RetryPolicy(
            budget_frac=args.retry_budget, seed=args.seed
        )
    server = FlexEMRServer(
        cfg, params, tables, controller=controller,
        num_engines=args.num_engines, pushdown=not args.no_pushdown,
        engine=args.engine, pipeline_depth=args.pipeline_depth,
        dedup=not args.no_dedup,
        tracer=tracer, registry=registry, slo=slo, chaos=chaos,
        admission=admission, retry_policy=retry_policy,
        degrade_policy=args.degrade_policy, device=args.device,
    )
    deadline_s = (
        1e-3 * args.deadline_ms if args.deadline_ms is not None else None
    )
    try:
        t0 = time.time()
        nonfinite = 0  # retired scores that are NaN or Inf

        def count_nonfinite(res):
            nonlocal nonfinite
            nonfinite += int((~np.isfinite(res["scores"])).sum())

        if args.arrival == "closed":
            sizes = syn.diurnal_batches(
                rng, args.requests // 8, base=8, peak=64
            )
            submitted = 0
            for burst in sizes:
                if submitted >= args.requests:
                    break
                for _ in range(int(burst)):
                    if submitted >= args.requests:
                        break
                    b = syn.recsys_batch(
                        rng, cfg.tables, 1, n_dense=cfg.n_dense
                    )
                    try:
                        server.submit(
                            {
                                "indices": b["indices"][0],
                                "mask": b["mask"][0],
                                "dense": b["dense"][0],
                            },
                            deadline_s=deadline_s,
                        )
                    except ShedError:
                        continue  # counted under serve.admission.*
                    submitted += 1
                while (res := server.step()) is not None:
                    count_nonfinite(res)
            while server.metrics.requests < submitted:
                if (res := server.step()) is None:
                    time.sleep(0.001)
                else:
                    count_nonfinite(res)
            driver_stats = None
        else:
            if args.arrival == "trace":
                if not args.qps_trace:
                    raise SystemExit(
                        "--arrival trace requires --qps-trace PATH"
                    )
                with open(args.qps_trace) as f:
                    pts = [(float(t), float(q)) for t, q in json.load(f)]
                schedule = qps_schedule_trace(pts)
            else:  # poisson
                schedule = constant(args.qps, args.duration)
            gen = OpenLoopGenerator(
                schedule,
                RecsysPayloadFactory(cfg.tables, cfg.n_dense),
                seed=args.seed,
                deadline_s=deadline_s,
            )
            events = gen.events()
            logger.info(
                "open-loop %s: %d arrivals over %.1fs (peak %.0f qps)",
                args.arrival, len(events), schedule.duration, schedule.peak,
            )
            driver_stats = OpenLoopDriver().run(
                server, events, on_output=count_nonfinite
            )
            submitted = driver_stats["submitted"] - driver_stats["shed"]
        wall = time.time() - t0
        out = server.metrics.summary()
        out["submitted"] = submitted
        out["nonfinite_scores"] = nonfinite
        out["throughput_rps"] = submitted / wall
        out["device"] = str(server.device)
        if driver_stats is not None:
            out["loadgen"] = driver_stats
        out["slo"] = slo.summary()
        if chaos is not None:
            out["chaos"] = chaos.summary()
        # Overload response: what was shed at the door, what retired as a
        # brownout partial, and what the retry ladder spent.
        if admission is not None:
            out["admission"] = server._admission_summary()
        out["degraded"] = server._degraded_summary()
        if retry_policy is not None:
            out["retry"] = server.service.retry_summary()
        eng = server.engine_summary()
        if eng is not None:
            out["rdma_engine"] = eng
            # Pushdown byte split: response vs request direction, and how
            # much of the response traffic the near-memory reduction pooled
            # away (segments pooled * rows collapsed per segment).
            resp = eng.get("wire_response_bytes", 0)
            out["pushdown"] = {
                "segment_pushdown": eng.get("segment_pushdown", False),
                "pooled_segment_wrs": eng.get("pooled_segment_wrs", 0),
                "pooled_segments": eng.get("pooled_segments", 0),
                "pooled_rows": eng.get("pooled_rows", 0),
                "wire_response_bytes": resp,
                "wire_request_bytes": eng.get("wire_request_bytes", 0),
                "request_frac": (
                    eng.get("wire_request_bytes", 0) / resp if resp else 0.0
                ),
            }
        logger.info("serve summary: %s", json.dumps(out, indent=1))
        if tracer is not None:
            tracer.save(args.trace)
            logger.info(
                "trace: %d events -> %s (open in https://ui.perfetto.dev)",
                len(tracer), args.trace,
            )
        if args.metrics_out:
            registry.save(args.metrics_out)
            logger.info("metrics snapshot -> %s", args.metrics_out)
        return out
    finally:
        server.close()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the dense stage runs (cuda | cpu); cuda "
                    "with no GPU present raises")
    ap.add_argument("--requests", type=int, default=1000)
    ap.add_argument("--num-servers", type=int, default=8)
    ap.add_argument("--num-engines", type=int, default=4,
                    help="engine-pool threads (pooled) / I/O threads (legacy)")
    ap.add_argument("--engine", choices=("pooled", "legacy"), default="pooled",
                    help="§3.2 rdma engine pool (default) or the legacy "
                    "per-connection RdmaEngine threads")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="batches in flight: N+1's lookup posts before N's "
                    "dense stage runs (1 = closed loop, no overlap)")
    ap.add_argument("--cache-rows", type=int, default=65536)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--no-pushdown", action="store_true",
                    help="disable pooling pushdown (near-memory segment "
                    "reduction on the miss path); lookups ship raw rows "
                    "and pool ranker-side — outputs are bit-equal either "
                    "way")
    ap.add_argument("--no-dedup", action="store_true",
                    help="disable the §3.1.1 wire dedup (unique-row "
                    "subrequests + in-flight coalescing + range WRs); "
                    "outputs are bit-equal either way")
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="record per-batch spans + per-WR events and save "
                    "Chrome-trace JSON here (Perfetto-loadable; see "
                    "docs/OBSERVABILITY.md)")
    ap.add_argument("--metrics-out", type=str, default=None, metavar="PATH",
                    help="save the unified metrics-registry snapshot "
                    "(flat dotted-name JSON) here at exit")
    ap.add_argument("--arrival", choices=("closed", "poisson", "trace"),
                    default="closed",
                    help="closed (default): lockstep diurnal replay; "
                    "poisson: open-loop seeded Poisson arrivals at --qps "
                    "for --duration; trace: open-loop replay of the "
                    "--qps-trace schedule")
    ap.add_argument("--qps", type=float, default=1000.0,
                    help="offered rate for --arrival poisson (req/s)")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="open-loop run length in seconds "
                    "(--arrival poisson)")
    ap.add_argument("--qps-trace", type=str, default=None, metavar="PATH",
                    help="JSON list of [t_seconds, qps] breakpoints for "
                    "--arrival trace (piecewise-linear)")
    ap.add_argument("--slo-target-ms", type=float, default=50.0,
                    help="latency objective for the SLO monitor; its "
                    "summary (good fraction, burn rates, goodput, alerts) "
                    "prints at exit")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="stamp every request with this deadline; goodput "
                    "then counts deadline-met completions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="inject a seeded fault schedule (engine kill, "
                    "shard drop + cache-tier re-replication, straggler "
                    "storm, live reshard) during the run; the chaos "
                    "summary prints at exit.  Pooled engine only")
    ap.add_argument("--chaos-faults", type=int, default=4,
                    help="number of faults FaultSchedule.generate draws "
                    "for --chaos-seed")
    ap.add_argument("--reshard-to", type=int, default=None, metavar="N",
                    help="live-reshard the embedding tier to N shards "
                    "mid-run (quiesce-free, under traffic); composes "
                    "with --chaos-seed")
    ap.add_argument("--admission", action="store_true",
                    help="deadline-aware admission control: shed requests "
                    "whose deadline is expired or unmeetable, bound the "
                    "submit queue, and adapt the pipeline depth under "
                    "sustained SLO alerts (serve.admission.* at exit)")
    ap.add_argument("--admission-queue", type=int, default=256,
                    help="bounded submit-queue size for --admission")
    ap.add_argument("--retry-budget", type=float, default=None,
                    metavar="FRAC",
                    help="arm the per-WR retry/timeout/backoff ladder with "
                    "this retry budget (fraction of primary WRs; hedges "
                    "charge it too).  Bit-equal to off when no fault "
                    "fires.  Pooled engine only")
    ap.add_argument("--degrade-policy", default="strict",
                    choices=("strict", "degrade", "block"),
                    help="dropped-shard cold-row policy: strict parks "
                    "until restore (default), degrade answers the cache "
                    "tier's best partial and flags the request, block "
                    "fails fast.  Pooled engine only")
    return ap.parse_args(argv)


def main():
    run(parse_args())


if __name__ == "__main__":
    main()
