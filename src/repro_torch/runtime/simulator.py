"""Discrete-event simulator of the multi-threaded RDMA lookup engine (§3.2).

Reproduces the paper's Fig 8(left) microbenchmark — naive multi-threaded RDMA
vs FlexEMR's mapping-aware engine — and the live-migration behaviour under
skew, on hardware this container does not have.  The model:

  * A ranker issues lookup *batches*; each batch fans out one subrequest per
    embedding server (the paper's fan-out pattern).
  * Each subrequest is posted by the engine (I/O thread) that owns its
    connection.  Posting occupies the engine for `t_post` AND requires the
    connection's RNIC *parallelism unit*: if the unit is currently held by a
    post from a DIFFERENT engine, the post serializes behind it and pays an
    extra `t_contention` (the cross-thread lock of Fig 6).
  * The server answers after `t_server + bytes * t_wire`.
  * A batch completes when its slowest subrequest completes (tail-sensitive,
    §3.2).  With `t_dense > 0` the completed batch then runs its dense
    stage, serialized on the single ranker thread; its pipeline slot frees
    only when the dense stage retires.  The closed loop keeps `inflight`
    batches outstanding — that is exactly the serving loop's
    `pipeline_depth`, so the same model prices cross-batch pipelining:
    engine/unit/wire state persists across batches, and at depth >= 2 the
    engines fetch batch N+1 while the ranker is dense-busy with batch N.
    `t_dense = 0` (default) recovers the pure lookup microbenchmark.

Calibration: t_post=1.0us, t_contention=0.35us (verbs lock handoff), t_server
=3us, 100 Gbps wire.  With 4 engines / 4 units / 16 servers this yields
~2.4-2.5x mapping-aware over naive — the paper's "up to 2.3x" regime
(Fig 8 left); the property test only pins the [1.5x, 4x] band so the claim
is robust to the constants.  ``calibrate_to_engine`` replaces the hand-picked
``t_post`` with one fitted to the per-thread utilization the repro_torch.rdma
engine pool actually measured, anchoring the sweeps to the engine we run.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass
class SimConfig:
    n_servers: int = 16
    n_engines: int = 4
    n_units: int = 4
    mapping_aware: bool = True
    migration: bool = False
    inflight: int = 8  # outstanding lookup batches == serving pipeline_depth
    n_batches: int = 2000
    # Ranker dense-NN stage per batch, serialized on the ranker thread; a
    # batch's pipeline slot frees when its dense stage retires.  0 = lookup
    # microbenchmark (no ranker stage modeled).
    t_dense: float = 0.0
    bytes_per_subrequest: float = 8192.0  # pooled partials (fig 4b)
    t_post: float = 1.0e-6
    t_contention: float = 0.35e-6  # calibrated: lands naive/aware at ~2.3-2.5x,
    t_server: float = 3.0e-6       # the paper's Fig-8(left) regime
    wire_bps: float = 100e9 / 8 * 1e0  # bytes/s on 100 Gbps
    skew_alpha: float = 0.0  # >0: zipf-skewed server popularity
    seed: int = 0
    migrate_every: float = 200e-6
    # repro_torch.hotcache tier in front of the wire: a hit-rate-h cache strips h of
    # every subrequest's rows (response bytes scale with the MISS rate), and a
    # subrequest whose rows ALL hit is never posted at all (no engine/unit
    # occupancy, no server visit) — that happens w.p. h^rows_per_subrequest.
    cache_hit_rate: float = 0.0
    rows_per_subrequest: int = 32
    # repro_torch.prefetch piggyback model (§3.1.2): every posted subrequest
    # carries `prefetch_budget_frac` extra response bytes of speculative
    # neighbor rows, of which `prefetch_accuracy` land in the cache before
    # their first reference, each then absorbing ~`prefetch_reuse` future
    # miss references (one spatial fetch buys a window of temporal reuse).
    # Accuracy ~0 is pure overhead; high accuracy converts the piggyback
    # bytes into a hit rate a demand-only cache of the same capacity cannot
    # reach in time.
    prefetch_accuracy: float = 0.0
    prefetch_budget_frac: float = 0.0
    prefetch_reuse: float = 4.0
    # §3.1.1 wire-dedup model: `dup_frac` is the duplicate fraction of a
    # batch's row references (1 - uniques/references, measured from the
    # workload); with `dedup_wire=True` the engine ships each distinct row
    # once, so every posted subrequest's response payload shrinks by the
    # duplicate share.  Duplicates make it onto the wire only in the miss
    # path, so the factor applies to the same (1 - hit_rate) term the cache
    # already scales.  Predicted byte reduction is 1 / (1 - dup_frac) — the
    # quantity compare_dedup checks against the engine's measured wire
    # counters (benchmarks/dedup_bench.py gates them within 10%).
    dup_frac: float = 0.0
    dedup_wire: bool = False
    # Segment-pushdown bytes model (near-memory bag reduction, the fig-4a
    # tentpole): `poolable_frac` is the share of a batch's post-dedup miss
    # entries covered by poolable per-(bag, shard) segments — exclusive ids,
    # segment length >= pushdown_min_rows, measured from the workload —
    # and `rows_per_segment` the mean rows each pooled segment collapses
    # into ONE [D] partial.  With `pushdown_wire=True` the poolable share
    # of every response shrinks by 1/rows_per_segment, so the predicted
    # response-byte reduction is
    #     1 / (1 - poolable_frac * (1 - 1/rows_per_segment))
    # — the quantity compare_pushdown checks against the engine pool's
    # measured wire_response_bytes (benchmarks/fig4_pooling_bytes.py gates
    # them within 10%).  Requests do NOT shrink: pushdown still posts every
    # scattered id, which is why the request direction gets its own price.
    poolable_frac: float = 0.0
    rows_per_segment: float = 8.0
    pushdown_wire: bool = False
    # Request-direction wire channel: each posted subrequest carries
    # `request_bytes_per_subrequest` of scattered-id-list / descriptor
    # payload, serialized on the QP ahead of the response at
    # `req_wire_bps` — the same two-term pricing as the verbs virtual
    # clock (VerbsTiming.req_wire_bps).
    request_bytes_per_subrequest: float = 0.0
    req_wire_bps: float = 100e9 / 8


class LookupSimulator:
    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # RNIC assigns units to connections round-robin at creation time.
        self.conn_unit = np.arange(cfg.n_servers) % cfg.n_units
        if cfg.mapping_aware:
            # FlexEMR: connections grouped by unit onto one engine — each
            # engine touches only its own units (Fig 6 right).
            self.conn_engine = self.conn_unit % cfg.n_engines
        else:
            # Naive: the application deals connections to threads in blocks
            # (ignorant of unit placement), so every engine posts into every
            # unit (Fig 6 left).
            block = max(1, cfg.n_servers // cfg.n_engines)
            self.conn_engine = np.minimum(
                np.arange(cfg.n_servers) // block, cfg.n_engines - 1
            )
        if cfg.skew_alpha > 0:
            w = (np.arange(cfg.n_servers) + 1.0) ** -cfg.skew_alpha
            self.server_weight = w / w.sum()
        else:
            self.server_weight = np.full(cfg.n_servers, 1.0 / cfg.n_servers)
        self.rng = rng

    def effective_hit_rate(self) -> float:
        """Demand hit rate plus the prefetch-converted share of the misses."""
        cfg = self.cfg
        gain = (
            cfg.prefetch_accuracy
            * min(1.0, cfg.prefetch_budget_frac * cfg.prefetch_reuse)
            * (1.0 - cfg.cache_hit_rate)
        )
        return min(1.0, cfg.cache_hit_rate + gain)

    def run(self) -> dict:
        cfg = self.cfg
        engine_free = np.zeros(cfg.n_engines)
        engine_busy = np.zeros(cfg.n_engines)  # summed post occupancy
        unit_free = np.zeros(cfg.n_units)
        # Who holds each unit *while it is busy*: a unit is released the
        # moment its post completes (unit_free), so ownership never goes
        # stale across batches — contention is paid only when a post from a
        # different engine arrives while the unit is actually held.
        unit_owner = np.full(cfg.n_units, -1)
        issued = 0
        events: list[tuple[float, int]] = []  # (time, batch_id) completions
        now = 0.0
        wire_bytes = 0.0  # response payload moved (the dedup A/B quantity)
        wire_request_bytes = 0.0  # scattered id lists / descriptors posted

        fanout = max(2, cfg.n_servers // 2)
        hit_rate = self.effective_hit_rate()
        if not 0.0 <= cfg.dup_frac < 1.0:
            raise ValueError("dup_frac must be in [0, 1)")
        if not 0.0 <= cfg.poolable_frac <= 1.0:
            raise ValueError("poolable_frac must be in [0, 1]")
        if cfg.rows_per_segment < 1.0:
            raise ValueError("rows_per_segment must be >= 1")
        # Wire dedup strips the duplicate share of every miss payload;
        # segment pushdown then collapses the poolable share of what
        # remains to one partial per segment (the two compose — dedup
        # owns the duplicates, pushdown the exclusive segments).
        pool_factor = (
            1.0 - cfg.poolable_frac * (1.0 - 1.0 / cfg.rows_per_segment)
            if cfg.pushdown_wire
            else 1.0
        )
        miss_frac = (
            (1.0 - hit_rate)
            * ((1.0 - cfg.dup_frac) if cfg.dedup_wire else 1.0)
            * pool_factor
        )

        def issue_batch(t_start: float) -> float:
            """Post one fan-out batch; returns completion time."""
            nonlocal engine_free, unit_free, unit_owner, wire_bytes, \
                wire_request_bytes
            # Each batch issues `fanout` subrequests drawn by popularity WITH
            # replacement — several subrequests of one lookup hitting the same
            # hot server is exactly the spatial locality / skew of §3.1-3.2.
            active = self.rng.choice(
                cfg.n_servers, size=fanout, replace=True, p=self.server_weight
            )
            if hit_rate > 0.0:
                # Fully-hit subrequests never leave the ranker.
                p_all_hit = hit_rate ** cfg.rows_per_subrequest
                active = active[self.rng.random(len(active)) >= p_all_hit]
            # Miss bytes shrink with the (prefetch-boosted) hit rate and —
            # under wire dedup — with the duplicate fraction; the
            # piggybacked neighbor rows ride every posted response.
            sub_bytes = cfg.bytes_per_subrequest * (
                miss_frac + cfg.prefetch_budget_frac
            )
            wire_bytes += sub_bytes * len(active)
            req_bytes = cfg.request_bytes_per_subrequest
            wire_request_bytes += req_bytes * len(active)
            # Even a fully-cached batch pays the ranker-local probe: floor
            # the completion at one t_post so hit_rate=1.0 yields a finite
            # (local-work-bound) throughput instead of a zero makespan.
            done_t = t_start + cfg.t_post
            for s in active:
                e = self.conn_engine[s]
                u = self.conn_unit[s]
                t = max(t_start, engine_free[e])
                post = cfg.t_post
                if t < unit_free[u]:
                    # Unit still held: serialize behind the holder, paying
                    # the cross-engine lock handoff if the holder differs
                    # (Fig 6 left).  A free unit carries no stale owner.
                    if unit_owner[u] != e:
                        post += cfg.t_contention
                    t = unit_free[u]
                unit_owner[u] = e
                t_done_post = t + post
                engine_free[e] = t_done_post
                engine_busy[e] += post
                unit_free[u] = t_done_post
                resp = (
                    t_done_post
                    + cfg.t_server
                    + req_bytes / cfg.req_wire_bps
                    + sub_bytes / cfg.wire_bps
                )
                done_t = max(done_t, resp)
            return done_t

        # Closed loop with `inflight` outstanding batches.
        for _ in range(min(cfg.inflight, cfg.n_batches)):
            c = issue_batch(now)
            heapq.heappush(events, (c, issued))
            issued += 1
        completed = 0
        last_migrate = 0.0
        ranker_free = 0.0  # single ranker thread: dense stages serialize
        while events:
            t_done, bid = heapq.heappop(events)
            completed += 1
            if cfg.t_dense > 0.0:
                # Retire = lookup completion + this batch's dense stage on
                # the (serialized) ranker; the freed slot admits the next
                # batch — the engines already worked through the dense gap.
                ranker_free = max(t_done, ranker_free) + cfg.t_dense
                now = ranker_free
            else:
                now = t_done
            if cfg.migration and now - last_migrate > cfg.migrate_every:
                self._migrate()
                last_migrate = now
            if issued < cfg.n_batches:
                c = issue_batch(now)
                heapq.heappush(events, (c, issued))
                issued += 1
        makespan = max(now, ranker_free)
        utilization = engine_busy / max(makespan, 1e-12)
        return {
            "throughput_batches_per_s": cfg.n_batches / makespan,
            "makespan_s": makespan,
            "effective_hit_rate": hit_rate,
            "wire_bytes": wire_bytes,
            "wire_request_bytes": wire_request_bytes,
            "engine_busy_s": engine_busy.tolist(),
            "engine_utilization": utilization.tolist(),
        }

    def _migrate(self):
        """Move the hottest connection to the least-loaded engine, adopting
        that engine's unit (mapping-aware re-association)."""
        loads = np.zeros(self.cfg.n_engines)
        for s in range(self.cfg.n_servers):
            loads[self.conn_engine[s]] += self.server_weight[s]
        hot_engine = int(np.argmax(loads))
        cold_engine = int(np.argmin(loads))
        conns = [s for s in range(self.cfg.n_servers)
                 if self.conn_engine[s] == hot_engine]
        if not conns:
            return
        hot_conn = max(conns, key=lambda s: self.server_weight[s])
        self.conn_engine[hot_conn] = cold_engine
        if self.cfg.mapping_aware:
            # Re-associate with the destination engine's resource domain,
            # picking its least-subscribed unit (paper: detach + attach).
            dst_units = [self.conn_unit[s] for s in range(self.cfg.n_servers)
                         if self.conn_engine[s] == cold_engine and s != hot_conn]
            engine_units = [
                u for u in range(self.cfg.n_units)
                if u % self.cfg.n_engines == cold_engine
            ]
            candidates = engine_units or sorted(set(dst_units))
            if candidates:
                counts = {u: dst_units.count(u) for u in candidates}
                self.conn_unit[hot_conn] = min(candidates, key=lambda u: counts.get(u, 0))


def calibrate_to_engine(
    measured_utilization,
    n_batches: int = 300,
    t_post_bounds: tuple[float, float] = (0.05e-6, 20e-6),
    tol: float = 0.02,
    max_iters: int = 16,
    **overrides,
) -> dict:
    """Calibrate the contention model against the real engine pool (§3.2).

    ``measured_utilization`` is ``RdmaEnginePool.utilization()`` — the
    per-thread posting occupancy the repro_torch.rdma engine measured on its
    (deterministic) verbs timing layer.  The simulator's utilization is
    monotone in ``t_post`` (posting cost vs wire/server time), so a
    geometric bisection on ``t_post`` finds the constant at which the
    simulator's mean per-engine utilization reproduces the engine's — after
    which its naive-vs-aware and migration sweeps extrapolate from a model
    anchored to the engine we actually run, not to hand-picked constants.

    Returns ``{"t_post", "target_utilization", "achieved_utilization",
    "iterations", "cfg"}``; pass engine-pool geometry (``n_engines``,
    ``n_units``, ...) through ``**overrides``.
    """
    target = float(np.mean(np.asarray(measured_utilization, np.float64)))
    target = float(np.clip(target, 1e-3, 0.98))
    lo, hi = t_post_bounds

    def mean_util(t_post: float) -> tuple[float, SimConfig]:
        cfg = SimConfig(t_post=t_post, n_batches=n_batches, **overrides)
        out = LookupSimulator(cfg).run()
        return float(np.mean(out["engine_utilization"])), cfg

    best: dict = {}
    for i in range(max_iters):
        mid = (lo * hi) ** 0.5
        util, cfg = mean_util(mid)
        err = util - target
        if not best or abs(err) < abs(best["achieved_utilization"] - target):
            best = {
                "t_post": mid,
                "target_utilization": target,
                "achieved_utilization": util,
                "iterations": i + 1,
                "cfg": cfg,
            }
        if abs(err) <= tol:
            break
        if util < target:
            lo = mid
        else:
            hi = mid
    return best


def compare_engines(**overrides) -> dict:
    """Fig 8(left): naive vs mapping-aware multi-threaded lookup."""
    out = {}
    for name, aware in (("naive", False), ("flexemr", True)):
        cfg = SimConfig(mapping_aware=aware, **overrides)
        out[name] = LookupSimulator(cfg).run()
    out["speedup"] = (
        out["flexemr"]["throughput_batches_per_s"]
        / out["naive"]["throughput_batches_per_s"]
    )
    return out


def compare_hit_rates(
    hit_rates=(0.0, 0.25, 0.5, 0.75, 0.9), **overrides
) -> dict:
    """Hotcache sweep: throughput vs cache hit rate (Fig-7/8-style axis).

    Byte-heavy regimes (pooling disabled / large dim) shift the bottleneck to
    the wire, which is exactly where the hit-rate term bites."""
    rates = sorted(float(h) for h in hit_rates)
    out = {}
    for h in rates:
        cfg = SimConfig(cache_hit_rate=h, **overrides)
        out[h] = LookupSimulator(cfg).run()
    out["speedup_at_max_hit"] = (
        out[rates[-1]]["throughput_batches_per_s"]
        / out[rates[0]]["throughput_batches_per_s"]
    )
    return out


def compare_prefetch(
    accuracies=(0.0, 0.25, 0.5, 0.75, 0.95),
    budget_frac: float = 0.25,
    cache_hit_rate: float = 0.5,
    **overrides,
) -> dict:
    """§3.1.2 sweep: throughput vs prefetch accuracy at a fixed piggyback
    budget, against the demand-only cache baseline.

    The piggyback bytes are pure overhead at accuracy 0 and convert misses
    into hits as accuracy rises; in the wire-bound regime the crossover is
    where speculation starts paying for its own bytes.
    """
    base_cfg = SimConfig(cache_hit_rate=cache_hit_rate, **overrides)
    out: dict = {"baseline": LookupSimulator(base_cfg).run()}
    accs = sorted(float(a) for a in accuracies)
    for a in accs:
        cfg = SimConfig(
            cache_hit_rate=cache_hit_rate,
            prefetch_accuracy=a,
            prefetch_budget_frac=budget_frac,
            **overrides,
        )
        out[a] = LookupSimulator(cfg).run()
    base = out["baseline"]["throughput_batches_per_s"]
    out["speedup_at_best_accuracy"] = (
        out[accs[-1]]["throughput_batches_per_s"] / base
    )
    out["overhead_at_zero_accuracy"] = (
        out[accs[0]]["throughput_batches_per_s"] / base
        if accs[0] == 0.0
        else float("nan")
    )
    return out


def compare_dedup(dup_frac: float = 0.5, **overrides) -> dict:
    """§3.1.1 wire-dedup sweep: duplicated vs unique-row transfers at a
    measured duplicate fraction.

    ``dup_frac`` is the workload's duplicate share of row references
    (``1 - uniques / references`` — benchmarks/dedup_bench.py measures it
    from the actual zipf stream and feeds it here).  Returns the two run
    dicts plus:

    * ``byte_reduction`` — wire bytes moved without dedup / with dedup;
      by construction of the model this is ``1 / (1 - dup_frac)``, the
      prediction the bench gates against the engine pool's measured
      ``wire_response_bytes`` counters (within 10%);
    * ``throughput_speedup`` — dedup-on over dedup-off batch throughput in
      the wire-bound regime (smaller payloads serialize faster on the QP
      wires; the real engine additionally saves per-WR posting, which the
      bench measures directly from the verbs layer).
    """
    out = {}
    for name, on in (("duplicated", False), ("dedup", True)):
        cfg = SimConfig(dup_frac=dup_frac, dedup_wire=on, **overrides)
        out[name] = LookupSimulator(cfg).run()
    out["byte_reduction"] = (
        out["duplicated"]["wire_bytes"] / max(1e-9, out["dedup"]["wire_bytes"])
    )
    out["throughput_speedup"] = (
        out["dedup"]["throughput_batches_per_s"]
        / out["duplicated"]["throughput_batches_per_s"]
    )
    return out


def compare_pushdown(
    poolable_frac: float = 0.7,
    rows_per_segment: float = 8.0,
    **overrides,
) -> dict:
    """Segment-pushdown sweep: gather+pool vs near-memory bag reduction.

    ``poolable_frac`` and ``rows_per_segment`` are measured from the real
    engine's pooled-WR counters (``pooled_rows`` over post-dedup entries,
    ``pooled_rows / pooled_segments`` — benchmarks/fig4_pooling_bytes.py
    feeds both from the serving A/B).  Returns the two run dicts plus:

    * ``byte_reduction`` — response wire bytes without pushdown / with; by
      construction of the model this is
      ``1 / (1 - poolable_frac * (1 - 1/rows_per_segment))``, the
      prediction the bench gates against the engine pool's measured
      ``wire_response_bytes`` (within 10%);
    * ``request_fraction`` — request-direction bytes over response bytes
      with pushdown ON: the channel that becomes the next bottleneck as
      responses shrink (pushdown leaves requests untouched);
    * ``throughput_speedup`` — pushdown-on over pushdown-off batch
      throughput in the wire-bound regime.
    """
    out = {}
    for name, on in (("gather", False), ("pushdown", True)):
        cfg = SimConfig(
            poolable_frac=poolable_frac,
            rows_per_segment=rows_per_segment,
            pushdown_wire=on,
            **overrides,
        )
        out[name] = LookupSimulator(cfg).run()
    out["byte_reduction"] = (
        out["gather"]["wire_bytes"] / max(1e-9, out["pushdown"]["wire_bytes"])
    )
    out["request_fraction"] = (
        out["pushdown"]["wire_request_bytes"]
        / max(1e-9, out["pushdown"]["wire_bytes"])
    )
    out["throughput_speedup"] = (
        out["pushdown"]["throughput_batches_per_s"]
        / out["gather"]["throughput_batches_per_s"]
    )
    return out


def compare_pipeline(
    depths=(1, 2, 4), t_dense: float = 30e-6, **overrides
) -> dict:
    """Cross-batch pipelining sweep: serving throughput vs pipeline depth.

    ``inflight`` (the model's outstanding-batch count) IS the serving
    loop's ``pipeline_depth``: at depth 1 the ranker's dense stage
    (``t_dense``) strictly alternates with the lookup fan-out; at depth 2+
    the engines fetch batch N+1's misses while the ranker is dense-busy
    with batch N.  Returns the per-depth run dicts plus ``speedup`` (widest
    depth over depth min) and ``overlap_utilization_gain`` (mean engine
    utilization recovered by pipelining) — the quantities the pipeline
    bench compares against the real engine pool's measured utilization.
    """
    ds = sorted(int(d) for d in depths)
    out: dict = {}
    for d in ds:
        cfg = SimConfig(inflight=d, t_dense=t_dense, **overrides)
        out[d] = LookupSimulator(cfg).run()
    out["speedup"] = (
        out[ds[-1]]["throughput_batches_per_s"]
        / out[ds[0]]["throughput_batches_per_s"]
    )
    out["overlap_utilization_gain"] = float(
        np.mean(out[ds[-1]]["engine_utilization"])
        - np.mean(out[ds[0]]["engine_utilization"])
    )
    return out


def compare_migration(skew_alpha: float = 1.2, **overrides) -> dict:
    """Skewed load with/without live connection migration."""
    out = {}
    for name, mig in (("static", False), ("migrated", True)):
        cfg = SimConfig(
            mapping_aware=True, migration=mig, skew_alpha=skew_alpha, **overrides
        )
        out[name] = LookupSimulator(cfg).run()
    out["speedup"] = (
        out["migrated"]["throughput_batches_per_s"]
        / out["static"]["throughput_batches_per_s"]
    )
    return out
