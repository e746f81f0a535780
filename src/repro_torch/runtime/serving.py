"""FlexEMR serving runtime: the ranker-side loop tying every §3 mechanism
together at host level.  Port of ``repro/runtime/serving.py``: the host side
(batcher, tier, engine pool, controller, admission, prefetcher, metrics)
is the reference's, and the dense stage runs in torch on ``device`` — on the
card its dot interaction is kernel K2, and a prefetcher whose miner runs on
the card selects neighbors with kernel K5.

  request queue (BucketBatcher)      — the task queue of Fig 5
  SlidingWindowLoadMonitor           — §3.1.1 temporal-dynamics tracing
  AdaptiveCacheController            — §3.1.1 cache sizing (+field replication)
  PrefetchEngine (optional)          — §3.1.2 co-occurrence piggyback on the
                                       plan swap-in
  PooledLookupService                — §3.2 multi-threaded rdma engine pool
                                       (engine="legacy" keeps the old
                                       per-connection HostLookupService)
  wire dedup (§3.1.1)                — `dedup=True`: miss subrequests carry
                                       unique rows only, a pipelined batch
                                       borrows rows already in flight for
                                       its predecessor, and sort-adjacent
                                       ids fold into range-read WRs
  cross-batch pipeline               — §3.2 follow-on: up to `pipeline_depth`
                                       batches in flight; batch N+1's cache
                                       probe + miss posting overlaps batch
                                       N's remote fetch and dense stage
  hedged subrequests                 — straggler mitigation: a lookup still
                                       unfinished after `hedge_timeout` is
                                       re-issued as duplicate subrequests on
                                       other engine threads through the pool
                                       (cancel-the-loser); the legacy engine
                                       keeps the ranker-side re-execution
  dense model (torch on `device`)    — the "ranker GPU" stage

The pipeline is an explicit admit/retire loop: ``step`` first *admits*
batches (pad + tiered ``lookup_begin``) until ``pipeline_depth`` are in
flight, then *retires* the oldest (wait on its miss handle, dense stage,
metrics, controller).  Depth 1 is the closed-loop pre-pipeline behaviour.
Outputs are bit-equal at any depth and with hedging on or off: the tier
merges in float64 over exactly-representable f32 rows and the pool merges
in subrequest issue order, so *when* bytes move never changes *what* scores
come back.

The same class drives ``python -m repro_torch.launch.serve``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.adaptive_cache import AdaptiveCacheController
from repro_torch.core.lookup_engine import HostLookupService
from repro_torch.core.sharding import FusedTables
from repro_torch.data.pipeline import BucketBatcher
from repro_torch.hotcache.miss_path import HostHashCache, TieredLookupService
from repro_torch.models import recsys as R
from repro_torch.obs.metrics import Histogram, get_registry
from repro_torch.obs.trace import (
    CAT_ADMISSION,
    CAT_DENSE,
    CAT_LOOKUP,
    CAT_SERVE,
    NULL_TRACER,
    TID_RANKER,
)
from repro_torch.rdma.service import PooledLookupService
from repro_torch.runtime.admission import AdmissionController, ShedError
from repro_torch.utils import logger, resolve_device, tree_to


# Per-request latency decomposition stages (serve.attr.* — see
# docs/OBSERVABILITY.md).  Batch-level stages; every request in a batch
# experiences all of them, plus its own queue wait (serve.queue_wait):
#   admit_other    pad/bookkeeping inside the admit phase not covered below
#   probe          cache probe + hit pooling (tier lookup_begin, first half)
#   post           miss posting + byte accounting (lookup_begin, second half)
#   pipeline_wait  admitted, sitting in the pipeline behind older batches
#   wire_stall     ranker blocked on the miss handle (wire + engine time)
#   merge          post-wire merge work (pool scatter + tier f64 merge)
#   dense          the ranker stage (torch on the server's device)
#   retire_other   retire-path bookkeeping outside the dense stage
ATTR_STAGES = (
    "admit_other", "probe", "post", "pipeline_wait",
    "wire_stall", "merge", "dense", "retire_other",
)


@dataclasses.dataclass
class ServeMetrics:
    batches: int = 0
    requests: int = 0
    cache_hits: int = 0
    lookups: int = 0
    hedges: int = 0  # batches whose miss lookup was hedged
    lookup_seconds: float = 0.0  # time the ranker thread STALLED on lookups
    dense_seconds: float = 0.0
    bytes_no_cache: int = 0  # wire bytes a cache-less deployment would move
    bytes_network: int = 0  # wire bytes actually moved (misses only)
    bytes_request: int = 0  # request-direction wire bytes (scattered id
    # lists + range descriptors) — pushdown shrinks responses, making this
    # the next bottleneck worth watching
    bytes_swap_in: int = 0  # hotcache refresh fetches
    bytes_prefetch: int = 0  # §3.1.2 piggybacked speculative fetches
    prefetch_issued: int = 0  # rows fetched speculatively
    prefetch_hits: int = 0  # hits served by prefetched-before-first-touch rows
    prefetch_evicted: int = 0  # speculative rows evicted before any hit
    # Bounded-memory request-latency distribution (obs.metrics.Histogram):
    # exact + interpolated through the warmup window, P² streaming after —
    # a server can run forever without this growing, and small-sample p99
    # interpolates instead of floor-indexing into the sorted list.
    latency_hist: Histogram = dataclasses.field(default_factory=Histogram)
    # Per-request time spent queued before admit (arrival -> admit start).
    queue_wait_hist: Histogram = dataclasses.field(default_factory=Histogram)
    # Admitted-but-unretired batches right now (serve.pipeline.occupancy):
    # occupancy pinned at pipeline_depth = overload; low occupancy with a
    # high wire_stall = slow lookups.  The two regimes look identical in
    # the latency histogram alone.
    pipeline_occupancy: int = 0
    # serve.attr.*: per-batch stage histograms + the exact-tiling check
    # accumulators (attributed seconds vs end-to-end seconds, request-
    # weighted; loadgen_bench gates |1 - coverage| <= 1%).
    attr_hists: dict = dataclasses.field(
        default_factory=lambda: {s: Histogram() for s in ATTR_STAGES}
    )
    attr_attributed_s: float = 0.0
    attr_e2e_s: float = 0.0

    @property
    def bytes_saved(self) -> int:
        return (
            self.bytes_no_cache
            - self.bytes_network
            - self.bytes_swap_in
            - self.bytes_prefetch
        )

    def observe_latency(self, seconds: float) -> None:
        self.latency_hist.add(seconds)

    def observe_attribution(self, stages: dict, queue_waits,
                            e2e_sum_s: float) -> None:
        """One retired batch's stage decomposition (ATTR_STAGES seconds) +
        its requests' queue waits; ``e2e_sum_s`` is the batch's summed
        end-to-end request latency, against which the attributed total is
        coverage-checked.  The tiling is exact by construction: each
        request's latency = its queue wait + the batch stages' sum."""
        for s, v in stages.items():
            self.attr_hists[s].add(v)
        batch_s = 0.0
        for v in stages.values():
            batch_s += v
        q_sum = 0.0
        for w in queue_waits:
            self.queue_wait_hist.add(w)
            q_sum += w
        self.attr_attributed_s += q_sum + batch_s * len(queue_waits)
        self.attr_e2e_s += e2e_sum_s

    def summary(self) -> dict:
        lat = self.latency_hist
        return {
            "batches": self.batches,
            "requests": self.requests,
            "hit_rate": self.cache_hits / max(1, self.lookups),
            "hedges": self.hedges,
            "mean_latency_ms": 1e3 * lat.mean,
            "p50_latency_ms": 1e3 * lat.quantile(0.5),
            "p99_latency_ms": 1e3 * lat.quantile(0.99),
            "lookup_seconds": self.lookup_seconds,
            "dense_seconds": self.dense_seconds,
            "network_bytes": self.bytes_network,
            "bytes_request": self.bytes_request,
            "bytes_no_cache": self.bytes_no_cache,
            "bytes_swap_in": self.bytes_swap_in,
            "bytes_prefetch": self.bytes_prefetch,
            "bytes_saved": self.bytes_saved,
            "bytes_saved_frac": self.bytes_saved / max(1, self.bytes_no_cache),
            "prefetch_issued": self.prefetch_issued,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_evicted": self.prefetch_evicted,
            "prefetch_useful_rate": self.prefetch_hits
            / max(1, self.prefetch_issued),
            "pipeline": {"occupancy": self.pipeline_occupancy},
            "queue_wait": self.queue_wait_hist.summary(),
            "attr": {
                **{s: h.summary() for s, h in self.attr_hists.items()},
                "attributed_s": self.attr_attributed_s,
                "e2e_s": self.attr_e2e_s,
                # request-weighted fraction of end-to-end latency the stage
                # decomposition accounts for (1.0 = exact tiling)
                "coverage": self.attr_attributed_s / self.attr_e2e_s
                if self.attr_e2e_s else 1.0,
            },
        }


class _InflightBatch(NamedTuple):
    """One admitted-but-unretired batch in the serving pipeline."""

    bucket: int
    reqs: list
    batch: dict
    pending: object  # PendingTieredLookup (miss handle + deferred merge)
    t_admit: float
    t_admit_end: float  # admit phase done; pipeline_wait starts here


class FlexEMRServer:
    """Disaggregated serving: host-DRAM embedding servers + a torch dense
    NN on ``device`` (``"cuda"`` unless the caller passes ``"cpu"``)."""

    def __init__(
        self,
        cfg: R.RecsysConfig,
        params: dict,
        tables: FusedTables,
        controller: AdaptiveCacheController | None = None,
        num_engines: int = 4,
        pushdown: bool = True,
        hedge_timeout: float | None = 0.05,
        cache_refresh_every: int = 16,
        prefetcher=None,  # repro_torch.prefetch.PrefetchEngine | None
        engine: str = "pooled",  # 'pooled' (§3.2 rdma pool) | 'legacy'
        pipeline_depth: int = 2,  # batches in flight (1 = closed loop)
        batcher: BucketBatcher | None = None,
        track_bytes: bool = True,  # False: skip wire-byte accounting (an
        # O(batch) np.unique per batch on the serving thread — measurable
        # against a pipelined lookup; byte metrics then read 0)
        timing=None,  # rdma.VerbsTiming override for the pooled engine
        emulate_wire: bool = False,  # pooled engine sleeps each WR's
        # virtual wire+server time for real: lookups become latency-bound
        # (the paper's regime) so pipelining is measurable without an RNIC
        dedup: bool = True,  # §3.1.1 wire dedup: unique-row subrequests,
        # in-flight coalescing across pipelined batches, range-coalesced
        # WRs (pooled engine); the legacy engine gets the unique-row
        # protocol too so A/Bs stay apples-to-apples.  Bit-equal on/off.
        # NOTE: dedup COMPOSES with segment pushdown for miss lookups:
        # poolable per-(bag, shard) segments of exclusive ids ship as one
        # pooled f64 partial per segment (near-memory reduction), the
        # remainder rides the unique-row/range machinery (rows ship once,
        # bags pool ranker-side).  Bit-equal on/off in every combination;
        # dedup_bench still reports the dedup-vs-fig-4b crossover as
        # dedup_vs_pushdown_bytes.
        tracer=None,  # obs.trace.Tracer | None: per-batch spans + per-WR
        # events on the wall + virtual timelines (docs/OBSERVABILITY.md).
        # None = NULL_TRACER: the hot path pays one branch per site.
        registry=None,  # obs.metrics.MetricsRegistry override (default:
        # the process-wide registry); every subsystem summary() registers
        # as a provider under its dotted namespace.
        slo=None,  # obs.slo.SloMonitor | None: fed one observation per
        # retired request (latency + deadline verdict when the request
        # carried one); its summary() registers under the slo.* namespace.
        chaos=None,  # repro_torch.chaos.ChaosInjector | None: seeded fault
        # injection + live elasticity.  The injector fires at batch admits
        # (on_admit), watchdogs the retire wait (guarded_wait), and is
        # drained first on close; its summary() registers under chaos.*.
        # Pooled engine only — the fault surface is the rdma pool.
        admission: AdmissionController | None = None,  # deadline-aware
        # overload shedding + adaptive pipeline depth at the submit
        # boundary (runtime.admission); None = admit everything, the
        # pre-overload-control behaviour.  Its summary() registers under
        # serve.admission.*.
        retry_policy=None,  # rdma.verbs.RetryPolicy | None: per-WR virtual
        # timeout + seeded backoff for transient WR failures + the shared
        # retry budget (hedges charge it too).  Pooled engine only.
        # Bit-equal with None when no fault fires.
        degrade_policy: str = "strict",  # brownout policy for dropped-shard
        # cold rows (rdma.engine.DEGRADE_POLICIES): 'strict' parks until
        # restore (the default), 'degrade' answers the cache tier's
        # best partial with a per-request degraded flag, 'block' fails
        # fast.  Pooled engine only.
        device="cuda",  # where the dense stage runs; the embedding tier
        # stays in host DRAM.  A CUDA device with no GPU present raises.
    ):
        if pipeline_depth <= 0:
            raise ValueError("pipeline_depth must be positive")
        if engine != "pooled" and (
            retry_policy is not None or degrade_policy != "strict"
        ):
            raise ValueError(
                "retry_policy / degrade_policy require the pooled engine"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        # Dense parameters on the ranker device; the fused table is served
        # from a host copy by the embedding servers below.
        self.params = tree_to(
            {k: v for k, v in params.items() if k != "emb"}, self.device
        )
        self.tables = tables
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.registry = registry or get_registry()
        table_np = params["emb"]["table"].detach().cpu().numpy()
        self.table_np = table_np
        if engine == "pooled":
            # §3.2: miss-path subrequests run on the rdma engine pool
            # (per-thread QPs, work stealing, doorbell batching, credit
            # window); num_engines becomes the pool's thread count.
            self.service = PooledLookupService(
                tables, table_np, num_threads=num_engines, pushdown=pushdown,
                pushdown_segments=pushdown,
                timing=timing, emulate_wire=emulate_wire, dedup=dedup,
                tracer=self.tracer,
                retry_policy=retry_policy,
                degrade_policy=degrade_policy,
            )
        elif engine == "legacy":
            self.service = HostLookupService(
                tables, table_np, num_engines=num_engines, pushdown=pushdown,
                dedup=dedup,
            )
        else:
            raise ValueError(f"unknown engine {engine!r} (pooled|legacy)")
        self.engine = engine
        self.controller = controller
        self.hedge_timeout = hedge_timeout
        self.cache_refresh_every = cache_refresh_every
        self.pipeline_depth = pipeline_depth
        self.batcher = batcher or BucketBatcher()
        self.metrics = ServeMetrics()
        self.degrade_policy = degrade_policy
        self.retry_policy = retry_policy
        self.admission = admission
        # Bounded-queue gauge: requests submitted but not yet admitted into
        # a batch.  Submit may run on a driver thread while _admit_next
        # drains on the serving thread, so the counter takes a leaf lock.
        self._queue_lock = threading.Lock()
        self._queued = 0
        # Brownout accounting (serve.degraded.*): requests retired with at
        # least one bag missing dropped-shard cold rows.
        self._degraded_requests = 0
        self._degraded_batches = 0
        self._degraded_rows = 0
        self.prefetcher = prefetcher
        # repro.hotcache tiered front end over the lookup service.  The hash
        # cache starts empty (0 slots) until the controller's first plan;
        # refresh_every=0: the controller owns the swap-in schedule, not the
        # tier's own LFU loop.  With a prefetcher, the tier mines
        # co-occurrence and attributes prefetch hits; the piggyback fetch
        # itself rides the plan swap-in (_apply_cache_plan), since the
        # controller owns that schedule here.
        # Straggler mitigation: on the pool, the miss tier posts async and
        # hedges *through the pool* (duplicate subrequests on other engine
        # threads, cancel-the-loser); the legacy engine keeps the ranker-side
        # re-execution from the authoritative shard copy.
        if engine == "pooled":
            tier_remote = {"remote_async_fn": self._pool_remote_async}
        else:
            tier_remote = {"remote_fn": self._hedged_remote}
        self._tiered = TieredLookupService(
            self.service,
            num_slots=0,
            refresh_every=0,
            prefetcher=prefetcher,
            track_bytes=track_bytes,
            # The controller consumes each batch's heat from the dedup
            # prepass published on the pending handle (admit phase, where
            # it overlaps in-flight fetches) instead of re-aggregating raw
            # references at retire time — see _retire_oldest.
            collect_unique=controller is not None,
            tracer=self.tracer,
            **tier_remote,
        )
        # The cross-batch pipeline: _InflightBatch entries, oldest first.
        self._pipeline: collections.deque = collections.deque()
        self._plan_swap_in_bytes = 0
        self._offsets = tables.field_offsets_array()
        # Unified metrics namespace (docs/OBSERVABILITY.md): every
        # subsystem's summary() becomes a provider, so ONE snapshot covers
        # the whole serving process.  Provider registration REPLACES, so a
        # rebuilt server takes over the namespace instead of
        # double-reporting.
        self.registry.register_provider("serve", self.metrics.summary)
        self.registry.register_provider("tier", self._tiered.stats.summary)
        if hasattr(self.service, "engine_summary"):
            self.registry.register_provider(
                "rdma.pool", self.service.engine_summary
            )
        if prefetcher is not None:
            self.registry.register_provider(
                "prefetch", prefetcher.stats.summary
            )
        self.chaos = chaos
        if chaos is not None:
            if engine != "pooled":
                raise ValueError(
                    "chaos injection requires the pooled engine"
                )
            if not chaos.tracer.enabled and self.tracer.enabled:
                chaos.tracer = self.tracer
            chaos.bind(self)
            self.registry.register_provider("chaos", chaos.summary)
        self.slo = slo
        if slo is not None:
            # A monitor built without a tracer inherits the server's, so
            # alert fire/resolve instants land on the same timeline as the
            # serving spans.
            if not slo.tracer.enabled and self.tracer.enabled:
                slo.tracer = self.tracer
            self.registry.register_provider("slo", slo.summary)
        if admission is not None:
            # The configured depth is the adaptive ceiling; the effective
            # depth (admission.depth) shrinks under sustained burn-rate
            # alerts and re-grows on recovery — see step().
            admission.attach(pipeline_depth)
            self.registry.register_provider(
                "serve.admission", self._admission_summary
            )
        self.registry.register_provider(
            "serve.degraded", self._degraded_summary
        )
        if engine == "pooled":
            self.registry.register_provider(
                "rdma.retry", self.service.retry_summary
            )

    # ------------------------------------------------------------ dense part

    def _dense(self, pooled: np.ndarray, dense: np.ndarray) -> np.ndarray:
        """The ranker stage on ``self.device``.  The tier's pooled sums are
        rounded to f32 on the host before the copy, as the reference rounds
        them at ``jnp.asarray`` (x64 off)."""
        pooled_t = torch.from_numpy(np.asarray(pooled, np.float32))
        dense_t = torch.from_numpy(np.asarray(dense, np.float32))
        with torch.no_grad():
            scores = R.dense_forward(
                self.cfg, self.params, pooled_t.to(self.device),
                dense_t.to(self.device),
            )
        return scores.cpu().numpy()

    # ---------------------------------------------------------------- lookup

    def _pool_remote_async(self, indices: np.ndarray, cold_mask: np.ndarray):
        """Miss-tier executor on the §3.2 engine pool: posts the subrequests
        and returns the LookupHandle.  The straggler hedge arms at wait():
        a batch still unfinished after `hedge_timeout` has its unfinished
        subrequests duplicated onto other engine threads and the losers
        cancelled — no ranker-side re-execution, no double-count."""
        return self.service.lookup_async(
            indices, cold_mask, mean_normalize=False,
            hedge_timeout=self.hedge_timeout,
        )

    def _hedged_remote(self, indices: np.ndarray, cold_mask: np.ndarray):
        """Legacy miss-tier executor with ranker-side straggler hedging:
        returns [B,F,D] SUMS (the pooled engine hedges through the pool
        instead — see _pool_remote_async)."""
        t0 = time.perf_counter()
        done = threading.Event()
        result: list = [None]

        def work():
            result[0] = self.service.lookup(
                indices, cold_mask, mean_normalize=False
            )
            done.set()

        t = threading.Thread(target=work, daemon=True)
        t.start()
        if not done.wait(self.hedge_timeout):
            # straggler: hedge by executing ranker-side from the
            # authoritative table copy (zero-trust of the slow path)
            self.metrics.hedges += 1
            fused = indices.astype(np.int64) + self._offsets[None, :, None]
            fused_c = np.where(cold_mask, fused, 0)
            rows = self.table_np[fused_c] * cold_mask[..., None]
            out = rows.sum(axis=2, dtype=np.float64)  # split-invariant sums
            done.wait()  # drain the engine result; discard
        else:
            out = np.asarray(result[0], np.float64)
        self.metrics.lookup_seconds += time.perf_counter() - t0
        return out

    def _sync_tier_metrics(self) -> None:
        s = self._tiered.stats
        self.metrics.lookups = s.lookups
        self.metrics.cache_hits = s.hits
        self.metrics.bytes_no_cache = s.bytes_no_cache
        self.metrics.bytes_network = s.bytes_network
        self.metrics.bytes_request = s.bytes_request
        self.metrics.bytes_swap_in = s.bytes_swap_in + self._plan_swap_in_bytes
        self.metrics.prefetch_hits = s.prefetch_hits
        self.metrics.prefetch_evicted = s.prefetch_evicted
        if self.prefetcher is not None:
            # Piggybacks ride the plan swap-in here, so read the engine's
            # own counters (the tier's only cover self-driven refreshes).
            self.metrics.prefetch_issued = self.prefetcher.stats.issued
            self.metrics.bytes_prefetch = self.prefetcher.stats.bytes_prefetch

    def _lookup(self, indices: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Closed-loop tiered lookup (probe + miss + merge in one call) —
        the non-pipelined entry used by tests and direct callers.  Accounts
        the same lookup-time/hedge metrics the pipelined retire path does
        (the legacy engine's _hedged_remote times itself)."""
        t0 = time.perf_counter()
        pending = self._tiered.lookup_begin(indices, mask)
        out = pending.wait()
        if self.engine == "pooled":
            self.metrics.lookup_seconds += time.perf_counter() - t0
            if pending.hedged:
                self.metrics.hedges += 1
        self._sync_tier_metrics()
        return out

    # --------------------------------------------------------------- serving

    def submit(self, payload: dict, arrival: float | None = None,
               deadline_s: float | None = None) -> int:
        """Enqueue one request.  Open-loop drivers stamp ``arrival`` with
        the intended arrival time (perf_counter timebase) so submission lag
        counts as queue wait, and ``deadline_s`` with the latency budget the
        SLO monitor's goodput accounting checks at retire.

        With an :class:`AdmissionController` attached this is the shed
        boundary: an already-expired deadline, a full submit queue, or an
        unmeetable deadline estimate raises :class:`ShedError` *before* the
        request takes a pipeline slot.  Admitted requests flow the exact
        same path as with admission off (bit-equal outputs)."""
        if self.admission is not None:
            now = time.perf_counter()
            arr = now if arrival is None else min(arrival, now)
            with self._queue_lock:
                queued = self._queued
            try:
                self.admission.check(
                    now, arr, deadline_s, queued, len(self._pipeline)
                )
            except ShedError as exc:
                if self.tracer.enabled:
                    self.tracer.instant(
                        "shed", CAT_ADMISSION, self.tracer.now(),
                        tid=TID_RANKER,
                        args={"reason": exc.reason, "queued": queued,
                              "deadline_ms": None if deadline_s is None
                              else round(deadline_s * 1e3, 3)},
                    )
                raise
            with self._queue_lock:
                self._queued += 1
        return self.batcher.submit(payload, arrival=arrival,
                                   deadline_s=deadline_s)

    @property
    def effective_depth(self) -> int:
        """The pipeline depth currently in force: the configured depth,
        shrunk by the admission controller under sustained SLO alerts."""
        if self.admission is None:
            return self.pipeline_depth
        return min(self.pipeline_depth, self.admission.depth)

    def step(self) -> dict | None:
        """Admit batches until `pipeline_depth` are in flight, then retire
        the oldest: the explicit cross-batch pipeline.  Batch N+1's padding,
        cache probe, and miss *posting* all happen before batch N's dense
        stage runs, so the engine pool fetches N+1's misses while the ranker
        is in the dense NN (and, at admit time, while N is still on the
        wire).  Returns the oldest batch's result, or None when idle."""
        while len(self._pipeline) < self.effective_depth:
            if self._pipeline and self._pipeline[0].pending.done:
                # The oldest batch is already merged-ready: retire it now
                # rather than blocking in the batcher poll for an admit —
                # under sparse traffic that wait would add dead time to a
                # result that is just sitting there.  (While the oldest is
                # still in flight, the blocking poll is itself overlapped
                # work, so keep filling.)
                break
            if not self._admit_next():
                break
        if not self._pipeline:
            return None
        return self._retire_oldest()

    def _admit_next(self) -> bool:
        """Poll + pad one batch and post its tiered lookup (probe phase)."""
        polled = self.batcher.poll()
        if polled is None:
            return False
        bucket, reqs = polled
        if self.admission is not None:
            with self._queue_lock:
                self._queued = max(0, self._queued - len(reqs))
        if self.chaos is not None:
            # Fault triggers count admitted batches: a fault at batch k
            # fires here, before batch k's own lookup posts, so its WRs
            # already see the degraded world.
            self.chaos.on_admit()
        tracer = self.tracer
        t_adm = tracer.now() if tracer.enabled else 0.0
        t0 = time.perf_counter()
        F, NNZ = self.cfg.num_fields, self.cfg.max_nnz
        batch = self.batcher.pad_batch(
            reqs,
            bucket,
            {
                "indices": ((F, NNZ), np.int32),
                "mask": ((F, NNZ), np.bool_),
                "dense": ((self.cfg.n_dense,), np.float32),
            },
        )
        pending = self._tiered.lookup_begin(batch["indices"], batch["mask"])
        if tracer.enabled:
            tracer.complete(
                "admit", CAT_SERVE, t_adm, tracer.now() - t_adm,
                tid=TID_RANKER,
                args={"bucket": bucket, "requests": len(reqs),
                      "inflight": len(self._pipeline) + 1},
            )
        self._pipeline.append(
            _InflightBatch(bucket, reqs, batch, pending, t0,
                           time.perf_counter())
        )
        self.metrics.pipeline_occupancy = len(self._pipeline)
        return True

    def _retire_oldest(self) -> dict:
        """Wait on the oldest in-flight batch, run its dense stage, account."""
        bucket, reqs, batch, pending, t0, t_admit_end = \
            self._pipeline.popleft()
        self.metrics.pipeline_occupancy = len(self._pipeline)
        tracer = self.tracer
        t_wait = time.perf_counter()
        if self.chaos is not None:
            # Watchdogged wait: a batch stuck on a still-dropped shard gets
            # a forced restore instead of hanging the serving loop.
            pooled = self.chaos.guarded_wait(pending)
        else:
            pooled = pending.wait()
        t_wait_end = time.perf_counter()
        stall = t_wait_end - t_wait
        if self.engine == "pooled":
            # Ranker-thread stall on the miss path: with the pipeline full
            # this is what's LEFT of lookup latency after the overlap (the
            # legacy hedge path accounts its own full lookup time instead).
            # The "lookup_stall" span is THIS delta — span durations and
            # serve.lookup_seconds sum-check against each other.
            self.metrics.lookup_seconds += stall
            if pending.hedged:
                self.metrics.hedges += 1
        if tracer.enabled:
            tracer.complete(
                "lookup_stall", CAT_LOOKUP, tracer.now() - stall, stall,
                tid=TID_RANKER,
                args={"bucket": bucket, "hedged": pending.hedged},
            )
        self._sync_tier_metrics()
        t1 = time.perf_counter()
        scores = self._dense(pooled, batch["dense"])
        d_dense = time.perf_counter() - t1
        self.metrics.dense_seconds += d_dense
        t_retire = time.perf_counter()
        dt = t_retire - t0
        self.metrics.batches += 1
        self.metrics.requests += len(reqs)
        # ---- per-request attribution: an exact tiling of [t0, t_retire]
        # into the ATTR_STAGES, each stage cut from the same timestamps the
        # tracer spans use.  probe/post/merge are the tier handle's always-
        # recorded perf_counter deltas, so the decomposition works with
        # tracing off; request latency = queue wait + the batch stages.
        merge_s = min(pending.merge_s, stall)
        attr = {
            "admit_other": max(
                0.0, (t_admit_end - t0) - pending.probe_s - pending.post_s
            ),
            "probe": pending.probe_s,
            "post": pending.post_s,
            "pipeline_wait": t_wait - t_admit_end,
            "wire_stall": stall - merge_s,
            "merge": merge_s,
            "dense": d_dense,
            "retire_other": max(0.0, (t_retire - t_wait_end) - d_dense),
        }
        queue_waits = [t0 - r.arrival for r in reqs]
        lats = [t_retire - r.arrival for r in reqs]
        self.metrics.observe_attribution(attr, queue_waits, sum(lats))
        if tracer.enabled:
            now = tracer.now()
            # Same deltas the metrics accumulated: dense span ==
            # serve.dense_seconds contribution, batch span == admit->retire.
            tracer.complete(
                "dense", CAT_DENSE, now - d_dense, d_dense, tid=TID_RANKER,
                args={"bucket": bucket, "batch_size": len(reqs)},
            )
            tracer.complete(
                "batch", CAT_SERVE, now - dt, dt, tid=TID_RANKER,
                args={"bucket": bucket, "requests": len(reqs),
                      "n": self.metrics.batches},
            )
            # One instant per batch carrying the stage breakdown — what
            # tools/trace_export.py --attribution renders into a table.
            tracer.instant(
                "attribution", CAT_SERVE, now, tid=TID_RANKER,
                args={"bucket": bucket, "requests": len(reqs),
                      "total_s": round(dt, 9),
                      "queue_wait_mean_s": round(
                          sum(queue_waits) / len(reqs), 9),
                      **{k: round(v, 9) for k, v in attr.items()}},
            )
        for r, lat in zip(reqs, lats):
            self.metrics.observe_latency(lat)
            if self.slo is not None:
                met = None if r.deadline_s is None \
                    else bool(lat <= r.deadline_s)
                self.slo.observe(lat, deadline_met=met)
        # ---- brownout flags (degrade policy): flat degraded bag ids
        # [0, B*F) map back to the requests whose sums they are — padded
        # tail rows carry no request and are skipped.
        degraded = [False] * len(reqs)
        dbags = pending.degraded_bags
        if dbags:
            F = self.cfg.num_fields
            for b in dbags:
                i = b // F
                if i < len(reqs):
                    degraded[i] = True
            n_deg = sum(degraded)
            if n_deg:
                self._degraded_batches += 1
                self._degraded_requests += n_deg
                self._degraded_rows += pending.degraded_rows
                if tracer.enabled:
                    tracer.instant(
                        "degraded", CAT_SERVE, tracer.now(), tid=TID_RANKER,
                        args={"bucket": bucket, "requests": n_deg,
                              "rows": pending.degraded_rows},
                    )
        if self.admission is not None:
            delta = self.admission.on_retire(
                t_retire, len(reqs),
                alerting=self.slo is not None and self.slo.alerting,
            )
            if delta and tracer.enabled:
                tracer.instant(
                    "depth_shrink" if delta < 0 else "depth_regrow",
                    CAT_ADMISSION, tracer.now(), tid=TID_RANKER,
                    args={"depth": self.admission.depth,
                          "max_depth": self.admission.max_depth},
                )
        if self.controller is not None:
            if pending.unique_ids is not None:
                # Heat off the hot path: the admit-phase dedup prepass
                # already aggregated this batch's (unique id, per-touch
                # count) pairs — identical tracker feeding to the raw-
                # reference path (regression-tested), with no np.unique
                # serialized against the retire stage.
                self.controller.observe(
                    bucket,
                    unique=(pending.unique_ids, pending.unique_counts),
                )
            else:
                fused = batch["indices"].astype(np.int64) \
                    + self._offsets[None, :, None]
                self.controller.observe(bucket, fused[batch["mask"]])
            if self.metrics.batches % self.cache_refresh_every == 0:
                self._apply_cache_plan(bucket)
        return {"bucket": bucket, "scores": scores, "latency_s": dt,
                "degraded": degraded}

    def _apply_cache_plan(self, current_batch: int) -> None:
        plan = self.controller.plan(current_batch)
        cache = self._tiered.cache
        if cache.num_slots != plan.hash_slots:
            # Resize = rebuild: the probe geometry depends on num_slots.
            cache = self._tiered.cache = HostHashCache(
                plan.hash_slots, self.cfg.embed_dim
            )
        self._tiered.policy = dataclasses.replace(
            self._tiered.policy,
            admission_threshold=plan.admission_threshold,
        )
        k = min(plan.capacity_rows, len(plan.hot_ids))
        if k and plan.hash_slots:
            ids = plan.hot_ids[:k]
            freqs = (
                plan.hot_freqs[:k]
                if len(plan.hot_freqs) >= k
                else np.ones((k,), np.int64)
            )
            rows = self.table_np[ids]  # swap-in fetch (RDMA on real hardware)
            # Only rows not already resident cost wire bytes to fetch.
            _, already = cache.probe(ids)
            entry = 4 + rows.shape[1] * rows.dtype.itemsize
            self._plan_swap_in_bytes += int((~already).sum()) * entry
            # The planned rows ARE the chosen hot set: threshold 1 (always
            # admit); plan.admission_threshold gates runtime misses instead.
            cache.insert(ids, rows, freqs, 1.0)
            if self.prefetcher is not None:
                # §3.1.2 piggyback: the plan's swap-in fetch carries the new
                # rows' co-occurring partners, under the plan's byte budget.
                self.prefetcher.set_byte_budget(plan.prefetch_budget_bytes)
                self.prefetcher.piggyback(ids[~already], cache, self.service)
                self.prefetcher.decay()
        if hasattr(self.service, "set_shard_affinity"):
            # Skew-aware dealing (§3.2 follow-on): feed the controller's
            # per-shard heat into the pool's shard->thread table so hot
            # shards spread across engine threads *before* work stealing
            # has to rescue them.  No heat yet -> keep the shard % T deal.
            heat = self.controller.shard_heat(
                self.tables.rows_per_shard, self.tables.num_shards
            )
            self.service.set_shard_affinity(heat if heat.sum() > 0 else None)
        logger.info("cache plan applied: %s", plan.reason)

    def reshard(self, new_num_shards: int) -> dict:
        """Quiesce-free live reshard: re-partition the embedding tier to
        ``new_num_shards`` servers while lookups stay in flight.

        Fused row ids are invariant across shard counts (``FusedTables``
        pads the fused space at the end), so cache keys, dedup ids, and
        controller heat all survive; only *ownership* changes.  The service
        swaps its router/servers/pool map atomically; WRs already posted
        keep their submit-time epoch binding and read the old shard
        objects (dual-read handoff window), so retired outputs stay
        bit-equal with a fault-free run.  In-flight dedup-table entries
        for migrated rows are invalidated, and the engine heat deal is
        re-derived on the new shard map.  Pooled engine only.
        """
        if self.engine != "pooled":
            raise ValueError("live reshard requires the pooled engine")
        if new_num_shards < 1:
            raise ValueError("new_num_shards must be >= 1")
        from repro_torch.runtime.elastic import reshard_tables

        res = reshard_tables(self.tables, self.table_np, new_num_shards)
        invalidated = self.service.apply_reshard_live(res.tables, res.table)
        self.tables = res.tables
        self.table_np = res.table
        self._offsets = res.tables.field_offsets_array()
        if self.controller is not None:
            # Heat re-deal on the new map: per-shard heat is re-binned from
            # the same per-row tracker, so hot rows keep spreading across
            # engine threads under the new ownership.
            heat = self.controller.shard_heat(
                res.tables.rows_per_shard, res.tables.num_shards
            )
            self.service.set_shard_affinity(
                heat if heat.sum() > 0 else None
            )
        logger.info(
            "live reshard -> %d shards (%d rows moved, %d in-flight "
            "entries invalidated)",
            new_num_shards, res.moved_rows, invalidated,
        )
        return {
            "num_shards": new_num_shards,
            "moved_rows": res.moved_rows,
            "inflight_invalidated": invalidated,
        }

    def _admission_summary(self) -> dict:
        """serve.admission.*: controller counters + the live queue gauge."""
        s = self.admission.summary()
        with self._queue_lock:
            s["queue_depth"] = self._queued
        return s

    def _degraded_summary(self) -> dict:
        """serve.degraded.*: brownout-flagged work retired so far."""
        return {
            "requests": self._degraded_requests,
            "batches": self._degraded_batches,
            "rows": self._degraded_rows,
            "policy": self.degrade_policy,
        }

    def engine_summary(self) -> dict | None:
        """repro.rdma pool stats (virtual p50/p99, utilization, steals,
        hedges + cancellations, credit window) when serving on the pooled
        engine; None on legacy."""
        if hasattr(self.service, "engine_summary"):
            return self.service.engine_summary()
        return None

    def close(self):
        """Drain the pipeline (in-flight lookups complete and merge — never
        dropped mid-wire), then shut the engine down.  A batch that FAILED
        in flight is logged, not raised: close must always reach
        service.close() or the engine-pool threads leak."""
        try:
            if self.chaos is not None:
                # Recover every live fault first so the drain below runs
                # against healthy shards (parked WRs release and resolve).
                self.chaos.drain()
            while self._pipeline:
                entry = self._pipeline.popleft()
                try:
                    entry.pending.wait()
                except Exception:  # noqa: BLE001
                    logger.exception(
                        "pipeline drain: in-flight batch failed"
                    )
        finally:
            self.service.close()
