"""Observability subsystem: unified metrics registry + end-to-end tracing.

The serving hot path (runtime.serving -> hotcache.miss_path -> rdma.service
-> rdma.engine -> rdma.verbs) exposes its *aggregate* state through one
process-wide :class:`MetricsRegistry` (thread-safe counters, gauges, and
bounded streaming-quantile histograms under a stable dotted namespace, plus
every subsystem's ``summary()`` dict registered as a provider) and its
*per-batch journey* through a :class:`Tracer` producing Chrome-trace /
Perfetto-loadable spans: admit -> probe -> post -> steal/hedge -> merge ->
dense -> retire, with per-WR events on the verbs layer's virtual timeline.

The default tracer is :data:`NULL_TRACER`, a no-op whose ``enabled`` flag is
False — instrumented code guards every emission with ``if tracer.enabled:``
so the hot path pays exactly one attribute check when tracing is off (the
registry's counters are always live; they are the pre-existing summary
fields).

See docs/OBSERVABILITY.md for the metric namespace table and span taxonomy.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    P2Quantile,
    get_registry,
)
from repro_torch.obs.slo import (  # noqa: F401
    SloMonitor,
    SloObjective,
    WindowedHistogram,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    CAT_CACHE,
    CAT_CREDIT,
    CAT_DENSE,
    CAT_HEDGE,
    CAT_LOOKUP,
    CAT_PREFETCH,
    CAT_SERVE,
    CAT_SLO,
    CAT_STEAL,
    CAT_WIRE,
    PID_VIRTUAL,
    PID_WALL,
    NullTracer,
    Tracer,
)
