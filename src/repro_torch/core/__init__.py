"""core: routing, the single-device embedding layer, the host lookup engine,
the adaptive-cache controller and credit flow control.

  sharding        — range-based routing + row-wise table sharding (§3.1.2)
  embedding       — DisaggEmbedding: baseline / hierarchical / cached lookups
  adaptive_cache  — load-aware cache sizing controller (§3.1.1)
  lookup_engine   — multi-threaded host engine + chunked mesh lookups (§3.2)
  flow_control    — credit-based flow control w/ priority channel (§3.2)
  migration       — live connection migration + elastic resharding (§3.2)

The device-resident hot-embedding cache lives in ``repro_torch.hotcache``.
The names below are the reference package's ``repro.core`` surface.
Importing this package builds no kernel.
"""
from repro_torch.core.adaptive_cache import (
    AdaptiveCacheController,
    CachePlan,
    EmaFrequencyTracker,
    MemoryModel,
    SlidingWindowLoadMonitor,
)
from repro_torch.core.lookup_engine import HostLookupService, chunked_lookup
from repro_torch.core.sharding import (
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_POD,
    FusedTables,
    RangeRouter,
    TableSpec,
    make_fused_tables,
)

__all__ = [
    "AdaptiveCacheController",
    "CachePlan",
    "EmaFrequencyTracker",
    "MemoryModel",
    "SlidingWindowLoadMonitor",
    "DisaggEmbedding",
    "HotCacheState",
    "empty_cache",
    "make_cache_from_table",
    "make_hash_cache_from_table",
    "HostLookupService",
    "chunked_lookup",
    "AXIS_DATA",
    "AXIS_MODEL",
    "AXIS_POD",
    "FusedTables",
    "RangeRouter",
    "TableSpec",
    "make_fused_tables",
]

# ``core.embedding`` imports ``hotcache.table``, which imports
# ``core.sharding`` and so this package: its names load on first use
# (PEP 562), or importing ``repro_torch.hotcache`` first would meet a
# partly initialised ``hotcache.table``.
_EMBEDDING_NAMES = ("DisaggEmbedding", "HotCacheState", "empty_cache",
                    "make_cache_from_table", "make_hash_cache_from_table")


def __getattr__(name: str):
    if name in _EMBEDDING_NAMES:
        from repro_torch.core import embedding

        return getattr(embedding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
