"""hotcache — the hot-embedding cache subsystem (§3.1.1), device and host.

  table      — HashCacheState: open-addressing (linear probe) hash table on
               the device; LFU insert (host decision pass + kernel K4).
  kernels    — K3: fused hash probe + masked gather + per-bag pooling + miss
               mask; K4: the swap-in scatter (CUDA, csrc/).
  ref        — their plain PyTorch versions.
  policy     — frequency-aware admission (FreqCacheEmbedding-style).
  miss_path  — HostHashCache mirror + TieredLookupService: only cache
               misses become HostLookupService subrequests.

Port of ``repro/hotcache``; ``cache_partition_spec`` gives the cache's
layout under a ``launch.mesh.Mesh`` (replicated on every rank).  Importing
this package builds no kernel.
"""
from repro_torch.hotcache.kernels import probe_gather_pool, scatter_update
from repro_torch.hotcache.miss_path import (
    HostHashCache,
    TieredLookupService,
    TieredStats,
)
from repro_torch.hotcache.policy import AdmissionPolicy, select_admissions
from repro_torch.hotcache.table import (
    EMPTY_KEY,
    HashCacheState,
    cache_insert,
    cache_partition_spec,
    cache_lookup,
    decay_freq,
    empty_hash_cache,
    hash_slots,
    hash_slots_np,
    next_pow2,
    probe_slots,
)

__all__ = [
    "AdmissionPolicy",
    "EMPTY_KEY",
    "HashCacheState",
    "HostHashCache",
    "TieredLookupService",
    "TieredStats",
    "cache_insert",
    "cache_partition_spec",
    "cache_lookup",
    "decay_freq",
    "empty_hash_cache",
    "hash_slots",
    "hash_slots_np",
    "next_pow2",
    "probe_gather_pool",
    "probe_slots",
    "scatter_update",
    "select_admissions",
]
