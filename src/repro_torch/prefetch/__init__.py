"""prefetch — spatial-locality prefetch subsystem (§3.1.2).

  cooccur     — CountMinSketch + CooccurrenceMiner: a bounded, decayed
                row-co-occurrence index mined online from the lookup stream;
                its neighbor select runs on the miner's device.
  kernels     — K5: top-k neighbor select (CUDA, csrc/).
  ref         — its plain PyTorch version (ties to the lowest index).
  prefetcher  — PrefetchEngine: piggybacks the missed rows' top-k partners
                onto every hotcache swap-in fetch, under a byte budget.

Port of ``repro/prefetch``.  Invariant: prefetch changes when bytes move,
never what lookups return.  Importing this package builds no kernel.
"""
from repro_torch.prefetch.cooccur import (
    CooccurrenceMiner,
    CountMinSketch,
    topk_select_np,
)
from repro_torch.prefetch.kernels import topk_neighbor_select
from repro_torch.prefetch.prefetcher import (
    PrefetchEngine,
    PrefetchPolicy,
    PrefetchStats,
)
from repro_torch.prefetch.ref import topk_neighbor_select_ref

__all__ = [
    "CooccurrenceMiner",
    "CountMinSketch",
    "PrefetchEngine",
    "PrefetchPolicy",
    "PrefetchStats",
    "topk_neighbor_select",
    "topk_neighbor_select_ref",
    "topk_select_np",
]
