"""repro.rdma — multi-threaded RDMA lookup engine (paper §3.2).

The third pillar of FlexEMR, next to the hotcache (§3.1.1, repro.hotcache)
and the co-occurrence prefetch (§3.1.2, repro.prefetch): batched miss-path
requests are sharded into per-shard subrequests and executed concurrently by
a pool of engine threads with per-thread queue pairs, work-stealing,
doorbell/completion batching, and a credit-bounded in-flight window.

Layers (see each module's docstring for the paper anchor and invariants):

  verbs.py    simulated verbs timing + deterministic schedule planner
              (VerbsState carries QP/credit state across batches;
              heat_affinity is the skew-aware shard->thread dealing)
  engine.py   RdmaEnginePool: real engine threads + the virtual timing
              layer, pool-side straggler hedging (cancel-the-loser)
  service.py  PooledLookupService: drop-in HostLookupService on the pool;
              lookup_async returns a LookupHandle for cross-batch
              pipelined serving (runtime.serving.FlexEMRServer)
"""
from repro_torch.rdma.engine import BatchHandle, RdmaEnginePool
from repro_torch.rdma.service import LookupHandle, PooledLookupService
from repro_torch.rdma.verbs import (
    LookupSubrequest,
    SchedulePlan,
    VerbsState,
    VerbsTiming,
    heat_affinity,
    plan_schedule,
)

__all__ = [
    "BatchHandle",
    "LookupHandle",
    "LookupSubrequest",
    "PooledLookupService",
    "RdmaEnginePool",
    "SchedulePlan",
    "VerbsState",
    "VerbsTiming",
    "heat_affinity",
    "plan_schedule",
]
