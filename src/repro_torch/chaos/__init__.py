"""Deterministic chaos harness for the disaggregated serving stack.

Seeded fault injection (engine-thread death, shard loss with cache-tier
re-replication, straggler storms) and live elasticity (quiesce-free
resharding under traffic) over the §3.2 rdma engine pool — with the
accounting to prove recovery: bit-equal retired outputs vs a fault-free
run, bounded p99 inflation, zero hangs.  See docs/ARCHITECTURE.md.
"""
from repro_torch.chaos.faults import (
    FAULT_DROP_SHARD,
    FAULT_KILL_ENGINE,
    FAULT_KINDS,
    FAULT_RESHARD,
    FAULT_STRAGGLER_STORM,
    DegradedShard,
    FaultSchedule,
    FaultSpec,
)
from repro_torch.chaos.injector import ChaosInjector

__all__ = [
    "FAULT_DROP_SHARD",
    "FAULT_KILL_ENGINE",
    "FAULT_KINDS",
    "FAULT_RESHARD",
    "FAULT_STRAGGLER_STORM",
    "ChaosInjector",
    "DegradedShard",
    "FaultSchedule",
    "FaultSpec",
]
