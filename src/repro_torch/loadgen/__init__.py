"""Open-loop load generation for the serving harness.

Offered load is fixed in advance (:mod:`~repro_torch.loadgen.schedule`), arrivals
are drawn by seeded Poisson thinning (:mod:`~repro_torch.loadgen.arrivals`), and
the driver submits them to ``FlexEMRServer`` at their due times without
waiting for completions (:mod:`~repro_torch.loadgen.driver`) — so queueing delay
shows up in the measured latency instead of silently pacing the client.
"""
from repro_torch.loadgen.arrivals import (
    ArrivalEvent,
    OpenLoopGenerator,
    RecsysPayloadFactory,
    poisson_arrivals,
)
from repro_torch.loadgen.driver import OpenLoopDriver, replay_open_loop
from repro_torch.loadgen.schedule import (
    FlashCrowd,
    QpsSchedule,
    constant,
    diurnal,
    flash_crowd,
    trace,
)

__all__ = [
    "ArrivalEvent",
    "FlashCrowd",
    "OpenLoopDriver",
    "OpenLoopGenerator",
    "QpsSchedule",
    "RecsysPayloadFactory",
    "constant",
    "diurnal",
    "flash_crowd",
    "poisson_arrivals",
    "replay_open_loop",
    "trace",
]
