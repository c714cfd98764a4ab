"""Fault tolerance: seeded fault injection (:mod:`repro_torch.ft.faultinject`).

The heartbeat detector, the straggler policy and elastic re-mesh planning
come with a later slice (ROADMAP); the serving loops take any object with
the heartbeat monitor's methods in the meantime.
"""
from repro_torch.ft.faultinject import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
    RankKilled,
    SendTimeout,
    VirtualClock,
)
