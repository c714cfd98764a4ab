"""Fault tolerance: heartbeat failure detection, straggler policy, elastic
re-mesh, and seeded fault injection (:mod:`repro_torch.ft.faultinject`)."""
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.ft.straggler import StragglerMonitor, Advice
from repro_torch.ft.elastic import MeshPlan, plan_remesh, reshard_plan
from repro_torch.ft.faultinject import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
    RankKilled,
    SendTimeout,
    VirtualClock,
)
