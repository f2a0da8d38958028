"""Deterministic chaos injection for the API plane, the node fleet,
and the control-plane processes themselves.

`ChaosClient` wraps any `api.client.Client` with seeded, per-verb fault
streams (error rates, injected latency, 429/503 bursts, watch-stream
cuts) — the machinery the chaos soak and the fault-load perf arm run
on. See `injector.py` for the determinism contract.

`NodeFaultPlan`/`NodeChaos` extend the same fixed-draw determinism to
NODE faults — seeded kill / heartbeat-freeze / flap schedules driving a
`kubemark.fleet.HollowFleet` (see `nodes.py`).

`CrashPlan`/`CrashChaos` extend it to PROCESS death: seeded kill points
(in bound-pod progress, not wall time) for the apiserver, the active
scheduler, and the active controller-manager — the durability/HA gates
ride these (see `crash.py`; the crash soak waits for the port of the
HTTP plane).

`WorkloadPlan`/`WorkloadChaos` extend it to the WORKLOAD itself: a
seeded, time-compressed replay of heterogeneous arrival traces
(diurnal HPA-driven demand, Poisson flash crowds, batch Job waves,
rollout steps, Service churn) — the trace-replay scenario suite rides
these (see `workload.py`; the workload soak waits for the port of the
HTTP plane).
"""

from .crash import TARGETS as CRASH_TARGETS
from .crash import CrashChaos, CrashPlan
from .injector import VERBS, ChaosClient, ChaosWatcher, FaultPlan
from .nodes import NodeChaos, NodeFaultPlan
from .workload import GENERATORS as WORKLOAD_GENERATORS
from .workload import WorkloadChaos, WorkloadEvent, WorkloadPlan

__all__ = ["ChaosClient", "ChaosWatcher", "CrashChaos", "CrashPlan",
           "CRASH_TARGETS", "FaultPlan", "NodeChaos", "NodeFaultPlan",
           "VERBS", "WORKLOAD_GENERATORS", "WorkloadChaos",
           "WorkloadEvent", "WorkloadPlan"]
