"""Seeded trace-replay workload generation: a day of heterogeneous
production traffic, compressed into a deterministic event stream.

Determinism contract — the same fixed-draw discipline as `FaultPlan`
(injector.py), `NodeFaultPlan` (nodes.py) and `CrashPlan` (crash.py):
every generator owns an independent RNG stream seeded from
`(plan.seed, "workload", generator)`, and each replay tick consumes a
FIXED number of draws per generator — so the event a generator emits
at tick t is a pure function of (seed, generator, t), independent of
which branches other ticks or other generators took. `schedule()`
replays the whole trace purely; `WorkloadChaos.trace()` records what a
live run actually applied, and the workload soak gates on the two
being byte-identical (tests/test_workload.py).

The replay CLOCK is the compressed tick axis, not wall time: a trace
is defined over `ticks` virtual steps (a "day" at whatever resolution
the plan chooses), and the soak maps ticks onto wall seconds with a
compression factor. Wall timing — how long the apiserver takes, where
the GIL slices land — is explicitly outside the contract, exactly like
NodeFaultPlan's flap-toggle phase (see DIVERGENCES.md).

The six generators model the heterogeneous-workload regime Gavel
(PAPERS.md) argues schedulers must be evaluated under:

  diurnal   a sinusoid of per-Deployment demand (user traffic) that
            the HPA chases up and down through the scale subresource
  burst     Poisson flash crowds: batches of bare pods whose
            time-to-bind during the burst window is an SLO gate
  jobwave   batch Job waves (parallelism/completions drawn per wave;
            a drawn fraction of waves crash-loop, exercising the Job
            controller's failure backoff)
  rollout   Deployment template bumps (hash-based rolling update) and
            DaemonSet retargeting steps
  churn     Service create/delete churn against a fixed name pool
  drain     low-priority batch fill waves that saturate the fleet,
            then ONE high-priority surge (drawn tick in the second
            half of the day) — the flash-crowd drain scenario the
            preemption soak gates on (surge pods bind by evicting
            fill pods; sched/preemption.py)

Reference: the reference grows this as test/e2e's load/density
generators (RunRC + load.go's traffic shapes); v1.1 has no equivalent
replayable trace engine — see DIVERGENCES.md.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..utils.clock import REAL, Clock

#: generator evaluation order inside one tick (ties in the merged
#: stream break by this order, deterministically)
GENERATORS = ("diurnal", "burst", "jobwave", "rollout", "churn", "drain")


@dataclass(frozen=True)
class WorkloadEvent:
    """One replayable workload action. Frozen + tuple params so event
    streams compare bit-for-bit across invocations."""

    tick: int
    generator: str
    action: str
    target: str = ""
    value: int = 0
    params: Tuple[int, ...] = ()


@dataclass
class WorkloadPlan:
    """One seed, one reproducible day of traffic."""

    seed: int = 0
    #: virtual steps in the replay (the compressed "day" axis)
    ticks: int = 24
    # ---- diurnal: demand = base + amp * sin(2pi * (t/period + phase))
    diurnal_base: int = 30
    diurnal_amp: int = 20
    diurnal_period: int = 24
    diurnal_noise: int = 2
    deployment: str = "web"
    # ---- burst: flash crowds of bare pods
    burst_rate: float = 0.15
    burst_min: int = 8
    burst_max: int = 24
    # ---- jobwave: batch Job waves
    jobwave_rate: float = 0.2
    jobwave_max_parallelism: int = 3
    jobwave_max_extra_completions: int = 3
    jobwave_fail_fraction: float = 0.25
    # ---- rollout: Deployment image bumps + DaemonSet retargeting
    rollout_rate: float = 0.12
    daemonset: str = "agent"
    n_zones: int = 4
    # ---- churn: Service create/delete against a fixed pool
    churn_rate: float = 0.5
    service_pool: int = 6
    # ---- drain: low-priority batch fill waves + one high-priority
    # surge. Defaults are crowd-pod sized (10m/16Mi) so the generator
    # rides along in every workload soak without saturating anything;
    # the flash-drain soak passes fleet-saturating requests explicitly.
    drain_fill_rate: float = 0.3
    drain_fill_min: int = 4
    drain_fill_max: int = 12
    drain_fill_priority: int = -100
    drain_fill_cpu_milli: int = 10
    drain_fill_mem_mi: int = 16
    drain_surge_min: int = 4
    drain_surge_max: int = 12
    drain_surge_priority: int = 1000
    drain_surge_cpu_milli: int = 10
    drain_surge_mem_mi: int = 16

    def stream(self, generator: str) -> random.Random:
        # str seeding hashes via sha512 — stable across processes
        # (same rule as FaultPlan/NodeFaultPlan/CrashPlan.stream)
        return random.Random(f"{self.seed}:workload:{generator}")

    # ------------------------------------------------------- generators
    #
    # Each consumes a FIXED number of draws per tick (noted per
    # generator), so tick t's event never depends on earlier branches.

    def _diurnal(self) -> List[WorkloadEvent]:
        """1 setup draw (phase) + 1 draw/tick (noise)."""
        rng = self.stream("diurnal")
        phase = rng.random()
        out = []
        for t in range(self.ticks):
            noise = (rng.random() * 2.0 - 1.0) * self.diurnal_noise
            demand = self.diurnal_base + self.diurnal_amp * math.sin(
                2.0 * math.pi * (t / max(1, self.diurnal_period) + phase))
            out.append(WorkloadEvent(
                tick=t, generator="diurnal", action="demand",
                target=self.deployment,
                value=max(0, int(round(demand + noise)))))
        return out

    def _burst(self) -> List[WorkloadEvent]:
        """2 draws/tick (start?, size)."""
        rng = self.stream("burst")
        out = []
        for t in range(self.ticks):
            r_start, r_size = rng.random(), rng.random()
            if r_start < self.burst_rate:
                span = self.burst_max - self.burst_min + 1
                out.append(WorkloadEvent(
                    tick=t, generator="burst", action="crowd",
                    target=f"crowd-{t:03d}",
                    value=self.burst_min + int(r_size * span) % span))
        return out

    def _jobwave(self) -> List[WorkloadEvent]:
        """4 draws/tick (start?, parallelism, completions, failing?)."""
        rng = self.stream("jobwave")
        out = []
        for t in range(self.ticks):
            r_start, r_par, r_comp, r_fail = (rng.random(), rng.random(),
                                              rng.random(), rng.random())
            if r_start < self.jobwave_rate:
                par = 1 + int(r_par * self.jobwave_max_parallelism) \
                    % self.jobwave_max_parallelism
                completions = par + int(
                    r_comp * (self.jobwave_max_extra_completions + 1)) \
                    % (self.jobwave_max_extra_completions + 1)
                failing = 1 if r_fail < self.jobwave_fail_fraction else 0
                out.append(WorkloadEvent(
                    tick=t, generator="jobwave", action="job",
                    target=f"wave-{t:03d}", value=completions,
                    params=(par, failing)))
        return out

    def _rollout(self) -> List[WorkloadEvent]:
        """3 draws/tick (step?, kind, param). Deployment image versions
        are the running count of prior deploy steps (pure)."""
        rng = self.stream("rollout")
        out = []
        version = 1
        for t in range(self.ticks):
            r_step, r_kind, r_param = (rng.random(), rng.random(),
                                       rng.random())
            if r_step >= self.rollout_rate:
                continue
            if r_kind < 0.5:
                version += 1
                out.append(WorkloadEvent(
                    tick=t, generator="rollout", action="deploy_image",
                    target=self.deployment, value=version))
            else:
                # zone -1 clears the selector (daemons on every node)
                zone = int(r_param * (self.n_zones + 1)) \
                    % (self.n_zones + 1) - 1
                out.append(WorkloadEvent(
                    tick=t, generator="rollout", action="ds_retarget",
                    target=self.daemonset, value=zone))
        return out

    def _churn(self) -> List[WorkloadEvent]:
        """3 draws/tick (act?, create-vs-delete, index)."""
        rng = self.stream("churn")
        out = []
        for t in range(self.ticks):
            r_act, r_kind, r_idx = (rng.random(), rng.random(),
                                    rng.random())
            if r_act < self.churn_rate:
                idx = int(r_idx * self.service_pool) % self.service_pool
                action = "svc_create" if r_kind < 0.5 else "svc_delete"
                out.append(WorkloadEvent(
                    tick=t, generator="churn", action=action,
                    target=f"svc-{idx}"))
        return out

    def _drain(self) -> List[WorkloadEvent]:
        """1 setup draw (surge tick) + 3 draws/tick (fill?, fill size,
        surge size). Event params carry (priority, cpu_milli, mem_mi)
        so the trace pins the exact pods a replay must create."""
        rng = self.stream("drain")
        half = self.ticks // 2
        span_t = max(1, self.ticks - half)
        surge_tick = half + int(rng.random() * span_t) % span_t
        out = []
        for t in range(self.ticks):
            r_fill, r_fsize, r_ssize = (rng.random(), rng.random(),
                                        rng.random())
            if r_fill < self.drain_fill_rate:
                span = self.drain_fill_max - self.drain_fill_min + 1
                out.append(WorkloadEvent(
                    tick=t, generator="drain", action="batch_fill",
                    target=f"fill-{t:03d}",
                    value=self.drain_fill_min + int(r_fsize * span) % span,
                    params=(self.drain_fill_priority,
                            self.drain_fill_cpu_milli,
                            self.drain_fill_mem_mi)))
            if t == surge_tick:
                span = self.drain_surge_max - self.drain_surge_min + 1
                out.append(WorkloadEvent(
                    tick=t, generator="drain", action="surge",
                    target=f"surge-{t:03d}",
                    value=self.drain_surge_min + int(r_ssize * span) % span,
                    params=(self.drain_surge_priority,
                            self.drain_surge_cpu_milli,
                            self.drain_surge_mem_mi)))
        return out

    def surge_tick(self) -> int:
        """The tick the drain surge lands at (pure) — the flash-drain
        soak keys its SLO trip window off it."""
        for ev in self._drain():
            if ev.action == "surge":
                return ev.tick
        return self.ticks  # unreachable for ticks >= 1

    # ----------------------------------------------------------- replay

    def schedule(self) -> Dict[str, List[WorkloadEvent]]:
        """The full trace, replayed purely — what any live run with
        this seed MUST apply, per generator stream."""
        return {"diurnal": self._diurnal(), "burst": self._burst(),
                "jobwave": self._jobwave(), "rollout": self._rollout(),
                "churn": self._churn(), "drain": self._drain()}

    def events(self) -> List[WorkloadEvent]:
        """The merged stream, ordered by (tick, generator order) — the
        order `WorkloadChaos.apply_tick` applies events in."""
        sched = self.schedule()
        rank = {g: i for i, g in enumerate(GENERATORS)}
        return sorted((ev for evs in sched.values() for ev in evs),
                      key=lambda e: (e.tick, rank[e.generator]))

    def demand_curve(self) -> List[int]:
        """Per-tick diurnal demand (pure) — what the HPA convergence
        gate compares replica counts against."""
        return [ev.value for ev in self._diurnal()]

    def expected_services(self) -> List[str]:
        """The service set a full replay must end with (pure fold of
        the churn stream) — a state-equality gate both same-seed
        invocations are compared against."""
        live: set = set()
        for ev in self._churn():
            if ev.action == "svc_create":
                live.add(ev.target)
            else:
                live.discard(ev.target)
        return sorted(live)

    def final_ds_selector(self) -> Optional[int]:
        """The DaemonSet zone the replay ends retargeted at (-1 = all
        nodes), or None when the rollout stream never retargets."""
        zone = None
        for ev in self._rollout():
            if ev.action == "ds_retarget":
                zone = ev.value
        return zone


class WorkloadChaos:
    """Apply a WorkloadPlan against a cluster, recording a trace.

    The applier is intentionally thin: it owns WHAT happens (object
    creates/updates/deletes in plan order, retried through injected API
    faults until they land) and records it; the soak harness owns the
    surrounding cluster and the SLO measurement. `demand` is the shared
    diurnal demand signal the harness wires into the HPA's metrics
    source."""

    def __init__(self, client, plan: WorkloadPlan,
                 namespace: str = "default",
                 clock: Optional[Clock] = None):
        self.client = client
        self.plan = plan
        self.namespace = namespace
        self.clock = clock or REAL
        self.demand = plan.diurnal_base  # pre-replay demand floor
        self._by_tick: Dict[int, List[WorkloadEvent]] = {}
        for ev in plan.events():
            self._by_tick.setdefault(ev.tick, []).append(ev)
        self._trace: Dict[str, List[WorkloadEvent]] = \
            {g: [] for g in GENERATORS}
        #: crowd pods created, in creation order (the burst-window
        #: bind-SLO population)
        self.crowd_pods: List[str] = []
        #: jobs created -> (completions, failing)
        self.jobs: Dict[str, Tuple[int, bool]] = {}
        #: optional hook(names) fired the moment a crowd batch lands —
        #: the soak stamps burst-pod creation times here, so the
        #: bind-latency SLO clock starts at the POST, not at a poll
        self.on_crowd = None
        #: drain-generator state, same shape: fill pods and surge pods
        #: in creation order, plus the surge hook the flash-drain soak
        #: stamps surge-bind SLO clocks with
        self.drain_pods: List[str] = []
        self.surge_pods: List[str] = []
        self.on_surge = None

    def trace(self) -> Dict[str, List[WorkloadEvent]]:
        """Events actually applied, per generator, in apply order — a
        run is reproducible when this equals plan.schedule() for every
        tick the run replayed."""
        return {g: list(evs) for g, evs in self._trace.items()}

    def apply_tick(self, tick: int, deadline: float,
                   generators=None) -> List[WorkloadEvent]:
        """Apply every event of one tick, in merged-stream order. Each
        apply retries through injected faults until it lands or the
        deadline (on this applier's clock.monotonic() axis) passes —
        an event that never lands leaves the trace short, which the
        schedule-replay gate then correctly fails. `generators`
        restricts the replay to a subset of streams (the flash-drain
        soak replays only "drain"; its reproducibility gate then
        compares only that stream's trace)."""
        applied = []
        for ev in self._by_tick.get(tick, ()):
            if generators is not None and ev.generator not in generators:
                continue
            while True:
                try:
                    self._apply(ev)
                except Exception:
                    if self.clock.monotonic() > deadline:
                        return applied
                    self.clock.sleep(0.02)
                    continue
                self._trace[ev.generator].append(ev)
                applied.append(ev)
                break
        return applied

    # ------------------------------------------------------ event verbs

    def _apply(self, ev: WorkloadEvent) -> None:
        from ..core import types as api
        from ..core.errors import AlreadyExists, NotFound
        ns = self.namespace
        if ev.action == "demand":
            self.demand = ev.value
        elif ev.action == "crowd":
            names = [f"{ev.target}-{i:03d}" for i in range(ev.value)]
            pods = [p for p in (self._crowd_pod(n) for n in names)
                    if p is not None]
            if pods:
                self.client.create_batch("pods", pods, ns)
            created = [n for n in names if n not in set(self.crowd_pods)]
            self.crowd_pods.extend(created)
            if self.on_crowd and created:
                self.on_crowd(created)
        elif ev.action == "job":
            par, failing = ev.params
            labels = {"wave": ev.target}
            try:
                self.client.create("jobs", api.Job(
                    metadata=api.ObjectMeta(
                        name=ev.target, namespace=ns,
                        labels={"failing": str(failing)}),
                    spec=api.JobSpec(
                        parallelism=par, completions=ev.value,
                        selector=labels,
                        template=api.PodTemplateSpec(
                            metadata=api.ObjectMeta(labels=dict(labels)),
                            spec=self._tiny_pod_spec()))), ns)
            except AlreadyExists:
                pass  # landed on a retried apply
            self.jobs[ev.target] = (ev.value, bool(failing))
        elif ev.action == "deploy_image":
            d = self.client.get("deployments", ev.target, ns)
            from dataclasses import replace
            tpl = d.spec.template
            spec = replace(tpl.spec, containers=[
                replace(c, image=f"img:v{ev.value}")
                for c in tpl.spec.containers])
            self.client.update("deployments", replace(
                d, spec=replace(d.spec, template=replace(
                    tpl, spec=spec))), ns)
        elif ev.action == "ds_retarget":
            ds = self.client.get("daemonsets", ev.target, ns)
            from dataclasses import replace
            sel = {} if ev.value < 0 else {"zone": f"z{ev.value}"}
            tpl = ds.spec.template
            self.client.update("daemonsets", replace(
                ds, spec=replace(ds.spec, template=replace(
                    tpl, spec=replace(tpl.spec, node_selector=sel)))), ns)
        elif ev.action in ("batch_fill", "surge"):
            prio, cpu_m, mem_mi = ev.params
            surge = ev.action == "surge"
            seen_list = self.surge_pods if surge else self.drain_pods
            seen = set(seen_list)
            names = [f"{ev.target}-{i:03d}" for i in range(ev.value)]
            labels = {"surge": "1"} if surge else {"drain": "1"}
            pods = [self._drain_pod(n, prio, cpu_m, mem_mi, labels)
                    for n in names if n not in seen]
            if pods:
                self.client.create_batch("pods", pods, ns)
            created = [n for n in names if n not in seen]
            seen_list.extend(created)
            if surge and self.on_surge and created:
                self.on_surge(created)
        elif ev.action == "svc_create":
            try:
                self.client.create("services", api.Service(
                    metadata=api.ObjectMeta(name=ev.target, namespace=ns),
                    spec=api.ServiceSpec(
                        selector={"app": ev.target},
                        ports=[api.ServicePort(port=80)])), ns)
            except AlreadyExists:
                pass  # churn drew a create for a live name: a no-op
        elif ev.action == "svc_delete":
            try:
                self.client.delete("services", ev.target, ns)
            except NotFound:
                pass  # churn drew a delete for a dead name: a no-op
        else:  # pragma: no cover - plan and applier are one module
            raise ValueError(f"unknown workload action {ev.action!r}")

    def _crowd_pod(self, name: str):
        from ..core import types as api
        from ..core.quantity import parse_quantity
        if name in self.crowd_pods:
            return None  # landed on a retried apply
        return api.Pod(
            metadata=api.ObjectMeta(name=name, namespace=self.namespace,
                                    labels={"crowd": "1"}),
            spec=api.PodSpec(containers=[api.Container(
                name="c", image="img",
                resources=api.ResourceRequirements(
                    requests={"cpu": parse_quantity("10m"),
                              "memory": parse_quantity("16Mi")}))]),
            status=api.PodStatus(phase="Pending"))

    def _drain_pod(self, name: str, prio: int, cpu_m: int, mem_mi: int,
                   labels: Dict[str, str]):
        from ..core import types as api
        from ..core.quantity import parse_quantity
        return api.Pod(
            metadata=api.ObjectMeta(name=name, namespace=self.namespace,
                                    labels=dict(labels)),
            spec=api.PodSpec(priority=prio, containers=[api.Container(
                name="c", image="img",
                resources=api.ResourceRequirements(
                    requests={"cpu": parse_quantity(f"{cpu_m}m"),
                              "memory": parse_quantity(f"{mem_mi}Mi")}))]),
            status=api.PodStatus(phase="Pending"))

    def _tiny_pod_spec(self):
        from ..core import types as api
        from ..core.quantity import parse_quantity
        return api.PodSpec(containers=[api.Container(
            name="c", image="img",
            resources=api.ResourceRequirements(
                requests={"cpu": parse_quantity("10m"),
                          "memory": parse_quantity("16Mi")}))])
