"""Mixed-mode scheduling: device-probed predicates/priorities + HTTP
extenders on the survivors.

The middle rung of the fast-path ladder (full batch > mixed > serial):
a policy with extenders can't run the all-device batch loop — the
extender RPC sits between filter and select (extender.go:95) — but the
O(nodes x predicates) inner math still belongs on device. Each pod gets
one probe (BatchEngine.probe over the incremental state), the extender
chain filters/scores the surviving nodes over HTTP, and selection uses
the reference's ordering with the engine's deterministic tie-break.

Pods the incremental encoder can't express (inter-pod affinity terms)
take a per-pod serial fallback — the provable-fallback contract at pod
granularity instead of condemning the whole policy to the serial loop.

The port's copy of the JAX package's module; the probe is the engine's
(one launch of the probe kernel on the card).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..core import types as api
from .api import HostPriority
from .device import BatchEngine
from .device.incremental import IncrementalEncoder, NeedsFullEncode
from .generic import FitError, GenericScheduler, sort_host_priorities


class DeviceAssistedAlgorithm:
    """Drop-in for the serial control loop's `algorithm` seam
    (scheduler_interface.go ScheduleAlgorithm), device-backed."""

    def __init__(self, factory, engine: BatchEngine,
                 extenders: Sequence,
                 serial_fallback: Optional[GenericScheduler] = None):
        self.factory = factory
        self.engine = engine
        self.extenders = list(extenders)
        self.serial_fallback = serial_fallback
        self.inc = IncrementalEncoder().attach(factory)

    def assume(self, pod: api.Pod) -> None:
        """Wired to SchedulerConfig.on_assume: the bound pod joins the
        persistent device state at the modeler-assume moment."""
        self.inc.assume(pod)

    def schedule(self, pod: api.Pod, node_lister) -> str:
        try:
            enc = self.inc.encode_tile(
                [pod], self.factory.service_lister.list(),
                self.factory.controller_lister.list())
        except NeedsFullEncode:
            if self.serial_fallback is None:
                raise
            return self.serial_fallback.schedule(pod, node_lister)
        mask, total = self.engine.probe(enc)
        mask, total = mask[0], total[0]
        # one pass over the candidate nodes (the Node objects are needed
        # for the extender wire format anyway); slots come from the
        # encoder's live table — stable for a node's life — instead of
        # rebuilding O(n_cap) dicts per pod
        slot = self.inc.node_slot
        n_lanes = len(mask)
        survivors: List[api.Node] = []
        for n in node_lister.list():
            i = slot.get(n.metadata.name)
            # bounds guard: a node added after encode_tile may hold a
            # slot past this probe's arrays (table growth); it wasn't in
            # the snapshot, so it simply isn't a candidate this pod
            if i is not None and i < n_lanes and mask[i]:
                survivors.append(n)
        if survivors:
            for extender in self.extenders:
                survivors = extender.filter(pod, survivors)
                if not survivors:
                    break
        if not survivors:
            raise FitError(pod, {})

        # a non-conformant extender may return hosts it was never sent
        # (the serial path tolerates them, extender.py decodes verbatim);
        # score unknowns at device 0 rather than KeyError-looping the pod
        combined = {}
        for n in survivors:
            i = slot.get(n.metadata.name)
            combined[n.metadata.name] = (
                int(total[i]) if i is not None and i < n_lanes else 0)
        for extender in self.extenders:
            try:
                scores, weight = extender.prioritize(pod, survivors)
            except Exception:
                continue  # prioritize errors are ignored
                # (generic_scheduler.go:197-199)
            for entry in scores:
                if entry.host in combined:
                    combined[entry.host] += entry.score * weight
        ordered = sort_host_priorities(
            [HostPriority(host, score) for host, score in combined.items()])
        # deterministic tie-break: first in reference order (the engine's
        # documented divergence from rand.Int()%len)
        return ordered[0].host
