"""PersistentVolume claim binder.

Reference: pkg/controller/persistentvolume/persistent_volume_claim_binder.go
— reconcile pending claims against available volumes: pick the smallest
volume whose capacity and access modes satisfy the claim, stamp
volume.spec.claimRef + phase Bound and claim.spec.volumeName + status
Bound; when a bound claim disappears the volume goes Released (Retain
reclaim policy keeps it for an admin; Recycle makes it Available again).
"""

from __future__ import annotations

import threading
from dataclasses import replace
from typing import List, Optional

from ..core import types as api
from ..core.errors import ApiError, NotFound
from ..core.quantity import Quantity

SYNC_PERIOD = 10.0  # ref: --pvclaimbinder-sync-period default 10s


def _storage(capacity) -> int:
    q = capacity.get("storage")
    return q.milli if q is not None else 0


def _access_ok(volume: api.PersistentVolume,
               claim: api.PersistentVolumeClaim) -> bool:
    return set(claim.spec.access_modes) <= set(volume.spec.access_modes)


def match_volume(claim: api.PersistentVolumeClaim,
                 volumes: List[api.PersistentVolume]
                 ) -> Optional[api.PersistentVolume]:
    """Smallest satisfying available volume (ref: volume index
    findBestMatchForClaim: exact-or-larger capacity, access mode subset)."""
    want = _storage(claim.spec.resources.requests)
    best = None
    for volume in volumes:
        if volume.spec.claim_ref is not None:
            continue
        if volume.status.phase not in ("", api.VOLUME_AVAILABLE):
            continue
        if not _access_ok(volume, claim):
            continue
        if _storage(volume.spec.capacity) < want:
            continue
        if best is None or (_storage(volume.spec.capacity)
                            < _storage(best.spec.capacity)):
            best = volume
    return best


class PersistentVolumeClaimBinder:
    def __init__(self, client, sync_period: float = SYNC_PERIOD):
        self.client = client
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- sync

    def sync_once(self) -> int:
        """Returns number of bind/release actions taken."""
        try:
            volumes, _ = self.client.list("persistentvolumes")
            claims, _ = self.client.list("persistentvolumeclaims")
        except Exception:
            return 0
        actions = 0
        claims_by_key = {(c.metadata.namespace, c.metadata.name): c
                         for c in claims}

        # phase volumes whose claim vanished; recycle if policy says so
        for volume in volumes:
            ref = volume.spec.claim_ref
            if ref is None:
                if volume.status.phase == "":
                    self._set_volume_phase(volume, api.VOLUME_AVAILABLE)
                    actions += 1
                continue
            if (ref.namespace, ref.name) not in claims_by_key:
                if volume.spec.persistent_volume_reclaim_policy == "Recycle":
                    scrubbed = replace(
                        volume,
                        spec=replace(volume.spec, claim_ref=None),
                        status=api.PersistentVolumeStatus(
                            phase=api.VOLUME_AVAILABLE))
                    self._update_volume(scrubbed)
                else:
                    self._set_volume_phase(volume, api.VOLUME_RELEASED)
                actions += 1
            elif volume.status.phase != api.VOLUME_BOUND:
                self._set_volume_phase(volume, api.VOLUME_BOUND)
                actions += 1

        # bind pending claims — against a fresh listing, since the phase
        # pass above bumped resource versions (stale objects would CAS-fail)
        if actions:
            try:
                volumes, _ = self.client.list("persistentvolumes")
            except Exception:
                return actions
        bound_refs = {(v.spec.claim_ref.namespace, v.spec.claim_ref.name):
                      v.metadata.name
                      for v in volumes if v.spec.claim_ref is not None}
        for claim in claims:
            key = (claim.metadata.namespace, claim.metadata.name)
            if claim.status.phase == api.CLAIM_BOUND:
                continue
            if key in bound_refs:
                # pre-bound volume (admin-set claimRef) or a crash between
                # volume and claim writes: finish from the volume's side
                self._mark_claim_bound(claim, bound_refs[key])
                actions += 1
                continue
            volume = match_volume(claim, volumes)
            if volume is None:
                if claim.status.phase != api.CLAIM_PENDING:
                    self._set_claim_phase(claim, api.CLAIM_PENDING)
                    actions += 1
                continue
            try:
                bound = replace(
                    volume,
                    spec=replace(volume.spec, claim_ref=api.ObjectReference(
                        kind="PersistentVolumeClaim",
                        namespace=claim.metadata.namespace,
                        name=claim.metadata.name,
                        uid=claim.metadata.uid)),
                    status=api.PersistentVolumeStatus(
                        phase=api.VOLUME_BOUND))
                self._update_volume(bound)
                # track locally so a later claim can't match this volume
                # this pass (store objects are never mutated in place)
                volumes[volumes.index(volume)] = bound
                bound_refs[key] = volume.metadata.name
                self._mark_claim_bound(claim, volume.metadata.name)
                actions += 1
            except ApiError:
                continue  # raced another binder; next resync converges
        return actions

    def _update_volume(self, volume: api.PersistentVolume) -> None:
        self.client.update("persistentvolumes", volume)

    def _set_volume_phase(self, volume: api.PersistentVolume,
                          phase: str) -> None:
        try:
            self.client.update_status("persistentvolumes", replace(
                volume, status=replace(volume.status, phase=phase)))
        except (NotFound, ApiError):
            pass

    def _mark_claim_bound(self, claim: api.PersistentVolumeClaim,
                          volume_name: str) -> None:
        try:
            if claim.spec.volume_name != volume_name:
                claim = self.client.update(
                    "persistentvolumeclaims",
                    replace(claim, spec=replace(claim.spec,
                                                volume_name=volume_name)),
                    claim.metadata.namespace)
            self.client.update_status("persistentvolumeclaims", replace(
                claim, status=api.PersistentVolumeClaimStatus(
                    phase=api.CLAIM_BOUND,
                    access_modes=list(claim.spec.access_modes))),
                claim.metadata.namespace)
        except (NotFound, ApiError):
            pass

    # -------------------------------------------------------- lifecycle

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.sync_once()
            self._stop.wait(self.sync_period)

    def run(self) -> "PersistentVolumeClaimBinder":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pv-claim-binder")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
