"""Storage-version migration: rewrite every stored object through the
current codec.

Reference: hack/test-update-storage-objects.sh — the reference
upgrades stored objects across API versions by reading each object and
writing it back through the new binary's codec (kubectl get | replace
against an apiserver running the target --storage-versions); its
pkg/conversion machinery (4,120 LoC of generated converters) does the
shape change in flight.

Here one wire version is served (DIVERGENCES #8), so migration's job
is NORMALIZATION: a store populated by an older build may hold JSON
with legacy/unknown fields (serde.from_wire drops them) or miss
newer fields (dataclass defaults fill them); rewriting re-encodes
every object in the current shape. A `transform` hook carries true
cross-version conversions (field renames, semantic rewrites) the day
there are two shapes — the role the reference's conversion functions
play.

Two entry points, mirroring the reference's two halves:
  - migrate_store(store): embedded path — walk a Store/NativeStore
    directly (the native store holds serialized bytes, so this is the
    real storage rewrite).
  - migrate_via_api(client): live-cluster path — GET each resource
    list and PUT every object back, exactly the script's
    kubectl-get-replace loop.

Both bump resourceVersions (so watchers observe MODIFIED, like any
write) and are idempotent — a second run rewrites again with no
semantic change.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .errors import NotFound

REGISTRY_PREFIX = "/registry/"


@dataclass
class MigrationReport:
    scanned: int = 0
    rewritten: int = 0
    failed: List[str] = field(default_factory=list)
    by_prefix: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"scanned": self.scanned, "rewritten": self.rewritten,
                "failed": self.failed, "by_prefix": self.by_prefix}


def migratable_resources() -> List[str]:
    """Every stored resource kind (componentstatuses are computed per
    request, never stored — the reference's script skips them too)."""
    from ..api.registry import RESOURCES
    return sorted(r for r in RESOURCES if r != "componentstatuses")


def migrate_store(store, transform: Optional[Callable] = None,
                  resources: Optional[List[str]] = None
                  ) -> MigrationReport:
    """Rewrite every stored object through the current codec.

    Works on both backends: list() decodes through the CURRENT
    from_wire (legacy fields drop, missing fields default), the
    optional transform applies the cross-version conversion, and a
    CAS write re-stores the object in the current encoding. Conflicts
    (a live writer won the race) re-read and retry via
    guaranteed_update — migration must never clobber newer state.
    (ThirdPartyResourceData lives under its own /registry/thirdparty/
    layout and is stored AS the carrier type, so the standard walk
    covers the declarations while custom objects re-encode through
    their carrier on read.)"""
    from ..api.registry import RESOURCES, Registry

    report = MigrationReport()
    for seg in (resources or migratable_resources()):
        info = RESOURCES.get(seg)
        if info is None:
            report.failed.append(f"{seg}: unknown resource")
            continue
        try:
            items, _rev = store.list(f"/registry/{seg}/")
        except Exception as e:
            # a corrupt value fails the whole segment's decode (list
            # is the only enumeration the store API affords) — report
            # it and KEEP WALKING the other resources
            report.failed.append(f"/registry/{seg}/: list: {e!r}")
            continue
        for obj in items:
            report.scanned += 1
            meta = obj.metadata
            key = Registry.key(seg, meta.namespace, meta.name)
            try:
                def rewrite(cur, _t=transform):
                    return _t(cur) if _t is not None else cur

                store.guaranteed_update(key, rewrite)
                report.rewritten += 1
                report.by_prefix[seg] = report.by_prefix.get(seg, 0) + 1
            except NotFound:
                # deleted (or TTL-expired: events) between list and
                # rewrite — the race migrate_via_api also tolerates;
                # a gone object needs no migration
                pass
            except Exception as e:  # keep walking; report stragglers
                report.failed.append(f"{key}: {e!r}")
    # custom-object data rides its own /registry/thirdparty/ layout
    # (registry.third_party_key): enumerate via the stored TPR
    # declarations so at-rest custom resources get rewritten too
    if resources is None:
        _migrate_third_party(store, transform, report)
    return report


def _migrate_third_party(store, transform, report: MigrationReport
                         ) -> None:
    from ..api.registry import extract_group_and_kind

    try:
        tprs, _ = store.list("/registry/thirdpartyresources/")
    except Exception as e:
        report.failed.append(f"thirdpartyresources: list: {e!r}")
        return
    for tpr in tprs:
        try:
            _kind, group, plural = extract_group_and_kind(tpr)
        except Exception as e:
            report.failed.append(
                f"tpr {tpr.metadata.name}: {e!r}")
            continue
        prefix = f"/registry/thirdparty/{group}/{plural}/"
        try:
            items, _ = store.list(prefix)
        except Exception as e:
            report.failed.append(f"{prefix}: list: {e!r}")
            continue
        for obj in items:
            report.scanned += 1
            meta = obj.metadata
            key = f"{prefix}{meta.namespace}/{meta.name}"
            try:
                def rewrite(cur, _t=transform):
                    return _t(cur) if _t is not None else cur

                store.guaranteed_update(key, rewrite)
                report.rewritten += 1
                report.by_prefix["thirdparty"] = \
                    report.by_prefix.get("thirdparty", 0) + 1
            except Exception as e:
                report.failed.append(f"{key}: {e!r}")


def migrate_via_api(client, resources: Optional[List[str]] = None
                    ) -> MigrationReport:
    """The live-cluster half: list each resource through the API and
    PUT every object straight back (the reference script's
    kubectl get | kubectl replace loop) — the apiserver re-encodes
    through its current codec on the way to storage."""
    from ..core.errors import Conflict, NotFound

    report = MigrationReport()
    if resources is None:
        resources = migratable_resources()
    for resource in resources:
        try:
            items, _ = client.list(resource, "")
        except Exception as e:
            report.failed.append(f"{resource}: list: {e!r}")
            continue
        for obj in items:
            report.scanned += 1
            try:
                client.update(resource, obj, obj.metadata.namespace)
                report.rewritten += 1
                report.by_prefix[resource] = \
                    report.by_prefix.get(resource, 0) + 1
            except (Conflict, NotFound):
                pass  # a live writer moved it; its write IS current
            except Exception as e:
                report.failed.append(
                    f"{resource}/{obj.metadata.name}: {e!r}")
    return report
