"""Security-context application at the runtime boundary.

Reference: pkg/securitycontext/provider.go — SimpleSecurityContext
Provider.ModifyContainerConfig (RunAsUser -> config.User) and
ModifyHostConfig (Privileged, Capabilities Add/Drop -> HostConfig).
The admission side (SecurityContextDeny) polices these fields; this
module is the half that actually programs them into the engine's
container-create payload. The subprocess runtime applies what a
process CAN honor (it refuses privileged — there is no privileged
process mode to grant)."""

from __future__ import annotations

from typing import Optional

from ..core import types as api


def effective_privileged(container: api.Container) -> bool:
    """The flat pre-SecurityContext field OR the nested one — the
    reference reads SecurityContext.Privileged; the flat field stayed
    for wire compat with older objects."""
    if container.privileged:
        return True
    sc = container.security_context
    return bool(sc is not None and sc.privileged)


def apply_to_container_config(container: api.Container,
                              config: dict) -> None:
    """(provider.go ModifyContainerConfig). run_as_non_root is
    ENFORCED here, not silently carried: without image inspection the
    only verifiable non-root assertion is an explicit nonzero
    run_as_user — anything else must refuse to start (the
    fail-closed reading of the later reference's VerifyNonRoot)."""
    sc = container.security_context
    if sc is not None and sc.run_as_user is not None:
        config["User"] = str(sc.run_as_user)
    if sc is not None and sc.run_as_non_root:
        if sc.run_as_user is None:
            raise ValueError(
                f"container {container.name!r}: runAsNonRoot requires "
                f"an explicit runAsUser (image users are not "
                f"inspectable here)")
        if sc.run_as_user == 0:
            raise ValueError(
                f"container {container.name!r}: runAsNonRoot with "
                f"runAsUser=0 is contradictory")


def apply_to_host_config(container: api.Container,
                         host_config: dict) -> None:
    """(provider.go ModifyHostConfig)"""
    if effective_privileged(container):
        host_config["Privileged"] = True
    sc = container.security_context
    if sc is not None and sc.capabilities is not None:
        if sc.capabilities.add:
            host_config["CapAdd"] = list(sc.capabilities.add)
        if sc.capabilities.drop:
            host_config["CapDrop"] = list(sc.capabilities.drop)
