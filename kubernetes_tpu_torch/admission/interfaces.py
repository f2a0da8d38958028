"""Admission interfaces (ref: pkg/admission/interfaces.go)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..core.errors import Forbidden  # noqa: F401 (re-exported: the
# admission rejection error, ref admission.NewForbidden -> 403)


class Operation:
    CREATE = "CREATE"
    UPDATE = "UPDATE"
    DELETE = "DELETE"
    CONNECT = "CONNECT"  # exec/attach/proxy subresources


@dataclass
class Attributes:
    """(ref: interfaces.go Attributes)"""
    object: Any = None
    namespace: str = ""
    name: str = ""
    resource: str = ""
    operation: str = Operation.CREATE
    user_name: str = ""


class Interface:
    """One admission plugin. admit() may MUTATE attributes.object (the
    mutating plugins: limitranger defaults, serviceaccount injection) or
    raise Forbidden/ApiError to reject the request."""

    def admit(self, attributes: Attributes) -> None:
        raise NotImplementedError

    def handles(self, operation: str) -> bool:
        return True
