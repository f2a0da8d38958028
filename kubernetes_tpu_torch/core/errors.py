"""API errors with HTTP status semantics.

Mirrors the reference's pkg/api/errors (StatusError carrying a Status object
with reason/code) in a minimal Python form; these surface both through the
in-process client and as HTTP status codes from the REST server.
"""

from __future__ import annotations


class ApiError(Exception):
    code = 500
    reason = "InternalError"
    #: seconds the server asked the client to wait before retrying
    #: (header-borne — a 429's Retry-After; None when the server sent
    #: none). Consumed by api.retry.RetryPolicy.
    retry_after = None

    def __init__(self, message: str = "", kind: str = "", name: str = ""):
        self.kind = kind
        self.name = name
        if not message and (kind or name):
            message = f'{self.reason}: {kind or "object"} "{name}"'
        super().__init__(message or self.reason)

    def status(self) -> dict:
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Failure",
            "message": str(self),
            "reason": self.reason,
            "code": self.code,
            "details": {"kind": self.kind, "name": self.name},
        }


class NotFound(ApiError):
    code = 404
    reason = "NotFound"


class AlreadyExists(ApiError):
    code = 409
    reason = "AlreadyExists"


class Conflict(ApiError):
    code = 409
    reason = "Conflict"


class Invalid(ApiError):
    code = 422
    reason = "Invalid"


class BadRequest(ApiError):
    code = 400
    reason = "BadRequest"


class MethodNotSupported(ApiError):
    code = 405
    reason = "MethodNotSupported"


class Unauthorized(ApiError):
    code = 401
    reason = "Unauthorized"


class Forbidden(ApiError):
    code = 403
    reason = "Forbidden"


class TooManyRequests(ApiError):
    code = 429
    reason = "TooManyRequests"


class Expired(ApiError):
    """Watch window no longer contains the requested revision (410 Gone);
    the client must re-list (ref: pkg/storage/cacher.go 'too old resource
    version')."""
    code = 410
    reason = "Expired"


class BadGateway(ApiError):
    """An upstream the apiserver relays to (a node's kubelet) failed."""
    code = 502
    reason = "BadGateway"


class ServiceUnavailable(ApiError):
    """No backend can take the proxied request (ref:
    errors.NewServiceUnavailable, pkg/registry/service/rest.go:320)."""
    code = 503
    reason = "ServiceUnavailable"


def from_status(status: dict) -> ApiError:
    reason = status.get("reason", "")
    for cls in (NotFound, AlreadyExists, Conflict, Invalid, BadRequest,
                MethodNotSupported, Unauthorized, Forbidden, TooManyRequests,
                Expired, BadGateway, ServiceUnavailable):
        if cls.reason == reason:
            err = cls(status.get("message", ""))
            details = status.get("details") or {}
            err.kind = details.get("kind", "")
            err.name = details.get("name", "")
            return err
    return ApiError(status.get("message", "unknown error"))
