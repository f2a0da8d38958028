"""Request authentication and authorization.

Reference: pkg/auth/{authenticator,authorizer,user} interfaces with the
plugin set under plugin/pkg/auth (password/passwordfile basicauth,
tokenfile bearer tokens, union authenticators; ABAC file authorizer
pkg/apiserver/authz.go + pkg/auth/authorizer/abac). The API server wraps
its handler chain the way master.go:702,710 does: authenticate -> 401,
authorize -> 403, then route.
"""

from .authenticate import (Authenticator, BasicAuthAuthenticator,
                           TokenAuthenticator, UnionAuthenticator, UserInfo,
                           authenticate_request)
from .authorize import (ABACAuthorizer, AlwaysAllowAuthorizer,
                        AlwaysDenyAuthorizer, AuthorizerAttributes,
                        UnionAuthorizer, abac_from_lines)

__all__ = [
    "Authenticator", "BasicAuthAuthenticator", "TokenAuthenticator",
    "UnionAuthenticator", "UserInfo", "authenticate_request",
    "ABACAuthorizer", "AlwaysAllowAuthorizer", "AlwaysDenyAuthorizer",
    "AuthorizerAttributes", "UnionAuthorizer", "abac_from_lines",
]
