"""Request authenticators (ref: pkg/auth/authenticator, plugin/pkg/auth:
password/{allow,passwordfile}, request/{basicauth,union}, token/tokenfile).
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class UserInfo:
    """(ref: pkg/auth/user.DefaultInfo)"""
    name: str = ""
    uid: str = ""
    groups: List[str] = field(default_factory=list)


class Authenticator:
    """Returns (UserInfo, ok). Never raises for bad credentials — a False
    lets union try the next method (ref: authenticator.Request)."""

    def authenticate(self, headers) -> Tuple[Optional[UserInfo], bool]:
        raise NotImplementedError


def _parse_basic(header: str):
    """-> (user, password) from a Basic Authorization header, or None
    (shared by every password authenticator so the parse can't drift)."""
    if not header.startswith("Basic "):
        return None
    try:
        decoded = base64.b64decode(header[6:]).decode()
    except (binascii.Error, UnicodeDecodeError):
        return None
    user, _, password = decoded.partition(":")
    return user, password


class BasicAuthAuthenticator(Authenticator):
    """HTTP basic auth against a user->password map (ref:
    plugin/pkg/auth/authenticator/request/basicauth +
    password/passwordfile; file format: password,user,uid per line)."""

    def __init__(self, passwords: Dict[str, Tuple[str, str]]):
        """passwords: user -> (password, uid)"""
        self.passwords = passwords

    @classmethod
    def from_lines(cls, lines: Sequence[str]) -> "BasicAuthAuthenticator":
        out: Dict[str, Tuple[str, str]] = {}
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 3:
                raise ValueError(
                    f"password file line needs password,user,uid: {line!r}")
            password, user, uid = parts[0], parts[1], parts[2]
            out[user] = (password, uid)
        return cls(out)

    def authenticate(self, headers) -> Tuple[Optional[UserInfo], bool]:
        parsed = _parse_basic(headers.get("Authorization", ""))
        if parsed is None:
            return None, False
        user, password = parsed
        entry = self.passwords.get(user)
        expected = entry[0] if entry is not None else ""
        # constant-time compare forecloses the timing side channel
        ok = hmac.compare_digest(expected.encode(), password.encode())
        if entry is None or not ok:
            return None, False
        return UserInfo(name=user, uid=entry[1]), True


class TokenAuthenticator(Authenticator):
    """Bearer tokens against a token->user map (ref:
    plugin/pkg/auth/authenticator/token/tokenfile; file format:
    token,user,uid per line)."""

    def __init__(self, tokens: Dict[str, UserInfo]):
        self.tokens = tokens
        self._by_digest = {
            hashlib.sha256(t.encode()).hexdigest(): (t, u)
            for t, u in tokens.items()}

    @classmethod
    def from_lines(cls, lines: Sequence[str]) -> "TokenAuthenticator":
        out: Dict[str, UserInfo] = {}
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 3:
                raise ValueError(
                    f"token file line needs token,user,uid: {line!r}")
            out[parts[0]] = UserInfo(name=parts[1], uid=parts[2],
                                     groups=parts[3:])
        return cls(out)

    def authenticate(self, headers) -> Tuple[Optional[UserInfo], bool]:
        header = headers.get("Authorization", "")
        if not header.startswith("Bearer "):
            return None, False
        presented = header[7:]
        # probe by digest, then one constant-time compare of the stored
        # token — O(1) per request with no token-prefix timing channel
        digest = hashlib.sha256(presented.encode()).hexdigest()
        entry = self._by_digest.get(digest)
        if entry is None or not hmac.compare_digest(
                entry[0].encode(), presented.encode()):
            return None, False
        return entry[1], True


def _b64url_decode(part: str) -> bytes:
    pad = "=" * (-len(part) % 4)
    return base64.urlsafe_b64decode(part + pad)


class JWTAuthenticator(Authenticator):
    """OIDC bearer JWTs: signature + iss/aud/exp claims checked,
    identity from configurable claims.

    Reference: plugin/pkg/auth/authenticator/token/oidc (flags
    --oidc-issuer-url/-client-id/-username-claim/-groups-claim;
    oidc.go verifies RS256 against the provider's JWKS). RS256 is
    verified here with pure-Python PKCS#1 v1.5 (auth/rsa.py) against a
    JWKS document; HS256 against a shared secret stays for the local
    identity-provider role. Algorithm dispatch is strict — an RS256
    public key can never be used as an HS256 secret (the classic JWT
    alg-confusion downgrade), because each algorithm only consults its
    own key material and a missing secret/jwks rejects outright."""

    def __init__(self, secret: Optional[bytes] = None, issuer: str = "",
                 audience: str = "", username_claim: str = "sub",
                 groups_claim: str = "groups", clock=None,
                 jwks: Optional[dict] = None):
        self.secret = secret
        self.issuer = issuer
        self.audience = audience
        self.username_claim = username_claim
        self.groups_claim = groups_claim
        self._now = clock or time.time
        from . import rsa as rsapkg
        self._rsa = rsapkg
        self._rsa_keys = rsapkg.jwks_rsa_keys(jwks) if jwks else []

    def _signature_ok(self, head: dict, parts: List[str]) -> bool:
        alg = head.get("alg")
        signing_input = f"{parts[0]}.{parts[1]}".encode()
        sig = _b64url_decode(parts[2])
        if alg == "HS256":
            if not self.secret:
                return False
            expected = hmac.new(self.secret, signing_input,
                                hashlib.sha256).digest()
            return hmac.compare_digest(expected, sig)
        if alg == "RS256":
            kid = head.get("kid")
            candidates = [(k, n, e) for k, n, e in self._rsa_keys
                          if kid is None or k is None or k == kid]
            return any(
                self._rsa.verify_pkcs1v15_sha256(n, e, signing_input, sig)
                for _k, n, e in candidates)
        return False  # unknown or absent alg (incl. "none"): reject

    def authenticate(self, headers) -> Tuple[Optional[UserInfo], bool]:
        header = headers.get("Authorization", "")
        if not header.startswith("Bearer "):
            return None, False
        token = header[7:]
        parts = token.split(".")
        if len(parts) != 3:
            return None, False
        try:
            import json
            head = json.loads(_b64url_decode(parts[0]))
            if not self._signature_ok(head, parts):
                return None, False
            claims = json.loads(_b64url_decode(parts[1]))
        except (ValueError, binascii.Error):
            return None, False
        if self.issuer and claims.get("iss") != self.issuer:
            return None, False
        if self.audience:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                return None, False
        exp = claims.get("exp")
        if exp is not None:
            try:
                if float(exp) <= self._now():
                    return None, False
            except (TypeError, ValueError):
                return None, False  # unparseable exp: reject, not 500
        name = claims.get(self.username_claim)
        if not name:
            return None, False
        groups = claims.get(self.groups_claim) or []
        if not isinstance(groups, list):
            groups = [groups]
        return UserInfo(name=str(name), uid=str(claims.get("sub", "")),
                        groups=[str(g) for g in groups]), True


def _b64url_encode_json(obj) -> str:
    import json
    raw = json.dumps(obj, separators=(",", ":")).encode()
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


def make_jwt(secret: bytes, claims: dict, header: Optional[dict] = None
             ) -> str:
    """Mint an HS256 JWT (tests + local identity provider role).
    `header` overrides let tests forge alg-confusion headers."""
    head = _b64url_encode_json(header or {"alg": "HS256", "typ": "JWT"})
    body = _b64url_encode_json(claims)
    sig = hmac.new(secret, f"{head}.{body}".encode(),
                   hashlib.sha256).digest()
    return (f"{head}.{body}."
            f"{base64.urlsafe_b64encode(sig).rstrip(b'=').decode()}")


def make_jwt_rs256(key: Dict[str, int], claims: dict, kid: str = ""
                   ) -> str:
    """Mint an RS256 JWT with an auth.rsa keypair dict {'n','e','d'}
    (tests + local identity provider role)."""
    from . import rsa as rsapkg
    header = {"alg": "RS256", "typ": "JWT"}
    if kid:
        header["kid"] = kid
    head = _b64url_encode_json(header)
    body = _b64url_encode_json(claims)
    sig = rsapkg.sign_pkcs1v15_sha256(key["n"], key["d"],
                                      f"{head}.{body}".encode())
    return (f"{head}.{body}."
            f"{base64.urlsafe_b64encode(sig).rstrip(b'=').decode()}")


class X509Authenticator(Authenticator):
    """Client-certificate auth: CommonName -> user, Organization ->
    groups, from the CA-verified TLS peer subject the ApiServer injects
    as the X-Peer-Certificate pseudo-header (the server strips any
    client-supplied copy, so the header only ever carries what the TLS
    layer verified). Ref: plugin/pkg/auth/authenticator/request/x509
    CommonNameUserConversion."""

    def authenticate(self, headers) -> Tuple[Optional[UserInfo], bool]:
        raw = headers.get("X-Peer-Certificate", "")
        if not raw:
            return None, False
        try:
            subject = json.loads(raw)
        except ValueError:
            return None, False
        cn = ""
        orgs = []
        # ssl.getpeercert subject: sequence of RDNs, each a sequence of
        # (attribute, value) pairs
        for rdn in subject:
            for pair in rdn:
                if len(pair) != 2:
                    continue
                attr, value = pair
                if attr == "commonName" and not cn:
                    cn = value
                elif attr == "organizationName":
                    orgs.append(value)
        if not cn:
            return None, False
        return UserInfo(name=cn, groups=orgs), True


class KeystonePasswordAuthenticator(Authenticator):
    """Basic-auth credentials validated against an external identity
    service speaking the Keystone v2 tokens API (POST {auth_url}/tokens
    with passwordCredentials; any 2xx authenticates).

    Reference: plugin/pkg/auth/authenticator/request/keystone/
    keystone.go — AuthenticatePassword delegates the check to the
    keystone endpoint and returns DefaultInfo{Name: username}. Same
    https-only constraint (keystone.go NewKeystoneAuthenticator), with
    an explicit escape hatch for tests."""

    def __init__(self, auth_url: str, timeout: float = 10.0,
                 allow_insecure_for_tests: bool = False):
        if not auth_url:
            raise ValueError("auth URL is empty")
        if not auth_url.startswith("https") and not allow_insecure_for_tests:
            raise ValueError(
                "auth URL should be secure and start with https")
        self.auth_url = auth_url.rstrip("/")
        self.timeout = timeout

    def _validate(self, username: str, password: str) -> bool:
        import json as jsonlib
        import urllib.error
        import urllib.request
        body = jsonlib.dumps({"auth": {"passwordCredentials": {
            "username": username, "password": password}}}).encode()
        req = urllib.request.Request(
            self.auth_url + "/tokens", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return 200 <= r.status < 300
        except (urllib.error.URLError, OSError, ValueError):
            return False

    def authenticate(self, headers) -> Tuple[Optional[UserInfo], bool]:
        parsed = _parse_basic(headers.get("Authorization", ""))
        if parsed is None:
            return None, False
        user, password = parsed
        if not user or not self._validate(user, password):
            return None, False
        return UserInfo(name=user), True


class UnionAuthenticator(Authenticator):
    """First success wins (ref: request/union)."""

    def __init__(self, authenticators: Sequence[Authenticator]):
        self.authenticators = list(authenticators)

    def authenticate(self, headers) -> Tuple[Optional[UserInfo], bool]:
        for a in self.authenticators:
            info, ok = a.authenticate(headers)
            if ok:
                return info, True
        return None, False


def authenticate_request(authenticator: Optional[Authenticator],
                         headers) -> Tuple[Optional[UserInfo], bool]:
    """None authenticator = open server (every request is anonymous ok)."""
    if authenticator is None:
        return UserInfo(name="system:anonymous"), True
    return authenticator.authenticate(headers)
