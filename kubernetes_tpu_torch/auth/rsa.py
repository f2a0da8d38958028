"""Pure-Python RSA PKCS#1 v1.5 for OIDC RS256 token verification.

Reference: plugin/pkg/auth/authenticator/token/oidc/oidc.go validates
RS256 ID tokens against the provider's JWKS. The verify side is modular
exponentiation plus a byte-exact EMSA-PKCS1-v1_5 comparison (RFC 3447
section 8.2.2) — no crypto dependency needed. The signing/keygen half
exists so tests and the local identity-provider role can mint RS256
tokens; production verification never uses it.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import secrets
from typing import Dict, List, Optional, Tuple

# DigestInfo DER prefix for SHA-256 (RFC 3447 section 9.2 note 1)
_SHA256_DER_PREFIX = bytes.fromhex(
    "3031300d060960864801650304020105000420")


def _b64url_uint(data: str) -> int:
    pad = "=" * (-len(data) % 4)
    return int.from_bytes(base64.urlsafe_b64decode(data + pad), "big")


def _emsa_pkcs1_v15_sha256(message: bytes, k: int) -> Optional[bytes]:
    """EM = 0x00 0x01 PS 0x00 DigestInfo, len k (RFC 3447 9.2)."""
    t = _SHA256_DER_PREFIX + hashlib.sha256(message).digest()
    if k < len(t) + 11:
        return None
    return b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t


def verify_pkcs1v15_sha256(n: int, e: int, message: bytes,
                           signature: bytes) -> bool:
    """RSASSA-PKCS1-V1_5-VERIFY with SHA-256: encode-then-compare
    (byte-exact against the full EM, so padding malleability variants
    are rejected, not parsed)."""
    k = (n.bit_length() + 7) // 8
    if len(signature) != k:
        return False
    s = int.from_bytes(signature, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    expected = _emsa_pkcs1_v15_sha256(message, k)
    if expected is None:
        return False
    return hmac.compare_digest(em, expected)


# ------------------------------------------------------------------ JWKS

def jwks_rsa_keys(jwks: dict) -> List[Tuple[Optional[str], int, int]]:
    """[(kid, n, e)] for every usable RSA key in a JWKS document
    (unknown kty / malformed entries are skipped, as the reference's
    provider sync does)."""
    out = []
    for key in jwks.get("keys", []):
        if not isinstance(key, dict) or key.get("kty") != "RSA":
            continue
        try:
            n = _b64url_uint(key["n"])
            e = _b64url_uint(key["e"])
        except (KeyError, ValueError, TypeError):
            continue
        if n <= 0 or e <= 0:
            continue
        out.append((key.get("kid"), n, e))
    return out


# ---------------------------------------------------- test-side keygen

_SMALL_PRIMES = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47,
                 53, 59, 61, 67, 71, 73, 79, 83, 89, 97]


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        p = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(p):
            return p


def generate_keypair(bits: int = 1024) -> Dict[str, int]:
    """{'n','e','d'} — small-modulus keys for tests (not production
    key material; the authenticator only ever verifies)."""
    e = 65537
    while True:
        p = _random_prime(bits // 2)
        q = _random_prime(bits // 2)
        if p == q:
            continue
        n = p * q
        lam = (p - 1) * (q - 1)
        if lam % e == 0:
            continue
        d = pow(e, -1, lam)
        return {"n": n, "e": e, "d": d}


def sign_pkcs1v15_sha256(n: int, d: int, message: bytes) -> bytes:
    k = (n.bit_length() + 7) // 8
    em = _emsa_pkcs1_v15_sha256(message, k)
    if em is None:
        raise ValueError("modulus too small for SHA-256 DigestInfo")
    return pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")


def jwk_of(n: int, e: int, kid: str = "") -> dict:
    def b64(i: int) -> str:
        raw = i.to_bytes((i.bit_length() + 7) // 8, "big")
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()
    key = {"kty": "RSA", "n": b64(n), "e": b64(e), "alg": "RS256",
           "use": "sig"}
    if kid:
        key["kid"] = kid
    return key
