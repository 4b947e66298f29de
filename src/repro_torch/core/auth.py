"""API-token authentication.

The paper (sec. 3) authenticates API calls with user-generated tokens
carried in the request path (``/api/ask/<token>``); each token has a
validity period defined at generation and can be revoked at any time.
Tokens here are HMAC-signed, self-describing strings so that stateless
server workers can verify them with only the shared secret, while
revocation is tracked in shared state.
"""
from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json
import threading
import time
import uuid


class AuthError(Exception):
    pass


def bearer_token(headers: dict) -> str | None:
    """The token of an ``Authorization: Bearer <token>`` header, else
    None (header missing, non-bearer scheme, or empty token).

    The single bearer-parsing policy: both the router's auth step and
    the event-loop frontend's response-cache probe go through this, so
    they can never drift apart.
    """
    header = next((v for k, v in headers.items()
                   if k.lower() == "authorization"), None)
    if header is None:
        return None
    scheme, _, token = header.partition(" ")
    if scheme.lower() != "bearer" or not token.strip():
        return None
    return token.strip()


class TokenManager:
    # verified-signature memo cap: a service sees few distinct tokens
    _VERIFY_CACHE_MAX = 1024

    def __init__(self, secret: str = "hopaas-secret"):
        self._secret = secret.encode()
        self._revoked: set[str] = set()
        self._lock = threading.Lock()
        # token -> payload for tokens whose signature already checked
        # out; expiry and revocation are still enforced on every call
        # (only the HMAC + base64/JSON decode are amortized)
        self._verified: dict[str, dict] = {}

    # -- issue ------------------------------------------------------------
    def issue(self, user: str, ttl_seconds: float = 30 * 24 * 3600.0) -> str:
        payload = {"user": user, "exp": time.time() + ttl_seconds,
                   "jti": uuid.uuid4().hex[:12]}
        body = base64.urlsafe_b64encode(json.dumps(payload).encode()).decode().rstrip("=")
        sig = self._sign(body)
        return f"{body}.{sig}"

    def _sign(self, body: str) -> str:
        return hmac.new(self._secret, body.encode(), hashlib.sha256).hexdigest()[:24]

    @staticmethod
    def _split(token: str) -> tuple[str, str]:
        try:
            body, sig = token.rsplit(".", 1)
        except (ValueError, AttributeError):
            raise AuthError("malformed token")
        return body, sig

    @staticmethod
    def _decode_payload(body: str) -> dict:
        """Decode a token body -> payload dict.  Every decode failure —
        bad base64, bad JSON, non-object payload, missing/ill-typed
        claims — surfaces as ``AuthError``, never a raw ``ValueError`` /
        ``binascii.Error`` (which the wire layer would turn into a 500
        instead of a 401)."""
        pad = "=" * (-len(body) % 4)
        try:
            payload = json.loads(base64.urlsafe_b64decode(body + pad))
        except (ValueError, binascii.Error):
            raise AuthError("malformed token body")
        if not isinstance(payload, dict) \
                or not isinstance(payload.get("exp"), (int, float)) \
                or not isinstance(payload.get("jti"), str):
            raise AuthError("malformed token body")
        return payload

    # -- verify -------------------------------------------------------------
    def verify(self, token: str) -> dict:
        payload = self._verified.get(token)
        if payload is None:
            body, sig = self._split(token)
            if not hmac.compare_digest(sig, self._sign(body)):
                raise AuthError("bad signature")
            payload = self._decode_payload(body)
            with self._lock:
                if len(self._verified) >= self._VERIFY_CACHE_MAX:
                    self._verified.pop(next(iter(self._verified)))
                self._verified[token] = payload
        if payload["exp"] < time.time():
            raise AuthError("token expired")
        with self._lock:
            if payload["jti"] in self._revoked:
                raise AuthError("token revoked")
        return payload

    def revoke(self, token: str) -> None:
        body, _sig = self._split(token)
        payload = self._decode_payload(body)
        with self._lock:
            self._revoked.add(payload["jti"])
