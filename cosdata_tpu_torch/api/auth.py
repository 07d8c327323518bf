"""Session-token authentication.

Mirrors upstream src/api/auth/ + src/models/crypto.rs:34-137:
POST /auth/create-session with the admin credentials returns an HMAC session
token valid for one hour, held in an in-memory map and checked by Bearer
middleware on every /vectordb route.

Port of ``cosdata_tpu/api/auth.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import threading
import time

SESSION_LIFETIME_SECS = 3600  # 1h (api/auth/service.rs)


class SessionManager:
    def __init__(self, admin_key: str):
        self.admin_key = admin_key
        self._secret = os.urandom(32)
        self._sessions: dict[str, dict] = {}
        self._lock = threading.Lock()

    def create_session(self, username: str, password: str) -> dict:
        # constant-time comparison: != short-circuits on the first
        # differing byte, leaking key prefixes through response timing
        if not (
            hmac.compare_digest(username.encode(), b"admin")
            and hmac.compare_digest(
                password.encode(), self.admin_key.encode()
            )
        ):
            raise PermissionError("invalid credentials")
        now = int(time.time())
        # nonce: two logins in the same second must not share a token
        payload = f"{username}:{now}:{os.urandom(8).hex()}".encode()
        token = hmac.new(self._secret, payload, hashlib.sha256).hexdigest()
        details = {
            "access_token": token,
            "created_at": now,
            "expires_at": now + SESSION_LIFETIME_SECS,
        }
        with self._lock:
            # opportunistic sweep so tokens never re-presented don't
            # accumulate forever (one login per request patterns)
            if len(self._sessions) >= 1024:
                self._sessions = {
                    t: d for t, d in self._sessions.items()
                    if d["expires_at"] >= now
                }
            self._sessions[token] = details
        return details

    def check(self, token: str | None) -> bool:
        if not token:
            return False
        with self._lock:
            details = self._sessions.get(token)
            if details is None:
                return False
            if details["expires_at"] < time.time():
                del self._sessions[token]
                return False
            return True
