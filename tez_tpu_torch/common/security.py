"""Security primitives: the job token.

Reference parity: tez-api/.../common/security/JobTokenSecretManager.java:40.

The port's copy of tez_tpu.common.security's JobTokenSecretManager, the
AM's per-app secret; the shuffle-request HMAC and the ACLs come with the
remote shuffle path, which is not ported yet.
"""
from __future__ import annotations

import hashlib
import hmac
import os
from typing import Optional


class JobTokenSecretManager:
    """Per-app shared secret between orchestrator and shuffle servers."""

    def __init__(self, secret: Optional[bytes] = None):
        self.secret = secret or os.urandom(32)

    def compute_hash(self, msg: bytes) -> bytes:
        return hmac.new(self.secret, msg, hashlib.sha256).digest()

    def verify_hash(self, digest: bytes, msg: bytes) -> bool:
        return hmac.compare_digest(digest, self.compute_hash(msg))
