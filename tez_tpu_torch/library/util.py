"""Shared helpers for the stock IO library: the port's copy of
tez_tpu.library.util."""
from __future__ import annotations

from typing import Any, Dict


def conf_get(context: Any, key: str, default: Any) -> Any:
    """Resolve a runtime config key: IO payload overrides task conf
    (the 'runtime config travels inside the edge payload' rule)."""
    payload = context.user_payload.load()
    conf: Dict[str, Any] = dict(context.conf)
    if isinstance(payload, dict):
        conf.update(payload)
    return conf.get(key, default)
