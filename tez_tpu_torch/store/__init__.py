"""The tiered shuffle buffer store's entry point.

``ensure_store(conf)`` is the port's copy of tez_tpu.store.ensure_store's
contract for a conf that leaves the store off: it returns None.  The store
itself (tez_tpu/store/buffer_store.py) is not ported yet, so a conf that
enables it raises NotImplementedError rather than running without it.
"""
from __future__ import annotations

from typing import Any


def ensure_store(conf: Any) -> None:
    """None while ``tez.runtime.store.enabled`` is off; raises when it is
    on (tez_tpu would create the store and attach it to the shuffle
    service)."""
    from tez_tpu_torch.common import config as C
    enabled = conf.get(C.STORE_ENABLED.name) if hasattr(conf, "get") \
        else None
    if enabled is None:
        enabled = C.STORE_ENABLED.default
    if isinstance(enabled, str):
        enabled = enabled.lower() in ("1", "true", "yes")
    if enabled:
        raise NotImplementedError(
            "tez.runtime.store.enabled: the tiered shuffle buffer store is "
            "not ported to tez_tpu_torch yet")
    return None
