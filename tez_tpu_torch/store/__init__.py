"""Tiered shuffle buffer store (tez_tpu's docs/store.md).

``local_buffer_store()`` is the per-process singleton, mirroring
``local_shuffle_service()``: producers publish through the shuffle
service's delegation seam, consumers short-circuit fetches, and the AM
seals lineage keys on DAG commit.  ``ensure_store(conf)`` creates it from
the ``tez.runtime.store.*`` knobs on first use, attaches it to the local
shuffle service and registers its device-pressure relief as the
out-of-memory ladder's hook (ops/async_stage.py); it returns None while
the store is disabled so every call site stays zero-cost on the
historical path.  A push-enabled conf also attaches the push admission
controller (shuffle/push.py).  Runner processes each create their own
store from the task conf.

The port's copy of tez_tpu.store.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

from tez_tpu_torch.store.buffer_store import (COUNTER_GROUP, DEVICE, DISK,
                                              HOST, LINEAGE_PREFIX,
                                              ShuffleBufferStore,
                                              StoreKeyNotFound,
                                              StoreQuotaExceeded)

__all__ = ["ShuffleBufferStore", "StoreKeyNotFound", "StoreQuotaExceeded",
           "local_buffer_store",
           "ensure_store", "reset_store", "COUNTER_GROUP", "LINEAGE_PREFIX",
           "DEVICE", "HOST", "DISK"]

_lock = threading.Lock()
_store: Optional[ShuffleBufferStore] = None


def local_buffer_store() -> Optional[ShuffleBufferStore]:
    """The process store, or None when no DAG enabled it yet."""
    return _store


def ensure_store(conf: Any) -> Optional[ShuffleBufferStore]:
    """Create (once) and return the process store when the conf enables
    it; None otherwise.  ``conf`` is anything with a dict-style ``get``
    carrying tez.runtime.store.* keys."""
    from tez_tpu_torch.common import config as C

    def _get(key):
        v = conf.get(key.name) if hasattr(conf, "get") else None
        return key.default if v is None else v

    enabled = _get(C.STORE_ENABLED)
    if isinstance(enabled, str):
        enabled = enabled.lower() in ("1", "true", "yes")
    if not enabled:
        return None
    global _store
    with _lock:
        if _store is None:
            # fractional MB accepted (chaos/test scenarios shrink a tier
            # below 1MB to force eviction storms on tiny datasets)
            mb = float(1 << 20)
            _store = ShuffleBufferStore(
                device_capacity=int(float(_get(
                    C.STORE_DEVICE_CAPACITY_MB)) * mb),
                host_capacity=int(float(_get(
                    C.STORE_HOST_CAPACITY_MB)) * mb),
                disk_capacity=int(float(_get(
                    C.STORE_DISK_CAPACITY_MB)) * mb),
                disk_dir=str(_get(C.STORE_DIR) or ""),
                high_watermark=float(_get(C.STORE_HIGH_WATERMARK)),
                low_watermark=float(_get(C.STORE_LOW_WATERMARK)),
                tenant_device_quota=int(float(_get(
                    C.STORE_TENANT_DEVICE_QUOTA_MB)) * mb),
                tenant_host_quota=int(float(_get(
                    C.STORE_TENANT_HOST_QUOTA_MB)) * mb),
                tenant_disk_quota=int(float(_get(
                    C.STORE_TENANT_DISK_QUOTA_MB)) * mb),
                result_cache_ttl=float(_get(C.STORE_RESULT_CACHE_TTL_SECS)),
                result_cache_bytes=int(float(_get(
                    C.STORE_RESULT_CACHE_MB)) * mb),
                result_cache_admit=str(_get(C.STORE_RESULT_CACHE_ADMIT)
                                       or "always"))
            from tez_tpu_torch.shuffle.service import local_shuffle_service
            local_shuffle_service().attach_buffer_store(_store)
            from tez_tpu_torch.ops import async_stage
            store = _store
            async_stage.register_pressure_hook(
                store.relieve_device_pressure)
        push_on = _get(C.PUSH_ENABLED)
        if isinstance(push_on, str):
            push_on = push_on.lower() in ("1", "true", "yes")
        if push_on:
            # eager-push landing zone: attach the admission controller the
            # first push-enabled DAG configures (idempotent per process,
            # like the store itself; reset_store detaches it)
            from tez_tpu_torch.shuffle.service import local_shuffle_service
            svc = local_shuffle_service()
            if svc.push_admission() is None:
                from tez_tpu_torch.shuffle.push import PushAdmissionController
                svc.attach_push_admission(PushAdmissionController(
                    local_buffer_store,
                    source_quota_bytes=int(float(_get(
                        C.PUSH_SOURCE_QUOTA_MB)) * (1 << 20)),
                    admit_watermark=float(_get(C.PUSH_ADMIT_WATERMARK)),
                    retry_after_ms=float(_get(C.PUSH_RETRY_AFTER_MS))))
        return _store


def reset_store() -> None:
    """Tear down the process store (tests / session teardown)."""
    global _store
    with _lock:
        store, _store = _store, None
    if store is not None:
        from tez_tpu_torch.shuffle.service import local_shuffle_service
        local_shuffle_service().attach_buffer_store(None)
        local_shuffle_service().attach_push_admission(None)
        from tez_tpu_torch.ops import async_stage
        async_stage.clear_pressure_hooks()
        store.close()
