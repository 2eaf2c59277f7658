"""Scalar hash partitioner: the port's copy of
tez_tpu.library.partitioners (FNV-1a 32-bit, the oracle every batch
partition kernel must equal)."""
from __future__ import annotations

from typing import Any


def _stable_hash(key: Any) -> int:
    """Deterministic across processes (Python's hash() is salted)."""
    if isinstance(key, (bytes, bytearray)):
        data = bytes(key)
    elif isinstance(key, str):
        data = key.encode()
    elif isinstance(key, int):
        data = key.to_bytes(8, "little", signed=True)
    else:
        data = repr(key).encode()
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


class HashPartitioner:
    def get_partition(self, key: Any, value: Any, num_partitions: int) -> int:
        return _stable_hash(key) % num_partitions
