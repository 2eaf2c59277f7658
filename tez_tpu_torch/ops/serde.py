"""Long serde: the port's copy of tez_tpu.ops.serde's VarLongSerde and its
vectorized encode/decode (8-byte big-endian, sign bit flipped so byte order
== numeric order)."""
from __future__ import annotations

import struct
from typing import Any

import numpy as np


class VarLongSerde:
    name = "long"

    def to_bytes(self, obj: Any) -> bytes:
        return struct.pack(">Q", (int(obj) + (1 << 63)) & ((1 << 64) - 1))

    def from_bytes(self, data: bytes) -> int:
        return struct.unpack(">Q", data)[0] - (1 << 63)


def encode_longs_be(values: np.ndarray) -> np.ndarray:
    """int64 array -> uint8 array of 8-byte big-endian sign-flipped words."""
    enc = (values.astype(np.int64).view(np.uint64)
           ^ np.uint64(1 << 63)).astype(">u8")
    return np.frombuffer(enc.tobytes(), dtype=np.uint8).copy()


def decode_longs_be(val_bytes: np.ndarray, n: int) -> np.ndarray:
    """Inverse of encode_longs_be over n fixed-8-byte values."""
    u = np.ascontiguousarray(val_bytes).reshape(n, 8)
    return (u.view(">u8").astype(np.uint64).ravel()
            ^ np.uint64(1 << 63)).view(np.int64)
