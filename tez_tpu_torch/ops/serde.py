"""Key/value serialization.

Reference parity: tez-runtime-library/.../common/serializer/ (pluggable Hadoop
serialization) — here a small registry of codecs turning Python objects into
bytes for the device data plane.  The data plane itself only ever sees bytes;
serdes sit at the Writer/Reader surface.

The port's copy of tez_tpu.ops.serde.
"""
from __future__ import annotations

import pickle
import struct
from typing import Any


class Serde:
    name = "abstract"

    def to_bytes(self, obj: Any) -> bytes:
        raise NotImplementedError

    def from_bytes(self, data: bytes) -> Any:
        raise NotImplementedError


class BytesSerde(Serde):
    name = "bytes"

    def to_bytes(self, obj: Any) -> bytes:
        if isinstance(obj, bytes):
            return obj
        if isinstance(obj, bytearray):
            return bytes(obj)
        if isinstance(obj, str):
            return obj.encode()
        raise TypeError(f"BytesSerde cannot encode {type(obj)}")

    def from_bytes(self, data: bytes) -> bytes:
        return data


class TextSerde(Serde):
    name = "text"

    def to_bytes(self, obj: Any) -> bytes:
        return obj.encode() if isinstance(obj, str) else bytes(obj)

    def from_bytes(self, data: bytes) -> str:
        return data.decode()


class VarLongSerde(Serde):
    """8-byte big-endian signed (big-endian so byte order == numeric order,
    which lets longs be used as sort keys directly)."""
    name = "long"

    def to_bytes(self, obj: Any) -> bytes:
        # flip sign bit so negative numbers sort below positive byte-wise
        return struct.pack(">Q", (int(obj) + (1 << 63)) & ((1 << 64) - 1))

    def from_bytes(self, data: bytes) -> int:
        return struct.unpack(">Q", data)[0] - (1 << 63)


def encode_longs_be(values: "np.ndarray") -> "np.ndarray":
    """Vectorized VarLongSerde.to_bytes: int64 array -> uint8 array of
    8-byte big-endian sign-flipped encodings (byte order == numeric order)."""
    import numpy as np
    enc = (values.astype(np.int64).view(np.uint64)
           ^ np.uint64(1 << 63)).astype(">u8")
    return np.frombuffer(enc.tobytes(), dtype=np.uint8).copy()


def decode_longs_be(val_bytes: "np.ndarray", n: int) -> "np.ndarray":
    """Vectorized VarLongSerde.from_bytes over n fixed-8-byte values."""
    import numpy as np
    u = np.ascontiguousarray(val_bytes).reshape(n, 8)
    return (u.view(">u8").astype(np.uint64).ravel()
            ^ np.uint64(1 << 63)).view(np.int64)


class PickleSerde(Serde):
    name = "pickle"

    def to_bytes(self, obj: Any) -> bytes:
        return pickle.dumps(obj, protocol=4)

    def from_bytes(self, data: bytes) -> Any:
        return pickle.loads(data)


_SERDES = {s.name: s for s in
           (BytesSerde(), TextSerde(), VarLongSerde(), PickleSerde())}


def get_serde(name: str) -> Serde:
    try:
        return _SERDES[name]
    except KeyError:
        raise ValueError(f"unknown serde {name!r}; have {sorted(_SERDES)}")
