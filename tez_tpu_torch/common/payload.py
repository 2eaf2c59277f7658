"""Opaque user payloads and entity descriptors.

Reference parity: tez-api/src/main/java/org/apache/tez/dag/api/
{UserPayload,EntityDescriptor,ProcessorDescriptor,InputDescriptor,
OutputDescriptor,...}.java — every pluggable entity is shipped as
(class name, opaque bytes).  Here entities are Python classes addressed by
"module:Class" strings plus a payload that is either raw bytes or any
picklable object (the common case for in-process TPU deployments).

The port's copy of tez_tpu.common.payload.
"""
from __future__ import annotations

import dataclasses
import importlib
import pickle
from typing import Any


@dataclasses.dataclass(frozen=True)
class UserPayload:
    """Opaque configuration blob handed to a pluggable entity.

    Reference: UserPayload.java (ByteBuffer + version).
    """
    data: bytes = b""
    version: int = 0

    @staticmethod
    def of(obj: Any) -> "UserPayload":
        if obj is None:
            return UserPayload()
        if isinstance(obj, UserPayload):
            return obj
        if isinstance(obj, bytes):
            return UserPayload(obj)
        return UserPayload(pickle.dumps(obj), version=1)

    def load(self) -> Any:
        if not self.data:
            return None
        if self.version == 1:
            return pickle.loads(self.data)
        return self.data


def _qualname(cls: type) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def resolve_class(name: str) -> type:
    mod, _, qual = name.partition(":")
    obj: Any = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


@dataclasses.dataclass(frozen=True)
class EntityDescriptor:
    """(class name, payload) pair describing a pluggable entity.

    Reference: EntityDescriptor.java; subclasses mirror the reference's
    ProcessorDescriptor / InputDescriptor / ... type tags.
    """
    class_name: str
    payload: UserPayload = UserPayload()
    history_text: str = ""

    @classmethod
    def create(cls, target: type | str, payload: Any = None,
               history_text: str = "") -> "EntityDescriptor":
        name = target if isinstance(target, str) else _qualname(target)
        return cls(name, UserPayload.of(payload), history_text)

    def instantiate(self, *args: Any, **kw: Any) -> Any:
        return resolve_class(self.class_name)(*args, **kw)

    def with_payload(self, payload: Any) -> "EntityDescriptor":
        return dataclasses.replace(self, payload=UserPayload.of(payload))


class ProcessorDescriptor(EntityDescriptor):
    pass


class InputDescriptor(EntityDescriptor):
    pass


class OutputDescriptor(EntityDescriptor):
    pass


class InputInitializerDescriptor(EntityDescriptor):
    pass


class OutputCommitterDescriptor(EntityDescriptor):
    pass


class VertexManagerPluginDescriptor(EntityDescriptor):
    pass


class EdgeManagerPluginDescriptor(EntityDescriptor):
    pass
