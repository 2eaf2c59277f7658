"""Pluggable entities addressed by "module:Class" strings: the port's copy
of tez_tpu.common.payload's class lookup (the payload and descriptor
classes come with the port's inputs and outputs)."""
from __future__ import annotations

import importlib
from typing import Any


def resolve_class(name: str) -> type:
    """The object named by "module:Qual.Name"."""
    mod, _, qual = name.partition(":")
    obj: Any = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj
