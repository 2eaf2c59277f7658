"""One shared monotonic clock for cross-plane event correlation: the
port's copy of tez_tpu/common/clock.py.

Spans timestamp with ``time.time()`` (epoch seconds), stage pipelines with
``time.perf_counter()``, and the flight recorder with integer monotonic
nanoseconds.  A single ``(wall, monotonic_ns)`` pair captured at import
lets any monotonic timestamp be projected onto the wall clock (and back),
so flight events, history timestamps and span times line up on one axis.
The anchor is captured once: an NTP step after import skews the
projection, but every intra-process delta stays exact.
"""
from __future__ import annotations

import time
from typing import Tuple

#: (epoch seconds, monotonic ns) captured together at import — the one
#: anchor every projection in this process uses.
_ANCHOR: Tuple[float, int] = (time.time(), time.monotonic_ns())


def mono_ns() -> int:
    """Integer monotonic nanoseconds — the flight recorder's time axis."""
    return time.monotonic_ns()


def mono_s() -> float:
    """Monotonic seconds on the shared axis (``mono_ns() / 1e9``).

    The replacement for raw ``time.monotonic()`` in ``am/`` and ``obs/``,
    so every duration and series timestamp shares this module's anchor."""
    return time.monotonic_ns() / 1e9


def wall_s() -> float:
    """Epoch seconds — the replacement for raw ``time.time()`` in ``am/``
    and ``obs/`` (see :func:`mono_s`)."""
    return time.time()


def anchor() -> Tuple[float, int]:
    """The process ``(wall_s, mono_ns)`` anchor pair.  Flight dumps embed
    it so an offline reader can project event times onto the wall axis of
    the history journal written by the same process."""
    return _ANCHOR


def mono_to_wall(ns: int, anchor_pair: Tuple[float, int] = None) -> float:
    """Project a monotonic-ns timestamp onto epoch seconds."""
    wall0, mono0 = anchor_pair if anchor_pair is not None else _ANCHOR
    return wall0 + (ns - mono0) / 1e9


def wall_to_mono_ns(wall_s: float,
                    anchor_pair: Tuple[float, int] = None) -> int:
    """Project epoch seconds back onto the monotonic-ns axis."""
    wall0, mono0 = anchor_pair if anchor_pair is not None else _ANCHOR
    return mono0 + int((wall_s - wall0) * 1e9)
