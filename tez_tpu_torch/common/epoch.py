"""Process-global AM attempt-epoch registry: zombie fencing's source of truth.

Reference lineage: the reference fences stale task attempts with the AM
attempt number baked into the YARN container/token identity; a restarted AM
implicitly invalidates its predecessor because the RM kills the old
containers.  In-process and multi-runner deployments here have no RM to do
that killing, so zombie threads of a crashed AM incarnation can keep
running — this registry is how every shared seam (commit arbitration,
umbilical, shuffle registration, output publish) discovers it has been
superseded.

The epoch IS the AM attempt number: monotonically increasing per app across
incarnations.  Every ``DAGAppMaster`` registers ``(app_id, attempt)`` at
construction; components compare their own stamped epoch against
``current(app_id)`` before acting on shared state.

Stamping convention: epoch 0 means "unstamped" (legacy callers, standalone
tests) and is never fenced — fencing only rejects a *known-older* epoch.

Window generalization (streaming mode): the same fence carries a second
coordinate.  A resident streaming DAG processes numbered windows; the open
window id per ``(app_id, stream)`` lives in this registry next to the
attempt epoch, and every seam that fences on epoch also fences on a
*known-older* window.  The pair ``(attempt_epoch, window_id)`` is totally
ordered lexicographically: a zombie from a dead incarnation is caught by
the epoch coordinate, a straggler from a sealed window of the LIVE
incarnation is caught by the window coordinate.  Window id 0 means "batch /
unstamped" and is never fenced, so pre-streaming DAGs behave byte-
identically.

The port's copy of tez_tpu.common.epoch.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

_lock = threading.Lock()
_current: Dict[str, int] = {}
_windows: Dict[Tuple[str, str], int] = {}


class EpochFencedError(RuntimeError):
    """An actor from a superseded AM incarnation touched a fenced seam."""


class WindowFencedError(EpochFencedError):
    """An actor from a superseded *window* touched a fenced seam.

    Subclasses :class:`EpochFencedError` so every existing except-clause
    that absorbs epoch fencing (task runner die-path, shuffle fetch retry
    suppression) absorbs window fencing identically."""


def register(app_id: str, epoch: int) -> int:
    """Record ``epoch`` as a live incarnation of ``app_id``; keeps the max
    (a late-starting old attempt cannot roll the fence back).  Returns the
    current epoch after registration."""
    with _lock:
        cur = max(_current.get(app_id, 0), int(epoch))
        _current[app_id] = cur
        return cur


def current(app_id: str) -> int:
    """The newest registered epoch for ``app_id`` (0 = never registered)."""
    with _lock:
        return _current.get(app_id, 0)


def is_stale(app_id: str, epoch: int) -> bool:
    """True when ``epoch`` is a *known-older* incarnation of ``app_id``.
    Unstamped (<= 0) epochs are never stale."""
    if epoch <= 0:
        return False
    with _lock:
        return epoch < _current.get(app_id, 0)


def register_window(app_id: str, stream: str, window_id: int) -> int:
    """Record ``window_id`` as the open window of ``(app_id, stream)``;
    keeps the max (a replayed older window cannot roll the fence back —
    recovery re-registers the first *uncommitted* window, which is by
    definition >= everything that ever ran).  Returns the open window."""
    with _lock:
        key = (app_id, stream)
        cur = max(_windows.get(key, 0), int(window_id))
        _windows[key] = cur
        return cur


def current_window(app_id: str, stream: str) -> int:
    """The newest registered window for ``(app_id, stream)`` (0 = never)."""
    with _lock:
        return _windows.get((app_id, stream), 0)


def is_stale_window(app_id: str, stream: str, window_id: int) -> bool:
    """True when ``window_id`` is a *known-older* window of the stream.
    Batch / unstamped (<= 0) windows are never stale, and a stream that
    never registered fences nothing."""
    if window_id <= 0 or not stream:
        return False
    with _lock:
        return window_id < _windows.get((app_id, stream), 0)


def reset() -> None:
    """Test hook: drop all registrations (the registry is process-global)."""
    with _lock:
        _current.clear()
        _windows.clear()
