"""Always-on flight recorder: the port's copy of tez_tpu/obs/flight.py.

A bounded binary ring journal of cross-plane events on one shared
monotonic clock (:mod:`tez_tpu_torch.common.clock`): the last N things the
process did (span edges, histogram observations, breaker and watchdog
transitions), cheap enough to leave running and dumped when something goes
wrong.

- **Disarmed fast path**: every ``record()`` call checks the module flag
  ``_armed`` first: one attribute load, no allocation, no lock.
- **Arming**: ``install(scope)`` arms the plane, scope-refcounted so
  concurrent owners compose; ``clear(scope)`` releases one.  The ring
  survives disarm so post-run snapshots still see the data;
  ``clear_all()`` drops it.  (tez_tpu's ``install_from_conf`` arms from a
  DAG conf; it comes with the port's config module.)
- **Binary ring, lock-free append**: events are fixed 44-byte records
  (``<qqIIIqq``: seq, t_ns, kind, name_id, scope_id, a, b) packed into a
  preallocated ``bytearray``.  The sequence counter is an
  ``itertools.count`` and ``struct.pack_into`` is one C call, so appends
  from any thread interleave without a lock and without torn records.
  Strings are interned into an append-only table.
- **Consistent snapshots**: ``snapshot()`` copies the ring with a single
  ``bytes(buf)``, then the string table (append-only, so every id in the
  copied bytes resolves), decodes non-empty slots and sorts by seq.
- **Auto-dump**: ``auto_dump(reason)`` writes the snapshot as JSON into the
  configured dump dir, rate-limited per arm cycle.  The async span plane
  (ops/async_stage.py) dumps on breaker-open and watchdog fire.

Feeds: ``tracing.Span.finish`` records span edges, ``metrics.observe``
records every histogram observation, and the breaker and watchdog record
their typed events directly.
"""
from __future__ import annotations

import itertools
import json
import os
import struct
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from tez_tpu_torch.common import clock

#: record layout: seq, t_ns, kind, name_id, scope_id, a, b
_REC = struct.Struct("<qqIIIqq")
RECORD_SIZE = _REC.size                       # 44 bytes

DEFAULT_CAPACITY_EVENTS = 65536
DEFAULT_MAX_DUMPS = 8

# -- event kinds -------------------------------------------------------------
SPAN = 1          # span edge: a = start mono ns, b = duration ns
COUNTER = 2       # histogram observation: a = microseconds observed
BREAKER = 3       # breaker transition: name = new state, a = consecutive
WATCHDOG = 4      # watchdog fire: name = stage, scope = span ids
ADMIT = 5         # admission verdict: name = verdict, a = queue depth
STORE = 6         # store publish/demote/evict: a = nbytes
PUSH = 7          # push send/admit/reject: a = nbytes, b = wait us
EXCHANGE = 8      # exchange round plan: a = round index, b = rows
SLO = 9           # SLO breach/clear: a = observed (us or bp), b = target
MARK = 10         # free-form marks (dump reasons, scenario boundaries)

KIND_NAMES = {SPAN: "span", COUNTER: "counter", BREAKER: "breaker",
              WATCHDOG: "watchdog", ADMIT: "admit", STORE: "store",
              PUSH: "push", EXCHANGE: "exchange", SLO: "slo", MARK: "mark"}

_armed = False          # single-boolean fast path (see common/faults.py)


class FlightEvent(NamedTuple):
    """One decoded ring record."""
    seq: int
    t_ns: int
    kind: int
    name: str
    scope: str
    a: int
    b: int

    @property
    def kind_name(self) -> str:
        return KIND_NAMES.get(self.kind, str(self.kind))

    def wall(self, anchor_pair: Optional[Tuple[float, int]] = None) -> float:
        return clock.mono_to_wall(self.t_ns, anchor_pair)

    def to_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "t_ns": self.t_ns,
                "kind": self.kind_name, "name": self.name,
                "scope": self.scope, "a": self.a, "b": self.b}


class FlightSnapshot(NamedTuple):
    """Decoded ring + the clock anchor that projects it onto wall time."""
    events: List[FlightEvent]
    anchor: Tuple[float, int]
    dropped_before: int       # seq of the oldest surviving record - 1

    def to_dict(self) -> Dict[str, Any]:
        return {"anchor_wall_s": self.anchor[0],
                "anchor_mono_ns": self.anchor[1],
                "dropped_before": self.dropped_before,
                "events": [e.to_dict() for e in self.events]}


class FlightPlane:
    """Scope-refcounted arming + the binary ring itself."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._scopes: set = set()
        #: (bytearray, capacity_in_records) captured together so a racing
        #: reinstall can never pair a new buffer with an old capacity
        self._ring: Optional[Tuple[bytearray, int]] = None
        self._seq = itertools.count(1)
        self._names: Dict[str, int] = {"": 0}
        self._names_rev: List[str] = [""]
        self._dump_dir = ""
        self._max_dumps = DEFAULT_MAX_DUMPS
        self._dumps_written = 0
        self._dump_lock = threading.Lock()

    # -- arming ------------------------------------------------------------
    def install(self, scope: str,
                capacity: int = DEFAULT_CAPACITY_EVENTS,
                dump_dir: str = "", max_dumps: int = DEFAULT_MAX_DUMPS
                ) -> None:
        global _armed
        capacity = max(16, int(capacity))
        with self._lock:
            self._scopes.add(scope)
            if self._ring is None or self._ring[1] != capacity:
                self._ring = (bytearray(capacity * RECORD_SIZE), capacity)
            if dump_dir:
                self._dump_dir = dump_dir
            if max_dumps:
                self._max_dumps = int(max_dumps)
            self._dumps_written = 0
            _armed = True

    def clear(self, scope: str) -> None:
        """Release one scope.  The ring is deliberately retained so
        post-run snapshots/dumps still see the recorded events."""
        global _armed
        with self._lock:
            self._scopes.discard(scope)
            if not self._scopes:
                _armed = False

    def clear_all(self) -> None:
        global _armed
        with self._lock:
            self._scopes.clear()
            self._ring = None
            self._seq = itertools.count(1)
            self._names = {"": 0}
            self._names_rev = [""]
            self._dump_dir = ""
            self._max_dumps = DEFAULT_MAX_DUMPS
            self._dumps_written = 0
            _armed = False

    @property
    def scopes(self) -> set:
        with self._lock:
            return set(self._scopes)

    # -- append (hot path) -------------------------------------------------
    def _intern(self, s: str) -> int:
        sid = self._names.get(s)
        if sid is None:
            with self._lock:
                sid = self._names.get(s)
                if sid is None:
                    sid = len(self._names_rev)
                    self._names_rev.append(s)
                    self._names[s] = sid
        return sid

    def record(self, kind: int, name: str, scope: str = "",
               a: int = 0, b: int = 0) -> None:
        ring = self._ring      # local ref: survives a concurrent clear_all
        if ring is None:
            return
        buf, cap = ring
        nid = self._intern(name)
        sid = self._intern(scope) if scope else 0
        seq = next(self._seq)
        _REC.pack_into(buf, ((seq - 1) % cap) * RECORD_SIZE,
                       seq, clock.mono_ns(), kind, nid, sid,
                       int(a), int(b))

    # -- snapshot / dump ---------------------------------------------------
    def snapshot(self) -> FlightSnapshot:
        ring = self._ring
        if ring is None:
            return FlightSnapshot([], clock.anchor(), 0)
        buf, cap = ring
        raw = bytes(buf)             # single C call: no torn records
        names = list(self._names_rev)    # append-only; copied AFTER raw
        events: List[FlightEvent] = []
        for i in range(cap):
            seq, t_ns, kind, nid, sid, a, b = _REC.unpack_from(
                raw, i * RECORD_SIZE)
            if seq <= 0 or nid >= len(names) or sid >= len(names):
                continue             # empty slot (or mid-clear garbage)
            events.append(FlightEvent(seq, t_ns, kind, names[nid],
                                      names[sid], a, b))
        events.sort(key=lambda e: e.seq)
        dropped = events[0].seq - 1 if events else 0
        return FlightSnapshot(events, clock.anchor(), dropped)

    def dump(self, reason: str, scope: str = "") -> Optional[str]:
        """Write a snapshot to the dump dir.  Returns the path, or None
        when the per-arm-cycle dump budget is spent or no dir is set."""
        with self._dump_lock:
            if self._dumps_written >= self._max_dumps:
                return None
            d = self._dump_dir
            if not d:
                return None
            self._dumps_written += 1
            n = self._dumps_written
        self.record(MARK, "flight.dump", scope or reason)
        snap = self.snapshot()
        payload = snap.to_dict()
        payload["reason"] = reason
        payload["scope"] = scope
        payload["pid"] = os.getpid()
        safe = "".join(ch if (ch.isalnum() or ch in "._-") else "_"
                       for ch in reason)[:48]
        path = os.path.join(d, f"flight_{safe}_{os.getpid()}_{n}.json")
        from tez_tpu_torch.common import metrics   # lazy: metrics imports us
        try:
            os.makedirs(d, exist_ok=True)
            with metrics.timer("obs.flight.dump"):
                tmp = path + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump(payload, fh)
                os.replace(tmp, path)
        except OSError:
            return None              # diagnostics must never fail the run
        return path


_PLANE = FlightPlane()


def plane() -> FlightPlane:
    return _PLANE


def armed() -> bool:
    return _armed


def record(kind: int, name: str, scope: str = "",
           a: int = 0, b: int = 0) -> None:
    """Append one event.  Call sites that already hold data in locals may
    instead check ``flight._armed`` themselves and call
    ``plane().record`` — same thing, one call fewer."""
    if not _armed:
        return
    _PLANE.record(kind, name, scope, a, b)


def span_edge(name: str, start_wall_s: float, duration_s: float,
              cat: str = "") -> None:
    """Span-edge feed from ``tracing.Span.finish`` (already armed-gated
    by the caller): a = start on the mono axis, b = duration ns."""
    _PLANE.record(SPAN, name, cat,
                  clock.wall_to_mono_ns(start_wall_s),
                  int(duration_s * 1e9))


def install(scope: str = "manual",
            capacity: int = DEFAULT_CAPACITY_EVENTS,
            dump_dir: str = "", max_dumps: int = DEFAULT_MAX_DUMPS) -> None:
    _PLANE.install(scope, capacity, dump_dir, max_dumps)


def clear(scope: str) -> None:
    _PLANE.clear(scope)


def clear_all() -> None:
    _PLANE.clear_all()


def snapshot() -> FlightSnapshot:
    return _PLANE.snapshot()


def auto_dump(reason: str, scope: str = "") -> Optional[str]:
    """Dump the ring because something went wrong (breaker-open, watchdog
    fire, DAG failure, admission shed).  No-op while disarmed."""
    if not _armed:
        return None
    return _PLANE.dump(reason, scope)


def load_dump(path: str) -> FlightSnapshot:
    """Read a dump file back into a FlightSnapshot."""
    with open(path) as fh:
        d = json.load(fh)
    kinds = {v: k for k, v in KIND_NAMES.items()}
    events = [FlightEvent(e["seq"], e["t_ns"], kinds.get(e["kind"], MARK),
                          e["name"], e["scope"], e["a"], e["b"])
              for e in d.get("events", [])]
    return FlightSnapshot(events,
                          (d.get("anchor_wall_s", 0.0),
                           d.get("anchor_mono_ns", 0)),
                          d.get("dropped_before", 0))
