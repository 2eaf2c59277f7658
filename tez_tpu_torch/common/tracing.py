"""Low-overhead tracing plane: the port's copy of tez_tpu/common/tracing.py.

Causal spans across threads and seams, with per-event timestamps.

- Process-global plane, armed per scope with ``arm(scope)`` and released
  with ``clear(scope)``; arming is reference-counted by scope and the span
  buffer survives disarm so post-run exporters can read it.  (tez_tpu's
  ``install_from_conf`` arms from a DAG conf; it comes with the port's
  config module.)
- Single-boolean disarmed fast path: every entry point checks the module
  flag ``_armed`` first and returns a shared no-op singleton, so a run
  that never arms tracing pays one attribute load per call and allocates
  nothing.
- Bounded in-memory ring buffer (``collections.deque(maxlen=...)``): a
  runaway run evicts its oldest spans instead of eating the heap.

The carrier format is W3C trace-context shaped (``00-<trace_id>-<span_id>-01``).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

from tez_tpu_torch.obs import flight as _flight

DEFAULT_BUFFER_SPANS = 32768

_armed = False          # single-boolean fast path (see common/faults.py)
_TLS = threading.local()


# --------------------------------------------------------------------------
# Trace context + carrier
# --------------------------------------------------------------------------

class TraceContext(NamedTuple):
    """Immutable causal coordinate: which trace, and which span is parent."""
    trace_id: str
    span_id: str

    def carrier(self) -> str:
        """W3C traceparent-style wire string for TaskSpec/heartbeat fields."""
        return f"00-{self.trace_id}-{self.span_id}-01"


def parse_carrier(s: Optional[str]) -> Optional[TraceContext]:
    """Parse a carrier string; malformed/empty carriers yield None (the
    receiver simply starts a fresh root trace — never an error)."""
    if not s:
        return None
    parts = s.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    return TraceContext(parts[1], parts[2])


def _gen_trace_id() -> str:
    return os.urandom(16).hex()


def _gen_span_id() -> str:
    return os.urandom(8).hex()


# --------------------------------------------------------------------------
# Spans
# --------------------------------------------------------------------------

class Span:
    """One timed unit of work.  start/end are epoch seconds (time.time) so
    spans recorded on different threads/processes align on one axis."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "start", "end", "args", "events", "thread", "_recorded")

    def __init__(self, name: str, cat: str, trace_id: str,
                 parent_id: Optional[str], args: Dict[str, Any]) -> None:
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = _gen_span_id()
        self.parent_id = parent_id
        self.start = time.time()
        self.end: Optional[float] = None
        self.args = args
        self.events: List[Tuple[float, str, Dict[str, Any]]] = []
        self.thread = threading.current_thread().name
        self._recorded = False

    # -- annotation -------------------------------------------------------
    def annotate(self, **kv: Any) -> "Span":
        self.args.update(kv)
        return self

    def event(self, name: str, **attrs: Any) -> None:
        """Timestamped point annotation inside this span (fault firings,
        fence rejections, penalty-box holds...)."""
        self.events.append((time.time(), name, attrs))

    # -- lifecycle --------------------------------------------------------
    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else time.time()) - self.start

    def finish(self, error: Optional[BaseException] = None) -> None:
        if self._recorded:
            return
        self._recorded = True
        self.end = time.time()
        if error is not None:
            self.args["error"] = f"{type(error).__name__}: {error}"
        _PLANE.record(self)
        if _flight.armed():
            _flight.span_edge(self.name, self.start, self.end - self.start,
                              cat=self.cat)

    # -- context-manager protocol (pushes onto the thread-local stack) ----
    def __enter__(self) -> "Span":
        _stack().append(self)
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.finish(error=exc if isinstance(exc, BaseException) else None)
        return False

    def __repr__(self) -> str:  # debugging aid only
        return (f"Span({self.name!r}, trace={self.trace_id[:8]}, "
                f"span={self.span_id}, parent={self.parent_id}, "
                f"dur={self.duration * 1000:.2f}ms)")


class _NoopSpan:
    """Shared disarmed singleton: every method is a no-op and ``with``
    support returns the same object, so the disarmed path allocates zero
    objects per call."""

    __slots__ = ()

    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    start = 0.0
    end = 0.0
    duration = 0.0
    context = None
    events: List[Any] = []
    args: Dict[str, Any] = {}

    def annotate(self, **kv: Any) -> "_NoopSpan":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def finish(self, error: Optional[BaseException] = None) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


def _stack() -> List[Span]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _resolve_parent(parent: Any) -> Tuple[str, Optional[str]]:
    """Return (trace_id, parent_span_id) honoring: explicit parent >
    thread-local current span > thread-attached ambient context > new root."""
    if parent is None:
        st = _stack()
        if st:
            ctx = st[-1].context
            return ctx.trace_id, ctx.span_id
        ambient = getattr(_TLS, "ambient", None)
        if ambient is not None:
            return ambient.trace_id, ambient.span_id
        return _gen_trace_id(), None
    if isinstance(parent, Span):
        return parent.trace_id, parent.span_id
    if isinstance(parent, TraceContext):
        return parent.trace_id, parent.span_id
    if isinstance(parent, str):
        ctx = parse_carrier(parent)
        if ctx is not None:
            return ctx.trace_id, ctx.span_id
        return _gen_trace_id(), None
    raise TypeError(f"unsupported span parent: {parent!r}")


# --------------------------------------------------------------------------
# Public span API
# --------------------------------------------------------------------------

def span(name: str, cat: str = "", parent: Any = None, **args: Any):
    """Start a span intended for ``with`` use on the current thread:
    it becomes the thread's current span until the block exits."""
    if not _armed:
        return NOOP_SPAN
    trace_id, parent_id = _resolve_parent(parent)
    return Span(name, cat, trace_id, parent_id, args)


def start_span(name: str, cat: str = "", parent: Any = None, **args: Any):
    """Start a span WITHOUT touching the thread-local stack — for
    long-lived / cross-thread spans (e.g. the DAG root span the AM holds
    open until on_dag_finished).  Caller must invoke .finish()."""
    if not _armed:
        return NOOP_SPAN
    trace_id, parent_id = _resolve_parent(parent)
    return Span(name, cat, trace_id, parent_id, args)


def event(name: str, parent: Any = None, **attrs: Any) -> None:
    """Record a point event.  Attached to the current span when one is
    active on this thread; otherwise recorded as a standalone zero-duration
    span (the common case for fence rejections and penalty-box holds that
    fire on dispatcher/fetcher threads)."""
    if not _armed:
        return
    st = _stack()
    if parent is None and st:
        st[-1].event(name, **attrs)
        return
    trace_id, parent_id = _resolve_parent(parent)
    sp = Span(name, "instant", trace_id, parent_id, dict(attrs))
    sp.finish()


def current_span() -> Optional[Span]:
    if not _armed:
        return None
    st = _stack()
    return st[-1] if st else None


def current_context() -> Optional[TraceContext]:
    """The causal coordinate a child started *now* on this thread would
    inherit — current span, else the thread-attached ambient context."""
    st = _stack()
    if st:
        return st[-1].context
    return getattr(_TLS, "ambient", None)


def current_carrier() -> str:
    ctx = current_context()
    return ctx.carrier() if ctx is not None else ""


@contextmanager
def attached(parent: Any) -> Iterator[Optional[TraceContext]]:
    """Attach an ambient trace context to this thread for the duration of
    the block: spans started with no explicit parent and no active span
    will parent under it.  ``parent`` may be a carrier string, TraceContext,
    or Span; falsy/unparseable values attach nothing (no-op)."""
    ctx: Optional[TraceContext] = None
    if isinstance(parent, TraceContext):
        ctx = parent
    elif isinstance(parent, Span):
        ctx = parent.context
    elif isinstance(parent, str):
        ctx = parse_carrier(parent)
    prev = getattr(_TLS, "ambient", None)
    _TLS.ambient = ctx if ctx is not None else prev
    try:
        yield ctx
    finally:
        _TLS.ambient = prev


# --------------------------------------------------------------------------
# The plane (arming + ring buffer)
# --------------------------------------------------------------------------

class TracePlane:
    """Scope-refcounted arming + bounded span ring buffer."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._scopes: set = set()
        self._buf: Optional[deque] = None

    def install(self, scope: str,
                capacity: int = DEFAULT_BUFFER_SPANS) -> None:
        global _armed
        with self._lock:
            self._scopes.add(scope)
            if self._buf is None or (self._buf.maxlen or 0) != capacity:
                old = list(self._buf) if self._buf is not None else []
                self._buf = deque(old, maxlen=max(1, int(capacity)))
            _armed = True

    def clear(self, scope: str) -> None:
        """Release one scope.  The buffer is deliberately retained so
        post-run exporters can still read the spans."""
        global _armed
        with self._lock:
            self._scopes.discard(scope)
            if not self._scopes:
                _armed = False

    def clear_all(self) -> None:
        global _armed
        with self._lock:
            self._scopes.clear()
            self._buf = None
            _armed = False

    def record(self, sp: Span) -> None:
        buf = self._buf
        if buf is not None:
            buf.append(sp)       # deque.append with maxlen is atomic

    def snapshot(self) -> List[Span]:
        buf = self._buf
        return list(buf) if buf is not None else []

    @property
    def scopes(self) -> set:
        with self._lock:
            return set(self._scopes)


_PLANE = TracePlane()


def plane() -> TracePlane:
    return _PLANE


def armed() -> bool:
    return _armed


def arm(scope: str = "manual",
        capacity: int = DEFAULT_BUFFER_SPANS) -> None:
    _PLANE.install(scope, capacity)


def clear(scope: str) -> None:
    _PLANE.clear(scope)


def clear_all() -> None:
    _PLANE.clear_all()


def snapshot() -> List[Span]:
    return _PLANE.snapshot()
