"""Central event bus for the orchestrator.

Reference parity: tez-common/.../AsyncDispatcher.java:50 (single-threaded typed
event bus; all control-plane state mutation is serialized through it) and
AsyncDispatcherConcurrent.java (hash-sharded variant for event storms).

Design kept from the reference (SURVEY.md §5.2): *all control-plane mutation on
one event loop* — state machines are never locked, they are only touched from
the dispatcher thread.  Two modes:

- ``Dispatcher`` — a background thread draining a queue (production).
- ``DrainDispatcher`` — same bus but manually pumped (``drain()``), giving the
  deterministic unit-test style of the reference's DrainDispatcher.

The port's copy of tez_tpu.common.dispatcher, with ShardedDispatcher
(``tez.am.concurrent.dispatcher.shards`` > 1).
"""
from __future__ import annotations

import enum
import logging
import queue
import threading
from typing import Callable, Dict, Type

log = logging.getLogger(__name__)


class Event:
    """Base event: subclasses carry an ``event_type`` enum member."""
    __slots__ = ("event_type",)

    def __init__(self, event_type: enum.Enum):
        self.event_type = event_type

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.event_type.name})"


EventHandler = Callable[[Event], None]


class Dispatcher:
    """Typed event bus: handlers register per event-type *enum class*.

    Reference: AsyncDispatcher.register(Class<? extends Enum>, EventHandler).
    """

    def __init__(self, name: str = "dispatcher"):
        self.name = name
        self._handlers: Dict[Type[enum.Enum], EventHandler] = {}
        self._queue: "queue.Queue[Event | None]" = queue.Queue()
        self._thread: threading.Thread | None = None
        self._stopped = threading.Event()
        self._drained = threading.Condition()
        self._in_flight = 0
        self._delivered = 0   # monotonically counts handled events
        self.peak_in_flight = 0   # high-water queue depth (storm metric)
        self.on_error: Callable[[BaseException, Event], None] | None = None

    # -- registration -------------------------------------------------------
    def register(self, event_type_class: Type[enum.Enum], handler: EventHandler) -> None:
        existing = self._handlers.get(event_type_class)
        if existing is not None:
            self._handlers[event_type_class] = _MultiHandler(existing, handler)
        else:
            self._handlers[event_type_class] = handler

    # -- event intake -------------------------------------------------------
    def dispatch(self, event: Event) -> None:
        with self._drained:
            self._in_flight += 1
            if self._in_flight > self.peak_in_flight:
                self.peak_in_flight = self._in_flight
        self._queue.put(event)

    @property
    def event_handler(self) -> EventHandler:
        return self.dispatch

    # -- delivery -----------------------------------------------------------
    def _deliver(self, event: Event) -> None:
        handler = self._handlers.get(type(event.event_type))
        try:
            if handler is None:
                log.warning("%s: no handler for %r", self.name, event)
            else:
                handler(event)
        except BaseException as e:  # noqa: BLE001 — AM error funnel
            log.exception("%s: handler error for %r", self.name, event)
            if self.on_error is not None:
                self.on_error(e, event)
            else:
                raise
        finally:
            with self._drained:
                self._in_flight -= 1
                self._delivered += 1
                if self._in_flight == 0 and self._queue.empty():
                    self._drained.notify_all()

    # -- threaded mode ------------------------------------------------------
    def start(self) -> None:
        assert self._thread is None
        self._stopped.clear()
        self._thread = threading.Thread(target=self._run, name=self.name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stopped.is_set():
            ev = self._queue.get()
            if ev is None:
                break
            self._deliver(ev)

    def stop(self) -> None:
        self._stopped.set()
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # Abandon undelivered events so await_drained() callers unblock.
        with self._drained:
            dropped = 0
            while True:
                try:
                    if self._queue.get_nowait() is not None:
                        dropped += 1
                except queue.Empty:
                    break
            if dropped:
                log.warning("%s: dropped %d undelivered events on stop",
                            self.name, dropped)
            self._in_flight = 0
            self._drained.notify_all()

    def await_drained(self, timeout: float | None = None) -> bool:
        """Block until every queued event has been handled."""
        with self._drained:
            return self._drained.wait_for(
                lambda: self._in_flight == 0 and self._queue.empty(), timeout)


class DrainDispatcher(Dispatcher):
    """Manually pumped dispatcher for deterministic tests and sync local mode.

    Reference: DrainDispatcher used throughout tez-dag state-machine tests.
    """

    def drain(self) -> int:
        """Deliver queued events until the queue is empty (including events
        enqueued by handlers).  Returns the number delivered."""
        n = 0
        while True:
            try:
                ev = self._queue.get_nowait()
            except queue.Empty:
                return n
            if ev is None:
                continue
            self._deliver(ev)
            n += 1

    def start(self) -> None:  # drained explicitly; no thread
        pass

    def stop(self) -> None:
        pass


class _MultiHandler:
    """Fan-out when two subsystems register for the same event-type class
    (reference: AsyncDispatcher MultiListenerHandler)."""

    def __init__(self, *handlers: EventHandler):
        self.handlers = list(handlers)

    def __call__(self, event: Event) -> None:
        for h in self.handlers:
            h(event)


class ShardedDispatcher(Dispatcher):
    """Hash-sharded event bus for event storms: events partition across N
    worker queues by a shard key so unrelated entities process in parallel
    while per-entity ordering is preserved.

    Reference: tez-common AsyncDispatcherConcurrent.java (used by the AM for
    vertex/task event storms at high task counts).  The shard key defaults
    to the event's entity id attribute when present.
    """

    def __init__(self, name: str = "sharded-dispatcher", num_shards: int = 4):
        super().__init__(name)
        self.num_shards = max(1, num_shards)
        self._shards = [Dispatcher(f"{name}-{i}")
                        for i in range(self.num_shards)]
        for s in self._shards:
            s._handlers = self._handlers   # shared registry
            # forward errors at delivery time so assigning self.on_error
            # after start() still reaches the funnel
            s.on_error = self._forward_error

    def _forward_error(self, exc: BaseException, event: Event) -> None:
        if self.on_error is not None:
            self.on_error(exc, event)
        else:
            raise exc

    def peak_depths(self) -> "list[int]":
        """Per-shard high-water queue depths (storm diagnostics)."""
        return [s.peak_in_flight for s in self._shards]

    def _shard_key(self, event: Event) -> int:
        """The shard of the state machine the event drives.  An event names
        its target and may carry finer ids besides (a vertex's
        V_TASK_COMPLETED names the task and the attempt), so the coarsest
        id present is the target.  An attempt's events go to its task's
        shard: a task drives its attempts' state machines in place (it
        kills the losers when one succeeds).  tez_tpu keys by the finest id
        an event carries, so one vertex's or one task's events can run on
        two shard threads at once (ROADMAP Queue 3)."""
        for attr in ("dag_id", "vertex_id", "task_id"):
            v = getattr(event, attr, None)
            if v is not None:
                return hash(str(v))
        v = getattr(event, "attempt_id", None)
        if v is not None:
            return hash(str(getattr(v, "task_id", v)))
        return 0

    def dispatch(self, event: Event) -> None:
        self._shards[self._shard_key(event) % self.num_shards].dispatch(event)

    def start(self) -> None:
        for s in self._shards:
            s.start()

    def stop(self) -> None:
        for s in self._shards:
            s.stop()

    def await_drained(self, timeout: float | None = None) -> bool:
        """Drained only when TWO consecutive full passes observe every shard
        empty with no deliveries in between — handlers may cascade events
        ACROSS shards, so a single quiet pass has a TOCTOU window.  The
        shared deadline bounds total wait at `timeout`."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        prev_gen = -1
        while True:
            for s in self._shards:
                remaining = None if deadline is None else \
                    max(0.0, deadline - _time.monotonic())
                if not s.await_drained(remaining):
                    return False
            gen = sum(sh._delivered for sh in self._shards)
            if gen == prev_gen:
                # nothing was delivered between two fully-drained passes:
                # no cascade can be in flight
                return True
            prev_gen = gen
            if deadline is not None and _time.monotonic() >= deadline:
                return False
