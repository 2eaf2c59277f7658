"""Declarative state-machine kernel used by DAG/Vertex/Task/Attempt.

Reference parity: Hadoop's StateMachineFactory + tez-dag/.../state/
StateMachineTez.java:27 (state-change callbacks).  Transitions are declared as
a table; hooks may return the next state (multi-arc transitions).

The port's copy of tez_tpu.common.statemachine.
"""
from __future__ import annotations

import enum
import logging
from typing import Any, Callable, Dict, Generic, Iterable, Tuple, TypeVar

log = logging.getLogger(__name__)

S = TypeVar("S", bound=enum.Enum)


class InvalidStateTransition(Exception):
    def __init__(self, state: enum.Enum, event_type: enum.Enum):
        super().__init__(f"invalid event {event_type} at state {state}")
        self.state = state
        self.event_type = event_type


Transition = Callable[[Any, Any], "enum.Enum | None"]


class StateMachineFactory(Generic[S]):
    """Builds immutable transition tables.

    ``add(pre, post, events, hook)`` — single-arc: hook's return ignored.
    ``add_multi(pre, posts, events, hook)`` — multi-arc: hook returns one of
    ``posts``.
    """

    def __init__(self, initial_state: S):
        self.initial_state = initial_state
        self._table: Dict[Tuple[S, enum.Enum], Tuple[Tuple[S, ...], Transition | None]] = {}

    def add(self, pre: S, post: S,
            events: "enum.Enum | Iterable[enum.Enum]",
            hook: Transition | None = None) -> "StateMachineFactory[S]":
        return self.add_multi(pre, (post,), events, hook)

    def add_multi(self, pre: S, posts: Iterable[S],
                  events: "enum.Enum | Iterable[enum.Enum]",
                  hook: Transition | None = None) -> "StateMachineFactory[S]":
        posts = tuple(posts)
        assert len(posts) == 1 or hook is not None, \
            "multi-arc transition requires a hook to pick the post state"
        if isinstance(events, enum.Enum):
            events = [events]
        for ev in events:
            key = (pre, ev)
            assert key not in self._table, f"duplicate transition {key}"
            self._table[key] = (posts, hook)
        return self

    def make(self, entity: Any,
             on_state_change: Callable[[Any, S, S], None] | None = None) -> "StateMachine[S]":
        return StateMachine(self, entity, on_state_change)


class StateMachine(Generic[S]):
    def __init__(self, factory: StateMachineFactory[S], entity: Any,
                 on_state_change: Callable[[Any, S, S], None] | None = None):
        self._factory = factory
        self._entity = entity
        self._state = factory.initial_state
        self._on_state_change = on_state_change

    @property
    def state(self) -> S:
        return self._state

    def force_state(self, state: S) -> None:
        """Recovery-only escape hatch (reference: recovery transitions)."""
        self._state = state

    def handle(self, event: Any) -> S:
        key = (self._state, event.event_type)
        entry = self._factory._table.get(key)
        if entry is None:
            raise InvalidStateTransition(self._state, event.event_type)
        posts, hook = entry
        old = self._state
        if hook is not None:
            ret = hook(self._entity, event)
            if len(posts) == 1:
                new = posts[0]
            else:
                assert ret in posts, f"hook returned {ret}, expected one of {posts}"
                new = ret
        else:
            new = posts[0]
        self._state = new
        if new is not old and self._on_state_change is not None:
            self._on_state_change(self._entity, old, new)
        return new

    def can_handle(self, event_type: enum.Enum) -> bool:
        return (self._state, event_type) in self._factory._table
