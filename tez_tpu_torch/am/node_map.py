"""Per-node health tracking and blacklisting.

Reference parity: tez-dag/.../app/rm/node/ (AMNodeImpl / AMNodeTracker) —
task-attempt failures accumulate per NODE (not just per container); crossing
tez.am.maxtaskfailures.per.node blacklists the node so no new work lands
there, and when more than tez.am.node.blacklisting.ignore.threshold of the
cluster is blacklisted, blacklisting is IGNORED (nodes go FORCED_ACTIVE)
rather than deadlocking the app on its own pessimism.

Here a "node" is one runner host: "local-0" for the in-process pool, the
--node-id of each runner process for the subprocess pool (one per TPU host
in a pod deployment).

The port's copy of tez_tpu.am.node_map.
"""
from __future__ import annotations

import enum
import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)


class NodeState(enum.Enum):
    ACTIVE = enum.auto()
    BLACKLISTED = enum.auto()
    FORCED_ACTIVE = enum.auto()    # blacklisted but ignore-threshold crossed


class AMNodeTracker:
    def __init__(self, conf: Any):
        from tez_tpu_torch.common import config as C
        self.max_failures = int(conf.get(C.NODE_MAX_TASK_FAILURES))
        self.enabled = bool(conf.get(C.NODE_BLACKLISTING_ENABLED))
        self.ignore_threshold = float(
            conf.get(C.NODE_BLACKLISTING_FAILURE_THRESHOLD)) / 100.0
        self._lock = threading.Lock()
        self._failures: Dict[str, int] = {}
        self._states: Dict[str, NodeState] = {}
        self._ignoring = False
        #: observer for state transitions: (node_id, new_state, failures).
        #: Invoked OUTSIDE the lock (the AM's handler emits history events,
        #: which may re-enter tracker queries).
        self.on_transition: Optional[
            Callable[[str, NodeState, int], None]] = None

    def _notify(self, transitions: List[Tuple[str, NodeState, int]]) -> None:
        """Fire collected transitions after the lock is released."""
        cb = self.on_transition
        if cb is None:
            return
        for node, state, failures in transitions:
            try:
                cb(node, state, failures)
            except Exception:  # noqa: BLE001 — observers must not wedge
                log.exception("node transition observer failed")

    # -- bookkeeping ---------------------------------------------------------
    def node_seen(self, node_id: str) -> None:
        if not node_id:
            return
        transitions: List[Tuple[str, NodeState, int]] = []
        with self._lock:
            if node_id not in self._states:
                self._states[node_id] = NodeState.ACTIVE
                # fleet grew: the blacklisted fraction changed, so a
                # FORCED_ACTIVE node may have to revert to BLACKLISTED
                self._recompute_ignore_locked(transitions)
        self._notify(transitions)

    def on_attempt_failed(self, node_id: str) -> None:
        if not node_id or not self.enabled:
            return
        transitions: List[Tuple[str, NodeState, int]] = []
        with self._lock:
            self._states.setdefault(node_id, NodeState.ACTIVE)
            n = self._failures.get(node_id, 0) + 1
            self._failures[node_id] = n
            if n >= self.max_failures and \
                    self._states[node_id] is NodeState.ACTIVE:
                self._states[node_id] = NodeState.BLACKLISTED
                log.warning("node %s blacklisted after %d task failures",
                            node_id, n)
                transitions.append((node_id, NodeState.BLACKLISTED, n))
                self._recompute_ignore_locked(transitions)
        self._notify(transitions)

    def on_attempt_succeeded(self, node_id: str) -> None:
        """Reference semantics: success does not clear the failure count
        (AMNodeImpl only counts failures); kept as a hook for health probes."""

    def node_gone(self, node_id: str) -> None:
        """A node left the fleet (host decommissioned): drop its state so
        stale blacklist entries don't skew the ignore-threshold math."""
        transitions: List[Tuple[str, NodeState, int]] = []
        with self._lock:
            self._states.pop(node_id, None)
            self._failures.pop(node_id, None)
            self._recompute_ignore_locked(transitions)
        self._notify(transitions)

    def _recompute_ignore_locked(
            self, transitions: Optional[
                List[Tuple[str, NodeState, int]]] = None) -> None:
        total = len(self._states)
        blacklisted = sum(1 for s in self._states.values()
                          if s in (NodeState.BLACKLISTED,
                                   NodeState.FORCED_ACTIVE))
        ignore = total > 0 and blacklisted / total > self.ignore_threshold
        if ignore and not self._ignoring:
            log.warning("%d/%d nodes blacklisted (> %.0f%%): ignoring "
                        "blacklists to keep the app alive", blacklisted,
                        total, self.ignore_threshold * 100)
        self._ignoring = ignore
        for node, s in self._states.items():
            if ignore and s is NodeState.BLACKLISTED:
                self._states[node] = NodeState.FORCED_ACTIVE
            elif not ignore and s is NodeState.FORCED_ACTIVE:
                self._states[node] = NodeState.BLACKLISTED
            else:
                continue
            if transitions is not None:
                transitions.append((node, self._states[node],
                                    self._failures.get(node, 0)))

    # -- queries -------------------------------------------------------------
    def is_usable(self, node_id: str) -> bool:
        if not self.enabled or not node_id:
            return True
        with self._lock:
            return self._states.get(node_id, NodeState.ACTIVE) is not \
                NodeState.BLACKLISTED

    def state(self, node_id: str) -> NodeState:
        with self._lock:
            return self._states.get(node_id, NodeState.ACTIVE)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {n: {"state": s.name,
                        "failures": self._failures.get(n, 0)}
                    for n, s in self._states.items()}
