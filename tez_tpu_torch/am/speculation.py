"""Speculative execution of straggler attempts.

Reference parity: tez-dag/.../dag/speculation/legacy/LegacySpeculator.java:63.
The runtime estimate comes from a pluggable ``TaskRuntimeEstimator``
(``tez.am.legacy.speculative.estimator.class`` — see am/estimators.py):
"simple_exponential" (default, smoothed recent progress rate + stagnation
detection) or "legacy" (whole-lifetime progress rate).  A running attempt is
speculated when its estimated completion is later than the estimated
completion of a fresh replacement AND its estimated total runtime clears the
slowtask threshold over the vertex mean; at most one new speculation per
vertex per scan (the best candidate), one speculative sibling per task.

The port's copy of tez_tpu.am.speculation.  A speculative sibling runs on
the AM's device like its original; the loser is killed mid-span, and its
runner thread gives its span plane back (runtime/task_runner.py).
"""
from __future__ import annotations

import logging
import math
import threading
from typing import Any, Dict, Set

from tez_tpu_torch.am.estimators import TaskRuntimeEstimator, create_estimator
from tez_tpu_torch.am.events import TaskEvent, TaskEventType
from tez_tpu_torch.am.task_impl import TaskAttemptState, TaskState
from tez_tpu_torch.common import clock, config as C

log = logging.getLogger(__name__)

#: Attempts younger than this are never speculated.
MIN_RUNTIME_BEFORE_SPECULATION = 0.5


class Speculator:
    """Per-DAG straggler watcher; runs its own scan thread (the reference
    speculator is also timer-driven outside the dispatcher)."""

    def __init__(self, dag: Any):
        self.dag = dag
        self.ctx = dag.ctx
        self.threshold = dag.conf.get(C.SPECULATION_SLOWTASK_THRESHOLD)
        # concurrent-speculation budget + scan pacing (reference:
        # LegacySpeculator.maybeScheduleASpeculation / computeSpeculations)
        self.min_allowed = dag.conf.get(C.SPECULATION_MIN_ALLOWED_TASKS)
        self.prop_total = dag.conf.get(C.SPECULATION_PROPORTION_TOTAL)
        self.prop_running = dag.conf.get(C.SPECULATION_PROPORTION_RUNNING)
        self.retry_no_spec = max(
            dag.conf.get(C.SPECULATION_RETRY_AFTER_NO_SPECULATE_MS), 50) \
            / 1000.0
        self.retry_spec = max(
            dag.conf.get(C.SPECULATION_RETRY_AFTER_SPECULATE_MS), 50) \
            / 1000.0
        stvt = dag.conf.get(C.SPECULATION_SINGLE_TASK_VERTEX_TIMEOUT_MS)
        self.single_task_timeout = stvt / 1000.0 if stvt >= 0 else None
        # fail fast on a bad estimator class name — a typo must surface at
        # DAG submit, not as a logged exception every scan forever
        create_estimator(dag.conf, "<probe>")
        self.estimators: Dict[str, TaskRuntimeEstimator] = {}
        self._fed_durations: Set[str] = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"speculator-{dag.dag_id}")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        # adaptive pacing: back off hard after launching a speculation (it
        # needs time to prove itself), rescan on the no-speculate cadence
        # otherwise (reference: SOONEST_RETRY_AFTER_SPECULATE /
        # _NO_SPECULATE — the operator's value is honored as-is)
        wait = self.retry_no_spec
        while not self._stop.wait(wait):
            speculated = 0
            try:
                speculated = self._scan()
            except BaseException:  # noqa: BLE001
                log.exception("speculator scan failed")
            wait = self.retry_spec if speculated else self.retry_no_spec

    def _estimator(self, vertex: Any) -> TaskRuntimeEstimator:
        est = self.estimators.get(vertex.name)
        if est is None:
            est = create_estimator(self.dag.conf, vertex.name)
            self.estimators[vertex.name] = est
        return est

    def _speculation_budget(self) -> int:
        """How many NEW speculative attempts may launch now: the cap is
        max(minimum floor, proportion of total tasks, proportion of running
        tasks) minus speculations already in flight (reference:
        LegacySpeculator.computeSpeculations)."""
        total = running = in_flight = 0
        for vertex in self.dag.vertices.values():
            for task in vertex.tasks.values():
                total += 1
                if task.state is TaskState.RUNNING:
                    running += 1
                    if len(task.live_attempts()) > 1:
                        in_flight += 1
        cap = max(self.min_allowed,
                  int(self.prop_total * total),
                  int(self.prop_running * running))
        return cap - in_flight

    def _scan(self) -> int:
        from tez_tpu_torch.am.dag_impl import TERMINAL_DAG_STATES
        if self.dag.state in TERMINAL_DAG_STATES:
            self._stop.set()
            return 0
        now = clock.wall_s()
        budget = self._speculation_budget()
        speculated = 0
        for vertex in self.dag.vertices.values():
            est = self._estimator(vertex)
            # feed newly completed durations into the vertex statistics
            for task in vertex.tasks.values():
                att = task.successful_attempt_impl()
                if att is not None and att.launch_time and \
                        att.attempt_id not in self._fed_durations:
                    self._fed_durations.add(att.attempt_id)
                    est.attempt_succeeded(att.finish_time - att.launch_time)
                    est.forget(att.attempt_id)  # prune per-attempt state
            if budget - speculated <= 0:
                break      # concurrent-speculation budget exhausted
            new_runtime = est.estimated_new_attempt_runtime()
            if new_runtime is None:
                # a single-task vertex never produces a sibling-completion
                # estimate; the reference gates it on a wall-clock timeout
                # instead (single.task.vertex.timeout, -1 = never)
                if self.single_task_timeout is not None and \
                        len(vertex.tasks) == 1:
                    speculated += self._maybe_speculate_single_task(
                        vertex, now)
                continue   # nothing completed yet: no replacement estimate
            best_task = None
            best_value = 0.0
            for task in vertex.tasks.values():
                if task.state is not TaskState.RUNNING:
                    continue
                live = task.live_attempts()
                if len(live) != 1:
                    continue  # already speculating (or nothing to watch)
                att = live[0]
                if att.state is not TaskAttemptState.RUNNING or \
                        not att.launch_time:
                    continue
                est.enroll(att.attempt_id, att.launch_time)
                est.update_attempt(att.attempt_id, att.progress, now)
                runtime = now - att.launch_time
                if runtime < max(MIN_RUNTIME_BEFORE_SPECULATION,
                                 new_runtime * (1 + self.threshold)):
                    continue
                estimated_total = est.estimated_runtime(att.attempt_id, now)
                if estimated_total is None:
                    continue   # estimator not confident yet
                if estimated_total <= new_runtime * (1 + self.threshold):
                    continue
                # speculation value: how much earlier a replacement would end
                estimated_end = att.launch_time + estimated_total
                replacement_end = now + new_runtime
                value = estimated_end - replacement_end
                if value <= 0:
                    continue
                if best_task is None or value > best_value:
                    best_task, best_value = task, value
                    best_info = (att, runtime, estimated_total, new_runtime)
            if best_task is not None:
                att, runtime, estimated_total, new_runtime = best_info
                log.info("speculating %s (runtime %.2fs, estimate %s, "
                         "new-attempt %.2fs, progress %.2f)",
                         att.attempt_id, runtime,
                         "inf" if math.isinf(estimated_total)
                         else f"{estimated_total:.2f}s",
                         new_runtime, att.progress)
                self.ctx.dispatch(TaskEvent(
                    TaskEventType.T_ADD_SPEC_ATTEMPT, best_task.task_id))
                speculated += 1
        return speculated

    def _maybe_speculate_single_task(self, vertex: Any, now: float) -> int:
        """Wall-clock speculation for one-task vertices (reference:
        TEZ_AM_LEGACY_SPECULATIVE_SINGLE_TASK_VERTEX_TIMEOUT)."""
        task = next(iter(vertex.tasks.values()))
        if task.state is not TaskState.RUNNING:
            return 0
        live = task.live_attempts()
        if len(live) != 1:
            return 0
        att = live[0]
        if att.state is not TaskAttemptState.RUNNING or not att.launch_time:
            return 0
        if now - att.launch_time <= self.single_task_timeout:
            return 0
        log.info("speculating single-task vertex attempt %s "
                 "(runtime %.2fs > timeout %.2fs)", att.attempt_id,
                 now - att.launch_time, self.single_task_timeout)
        self.ctx.dispatch(TaskEvent(
            TaskEventType.T_ADD_SPEC_ATTEMPT, task.task_id))
        return 1
