"""Fault-injectable Input/Processor/Output test doubles.

Reference parity: tez-tests/.../test/{TestInput,TestProcessor,TestOutput}.java
(config-driven failures by task/attempt index, SURVEY.md §4 item 4).  Payload
dict keys:
  do_fail: bool                 fail in run/read
  failing_task_indices: [int]   which tasks fail ([-1] = all)
  failing_upto_attempt: int     fail attempts <= this number (then succeed)
  fatal: bool                   report a FATAL failure
  sleep_ms: int                 delay before acting

The port's copy of tez_tpu.library.test_components: the test input, output
and processor, the flaky-fetch ordered input, and the scripted fetch session
behind tez.runtime.shuffle.fetcher.class.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence

from tez_tpu_torch.api.events import TezAPIEvent
from tez_tpu_torch.api.runtime import (KeyValueReader, LogicalIOProcessor,
                                       LogicalInput, LogicalOutput, Reader,
                                       Writer)


class _FailPolicy:
    def __init__(self, context: Any):
        payload = context.user_payload.load() or {}
        self.payload = payload if isinstance(payload, dict) else {}
        self.context = context

    def should_fail(self) -> bool:
        if not self.payload.get("do_fail"):
            return False
        tasks = self.payload.get("failing_task_indices", [-1])
        if -1 not in tasks and self.context.task_index not in tasks:
            return False
        upto = self.payload.get("failing_upto_attempt", 10**9)
        return self.context.task_attempt_number <= upto

    @property
    def fatal(self) -> bool:
        return bool(self.payload.get("fatal"))

    def sleep(self) -> None:
        ms = self.payload.get("sleep_ms", 0)
        if ms:
            time.sleep(ms / 1000.0)


class _EmptyReader(KeyValueReader):
    def __iter__(self):
        return iter(())


class TestInput(LogicalInput):
    def initialize(self) -> List[TezAPIEvent]:
        self._policy = _FailPolicy(self.context)
        return []

    def get_reader(self) -> Reader:
        self._policy.sleep()
        if self._policy.should_fail():
            if self._policy.fatal:
                self.context.fatal_error(None, "TestInput fatal failure")
            raise RuntimeError(
                f"TestInput failing task={self.context.task_index} "
                f"attempt={self.context.task_attempt_number}")
        return _EmptyReader()

    def handle_events(self, events: Sequence[TezAPIEvent]) -> None:
        pass

    def close(self) -> List[TezAPIEvent]:
        return []


class _NullWriter(Writer):
    def write(self, key: Any, value: Any) -> None:
        pass


class TestOutput(LogicalOutput):
    def initialize(self) -> List[TezAPIEvent]:
        self._policy = _FailPolicy(self.context)
        return []

    def get_writer(self) -> Writer:
        return _NullWriter()

    def handle_events(self, events: Sequence[TezAPIEvent]) -> None:
        pass

    def close(self) -> List[TezAPIEvent]:
        if self._policy.should_fail():
            raise RuntimeError("TestOutput failing at close")
        return []


class TestProcessor(LogicalIOProcessor):
    def initialize(self) -> None:
        self._policy = _FailPolicy(self.context)

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        self._policy.sleep()
        # drive inputs so TestInput failures fire
        for inp in inputs.values():
            reader = inp.get_reader()
            if isinstance(reader, KeyValueReader):
                for _ in reader:
                    pass
        if self._policy.should_fail():
            if self._policy.fatal:
                self.context.fatal_error(None, "TestProcessor fatal failure")
                raise RuntimeError("fatal TestProcessor failure")
            raise RuntimeError(
                f"TestProcessor failing task={self.context.task_index} "
                f"attempt={self.context.task_attempt_number}")

    def close(self) -> None:
        pass


class FlakyFetchOrderedInput(LogicalInput):
    """OrderedGroupedKVInput wrapper that injects a fetch failure on the
    first event delivery of attempt 0 of configured tasks (reference:
    FetcherWithInjectableErrors + FetcherErrorTestingConfig).

    Payload: {"failing_fetch_task_indices": [ints] (default [0]),
    "inject_delay_ms": int (default 0) — hold the failure report back so the
    cluster reaches a chosen state first (e.g. all slots occupied)}.
    """

    def __new__(cls, context, num_physical_inputs):
        from tez_tpu_torch.library.inputs import OrderedGroupedKVInput

        class _Impl(OrderedGroupedKVInput):
            def initialize(self):
                payload = self.context.user_payload.load() or {}
                if not isinstance(payload, dict):
                    payload = {}
                self._failing_tasks = payload.get(
                    "failing_fetch_task_indices", [0])
                self._inject_delay = payload.get("inject_delay_ms", 0) / 1e3
                self._injected = False
                return super().initialize()

            def handle_events(self, events):
                from tez_tpu_torch.api.events import (
                    CompositeRoutedDataMovementEvent, DataMovementEvent,
                    InputReadErrorEvent)
                passthrough = []
                for ev in events:
                    if (not self._injected
                            and self.context.task_attempt_number == 0
                            and self.context.task_index in self._failing_tasks
                            and isinstance(ev,
                                           (CompositeRoutedDataMovementEvent,
                                            DataMovementEvent))):
                        self._injected = True
                        if self._inject_delay:
                            time.sleep(self._inject_delay)
                        slot = getattr(ev, "target_index_start",
                                       getattr(ev, "target_index", 0))
                        self.context.send_events([InputReadErrorEvent(
                            diagnostics="injected fetch failure",
                            index=slot, version=ev.version,
                            is_local_fetch=True)])
                        continue   # drop just this event: its fetch "failed"
                    passthrough.append(ev)
                if passthrough:
                    super().handle_events(passthrough)

        return _Impl(context, num_physical_inputs)


class ScriptedFetchSession:
    """Injectable fetch-session factory for tez.runtime.shuffle.fetcher.class
    (reference: FetcherWithInjectableErrors — scripted fetch failures behind
    the real seam).  Serves from the in-process shuffle service regardless of
    host so no TCP server is needed; class-level script controls failures.

    Script (class attributes, reset per test):
      fail_remaining — first N fetches raise ConnectionError
      sessions / fetch_log — observability for coalescing assertions
    """

    fail_remaining = 0
    sessions: list = []
    fetch_log: list = []

    @classmethod
    def reset(cls, fail_remaining: int = 0) -> None:
        cls.fail_remaining = fail_remaining
        cls.sessions = []
        cls.fetch_log = []

    def __init__(self, host: str, port: int):
        type(self).sessions.append(self)
        self.host, self.port = host, port

    def fetch(self, path: str, spill: int, partition: int):
        cls = type(self)
        cls.fetch_log.append((self.host, path, spill, partition))
        if cls.fail_remaining > 0:
            cls.fail_remaining -= 1
            raise ConnectionError("scripted fetch failure")
        from tez_tpu_torch.shuffle.service import local_shuffle_service
        return local_shuffle_service().fetch_partition(path, spill,
                                                       partition)

    def close(self) -> None:
        pass
