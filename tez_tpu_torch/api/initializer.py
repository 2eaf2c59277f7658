"""InputInitializer and OutputCommitter SPIs.

Reference parity: tez-api/.../runtime/api/InputInitializer.java:36 (AM-side
root-input planning: compute splits -> InputDataInformationEvents + suggested
parallelism) and OutputCommitter.java (per-output commit/abort, optionally
deferred to DAG success).

The port's copy of tez_tpu.api.initializer.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, List, Sequence

from tez_tpu_torch.api.events import InputInitializerEvent
from tez_tpu_torch.common.payload import UserPayload


class InputInitializerContext(abc.ABC):
    @property
    @abc.abstractmethod
    def input_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def vertex_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def dag_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def user_payload(self) -> UserPayload:
        """The initializer descriptor's payload."""

    @property
    def input_user_payload(self) -> UserPayload:
        """The input descriptor's payload (reference:
        InputInitializerContext.getInputUserPayload)."""
        return UserPayload()

    @property
    def conf(self) -> Any:
        """Effective vertex/DAG configuration.  (The reference delivers
        conf to split generators inside MRInputUserPayload; exposing it on
        the context lets tez.grouping.* keys work without payload
        plumbing.)"""
        return {}

    @property
    @abc.abstractmethod
    def num_tasks(self) -> int:
        """Vertex parallelism as declared (-1 = initializer decides)."""

    @abc.abstractmethod
    def get_total_available_resource(self) -> int: ...

    @abc.abstractmethod
    def get_vertex_num_tasks(self, vertex_name: str) -> int: ...

    @abc.abstractmethod
    def register_for_vertex_state_updates(self, vertex_name: str,
                                          states: Sequence[str]) -> None: ...


@dataclasses.dataclass
class InputConfigureVertexTasksEvent:
    """Initializer asks the framework to set parallelism
    (reference: events/InputConfigureVertexTasksEvent.java)."""
    num_tasks: int
    location_hints: Any = None


class InputInitializer(abc.ABC):
    """Reference: InputInitializer.java:36."""

    def __init__(self, context: InputInitializerContext):
        self.context = context

    @abc.abstractmethod
    def initialize(self) -> List[Any]:
        """Returns a list of events: InputDataInformationEvent per split and
        optionally one InputConfigureVertexTasksEvent."""

    def handle_input_initializer_event(
            self, events: List[InputInitializerEvent]) -> None:
        pass

    def on_vertex_state_updated(self, update: Any) -> None:
        pass


class OutputCommitterContext(abc.ABC):
    @property
    @abc.abstractmethod
    def output_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def vertex_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def user_payload(self) -> UserPayload: ...


class SimpleCommitterContext(OutputCommitterContext):
    """Concrete committer identity used by the AM (and by recovery, which
    rebuilds committers straight from the plan).  Carries the owning AM
    incarnation so committers can fence filesystem mutations against a
    restarted AM (0 = unstamped/legacy)."""

    def __init__(self, output_name: str, vertex_name: str, payload: Any,
                 app_id: str = "", am_epoch: int = 0):
        self._o, self._v, self._p = output_name, vertex_name, payload
        self.app_id = app_id
        self.am_epoch = am_epoch

    @property
    def output_name(self) -> str:
        return self._o

    @property
    def vertex_name(self) -> str:
        return self._v

    @property
    def user_payload(self) -> Any:
        return self._p


class OutputCommitter(abc.ABC):
    """Reference: OutputCommitter.java."""

    def __init__(self, context: OutputCommitterContext):
        self.context = context

    @abc.abstractmethod
    def initialize(self) -> None: ...

    @abc.abstractmethod
    def setup_output(self) -> None: ...

    @abc.abstractmethod
    def commit_output(self) -> None: ...

    @abc.abstractmethod
    def abort_output(self, final_state: str) -> None: ...

    def is_task_recovery_supported(self) -> bool:
        return False

    def recover_task(self, task_index: int, previous_dag_attempt: int) -> None:
        pass
