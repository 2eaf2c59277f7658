"""Runs InputInitializers on the AM executor, feeding events back through
the dispatcher.

Reference parity: tez-dag/.../dag/impl/RootInputInitializerManager.java:82.

The port's copy of tez_tpu.am.initializer_host.
"""
from __future__ import annotations

import logging
from typing import Any, TYPE_CHECKING

from tez_tpu_torch.api.events import InputInitializerEvent
from tez_tpu_torch.api.initializer import (InputInitializer,
                                           InputInitializerContext)
from tez_tpu_torch.am.events import VertexEvent, VertexEventType
from tez_tpu_torch.common.payload import UserPayload
from tez_tpu_torch.dag.plan import RootInputSpec

if TYPE_CHECKING:
    from tez_tpu_torch.am.vertex_impl import VertexImpl

log = logging.getLogger(__name__)


class _InitializerContext(InputInitializerContext):
    def __init__(self, vertex: "VertexImpl", spec: RootInputSpec):
        self._vertex = vertex
        self._spec = spec

    @property
    def input_name(self) -> str:
        return self._spec.name

    @property
    def vertex_name(self) -> str:
        return self._vertex.name

    @property
    def dag_name(self) -> str:
        return self._vertex.dag.name

    @property
    def user_payload(self) -> UserPayload:
        # The initializer's own payload, unconditionally (reference:
        # InputInitializerContext.getUserPayload); the input descriptor's
        # payload is exposed separately as input_user_payload.
        if self._spec.initializer_descriptor is not None:
            return self._spec.initializer_descriptor.payload
        return UserPayload()

    @property
    def input_user_payload(self) -> UserPayload:
        return self._spec.input_descriptor.payload

    @property
    def conf(self) -> Any:
        return self._vertex.conf

    @property
    def num_tasks(self) -> int:
        return self._vertex.num_tasks

    def get_total_available_resource(self) -> int:
        return self._vertex.ctx.total_slots()

    def get_vertex_num_tasks(self, vertex_name: str) -> int:
        v = self._vertex.dag.vertex_by_name(vertex_name)
        return v.num_tasks if v is not None else -1

    def register_for_vertex_state_updates(self, vertex_name: str,
                                          states: Any) -> None:
        self._vertex.dag.register_state_updates(
            vertex_name, self._vertex.initializers.get(self._spec.name), states)


def run_initializer(vertex: "VertexImpl", spec: RootInputSpec) -> None:
    ctx = _InitializerContext(vertex, spec)
    try:
        initializer: InputInitializer = \
            spec.initializer_descriptor.instantiate(ctx)
    except BaseException as e:  # noqa: BLE001
        vertex.ctx.dispatch(VertexEvent(
            VertexEventType.V_ROOT_INPUT_FAILED, vertex.vertex_id,
            input_name=spec.name, diagnostics=repr(e)))
        return
    vertex.initializers[spec.name] = initializer

    def _run() -> None:
        try:
            events = initializer.initialize()
            vertex.ctx.dispatch(VertexEvent(
                VertexEventType.V_ROOT_INPUT_INITIALIZED, vertex.vertex_id,
                input_name=spec.name, events=events))
        except BaseException as e:  # noqa: BLE001
            log.exception("initializer %s/%s failed", vertex.name, spec.name)
            vertex.ctx.dispatch(VertexEvent(
                VertexEventType.V_ROOT_INPUT_FAILED, vertex.vertex_id,
                input_name=spec.name, diagnostics=repr(e)))

    vertex.ctx.submit_to_executor(_run)


def deliver_initializer_event(vertex: "VertexImpl",
                              event: InputInitializerEvent) -> None:
    init = vertex.initializers.get(event.target_input_name)
    if init is not None:
        try:
            init.handle_input_initializer_event([event])
        except BaseException:  # noqa: BLE001
            log.exception("initializer event handler failed")
