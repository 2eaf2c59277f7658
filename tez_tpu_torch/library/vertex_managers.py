"""Stock vertex managers.

Reference parity:
- ImmediateStartVertexManager (tez-runtime-library/.../vertexmanager/)
- RootInputVertexManager (tez-dag/.../dag/impl/RootInputVertexManager.java:
  slow-start for root-input vertices; simplified to immediate here)
- InputReadyVertexManager (ONE_TO_ONE/location affinity scheduling)
- ShuffleVertexManager{Base} (slow-start by source completion fraction +
  auto-parallelism, ShuffleVertexManagerBase.java:271,320; auto-parallelism
  shrink in tez_tpu_torch.library.shuffle_vm_payloads)

The port's copy of tez_tpu.library.vertex_managers.
"""
from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Sequence, Set

from tez_tpu_torch.api.events import VertexManagerEvent
from tez_tpu_torch.api.vertex_manager import (ScheduleTaskRequest,
                                              TaskAttemptIdentifier,
                                              VertexManagerPlugin)
from tez_tpu_torch.dag.edge_property import DataMovementType

log = logging.getLogger(__name__)


class ImmediateStartVertexManager(VertexManagerPlugin):
    """Schedule every task as soon as the vertex starts."""

    def initialize(self) -> None:
        pass

    def on_vertex_started(self, completions: Sequence[TaskAttemptIdentifier]) -> None:
        n = self.context.get_vertex_num_tasks(self.context.vertex_name)
        self.context.schedule_tasks(
            [ScheduleTaskRequest(i) for i in range(n)])

    def on_source_task_completed(self, attempt: TaskAttemptIdentifier) -> None:
        pass

    def on_vertex_manager_event_received(self, event: VertexManagerEvent) -> None:
        pass

    def on_root_vertex_initialized(self, input_name: str, descriptor: Any,
                                   events: List[Any]) -> None:
        pass


class RootInputVertexManager(ImmediateStartVertexManager):
    """Vertices fed by root inputs; parallelism is already settled by the
    initializer when the vertex starts, so scheduling is immediate.  The
    reference adds optional slow-start against *source vertices* which root
    vertices don't have."""


class InputReadyVertexManager(VertexManagerPlugin):
    """Schedule task i when every ONE_TO_ONE source task i has completed and
    broadcast sources are fully done (reference: InputReadyVertexManager —
    also provides affinity; locality is a no-op in-process)."""

    def initialize(self) -> None:
        self._scheduled: Set[int] = set()
        self._one_to_one_done: Dict[str, Set[int]] = {}
        self._broadcast_done: Dict[str, Set[int]] = {}
        self._started = False

    def _edge_sources(self) -> Dict[str, Any]:
        return self.context.get_input_vertex_edge_properties()

    def on_vertex_started(self, completions: Sequence[TaskAttemptIdentifier]) -> None:
        self._started = True
        for c in completions:
            self._record(c)
        self._maybe_schedule()

    def on_source_task_completed(self, attempt: TaskAttemptIdentifier) -> None:
        self._record(attempt)
        if self._started:
            self._maybe_schedule()

    def _record(self, attempt: TaskAttemptIdentifier) -> None:
        props = self._edge_sources()
        prop = props.get(attempt.vertex_name)
        if prop is None:
            return
        if prop.data_movement_type is DataMovementType.ONE_TO_ONE:
            self._one_to_one_done.setdefault(
                attempt.vertex_name, set()).add(attempt.task_index)
        else:
            self._broadcast_done.setdefault(
                attempt.vertex_name, set()).add(attempt.task_index)

    def _maybe_schedule(self) -> None:
        props = self._edge_sources()
        num = self.context.get_vertex_num_tasks(self.context.vertex_name)
        def _source_done(name: str) -> bool:
            target = self.context.get_vertex_num_tasks(name)
            # parallelism undetermined (-1) means the source hasn't even
            # initialized — definitely not ready
            return target >= 0 and \
                len(self._broadcast_done.get(name, ())) >= target

        bcast_ready = all(
            _source_done(name) for name, p in props.items()
            if p.data_movement_type is not DataMovementType.ONE_TO_ONE)
        if not bcast_ready:
            return
        o2o = [name for name, p in props.items()
               if p.data_movement_type is DataMovementType.ONE_TO_ONE]
        ready = []
        for i in range(num):
            if i in self._scheduled:
                continue
            if all(i in self._one_to_one_done.get(name, ()) for name in o2o):
                ready.append(i)
        if ready:
            self._scheduled.update(ready)
            self.context.schedule_tasks(
                [ScheduleTaskRequest(i) for i in ready])

    def on_vertex_manager_event_received(self, event: VertexManagerEvent) -> None:
        pass

    def on_root_vertex_initialized(self, input_name: str, descriptor: Any,
                                   events: List[Any]) -> None:
        pass


class ShuffleVertexManager(VertexManagerPlugin):
    """Slow-start + (phase 5) auto-parallelism for scatter-gather consumers.

    Reference: ShuffleVertexManagerBase.java:271 — tasks are released as the
    fraction of completed source tasks crosses [min, max]; between the two
    fractions tasks are released proportionally.  Config via payload dict:
    {"min_fraction": 0.25, "max_fraction": 0.75, "auto_parallel": False,
     "desired_task_input_size": 100MiB, "min_task_parallelism": 1}.
    """

    DEFAULT_MIN_FRACTION = 0.25
    DEFAULT_MAX_FRACTION = 0.75

    @classmethod
    def create_descriptor(cls, conf: Any = None, **overrides: Any):
        """Config-builder parity (ShuffleVertexManager.createConfigBuilder):
        translate the registered tez.shuffle-vertex-manager.* conf keys into
        the plugin payload; keyword overrides win."""
        from tez_tpu_torch.common import config as C
        from tez_tpu_torch.common.payload import VertexManagerPluginDescriptor
        conf = conf or {}
        # single source of defaults: the registered ConfKeys
        payload = {
            "min_fraction": conf.get(C.SHUFFLE_VM_MIN_SRC_FRACTION.name,
                                     C.SHUFFLE_VM_MIN_SRC_FRACTION.default),
            "max_fraction": conf.get(C.SHUFFLE_VM_MAX_SRC_FRACTION.name,
                                     C.SHUFFLE_VM_MAX_SRC_FRACTION.default),
            "auto_parallel": conf.get(C.SHUFFLE_VM_AUTO_PARALLEL.name,
                                      C.SHUFFLE_VM_AUTO_PARALLEL.default),
            "desired_task_input_size": conf.get(
                C.SHUFFLE_VM_DESIRED_TASK_INPUT_SIZE.name,
                C.SHUFFLE_VM_DESIRED_TASK_INPUT_SIZE.default),
            "min_task_parallelism": conf.get(
                C.SHUFFLE_VM_MIN_TASK_PARALLELISM.name,
                C.SHUFFLE_VM_MIN_TASK_PARALLELISM.default),
        }
        payload.update(overrides)
        return VertexManagerPluginDescriptor.create(
            f"{cls.__module__}:{cls.__name__}", payload=payload)

    def initialize(self) -> None:
        payload = self.context.user_payload.load() or {}
        if not isinstance(payload, dict):
            payload = {}
        self.min_fraction = payload.get("min_fraction", self.DEFAULT_MIN_FRACTION)
        self.max_fraction = payload.get("max_fraction", self.DEFAULT_MAX_FRACTION)
        # push-based shuffle ingest mode: with eager push enabled, the
        # consumer should sit INGESTING pushed spills while the map wave
        # runs — release every task once the start fraction of sources has
        # finished (min==max makes _maybe_schedule release all) instead of
        # riding the slow-start ramp.  An explicit payload fraction wins:
        # someone who configured slow-start asked for it.  getattr: custom
        # duck-typed contexts written before get_vertex_conf existed keep
        # working (they simply never see ingest mode).
        conf = getattr(self.context, "get_vertex_conf", dict)() or {}
        push_on = conf.get("tez.runtime.shuffle.push.enabled", False) \
            if hasattr(conf, "get") else False
        if isinstance(push_on, str):
            push_on = push_on.lower() in ("1", "true", "yes")
        if push_on and "min_fraction" not in payload and \
                "max_fraction" not in payload:
            start = float(conf.get(
                "tez.runtime.shuffle.push.start-fraction", 0.05) or 0.05)
            self.min_fraction = self.max_fraction = start
        self.auto_parallel = payload.get("auto_parallel", False)
        self.desired_task_input_size = payload.get(
            "desired_task_input_size", 100 * 1024 * 1024)
        self.min_task_parallelism = payload.get("min_task_parallelism", 1)
        self._started = False
        self._scheduled: Set[int] = set()
        self._completed_sources: Set[tuple] = set()
        self._pending_completions: List[TaskAttemptIdentifier] = []
        self._output_stats: Dict[tuple, int] = {}   # (vertex, task) -> bytes
        self._parallelism_determined = not self.auto_parallel
        # A source whose parallelism is still unresolved (num_tasks == -1,
        # e.g. an InputInitializer racing this vertex's init) must hold
        # scheduling: releasing consumers against an unconfigured source
        # snapshots physical_input_count=-1 into their specs and they
        # complete empty.  Register for CONFIGURED so scheduling re-fires
        # the moment the source resolves (reference:
        # ShuffleVertexManagerBase registers for every source vertex's
        # state updates and counts numSourceTasksConfigured).  getattr:
        # duck-typed test contexts without the registry keep working.
        reg = getattr(self.context, "register_for_vertex_state_updates", None)
        if reg is not None:
            for name in self._shuffle_source_names():
                reg(name, ["CONFIGURED"])

    # -- source bookkeeping --------------------------------------------------
    def _shuffle_source_names(self) -> List[str]:
        return [name for name, prop in
                self.context.get_input_vertex_edge_properties().items()
                if prop.data_movement_type in (DataMovementType.SCATTER_GATHER,
                                               DataMovementType.CUSTOM)]

    def _total_source_tasks(self) -> int:
        """Total shuffle-source tasks, or -1 while ANY source is still
        unconfigured.  -1 must not be clamped into the sum: 'unknown' and
        'empty' are different answers — an unknown total makes the
        completed fraction meaningless (0/0 reads as 1.0 and releases the
        whole consumer against a source that hasn't resolved yet)."""
        total = 0
        for name in self._shuffle_source_names():
            n = self.context.get_vertex_num_tasks(name)
            if n < 0:
                return -1
            total += n
        return total

    def _completed_fraction(self, source_names: Sequence[str],
                            total_sources: int) -> float:
        """Completions from the given sources only — a BROADCAST side-input
        finishing first must not inflate the shuffle completion fraction
        (reference: ShuffleVertexManagerBase tracks per-srcVertex stats)."""
        names = set(source_names)
        done = sum(1 for (vname, _t) in self._completed_sources
                   if vname in names)
        return done / total_sources if total_sources else 1.0

    def on_vertex_started(self, completions: Sequence[TaskAttemptIdentifier]) -> None:
        self._started = True
        for c in completions:
            self._completed_sources.add((c.vertex_name, c.task_index))
        self._maybe_schedule()

    def on_source_task_completed(self, attempt: TaskAttemptIdentifier) -> None:
        self._completed_sources.add((attempt.vertex_name, attempt.task_index))
        if self._started:
            self._maybe_schedule()

    def on_vertex_manager_event_received(self, event: VertexManagerEvent) -> None:
        """Collect per-task output sizes (feeds auto-parallelism; reference:
        ShuffleVertexManagerBase.onVertexManagerEventReceived + compute of
        expected total output)."""
        payload = event.user_payload
        if isinstance(payload, dict) and "output_size" in payload and \
                event.producer_attempt is not None:
            att = event.producer_attempt
            vname = event.producer_vertex_name or \
                (str(att.vertex_id) if hasattr(att, "vertex_id") else str(att))
            key = (vname, att.task_id.id) \
                if hasattr(att, "task_id") else (vname, 0)
            self._output_stats[key] = payload["output_size"]
        if self._started:
            self._maybe_schedule()

    def _shuffle_output_stats(self) -> Dict[tuple, int]:
        """Stats from shuffle (SG/CUSTOM) sources only — a BROADCAST
        side-input's tiny output reports must not drag the per-task average
        down and over-shrink the consumer.  Falls back to all stats only
        when NO key is attributable to any input edge (older event path
        keyed by vertex id); 'only broadcast reported' yields {} so the
        no-shrink finalization path runs instead."""
        shuffle_names = set(self._shuffle_source_names())
        all_edges = set(self.context.get_input_vertex_edge_properties())
        attributable = any(k[0] in all_edges for k in self._output_stats)
        if not attributable:
            return dict(self._output_stats)
        return {k: v for k, v in self._output_stats.items()
                if k[0] in shuffle_names}

    def on_root_vertex_initialized(self, input_name: str, descriptor: Any,
                                   events: List[Any]) -> None:
        pass

    def on_vertex_state_updated(self, update) -> None:
        """A source vertex just resolved its parallelism (CONFIGURED):
        anything held back by the unconfigured-source gate can go now."""
        if update.state == "CONFIGURED" and self._started:
            self._maybe_schedule()

    # -- auto-parallelism (reference: ShuffleVertexManagerBase.computeRouting
    # :444 — shrink to ceil(totalSize/desiredTaskInputDataSize) and swap the
    # edge managers for range routing) ---------------------------------------
    def _try_determine_parallelism(self) -> bool:
        if self._parallelism_determined:
            return True
        if self.context.vertex_reconfiguration_restored():
            # a recovering AM already re-applied the journaled decision;
            # re-deciding here could shrink differently and orphan the
            # restored tasks (reference: recovered VertexConfigurationDone)
            self._parallelism_determined = True
            return True
        total_sources = self._total_source_tasks()
        if total_sources < 0:
            return False        # a source is unconfigured — wait for it
        if total_sources == 0:
            self._parallelism_determined = True
            return True
        fraction = self._completed_fraction(self._shuffle_source_names(),
                                            total_sources)
        stats = self._shuffle_output_stats()
        if not stats:
            if fraction >= 1.0:
                # every source finished without reporting stats (e.g. all
                # outputs empty): finalize with no shrink rather than
                # deadlocking the consumer (reference finalizes parallelism
                # unconditionally once sources complete)
                self._parallelism_determined = True
                return True
            return False
        if fraction < self.min_fraction:
            return False
        expected_total = (sum(stats.values()) / len(stats)) * total_sources
        current = self.context.get_vertex_num_tasks(self.context.vertex_name)
        desired = int(math.ceil(expected_total /
                                max(1, self.desired_task_input_size)))
        desired = max(self.min_task_parallelism, min(desired, current))
        if desired < current:
            from tez_tpu_torch.common.payload import (EdgeManagerPluginDescriptor)
            from tez_tpu_torch.dag.edge_property import (DataMovementType,
                                                         EdgeProperty)
            base_range = int(math.ceil(current / desired))
            # recompute so no trailing task gets an empty partition range
            # (e.g. 10 partitions, desired 6 -> base 2 -> 5 real tasks)
            desired = int(math.ceil(current / base_range))
            new_props = {}
            for name, prop in \
                    self.context.get_input_vertex_edge_properties().items():
                if prop.data_movement_type is not \
                        DataMovementType.SCATTER_GATHER:
                    continue
                desc = EdgeManagerPluginDescriptor.create(
                    "tez_tpu_torch.library.range_edge_manager:"
                    "RangeScatterGatherEdgeManager",
                    payload={"num_source_partitions": current,
                             "base_range": base_range})
                new_props[name] = EdgeProperty.create_custom(
                    desc, prop.data_source_type, prop.edge_source,
                    prop.edge_destination, prop.scheduling_type)
            log.info("%s: auto-parallelism %d -> %d (expected %.0f bytes)",
                     self.context.vertex_name, current, desired,
                     expected_total)
            self.context.reconfigure_vertex(desired,
                                            source_edge_properties=new_props)
            self.context.done_reconfiguring_vertex()
        self._parallelism_determined = True
        return True

    # -- scheduling ----------------------------------------------------------
    def _maybe_schedule(self) -> None:
        if not self._try_determine_parallelism():
            return
        total_sources = self._total_source_tasks()
        if total_sources < 0:
            return              # a source is unconfigured — wait for it
        num_tasks = self.context.get_vertex_num_tasks(self.context.vertex_name)
        if num_tasks <= 0:
            return
        fraction = self._completed_fraction(self._shuffle_source_names(),
                                            total_sources)
        if fraction < self.min_fraction:
            return
        if self.max_fraction <= self.min_fraction:
            release = num_tasks
        elif fraction >= self.max_fraction:
            release = num_tasks
        else:
            release = int(math.ceil(
                num_tasks * (fraction - self.min_fraction)
                / (self.max_fraction - self.min_fraction)))
        ready = [i for i in range(min(release, num_tasks))
                 if i not in self._scheduled]
        if ready:
            self._scheduled.update(ready)
            self.context.schedule_tasks(
                [ScheduleTaskRequest(i) for i in ready])


class VertexManagerWithConcurrentInput(ImmediateStartVertexManager):
    """Gang-schedules all tasks at vertex start: CONCURRENT edges mean the
    consumer runs alongside its producers rather than after them
    (reference: VertexManagerWithConcurrentInput.java, 248 LoC — the
    concurrent-edge trigger variants collapse to start-time scheduling in
    the runner-pool model)."""
