"""The per-task harness: build IOs from the TaskSpec, run the processor.

Reference parity: tez-runtime-internals/.../runtime/
LogicalIOProcessorRuntimeTask.java:169 (initialize :234, run :378, close :385)
+ TezTaskRunner2 (kill/abort races) + TaskReporter.java:79 (heartbeat thread
batching events/counters, receiving routed events back).

The port's copy of tez_tpu.runtime.task_runner.
"""
from __future__ import annotations

import logging
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tez_tpu_torch.api.events import (CustomProcessorEvent, TezAPIEvent,
                                      TezEvent)
from tez_tpu_torch.api.runtime import (LogicalIOProcessor, LogicalInput,
                                       LogicalOutput, MergedLogicalInput,
                                       ObjectRegistry)
from tez_tpu_torch.common import faults, metrics, tracing
from tez_tpu_torch.common.counters import TaskCounter, TezCounters
from tez_tpu_torch.ops.device import resolve_device
from tez_tpu_torch.runtime.contexts import (TaskKilledError,
                                            TezInputContext,
                                            TezOutputContext,
                                            TezProcessorContext)
from tez_tpu_torch.runtime.memory import (DEFAULT_TASK_BUDGET,
                                          MemoryDistributor)
from tez_tpu_torch.runtime.task_spec import TaskSpec

log = logging.getLogger(__name__)

HEARTBEAT_INTERVAL = 0.05

#: serializes per-task torch.profiler traces (one profile at a time in a
#: process)
_PROFILE_LOCK = threading.Lock()


class TaskRunner:
    """Runs one task attempt to completion and reports to the umbilical."""

    def __init__(self, spec: TaskSpec, umbilical: Any,
                 registry: Optional[ObjectRegistry] = None,
                 work_dir: str = "/tmp", node_id: str = "local",
                 service_metadata: Optional[Dict[str, Any]] = None,
                 device: Any = "cuda"):
        self.spec = spec
        #: where the task's data plane runs: the contexts hand it to the
        #: outputs' sorters and the inputs' merge managers (device="cpu"
        #: runs the kernels' plain versions); a card that is absent raises
        self.device = resolve_device(device)
        self.umbilical = umbilical
        self.registry = registry or ObjectRegistry()
        self.work_dir = work_dir
        self.node_id = node_id
        self.counters = TezCounters()
        from tez_tpu_torch.runtime.memory import (RESERVE_FRACTION,
                                                  parse_weight_ratios)
        self.memory = MemoryDistributor(
            int(spec.conf.get("tez.task.hbm.budget.bytes",
                              DEFAULT_TASK_BUDGET)),
            weights=parse_weight_ratios(
                str(spec.conf.get("tez.task.scale.memory.ratios", ""))),
            reserve_fraction=float(spec.conf.get(
                "tez.task.scale.memory.reserve-fraction", RESERVE_FRACTION)),
            weighted=str(spec.conf.get(
                "tez.task.scale.memory.allocator.class",
                "weighted")) != "uniform")
        self.progress = 0.0
        self.service_metadata: Dict[str, Any] = service_metadata or {
            "shuffle": {"host": node_id, "port": 0}}
        self.inputs: Dict[str, LogicalInput] = {}
        self.outputs: Dict[str, LogicalOutput] = {}
        self.processor: Optional[LogicalIOProcessor] = None
        self._event_buffer: List[TezEvent] = []
        self._event_lock = threading.Lock()
        self._killed = threading.Event()
        self._done = threading.Event()
        self._fatal: Optional[Tuple[BaseException | None, str]] = None
        # Incoming events arriving before IO initialize() completes are
        # trapped and replayed (reference: TezTrapEventHandler).  The
        # dispatch lock serializes replay vs. new heartbeat deliveries so
        # handle_events is single-threaded and in arrival order.
        self._inputs_ready = threading.Event()
        #: every output is served from sealed lineage: inputs stay idle
        self._serving_reuse = False
        self._dispatch_lock = threading.Lock()
        self._trapped_incoming: List[Tuple[str, TezAPIEvent]] = []

    # -- called by contexts --------------------------------------------------
    def enqueue_events(self, events: Sequence[TezEvent]) -> None:
        with self._event_lock:
            self._event_buffer.extend(events)

    def check_killed(self) -> None:
        if self._killed.is_set():
            raise TaskKilledError(str(self.spec.attempt_id))

    def fatal_error(self, exc: Optional[BaseException], message: str) -> None:
        self._fatal = (exc, message)
        self._killed.set()

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> str:
        """Returns final state string: SUCCEEDED | FAILED | KILLED."""
        start = time.time()
        from tez_tpu_torch.runtime.diagnostics import (RuntimeStatsUpdater,
                                                       ThreadDumpHelper)
        stats = RuntimeStatsUpdater(self.counters)
        dump_ms = int(self.spec.conf.get("tez.thread.dump.interval.ms", 0))
        dumper = ThreadDumpHelper(dump_ms,
                                  label=str(self.spec.attempt_id)).start()
        reporter = threading.Thread(target=self._heartbeat_loop,
                                    name=f"reporter-{self.spec.attempt_id}",
                                    daemon=True)
        reporter.start()
        from tez_tpu_torch.common import ndc
        try:
            # adopt the AM's trace context (TaskSpec carrier) so the
            # attempt span — and everything under it, including shuffle
            # fetches delivered on other threads — shares the DAG trace id
            with ndc.context(str(self.spec.attempt_id)), \
                    tracing.attached(getattr(self.spec, "trace_context", "")), \
                    tracing.span(f"attempt:{self.spec.attempt_id}",
                                 cat="task",
                                 vertex=self.spec.vertex_name,
                                 task_index=self.spec.task_index,
                                 attempt=self.spec.attempt_number):
                with tracing.span("initialize", cat="task"):
                    self._initialize()
                with tracing.span("run", cat="task"):
                    if self._try_reuse():
                        log.info("task %s: outputs served from store "
                                 "lineage — processor skipped",
                                 self.spec.attempt_id)
                    else:
                        self._run_processor()
                with tracing.span("close", cat="task"):
                    self._close()
            state = "SUCCEEDED"
        except TaskKilledError:
            # fatal_error() funnels through the kill flag; report it as a
            # FATAL failure, not a kill (kills respawn, fatals fail the DAG).
            state = "FAILED" if self._fatal is not None else "KILLED"
            if state == "KILLED":
                self._abort_outputs()
        except BaseException as e:  # noqa: BLE001
            log.exception("task %s failed", self.spec.attempt_id)
            state = "FAILED"
            self._failure_diag = (
                f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=20)}")
        finally:
            self._done.set()
            dumper.stop()
            reporter.join(timeout=5)
        stats.update(final=True)
        self.counters.find_counter(TaskCounter.WALL_CLOCK_MILLISECONDS)\
            .set_value(int((time.time() - start) * 1000))
        if state == "SUCCEEDED":
            self.umbilical.task_done(
                self.spec.attempt_id, self._drain_events(), self.counters,
                epoch=getattr(self.spec, "am_epoch", 0),
                window_id=getattr(self.spec, "window_id", 0),
                stream=getattr(self.spec, "stream", ""))
        elif state == "KILLED":
            self.umbilical.task_killed(self.spec.attempt_id,
                                       "killed during execution")
        else:
            fatal = False
            diag = getattr(self, "_failure_diag", "unknown")
            if self._fatal is not None:
                exc, msg = self._fatal
                diag = f"{msg}: {exc!r}"
                fatal = True
            self.umbilical.task_failed(self.spec.attempt_id, diag,
                                       fatal=fatal, counters=self.counters)
        return state

    def _initialize(self) -> None:
        """Create + initialize processor and IOs, then settle memory
        (reference: initialize:234 — parallel init; serialized here for
        determinism, the IO init cost on TPU is kernel compilation which is
        cached in the object registry anyway)."""
        spec = self.spec
        proc_ctx = TezProcessorContext(self, spec.processor_descriptor.payload)
        self.processor = spec.processor_descriptor.instantiate(proc_ctx)

        init_events: List[TezEvent] = []
        for i, ispec in enumerate(spec.inputs):
            ictx = TezInputContext(self, ispec.input_descriptor.payload,
                                   ispec.source_vertex_name, i)
            inp = ispec.input_descriptor.instantiate(
                ictx, ispec.physical_input_count)
            self.inputs[ispec.source_vertex_name] = inp
        for i, ospec in enumerate(spec.outputs):
            octx = TezOutputContext(self, ospec.output_descriptor.payload,
                                    ospec.destination_vertex_name, i)
            out = ospec.output_descriptor.instantiate(
                octx, ospec.physical_output_count)
            self.outputs[ospec.destination_vertex_name] = out

        self.processor.initialize()
        for name, inp in self.inputs.items():
            evs = inp.initialize() or []
            if evs:
                inp.context.send_events(evs)
        for name, out in self.outputs.items():
            evs = out.initialize() or []
            if evs:
                out.context.send_events(evs)

        # group (merged) inputs presented to the processor as one entry
        for g in spec.group_inputs:
            members = [self.inputs[v] for v in g.group_vertices
                       if v in self.inputs]
            ictx = TezInputContext(self, g.merged_input_descriptor.payload,
                                   g.group_name, len(spec.inputs))
            merged = g.merged_input_descriptor.instantiate(ictx, members)
            self.inputs[g.group_name] = merged

        self.memory.make_initial_allocations()

        # auto-start non-merged inputs (reference: startable inputs started
        # by the framework before processor.run)
        # an attempt every output of which will be served from sealed
        # lineage never reads its inputs: they are not started and their
        # events are dropped (tez_tpu starts them, and how much they fetch
        # before the reuse closes them follows the threads' timing)
        self._serving_reuse = self._reuse_ready()
        if not self._serving_reuse:
            for inp in self.inputs.values():
                if not isinstance(inp, MergedLogicalInput):
                    inp.start()

        # replay any events trapped while initializing (ready-flag flip and
        # replay are atomic w.r.t. heartbeat deliveries)
        with self._dispatch_lock:
            trapped, self._trapped_incoming = self._trapped_incoming, []
            self._inputs_ready.set()
            if trapped:
                self._dispatch_incoming(trapped)

    def _reuse_ready(self) -> bool:
        outs = list(self.outputs.values())
        return bool(outs) and all(
            getattr(out, "reuse_available", lambda: False)() for out in outs)

    def _try_reuse(self) -> bool:
        """Cross-DAG output reuse: when EVERY output reports a sealed store
        run for this task's lineage, alias them under this attempt's path
        and skip the processor entirely.  Any output that can't reuse (leaf
        outputs, pipelined shuffle, lineage off/miss) forces a full run —
        partial reuse would publish a mix of old and new data."""
        self.check_killed()
        if not self._serving_reuse:
            return False
        for out in self.outputs.values():
            evs = out.publish_reused() or []
            if evs:
                out.context.send_events(evs)
        self.counters.find_counter("ShuffleStore",
                                   "store.reuse.tasks").increment(1)
        return True

    def _run_processor(self) -> None:
        self.check_killed()
        # delay mode makes this attempt a straggler (speculation bait);
        # fail mode crashes it into the ordinary TA_FAILED retry path
        faults.fire("task.run", detail=str(self.spec.attempt_id))
        # an attempt killed while it was held (a speculation loser, a
        # crashed AM's runner fenced on its heartbeat) does not start its
        # processor: tez_tpu's runs it until its first progress report,
        # merging and launching on a dead attempt's behalf
        self.check_killed()
        assert self.processor is not None
        # Constituents of a group stay in self.inputs (they receive events)
        # but the processor only sees the merged input (reference:
        # LogicalIOProcessorRuntimeTask hides grouped constituents).
        grouped = {v for g in self.spec.group_inputs for v in g.group_vertices}
        run_inputs = {name: inp for name, inp in self.inputs.items()
                      if name not in grouped}
        # A per-task torch.profiler trace (kernel timings, copies) viewable
        # in Perfetto, gated off by default; the key keeps tez_tpu's name
        profile_dir = self.spec.conf.get("tez.task.jax-profile.dir", "")
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            trace_dir = os.path.join(str(profile_dir),
                                     str(self.spec.attempt_id))
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            # one profile at a time in a process; in-process runners share
            # it, so profiled tasks serialize — a debugging mode, not the
            # hot path
            with _PROFILE_LOCK, profile(activities=activities) as prof:
                self.processor.run(run_inputs, self.outputs)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        else:
            self.processor.run(run_inputs, self.outputs)

    def _close(self) -> None:
        self.check_killed()
        for inp in self.inputs.values():
            evs = inp.close() or []
            if evs and not isinstance(inp, MergedLogicalInput):
                inp.context.send_events(evs)
        for out in self.outputs.values():
            evs = out.close() or []
            if evs:
                out.context.send_events(evs)
        self.processor.close()

    def _abort_outputs(self) -> None:
        """A killed attempt (a speculation loser, a preemption victim)
        tears its outputs down: an output with an ``abort`` (the ordered
        output's sorter) lets its spans in flight finish, gives its device
        streams back and publishes nothing, so the next attempt in this
        runner finds the span plane as a fresh one would."""
        for out in self.outputs.values():
            abort = getattr(out, "abort", None)
            if abort is None:
                continue
            try:
                abort()
            except Exception:  # noqa: BLE001 — the attempt is dead
                log.exception("task %s: output abort failed",
                              self.spec.attempt_id)

    # -- heartbeat -----------------------------------------------------------
    def _drain_events(self) -> List[TezEvent]:
        with self._event_lock:
            out = self._event_buffer
            self._event_buffer = []
            return out

    def _heartbeat_loop(self) -> None:
        from tez_tpu_torch.am.task_comm import HeartbeatRequest
        try:
            interval = float(self.spec.conf.get(
                "tez.task.am.heartbeat.interval-ms",
                HEARTBEAT_INTERVAL * 1000)) / 1000.0
        except (TypeError, ValueError):
            interval = HEARTBEAT_INTERVAL
        while not self._done.wait(interval):
            try:
                self._heartbeat_once()
            except BaseException:  # noqa: BLE001
                log.exception("heartbeat failed for %s", self.spec.attempt_id)
                self._killed.set()
                return
        # final pull-free flush happens via task_done/task_failed

    def _heartbeat_once(self) -> None:
        from tez_tpu_torch.am.task_comm import HeartbeatRequest
        req = HeartbeatRequest(self.spec.attempt_id, self._drain_events(),
                               counters=None, progress=self.progress,
                               epoch=getattr(self.spec, "am_epoch", 0),
                               window_id=getattr(self.spec, "window_id", 0),
                               stream=getattr(self.spec, "stream", ""))
        t0 = time.perf_counter()
        resp = self.umbilical.heartbeat(req)
        metrics.observe("am.heartbeat.rtt",
                        (time.perf_counter() - t0) * 1000.0,
                        counters=self.counters)
        if resp.should_die:
            self._killed.set()
        if resp.events:
            with self._dispatch_lock:
                if not self._inputs_ready.is_set():
                    self._trapped_incoming.extend(resp.events)
                else:
                    self._dispatch_incoming(resp.events)

    def _dispatch_incoming(self, events: List[Tuple[str, TezAPIEvent]]) -> None:
        if self._serving_reuse:
            return
        by_input: Dict[str, List[TezAPIEvent]] = {}
        for input_name, ev in events:
            if isinstance(ev, CustomProcessorEvent):
                self.processor.handle_events([ev])
            else:
                by_input.setdefault(input_name, []).append(ev)
        for name, evs in by_input.items():
            inp = self.inputs.get(name)
            if inp is not None:
                inp.handle_events(evs)
            else:
                log.warning("events for unknown input %s", name)
