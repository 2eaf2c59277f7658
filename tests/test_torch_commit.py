"""The port's DAG commit under back-to-back vertex completions.

A vertex reports its completion to the DAG twice over: it counts itself
into ``DAGImpl.completed_vertices`` at once, on the dispatcher thread, and
queues a DAG_VERTEX_COMPLETED event that the DAG reads later.  When the
last two vertices finish before the first of those events is handled
(tasks served from sealed store lineage finish that fast), both events
find every vertex counted.  The DAG must start its commit once: two
commit threads list the same ``_temporary/committed/`` and race to rename
each part file, and the loser's FileNotFoundError fails the DAG (phase
18's query rerun, leg C).  tez_tpu's DAGImpl has the same race; the port
closes it on purpose.

Driven the way tests/test_state_machines.py drives tez_tpu: a
DrainDispatcher, no runners, attempt events injected by the test.
"""
import os

from tez_tpu_torch.am.dag_impl import DAGImpl, DAGState
from tez_tpu_torch.am.events import (DAGEvent, DAGEventType,
                                     SchedulerEventType, TaskAttemptEvent,
                                     TaskAttemptEventType, TaskEventType,
                                     VertexEventType)
from tez_tpu_torch.am.history import (HistoryEventType,
                                      InMemoryHistoryLoggingService)
from tez_tpu_torch.am.vertex_impl import VertexState
from tez_tpu_torch.common import config as C
from tez_tpu_torch.common.counters import TezCounters
from tez_tpu_torch.common.dispatcher import DrainDispatcher
from tez_tpu_torch.common.ids import DAGId
from tez_tpu_torch.common.payload import (OutputCommitterDescriptor,
                                          OutputDescriptor,
                                          ProcessorDescriptor)
from tez_tpu_torch.dag.dag import DAG, DataSinkDescriptor, Vertex


class QueueAM:
    """Minimal AMContext: events flow through a DrainDispatcher, and work
    for the executor (the DAG's commit) is queued for the test to run."""

    def __init__(self):
        self.dispatcher = DrainDispatcher()
        self.conf = C.TezConfiguration({})
        self.dag_counters = TezCounters()
        self.logging_service = InMemoryHistoryLoggingService()
        self.current_dag = None
        self.finished = []
        self.launch_requests = []
        self.executor = []
        d = self.dispatcher
        d.register(DAGEventType, lambda e: self.current_dag.handle(e))
        d.register(VertexEventType, self._vertex)
        d.register(TaskEventType, self._task)
        d.register(TaskAttemptEventType, self._attempt)
        d.register(SchedulerEventType, self._scheduler)

    def _vertex(self, e):
        self.current_dag.vertex_by_id(e.vertex_id).handle(e)

    def _task(self, e):
        v = self.current_dag.vertex_by_id(e.task_id.vertex_id)
        v.tasks[e.task_id.id].handle(e)

    def _attempt(self, e):
        v = self.current_dag.vertex_by_id(e.attempt_id.vertex_id)
        v.tasks[e.attempt_id.task_id.id].attempt(e.attempt_id).handle(e)

    def _scheduler(self, e):
        if e.event_type is SchedulerEventType.S_TA_LAUNCH_REQUEST:
            self.launch_requests.append(e.attempt_id)

    def dispatch(self, e):
        self.dispatcher.dispatch(e)

    def history(self, e):
        self.logging_service.handle(e)

    def history_vertex_configured(self, v):
        pass

    def submit_to_executor(self, fn):
        self.executor.append(fn)

    def total_slots(self):
        return 4

    def ensure_runners(self, backlog):
        pass

    def kill_attempt_in_runner(self, attempt_id):
        pass

    def deliver_processor_events(self, v, events, idx):
        pass

    def on_dag_finished(self, dag, final, **kw):
        self.finished.append(final)


def two_vertex_dag(am, out_dir):
    """Vertices a and b, one task each and no edge between them; b writes
    the FileOutput sink that the DAG commits."""
    dag = DAG.create("race")
    for name in ("a", "b"):
        dag.add_vertex(Vertex.create(name, ProcessorDescriptor.create(
            "tez_tpu_torch.library.processors:SimpleProcessor"), 1))
    dag.vertices["b"].add_data_sink("out", DataSinkDescriptor.create(
        OutputDescriptor.create("tez_tpu_torch.io.file_output:FileOutput",
                                payload={"path": out_dir}),
        OutputCommitterDescriptor.create(
            "tez_tpu_torch.io.file_output:FileOutputCommitter",
            payload={"path": out_dir})))
    impl = DAGImpl(DAGId("app_0_race", 1), dag.create_dag_plan(), am)
    am.current_dag = impl
    am.dispatch(DAGEvent(DAGEventType.DAG_INIT, impl.dag_id))
    am.dispatch(DAGEvent(DAGEventType.DAG_START, impl.dag_id))
    am.dispatcher.drain()
    return impl


def test_back_to_back_vertex_completions_commit_once(tmp_path):
    """Both attempts end in one drain, so both vertices count themselves
    complete before the DAG handles either DAG_VERTEX_COMPLETED: one
    commit starts, it publishes b's part, and the DAG succeeds."""
    am = QueueAM()
    out = str(tmp_path / "out")
    impl = two_vertex_dag(am, out)
    assert len(am.launch_requests) == 2
    for att in am.launch_requests:
        am.dispatch(TaskAttemptEvent(
            TaskAttemptEventType.TA_STARTED_REMOTELY, att,
            container_id="c0"))
    am.dispatcher.drain()
    # b's attempt moved its part into committed/ as FileOutput.close does
    committed = os.path.join(out, "_temporary", "committed")
    os.makedirs(committed)
    with open(os.path.join(committed, "part-00000"), "w") as fh:
        fh.write("k\tv\n")
    for att in am.launch_requests:
        am.dispatch(TaskAttemptEvent(TaskAttemptEventType.TA_DONE, att))
    am.dispatcher.drain()
    assert [v.state for v in impl.vertices.values()] == \
        [VertexState.SUCCEEDED] * 2
    assert impl.state is DAGState.COMMITTING
    started = am.logging_service.of_type(HistoryEventType.DAG_COMMIT_STARTED)
    assert len(started) == 1 and len(am.executor) == 1
    am.executor.pop()()
    am.dispatcher.drain()
    assert impl.state is DAGState.SUCCEEDED
    assert am.finished == [DAGState.SUCCEEDED]
    assert sorted(os.listdir(out)) == ["_SUCCESS", "part-00000"]
    with open(os.path.join(out, "part-00000")) as fh:
        assert fh.read() == "k\tv\n"
