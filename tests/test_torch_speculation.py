"""Port parity of the AM's optional services (am/estimators.py,
am/speculation.py, am/task_scheduler.py DagAwareTaskSchedulerService,
common/dispatcher.py ShardedDispatcher, common/lockorder.py) against
tez_tpu's, on the CPU.

The estimators get tests/test_speculation_estimators.py's progress
sequences on both packages and must give the same numbers to the bit; the
injected-slow-attempt race, the dag-aware scheduler's preemption victims
and the sharded dispatcher's per-entity order are compared outcome for
outcome; the lock-order witness must find the same provoked inversion and
stay clean over a real DAG.  The port's AMs run on device="cpu".
"""
import importlib
import math
import os
import threading
import time

import pytest

import chip_smoke

ROOTS = ("tez_tpu_torch", "tez_tpu")


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _fresh_planes():
    def reset():
        for root in ROOTS:
            mod(root, "common.epoch").reset()
            mod(root, "common.faults").clear_all()
            mod(root, "store").reset_store()
        mod(ROOTS[0], "common.lockorder").clear_all()
    reset()
    yield
    reset()


def both(fn):
    got = {root: fn(root) for root in ROOTS}
    assert got[ROOTS[0]] == got[ROOTS[1]]
    return got[ROOTS[0]]


# -- am/estimators.py ----------------------------------------------------------

def est_conf(root, **over):
    base = {"tez.am.legacy.speculative.exponential.smooth.lambda-millis":
            2_000,
            "tez.am.legacy.speculative.exponential.stagnated.millis": 5_000,
            "tez.am.legacy.speculative.exponential.skip.initials": 3}
    base.update(over)
    return mod(root, "common.config").TezConfiguration(base)


def feed(est, attempt, points):
    est.enroll(attempt, points[0][0])
    for t, p in points:
        est.update_attempt(attempt, p, t)


SLOW_START = [(float(t), 0.005 * t) for t in range(0, 21)] + \
    [(20.0 + t, 0.1 + 0.07 * t) for t in range(1, 11)]
HARSH_START = [(float(t), 0.001 * t) for t in range(0, 21)] + \
    [(20.0 + t, 0.02 + 0.095 * t) for t in range(1, 11)]
STAGNATED = [(float(t), 0.09 * t) for t in range(0, 11)] + \
    [(10.0 + 2 * t, 0.9) for t in range(1, 6)]


def estimates(root, points, now, durations=()):
    """(legacy, simple exponential) estimated runtime, the exponential
    one's stagnation verdict and its new-attempt runtime."""
    e = mod(root, "am.estimators")
    out = []
    for cls in (e.LegacyRuntimeEstimator, e.SimpleExponentialRuntimeEstimator):
        est = cls()
        est.contextualize(est_conf(root), "v")
        for d in durations:
            est.attempt_succeeded(d)
        feed(est, "a0", points)
        out.append(est.estimated_runtime("a0", now))
    return out + [est.has_stagnated("a0", now),
                  est.estimated_new_attempt_runtime(),
                  est.threshold_runtime(1.0)]


@pytest.mark.parametrize("case", ["slow_start", "harsh_start", "stagnated"])
def test_estimators_match_tez_tpu(case):
    points, now, durations = {
        "slow_start": (SLOW_START, 30.0, (10.0,)),
        "harsh_start": (HARSH_START, 30.0, ()),
        "stagnated": (STAGNATED, 20.0, (4.0, 6.0))}[case]
    legacy, exp, stagnated, new, threshold = both(
        lambda root: estimates(root, points, now, durations))
    if case == "slow_start":
        assert legacy == pytest.approx(37.5, rel=0.01) and exp < legacy
    elif case == "harsh_start":
        assert exp == pytest.approx(30.0 + (1 - 0.97) / 0.095, rel=0.2)
    else:
        assert stagnated and exp == math.inf
        assert (new, threshold) == (5.0, 6.0)


def test_data_statistics_and_skip_initials_match_tez_tpu():
    def run(root):
        e = mod(root, "am.estimators")
        s = e.DataStatistics()
        for x in (2.0, 4.0, 6.0, 11.5):
            s.add(x)
        exp = e.SimpleExponentialRuntimeEstimator()
        exp.contextualize(est_conf(root), "v")
        exp.enroll("a0", 0.0)
        seen = []
        for t, p in ((0.0, 0.1), (1.0, 0.2), (2.0, 0.3), (3.0, 0.4),
                     (4.0, 0.45)):
            exp.update_attempt("a0", p, t)
            seen.append(exp.estimated_runtime("a0", t + 0.5))
        return (s.count, s.mean(), s.var(), s.std(), s.outlier(1.5), seen)
    count, mean, _var, _std, _out, seen = both(run)
    assert count == 4 and mean == pytest.approx(5.875)
    assert seen[0] is None and seen[-1] is not None


@pytest.mark.parametrize("name", ["legacy", "simple_exponential", "custom"])
def test_create_estimator_matches_tez_tpu(name):
    def make(root):
        cls = name if name != "custom" else \
            f"{root}.am.estimators:SimpleExponentialRuntimeEstimator"
        est = mod(root, "am.estimators").create_estimator(est_conf(root, **{
            "tez.am.legacy.speculative.estimator.class": cls}), "v")
        return type(est).__name__, est.vertex_name
    both(make)


# -- am/speculation.py: the injected-slow-attempt race -------------------------

def race(root, tmp):
    """tests/test_speculation_estimators.py:144 on `root`: task 0's first
    attempt held 4 s before its processor runs; a speculative copy wins."""
    api = chip_smoke.dag_api(root, "cpu" if root == ROOTS[0] else None)
    P, D = api.payload, api.dag
    v = D.Vertex.create("v", P.ProcessorDescriptor.create(
        f"{root}.library.processors:SleepProcessor",
        payload={"sleep_ms": 50}), 4)
    dag = D.DAG.create("specrace").add_vertex(v)
    dag.set_conf("tez.am.speculation.enabled", True)
    dag.set_conf("tez.am.legacy.speculative.slowtask.threshold", 1.0)
    dag.set_conf("tez.am.soonest.retry.after.no.speculate", 200)
    dag.set_conf("tez.test.fault.spec",
                 "task.run:delay:ms=4000,n=1,match=_00_000000_0")
    dag.set_conf("tez.test.fault.seed", 6)
    client = api.TezClient.create("specrace", {
        "tez.staging-dir": os.path.join(tmp, "staging"),
        "tez.am.local.num-containers": 5}, **api.client_kw).start()
    try:
        t0 = time.monotonic()
        status = client.submit_dag(dag).wait_for_completion(timeout=30)
        elapsed = time.monotonic() - t0
        am = client.framework_client.am
        d = am.dag_counters.to_dict().get("DAGCounter", {})
        finished = {e.attempt_id.rsplit("_", 1)[-1] + ":" +
                    e.data.get("state", "")
                    for e in am.logging_service.events
                    if e.event_type.name == "TASK_ATTEMPT_FINISHED"
                    and "_00_000000_" in (e.attempt_id or "")}
    finally:
        client.stop()
    return (status.state.name, elapsed < 3.5, d.get("NUM_SPECULATIONS", 0),
            "1:SUCCEEDED" in finished)


def test_speculation_race_matches_tez_tpu(tmp_path):
    got = {}
    for root in ROOTS:
        (tmp_path / root).mkdir()
        got[root] = race(root, str(tmp_path / root))
    assert got[ROOTS[0]] == got[ROOTS[1]]
    state, fast, speculations, sibling_won = got[ROOTS[0]]
    assert state == "SUCCEEDED" and fast and speculations >= 1
    assert sibling_won


def test_speculative_loser_aborts_its_outputs(tmp_path, monkeypatch):
    """chip_smoke.py phase 19 C at a small size on the CPU, with the
    sorter's device floor at one record: tokenizer 0's first attempt
    holds once its sorter dispatched a span, loses to its sibling, and
    its kill aborts its ordered output with the span plane open (the
    abort finds the pipeline up): the span plane
    holds no stream pair after it, and neither the shuffle service nor
    the store (on here) gains an output from it.  Then the leg's abort
    with a span in flight (chip_smoke.abort_leg)."""
    import types
    from tez_tpu_torch.ops import device as device_ops, sorter
    aborted = []
    real = sorter.DeviceSorter.abort

    def spy(self):
        aborted.append(self._pipeline is not None)
        return real(self)
    monkeypatch.setattr(sorter.DeviceSorter, "abort", spy)
    args = types.SimpleNamespace(seed=0)
    corpus = chip_smoke.DagCorpus(str(tmp_path), args, corpus_mb=2,
                                  vocab_size=5_000, marks_mb=(2,))
    sz = dict(chip_smoke.TINY_STREAM, conf=dict(
        chip_smoke.FLOOR_CONF, **{"tez.runtime.store.enabled": True}))
    chip_smoke.speculation_leg(corpus, str(tmp_path), "cpu", sz,
                               __import__("collections").Counter())
    # the loser's output, then abort_leg's sorter
    assert len(aborted) == 2
    assert aborted == [True, True]
    held = chip_smoke.HELD_ATTEMPTS
    assert len(held) == 1 and held[0]["dispatched"] >= 1
    assert device_ops.held_stream_pairs() == 0     # no pair on the CPU


def test_sorter_abort_with_a_span_in_flight():
    """chip_smoke.abort_leg on the CPU: span 1's completion is held while
    the sorter aborts; abort() waits for it, nothing ships after the
    abort began, no run is left."""
    import collections
    chip_smoke.abort_leg("cpu", chip_smoke.TINY_STREAM,
                         collections.Counter())


def test_completion_after_abort_ships_nothing():
    """A span completion that reaches an aborted sorter is dropped: the
    pipelined output's on_spill is never called for it."""
    from tez_tpu_torch.ops.sorter import DeviceSorter
    s = DeviceSorter(num_partitions=4, key_width=12,
                     span_budget_bytes=1 << 20, engine="device",
                     device="cpu", pipeline_depth=2)
    shipped = []
    s.on_spill = lambda run, sid: shipped.append((run, sid))
    s._async_complete((0,), "run 0")
    s.abort()
    s._async_complete((2, 1), "run 1")
    assert shipped == [("run 0", 0)] and s.on_spill is None


# -- am/task_scheduler.py DagAwareTaskSchedulerService -------------------------

class _V:
    def __init__(self, name, dests):
        self.name = name
        self.out_edges = {
            d: type("E", (), {"destination_vertex":
                              type("V", (), {"name": d})()})()
            for d in dests}


class _Dag:
    dag_id = "dag_x"

    def __init__(self):
        # A -> B; C independent; D -> E
        self.vertices = {"A": _V("A", ["B"]), "B": _V("B", []),
                         "C": _V("C", []),
                         "D": _V("D", ["E"]), "E": _V("E", [])}
        self._by_index = dict(enumerate(self.vertices.values()))

    def vertex_by_id(self, vid):
        return self._by_index.get(vid.id)


def victims(root, scheduler, running, waiting):
    """The attempts a scheduler of `root` asks to kill: `running`
    (vertex index, task) attempts take both slots, then `waiting`
    (vertex index, priority) requests arrive."""
    C = mod(root, "common.config")

    class Ctx:
        conf = C.TezConfiguration({})

        def __init__(self):
            self.dispatched = []
            self.current_dag = _Dag()

        def ensure_runners(self, backlog):
            pass

        def dispatch(self, event):
            self.dispatched.append(event)

    ids = mod(root, "common.ids")
    did = ids.DAGId("app_1_da", 1)
    ctx = Ctx()
    sched = getattr(mod(root, "am.task_scheduler"), scheduler)(
        ctx, num_slots=2)
    for v, t in running:
        att = did.vertex(v).task(t).attempt(0)
        sched.schedule(att, f"spec-{v}-{t}", priority=20)
    assert sched.get_task("c0", timeout=0.1) is not None
    assert sched.get_task("c1", timeout=0.1) is not None
    for v, prio in waiting:
        sched.schedule(did.vertex(v).task(0).attempt(0), f"spec-{v}",
                       priority=prio)
    return [str(e.attempt_id).split("_", 3)[-1] for e in ctx.dispatched
            if getattr(e, "event_type", None) is not None
            and e.event_type.name == "TA_KILL_REQUEST"]


#: tests/test_resilience.py's cases: (running, waiting, expected victims of
#: the dag-aware scheduler); vertex indexes A0 B1 C2 D3 E4
PREEMPTION = {
    "descendant_only": ([(1, 0), (2, 0)], [(0, 5)], ["1_01_000000_0"]),
    "unrelated_spared": ([(2, 0), (2, 1)], [(0, 5)], []),
    "every_waiting_vertex": ([(4, 0), (2, 0)], [(0, 5), (3, 10)],
                             ["1_04_000000_0"]),
}


@pytest.mark.parametrize("case", sorted(PREEMPTION))
@pytest.mark.parametrize("scheduler", ["DagAwareTaskSchedulerService",
                                       "LocalTaskSchedulerService"])
def test_preemption_victims_match_tez_tpu(case, scheduler):
    running, waiting, want = PREEMPTION[case]
    got = both(lambda root: victims(root, scheduler, running, waiting))
    if scheduler == "DagAwareTaskSchedulerService":
        assert got == want
    else:
        assert len(got) == 1     # the stock scheduler preempts anyway


def test_dag_aware_scheduler_through_the_conf(tmp_path):
    def run(root):
        (tmp_path / root).mkdir()
        C = mod(root, "common.config")
        kw = {"device": "cpu"} if root == ROOTS[0] else {}
        am = mod(root, "am.app_master").DAGAppMaster(
            "app_1_das", C.TezConfiguration({
                "tez.staging-dir": str(tmp_path / root),
                "tez.am.task.scheduler.class": "dag-aware",
                "tez.am.concurrent.dispatcher.shards": 4,
                "tez.am.local.num-containers": 2}), **kw)
        am.start()
        try:
            P, D = mod(root, "common.payload"), mod(root, "dag.dag")
            v = D.Vertex.create("v", P.ProcessorDescriptor.create(
                f"{root}.library.processors:SleepProcessor",
                payload={"sleep_ms": 1}), 3)
            dag_id = am.submit_dag(
                D.DAG.create("das").add_vertex(v).create_dag_plan())
            state = am.wait_for_dag(dag_id, timeout=60).name
            return (type(am.task_scheduler).__name__,
                    type(am.dispatcher).__name__, state,
                    am.dag_counters.to_dict().get("DAGCounter", {}).get(
                        "NUM_SUCCEEDED_TASKS"))
        finally:
            am.stop()
    assert both(run) == ("DagAwareTaskSchedulerService", "ShardedDispatcher",
                         "SUCCEEDED", 3)


# -- common/dispatcher.py ShardedDispatcher ------------------------------------

@pytest.mark.parametrize("shards", [1, 4, 7])
def test_sharded_dispatcher_keeps_per_entity_order(shards):
    """tests/test_common.py's storm on both packages: 5 entities x 200
    events over `shards` queues, each entity's events handled in order."""
    def storm(root):
        import enum
        dmod = mod(root, "common.dispatcher")

        class Color(enum.Enum):
            PING = 1

        class KeyedEv(dmod.Event):
            def __init__(self, t, vertex_id, seq):
                super().__init__(t)
                self.vertex_id = vertex_id
                self.seq = seq

        d = dmod.ShardedDispatcher(num_shards=shards)
        got = {}
        d.register(Color, lambda e: got.setdefault(e.vertex_id, []).append(
            e.seq))
        d.start()
        for seq in range(200):
            for vid in "abcde":
                d.dispatch(KeyedEv(Color.PING, vid, seq))
        assert d.await_drained(10)
        d.stop()
        return got, len(d.peak_depths())
    got, n = both(storm)
    assert n == shards and got == {v: list(range(200)) for v in "abcde"}


def test_sharded_dispatcher_forwards_errors():
    def boom(root):
        import enum
        dmod = mod(root, "common.dispatcher")

        class Color(enum.Enum):
            PING = 1

        d = dmod.ShardedDispatcher(num_shards=3)
        seen = []

        def handler(e):
            raise ValueError("bad")
        d.register(Color, handler)
        d.start()
        d.on_error = lambda exc, ev: seen.append(type(exc).__name__)
        d.dispatch(dmod.Event(Color.PING))
        assert d.await_drained(10)
        d.stop()
        return seen
    assert both(boom) == ["ValueError"]


# -- common/lockorder.py ---------------------------------------------------------

def test_witness_finds_the_provoked_inversion():
    """A->B then B->A on private witnesses of both packages, armed one at
    a time: the same violation, rendered the same way."""
    def provoke(root):
        w = mod(root, "common.lockorder")
        wit = w.LockWitness()
        a = wit.wrap(w._ORIG_LOCK(), "fixture.A")
        b = wit.wrap(w._ORIG_LOCK(), "fixture.B")
        r = wit.wrap(w._ORIG_RLOCK(), "fixture.R")
        w.arm("test-inversion")
        try:
            with a:
                with b:
                    pass
            clean = wit.violations()
            with r:
                with r:
                    pass
            with b:
                with a:
                    pass
        finally:
            w.disarm("test-inversion")
        (v,) = wit.violations()
        return (clean, sorted(wit.edges()), v.held, v.acquired,
                v.render().split(" (thread")[0],
                "test_torch_speculation.py" in v.where)
    clean, edges, held, acquired, text, where = both(provoke)
    assert clean == [] and (held, acquired) == ("fixture.B", "fixture.A")
    assert edges == [("fixture.A", "fixture.B"), ("fixture.B", "fixture.A")]
    assert where


def test_port_witness_nests_inside_another_patch():
    """The port's witness saves the constructors in place when it arms and
    restores them when it disarms, so tez_tpu's session-wide patch (or
    none) is back afterwards; it wraps only locks its own package makes."""
    from tez_tpu_torch.common import lockorder
    from tez_tpu_torch.store.buffer_store import ShuffleBufferStore
    before = (threading.Lock, threading.RLock, threading.Condition)
    lockorder.arm("test-nesting")
    try:
        assert threading.Lock is not before[0]
        store = ShuffleBufferStore()
        mine = threading.Lock()
        assert getattr(store._lock, "_witness_name", None) == \
            "store.buffer_store.ShuffleBufferStore._lock"
        assert getattr(mine, "_witness_name", None) is None
        store.close()
    finally:
        lockorder.disarm("test-nesting")
    assert (threading.Lock, threading.RLock, threading.Condition) == before
    assert not lockorder.armed()


def test_lockorder_dag_runs_clean(tmp_path):
    """tez.debug.lockorder arms the port's witness for one DAG (the
    sharded dispatcher and dag-aware scheduler on too): the locks the DAG
    made are witnessed, no inversion is found, and the witness disarms
    when the DAG ends."""
    from tez_tpu_torch.common import lockorder
    api = chip_smoke.dag_api(ROOTS[0], "cpu")
    paths = [str(tmp_path / "in.txt")]
    with open(paths[0], "w") as fh:
        fh.write("a b c a b a\n" * 500)
    desc = chip_smoke.wordcount_description(paths, str(tmp_path / "out"),
                                            tokenizer_parallelism=2)
    run = chip_smoke.run_dag(api, desc, {
        "tez.staging-dir": str(tmp_path / "staging"),
        "tez.debug.lockorder": True,
        "tez.am.concurrent.dispatcher.shards": 4,
        "tez.am.task.scheduler.class": "dag-aware"})
    assert run.state == "SUCCEEDED"
    assert not lockorder.armed()
    assert len(lockorder.witness().lock_names()) > 0
    assert lockorder.check() == []


def test_sharded_dispatcher_keeps_a_state_machine_on_one_shard():
    """The port's shard key is the event's target: every event of one
    vertex (V_TASK_COMPLETED carries the task and attempt too) on the
    vertex's shard, and a task's events with its attempts' on the task's
    shard.  tez_tpu keys by the finest id an event carries, so these land
    on shards of their own (ROADMAP Queue 3), where with 4 shards a
    speculated task can run a third attempt after its success."""
    def keys(root):
        ev = mod(root, "am.events")
        ids = mod(root, "common.ids")
        shard = mod(root, "common.dispatcher").ShardedDispatcher(
            num_shards=4)._shard_key
        vertex = ids.DAGId("app_1_sk", 1).vertex(0)
        t0, t1 = vertex.task(0), vertex.task(1)
        a0, a1 = t0.attempt(0), t0.attempt(1)
        completed = [shard(ev.VertexEvent(
            ev.VertexEventType.V_TASK_COMPLETED, vertex, task_id=t,
            attempt_id=t.attempt(0))) for t in (t0, t1)]
        task = [shard(ev.TaskEvent(ev.TaskEventType.T_ATTEMPT_SUCCEEDED, t0,
                                   attempt_id=a1)),
                shard(ev.TaskEvent(ev.TaskEventType.T_ATTEMPT_KILLED, t0,
                                   attempt_id=a0)),
                shard(ev.TaskAttemptEvent(
                    ev.TaskAttemptEventType.TA_KILL_REQUEST, a0))]
        return len(set(completed)), len(set(task))
    assert keys(ROOTS[0]) == (1, 1)
    assert keys(ROOTS[1]) == (2, 2)
