"""Port parity of AM recovery (am/recovery.py RecoveryParser,
DAGAppMaster.crash / recover_and_resume at attempt > 1, the task and
vertex restore paths, the admission queue's crash and requeue,
TezClient.reattach / attach_dag) against tez_tpu's, on the CPU.

Every scenario of tests/test_resilience.py's AM recovery cases and of
tests/test_recovery_ha.py's crash-survival cases runs on both packages
inside one test, each in a staging directory of its own under the same
application id, and the two observations are compared: DAG states,
DAGCounter values, the successor AM's history event types in order (per
entity, with the application id cut out of its id) and the output bytes.
Everything compared is an integer, a name or bytes: there is no
tolerance.  The port's AMs run on device="cpu".
"""
import importlib
import json
import os
import subprocess
import sys
import threading
import time

import pytest

import chip_smoke

ROOTS = ("tez_tpu_torch", "tez_tpu")


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _fresh_planes():
    """Both packages' process-global planes start clean (tests/conftest.py
    resets only tez_tpu's)."""
    for root in ROOTS:
        mod(root, "common.epoch").reset()
        mod(root, "common.faults").clear_all()
        mod(root, "obs.flight").clear_all()
    yield
    for root in ROOTS:
        mod(root, "common.epoch").reset()
        mod(root, "common.faults").clear_all()
        mod(root, "obs.flight").clear_all()


def new_am(root, app_id, conf, attempt):
    kw = {"device": "cpu"} if root == ROOTS[0] else {}
    return mod(root, "am.app_master").DAGAppMaster(
        app_id, mod(root, "common.config").TezConfiguration(conf),
        attempt=attempt, **kw)


def client(root, name, conf, session=False):
    kw = {"device": "cpu"} if root == ROOTS[0] else {}
    return mod(root, "client.tez_client").TezClient.create(
        name, conf, session=session, **kw)


def both(tmp_path, scenario):
    """scenario(root, tmp) on each package, each in a directory of its
    own; returns the port's observation after asserting tez_tpu's equal."""
    obs = {}
    for root in ROOTS:
        tmp = tmp_path / root
        tmp.mkdir()
        obs[root] = scenario(root, tmp)
    assert obs[ROOTS[0]] == obs[ROOTS[1]]
    return obs[ROOTS[0]]


def sequences(am, entities=chip_smoke.ENTITY_FIELDS):
    """The AM's history event types in order, per entity: each event goes
    to the most specific id it carries (attempt, task, vertex, DAG or
    queued submission), with the application id cut out of it.
    `entities` picks which kinds of entity."""
    out = {}
    for ev in list(am.logging_service.events):
        for field in chip_smoke.ENTITY_FIELDS:
            ident = getattr(ev, field)
            if ident:
                if field in entities:
                    # a queued submission's id is <app id>-sub<n>
                    key = (field, "sub" + ident.rsplit("-sub", 1)[1]
                           if "-sub" in ident else ident.split("_", 3)[-1])
                    out.setdefault(key, []).append(ev.event_type.name)
                break
    return sorted(out.items())


def dag_counters(am):
    return am.dag_counters.to_dict().get("DAGCounter", {})


# -- processors, one set per package -------------------------------------------
def _components(root, tag):
    base = mod(root, "library.processors").SimpleProcessor

    class Emit(base):
        """Writes (key, 1) records downstream."""

        def run(self, inputs, outputs):
            writer = outputs["consumer"].get_writer()
            for i in range(50):
                writer.write(f"key{i:03d}".encode(), 1)

    class GatedCount(base):
        """Blocks until a sentinel file appears, then counts the sorted
        input and writes the total (payload: gate_path, result_path)."""

        def run(self, inputs, outputs):
            payload = self.context.user_payload.load() or {}
            while not os.path.exists(payload["gate_path"]):
                time.sleep(0.05)
            reader = inputs["producer"].get_reader()
            total = sum(sum(vs) for _k, vs in reader)
            with open(payload["result_path"], "w") as fh:
                fh.write(str(total))

    out = []
    for cls in (Emit, GatedCount):
        cls.__name__ = cls.__qualname__ = f"{cls.__name__}{tag}"
        globals()[cls.__name__] = cls
        out.append(cls)
    return out


COMPONENTS = {ROOTS[0]: _components(ROOTS[0], "Port"),
              ROOTS[1]: _components(ROOTS[1], "Ref")}


class _CarrierEvent:
    """Not a DME/CDME: forces the pickle wire kind (module-level so the
    allow_pickle=True leg can actually unpickle it)."""


def sleep_plan(root, name, sleep_ms=1, tasks=2):
    d, p = mod(root, "dag.dag"), mod(root, "common.payload")
    v = d.Vertex.create("v", p.ProcessorDescriptor.create(
        f"{root}.library.processors:SleepProcessor",
        payload={"sleep_ms": sleep_ms}), tasks)
    return d.DAG.create(name).add_vertex(v)


def gated_plan(root, name, gate, result, consumers=1, auto_parallel=False):
    """Two Emit producers -> GatedCount consumer(s) over an ordered
    scatter-gather edge."""
    d, p = mod(root, "dag.dag"), mod(root, "common.payload")
    ep = mod(root, "dag.edge_property")
    emit, count = COMPONENTS[root]
    kv = {"tez.runtime.key.class": "bytes",
          "tez.runtime.value.class": "long"}
    producer = d.Vertex.create("producer",
                               p.ProcessorDescriptor.create(emit), 2)
    consumer = d.Vertex.create("consumer", p.ProcessorDescriptor.create(
        count, payload={"gate_path": gate, "result_path": result}),
        consumers)
    if auto_parallel:
        consumer.set_vertex_manager_plugin(
            p.VertexManagerPluginDescriptor.create(
                f"{root}.library.vertex_managers:ShuffleVertexManager",
                payload={"auto_parallel": True,
                         "desired_task_input_size": 1 << 30,
                         "min_task_parallelism": 1,
                         "min_fraction": 1.0, "max_fraction": 1.0}))
    prop = ep.EdgeProperty.create(
        ep.DataMovementType.SCATTER_GATHER, ep.DataSourceType.PERSISTED,
        ep.SchedulingType.SEQUENTIAL,
        p.OutputDescriptor.create(
            f"{root}.library.outputs:OrderedPartitionedKVOutput", payload=kv),
        p.InputDescriptor.create(
            f"{root}.library.inputs:OrderedGroupedKVInput", payload=kv))
    dag = d.DAG.create(name).add_vertex(producer).add_vertex(consumer)
    dag.add_edge(d.Edge.create(producer, consumer, prop))
    return dag.create_dag_plan()


def wait_vertex(am, name, pred, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        dag = am.current_dag
        if dag is not None:
            st = dag.status_dict()
            v = st["vertices"].get(name)
            if v is not None and pred(v):
                return st
        time.sleep(0.05)
    pytest.fail(f"vertex {name} never reached the awaited state")


# -- tests/test_resilience.py ---------------------------------------------------
def test_am_recovery_resubmits_inflight_dag(tmp_path):
    def scenario(root, tmp):
        conf = {"tez.staging-dir": str(tmp / "stg"),
                "tez.am.local.num-containers": 2}
        am1 = new_am(root, "app_1_recov", conf, 1)
        am1.start()
        dag_id = am1.submit_dag(
            sleep_plan(root, "recov", sleep_ms=20_000).create_dag_plan())
        wait_vertex(am1, "v", lambda v: v["state"] == "RUNNING")
        am1.stop()
        am2 = new_am(root, "app_1_recov", conf, 2)
        am2.start()
        try:
            recovered = am2.recover_and_resume()
            running = am2.dag_status(recovered)["state"] in (
                "RUNNING", "INITED", "NEW")
            am2.kill_dag(recovered)
            final = am2.wait_for_dag(recovered, timeout=30).name
            return {"recovered": str(recovered) == str(dag_id),
                    "running": running, "final": final,
                    "dag": sequences(am2, ("dag_id",))}
        finally:
            am2.stop()
    obs = both(tmp_path, scenario)
    assert obs["recovered"] and obs["running"] and obs["final"] == "KILLED"


def test_am_recovery_short_circuits_succeeded_tasks(tmp_path):
    """The producer vertex completes before the crash; attempt 2 restores
    its tasks from the journal and only the consumer runs."""
    def scenario(root, tmp):
        gate, result = str(tmp / "gate"), str(tmp / "result")
        conf = {"tez.staging-dir": str(tmp / "stg"),
                "tez.am.local.num-containers": 3}
        am1 = new_am(root, "app_1_recsc", conf, 1)
        am1.start()
        am1.submit_dag(gated_plan(root, "recov_sc", gate, result))
        wait_vertex(am1, "producer", lambda v: v["state"] == "SUCCEEDED")
        am1.crash()
        am2 = new_am(root, "app_1_recsc", conf, 2)
        am2.start()
        try:
            recovered = am2.recover_and_resume()
            open(gate, "w").close()
            final = am2.wait_for_dag(recovered, timeout=60).name
            with open(result, "rb") as fh:
                out = fh.read()
            return {"final": final, "result": out,
                    "counters": dag_counters(am2),
                    "history": sequences(am2)}
        finally:
            am2.stop()
    obs = both(tmp_path, scenario)
    assert obs["final"] == "SUCCEEDED" and obs["result"] == b"100"
    assert obs["counters"]["TOTAL_LAUNCHED_TASKS"] == 1
    assert obs["counters"]["NUM_SUCCEEDED_TASKS"] == 3


def test_am_recovery_finished_dag_untouched(tmp_path):
    def scenario(root, tmp):
        conf = {"tez.staging-dir": str(tmp / "stg")}
        am1 = new_am(root, "app_1_fin", conf, 1)
        am1.start()
        dag_id = am1.submit_dag(sleep_plan(root, "recov").create_dag_plan())
        first = am1.wait_for_dag(dag_id, timeout=30).name
        am1.stop()
        am2 = new_am(root, "app_1_fin", conf, 2)
        am2.start()
        try:
            return {"first": first, "recovered": am2.recover_and_resume(),
                    "verdict": am2.completed_dags[str(dag_id)].name,
                    "counters": dag_counters(am2),
                    "history": sequences(am2)}
        finally:
            am2.stop()
    obs = both(tmp_path, scenario)
    assert obs["first"] == "SUCCEEDED" and obs["recovered"] is None
    assert obs["verdict"] == "SUCCEEDED" and obs["counters"] == {}


def sink_plan(root, name, out_dir):
    """Single-vertex plan with a FileOutput data sink (so recovery has a
    real committer to re-instantiate)."""
    d, p = mod(root, "dag.dag"), mod(root, "common.payload")
    v = d.Vertex.create("v", p.ProcessorDescriptor.create(
        f"{root}.library.processors:SleepProcessor",
        payload={"sleep_ms": 1}), 1)
    v.add_data_sink("sink", d.DataSinkDescriptor.create(
        p.OutputDescriptor.create(f"{root}.io.file_output:FileOutput",
                                  payload={"path": out_dir,
                                           "key_serde": "text",
                                           "value_serde": "text"}),
        p.OutputCommitterDescriptor.create(
            f"{root}.io.file_output:FileOutputCommitter",
            payload={"path": out_dir})))
    return d.DAG.create(name).add_vertex(v).create_dag_plan()


def tree(path):
    """Every file under path (relative name -> bytes)."""
    out = {}
    for dirpath, _dirs, files in os.walk(path):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = fh.read()
    return sorted(out.items())


#: commit-ledger cases: (policy, ledger records after DAG_COMMIT_STARTED's
#: plan, the output tree left by the crashed attempt)
COMMIT_CASES = {
    # commit started, no completion record, strict policy: FAILED, with
    # the rollback decision journaled (a DAG_COMMIT_ABORTED record)
    "in_flight_fails": ("fail", ("DAG_COMMIT_STARTED",), "plain"),
    # FINISHED: every committer ran; roll forward to SUCCEEDED
    "finished_rolls_forward": ("resume", ("DAG_COMMIT_STARTED",
                                          "DAG_COMMIT_FINISHED"), "plain"),
    # ABORTED: re-run the idempotent aborts, FAILED, nothing published
    "aborted_fails": ("resume", ("DAG_COMMIT_STARTED", "DAG_COMMIT_ABORTED"),
                      "partial"),
    # the default policy resumes the open ledger: the staged part is
    # published, _SUCCESS written, the ledger closed with FINISHED
    "in_flight_resumes": ("resume", ("DAG_COMMIT_STARTED",), "staged"),
}


@pytest.mark.parametrize("case", sorted(COMMIT_CASES))
def test_am_recovery_commit_ledger(tmp_path, case):
    policy, ledger, layout = COMMIT_CASES[case]

    def scenario(root, tmp):
        H = mod(root, "am.history")
        out_dir = str(tmp / "out")
        committed = os.path.join(out_dir, "_temporary", "committed")
        os.makedirs(committed)
        if layout != "plain":
            with open(os.path.join(out_dir, "part-00000"), "w") as fh:
                fh.write("published-by-crashed-attempt\n")
            with open(os.path.join(out_dir, "_temporary",
                                   "_publish_manifest"), "w") as fh:
                fh.write("part-00000\n")
        if layout == "staged":
            with open(os.path.join(committed, "part-00001"), "w") as fh:
                fh.write("still-staged\n")
        plan = sink_plan(root, "ledger", out_dir)
        conf = {"tez.staging-dir": str(tmp / "stg"),
                "tez.am.commit.recovery.policy": policy}
        am1 = new_am(root, "app_1_cled", conf, 1)
        am1.start()
        am1.history(H.HistoryEvent(
            H.HistoryEventType.DAG_SUBMITTED, dag_id="dag_1_cled_7",
            data={"dag_name": plan.name, "plan": plan.serialize().hex()}))
        for kind in ledger:
            am1.history(H.HistoryEvent(H.HistoryEventType[kind],
                                       dag_id="dag_1_cled_7"))
        am1.stop()
        am2 = new_am(root, "app_1_cled", conf, 2)
        am2.start()
        try:
            recovered = am2.recover_and_resume()
            kinds = [e.event_type.name for e in am2.logging_service.events
                     if e.dag_id == "dag_1_cled_7"]
            verdict = am2.completed_dags["dag_1_cled_7"].name
        finally:
            am2.stop()
        return {"recovered": str(recovered), "verdict": verdict,
                "journaled": kinds, "tree": tree(out_dir)}
    obs = both(tmp_path, scenario)
    assert obs["recovered"] == "dag_1_cled_7"
    want = {"in_flight_fails": "FAILED", "finished_rolls_forward":
            "SUCCEEDED", "aborted_fails": "FAILED",
            "in_flight_resumes": "SUCCEEDED"}[case]
    assert obs["verdict"] == want
    files = dict(obs["tree"])
    if case == "in_flight_fails":
        assert "DAG_COMMIT_ABORTED" in obs["journaled"]
    if case == "aborted_fails":
        assert files == {}
    if case == "in_flight_resumes":
        assert obs["journaled"][0] == "DAG_COMMIT_FINISHED"
        assert files == {"_SUCCESS": b"",
                         "part-00000": b"published-by-crashed-attempt\n",
                         "part-00001": b"still-staged\n"}


def test_am_recovery_idempotent_across_three_attempts(tmp_path):
    """Crash, recover, crash again, recover: attempt 3 still short-circuits
    the producers, because attempt 2 re-journaled them."""
    def scenario(root, tmp):
        gate, result = str(tmp / "gate"), str(tmp / "result")
        conf = {"tez.staging-dir": str(tmp / "stg"),
                "tez.am.max.app.attempts": 3,
                "tez.am.local.num-containers": 3}
        am1 = new_am(root, "app_1_r3", conf, 1)
        am1.start()
        am1.submit_dag(gated_plan(root, "recov3", gate, result))
        wait_vertex(am1, "producer", lambda v: v["state"] == "SUCCEEDED")
        am1.crash()
        am2 = new_am(root, "app_1_r3", conf, 2)
        am2.start()
        am2.recover_and_resume()
        wait_vertex(am2, "producer", lambda v: v["state"] == "SUCCEEDED")
        am2.crash()
        am3 = new_am(root, "app_1_r3", conf, 3)
        am3.start()
        try:
            recovered = am3.recover_and_resume()
            open(gate, "w").close()
            final = am3.wait_for_dag(recovered, timeout=60).name
            with open(result, "rb") as fh:
                out = fh.read()
            return {"final": final, "result": out,
                    "counters": dag_counters(am3),
                    "history": sequences(am3)}
        finally:
            am3.stop()
    obs = both(tmp_path, scenario)
    assert obs["final"] == "SUCCEEDED" and obs["result"] == b"100"
    assert obs["counters"]["TOTAL_LAUNCHED_TASKS"] == 1


def test_recovery_journal_pickle_gate():
    """Pickle-encoded journal payloads replay only under
    tez.dag.recovery.trusted-staging; typed kinds replay without it."""
    out = {}
    for root in ROOTS:
        rec = mod(root, "am.recovery")
        events = mod(root, "api.events")
        wire = rec.event_to_wire(_CarrierEvent())
        with pytest.raises(rec.UntrustedJournalPayload):
            rec.event_from_wire(wire)
        carried = rec.event_from_wire(wire, allow_pickle=True)
        dme = rec.event_from_wire(rec.event_to_wire(events.DataMovementEvent(
            source_index=1, user_payload=b"x", version=0)))
        with pytest.raises(rec.UntrustedJournalPayload):
            rec._payload_from_wire(rec._payload_to_wire(_CarrierEvent()))
        out[root] = (wire["t"], type(carried).__name__, dme.source_index,
                     dme.user_payload, dme.version)
    assert out[ROOTS[0]] == out[ROOTS[1]] == \
        ("pickle", "_CarrierEvent", 1, b"x", 0)


def test_am_recovery_restores_reconfigured_vertex(tmp_path):
    """A consumer shrunk by auto-parallelism (6 -> 1) before the crash
    keeps its parallelism after recovery (the journaled reconfiguration is
    re-applied), and the producers are restored, not re-run."""
    def scenario(root, tmp):
        gate, result = str(tmp / "gate"), str(tmp / "result")
        conf = {"tez.staging-dir": str(tmp / "stg"),
                "tez.am.local.num-containers": 3}
        am1 = new_am(root, "app_1_reconf", conf, 1)
        am1.start()
        am1.submit_dag(gated_plan(root, "recov_reconf", gate, result,
                                  consumers=6, auto_parallel=True))
        wait_vertex(am1, "consumer", lambda v: v.get("total_tasks") == 1)
        wait_vertex(am1, "producer", lambda v: v["state"] == "SUCCEEDED")
        am1.crash()
        am2 = new_am(root, "app_1_reconf", conf, 2)
        am2.start()
        try:
            recovered = am2.recover_and_resume()
            st = wait_vertex(am2, "consumer",
                             lambda v: v["state"] != "NEW")
            tasks = st["vertices"]["consumer"]["total_tasks"]
            open(gate, "w").close()
            final = am2.wait_for_dag(recovered, timeout=60).name
            with open(result, "rb") as fh:
                out = fh.read()
            return {"consumer_tasks": tasks, "final": final, "result": out,
                    "counters": dag_counters(am2),
                    "history": sequences(am2)}
        finally:
            am2.stop()
    obs = both(tmp_path, scenario)
    assert obs["consumer_tasks"] == 1 and obs["final"] == "SUCCEEDED"
    assert obs["result"] == b"100"
    assert obs["counters"]["TOTAL_LAUNCHED_TASKS"] == 1
    assert obs["counters"]["NUM_SUCCEEDED_TASKS"] == 3


def test_max_app_attempts_refuses_restart(tmp_path):
    msgs = {}
    for root in ROOTS:
        conf = {"tez.staging-dir": str(tmp_path / root),
                "tez.am.max.app.attempts": 2}
        new_am(root, "app_1_maxatt", conf, 2).stop()   # at the budget: ok
        with pytest.raises(RuntimeError, match="max.app.attempts") as e:
            new_am(root, "app_1_maxatt", conf, 3)
        msgs[root] = str(e.value)
    assert msgs[ROOTS[0]] == msgs[ROOTS[1]]


# -- tests/test_recovery_ha.py --------------------------------------------------
def session_conf(tmp, **extra):
    return dict({"tez.staging-dir": str(tmp / "stg"),
                 "tez.am.local.num-containers": 2,
                 "tez.am.max.app.attempts": 3,
                 "tez.am.session.max-concurrent-dags": 1,
                 "tez.am.session.queue-size": 4}, **extra)


def park(root, am, plan, errors, crashed):
    """Submit on a thread; the parked submitter must observe a typed
    AMCrashedError when the AM dies under it."""
    crashed_type = mod(root, "client.errors").AMCrashedError

    def run():
        try:
            am.submit_dag(plan)
            errors.append(f"{plan.name}: promoted instead of crashed")
        except crashed_type as e:
            crashed.append(e)
        except BaseException as e:  # noqa: BLE001 — typed verdicts only
            errors.append(f"{plan.name}: {type(e).__name__}: {e}")

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def wait_journaled(root, am, n, timeout=20.0):
    queued = mod(root, "am.history").HistoryEventType.DAG_QUEUED
    deadline = time.time() + timeout
    while len(am.logging_service.of_type(queued)) < n:
        if time.time() > deadline:
            pytest.fail(f"{n} DAG_QUEUED records never journaled")
        time.sleep(0.02)


def wait_name(am, name, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        dag_id = am.find_dag_id_by_name(name)
        if dag_id is not None:
            return dag_id
        time.sleep(0.05)
    pytest.fail(f"DAG {name} never promoted on the successor AM")


def test_crash_replays_parked_admission_queue(tmp_path):
    """Parked submissions die with AMCrashedError; the successor rebuilds
    the queue from unresolved DAG_QUEUED records (original sub_id, tenant
    and arrival order) under DAG_REQUEUED_ON_RECOVERY events."""
    def scenario(root, tmp):
        H = mod(root, "am.history").HistoryEventType
        conf = session_conf(tmp)
        am1 = new_am(root, "app_1_qrep", conf, 1)
        am1.start()
        am1.submit_dag(sleep_plan(root, "qa", sleep_ms=20_000)
                       .create_dag_plan())
        errors, crashed = [], []
        t_b = park(root, am1, sleep_plan(root, "qb").create_dag_plan(),
                   errors, crashed)
        wait_journaled(root, am1, 1)
        t_c = park(root, am1, sleep_plan(root, "qc").create_dag_plan(),
                   errors, crashed)
        wait_journaled(root, am1, 2)
        am1.crash()
        t_b.join(timeout=10)
        t_c.join(timeout=10)
        queued_ids = [e.dag_id for e in am1.logging_service.of_type(
            H.DAG_QUEUED)]
        am2 = new_am(root, "app_1_qrep", conf, 2)
        am2.start()
        try:
            recovered = am2.recover_and_resume()
            requeued = am2.logging_service.of_type(
                H.DAG_REQUEUED_ON_RECOVERY)
            am2.kill_dag(recovered)
            finals = [am2.wait_for_dag(recovered, timeout=30).name]
            for name in ("qb", "qc"):
                finals.append(am2.wait_for_dag(wait_name(am2, name),
                                               timeout=30).name)
            left = mod(root, "am.recovery").RecoveryParser(
                conf["tez.staging-dir"], "app_1_qrep").queued_submissions()
        finally:
            am2.stop()
        return {"errors": errors, "crashed": sorted(
                    (e.sub_id, e.dag_name) for e in crashed),
                "requeued": [(e.dag_id, e.data["dag_name"],
                              e.data["attempt"]) for e in requeued],
                "queued_ids": queued_ids, "recovered": str(recovered),
                "finals": finals, "left": left,
                "dag": sequences(am2, ("dag_id",))}
    obs = both(tmp_path, scenario)
    assert obs["errors"] == [] and len(obs["crashed"]) == 2
    assert [r[0] for r in obs["requeued"]] == obs["queued_ids"]
    assert [r[1:] for r in obs["requeued"]] == [("qb", 2), ("qc", 2)]
    assert obs["finals"] == ["KILLED", "SUCCEEDED", "SUCCEEDED"]
    assert obs["left"] == []


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_popped_but_unstarted_submission_replays(tmp_path):
    """The am.queue.delay window: the consumer pops a submission and dies
    before _start_dag; its DAG_QUEUED record alone replays it."""
    def scenario(root, tmp):
        faults = mod(root, "common.faults")
        H = mod(root, "am.history").HistoryEventType
        conf = session_conf(tmp)
        am1 = new_am(root, "app_1_qpop", conf, 1)
        am1.start()
        first = am1.submit_dag(sleep_plan(root, "pa", sleep_ms=20_000)
                               .create_dag_plan())
        errors, crashed = [], []
        t_b = park(root, am1, sleep_plan(root, "pb").create_dag_plan(),
                   errors, crashed)
        wait_journaled(root, am1, 1)
        faults.install("t", faults.parse_spec("am.queue.delay:fail:n=1"),
                       seed=1)
        try:
            am1.kill_dag(first)
            killed = am1.wait_for_dag(first, timeout=30).name
            deadline = time.time() + 10
            while am1.admission.consumer_alive():
                if time.time() > deadline:
                    pytest.fail("consumer survived the am.queue.delay fault")
                time.sleep(0.02)
            unresolved = len(am1.admission.unresolved())
            am1.crash()
        finally:
            faults.clear_all()
        t_b.join(timeout=10)
        am2 = new_am(root, "app_1_qpop", conf, 2)
        am2.start()
        try:
            am2.recover_and_resume()
            requeued = am2.logging_service.of_type(
                H.DAG_REQUEUED_ON_RECOVERY)
            final = am2.wait_for_dag(wait_name(am2, "pb"), timeout=30).name
        finally:
            am2.stop()
        return {"killed": killed, "unresolved": unresolved,
                "errors": errors, "crashed": [e.sub_id for e in crashed],
                "requeued": [(e.dag_id, e.data["dag_name"])
                             for e in requeued], "final": final}
    obs = both(tmp_path, scenario)
    assert obs["killed"] == "KILLED" and obs["unresolved"] == 1
    assert obs["errors"] == [] and len(obs["crashed"]) == 1
    assert obs["requeued"] == [(obs["crashed"][0], "pb")]
    assert obs["final"] == "SUCCEEDED"


def test_client_reattach_rebinds_live_handles(tmp_path):
    """TezClient.reattach(): the successor AM replays the journal, live
    DAGClient handles re-bind (finished ones too), attach_dag recovers the
    handle of a submission whose submitter saw AMCrashedError, and a name
    the journal never saw is typed lost."""
    def scenario(root, tmp):
        lost_type = mod(root, "client.errors").DAGLostError
        c = client(root, "ha", session_conf(tmp), session=True).start()
        try:
            done = c.submit_dag(sleep_plan(root, "done"))
            first = done.wait_for_completion(timeout=30).state.name
            # crash() joins the runner threads for up to 10 s while the
            # dispatcher still runs, so "live" may finish in attempt 1
            # (rolled forward) or be resubmitted: both end SUCCEEDED, and
            # which one it is depends on timing, so the DAG-level history
            # is not compared here
            live = c.submit_dag(sleep_plan(root, "live", sleep_ms=3000))
            errors, crashed = [], []
            am1 = c.framework_client.am
            t = park(root, am1, sleep_plan(root, "parked").create_dag_plan(),
                     errors, crashed)
            wait_journaled(root, am1, 1)
            am1.crash()
            t.join(timeout=10)
            c.reattach()
            am2 = c.framework_client.am
            rebound = live._am is am2 and am2.attempt == am1.attempt + 1
            live_final = live.wait_for_completion(timeout=60).state.name
            done_final = done.get_dag_status().state.name
            parked = c.attach_dag("parked", timeout=30)
            parked_final = parked.wait_for_completion(
                timeout=30).state.name
            with pytest.raises(lost_type):
                c.attach_dag("never-submitted", timeout=5)
            requeued = [e.data["dag_name"] for e in am2.logging_service.events
                        if e.event_type.name == "DAG_REQUEUED_ON_RECOVERY"]
        finally:
            c.stop()
        return {"first": first, "errors": errors, "crashed": len(crashed),
                "rebound": rebound, "live": live_final, "done": done_final,
                "parked": parked_final, "requeued": requeued}
    obs = both(tmp_path, scenario)
    assert obs["errors"] == [] and obs["crashed"] == 1 and obs["rebound"]
    assert (obs["first"], obs["live"], obs["done"], obs["parked"]) == \
        ("SUCCEEDED",) * 4
    assert obs["requeued"] == ["parked"]


def test_zombie_fence_counts_journals_and_flight_marks(tmp_path):
    """A heartbeat stamped with the dead incarnation's epoch is ordered to
    die, counted, journaled as ATTEMPT_FENCED and marked in the flight
    recorder."""
    def scenario(root, tmp):
        flight = mod(root, "obs.flight")
        H = mod(root, "am.history").HistoryEventType
        conf = {"tez.staging-dir": str(tmp / "stg"),
                "tez.am.max.app.attempts": 3}
        flight.install("t")
        am1 = new_am(root, "app_1_zfen", conf, 1)
        am2 = new_am(root, "app_1_zfen", conf, 2)
        try:
            am2.start()
            zombie = mod(root, "common.ids").DAGId("app_1_zfen", 1) \
                .vertex(0).task(0).attempt(0)
            resp = am2.task_comm.heartbeat(mod(
                root, "am.task_comm").HeartbeatRequest(zombie, [], epoch=1))
            fenced = am2.logging_service.of_type(H.ATTEMPT_FENCED)
            marks = [e for e in flight.snapshot().events
                     if e.name == "fence.stale_epoch"]
            return {"should_die": resp.should_die,
                    "fenced_count": am2.task_comm.fenced_count,
                    "fenced": [(e.data["msg_epoch"], e.data["am_epoch"])
                               for e in fenced], "marks": len(marks) > 0}
        finally:
            am2.stop()
            am1.stop()
            flight.clear_all()
    obs = both(tmp_path, scenario)
    assert obs == {"should_die": True, "fenced_count": 1,
                   "fenced": [(1, 2)], "marks": True}


def test_queued_plan_roundtrip_across_process_boundary(tmp_path):
    """The journaled DAG_QUEUED plan replays in a fresh interpreter that
    imports only the port (no JAX, no tez_tpu): its RecoveryParser reads
    the record and the plan re-serializes to the same bytes."""
    from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
    plan = sleep_plan(ROOTS[0], "xproc", tasks=3).create_dag_plan()
    staging = str(tmp_path / "stg")
    am1 = new_am(ROOTS[0], "app_1_xproc", {"tez.staging-dir": staging,
                                           "tez.am.max.app.attempts": 3}, 1)
    am1.start()
    am1.history(HistoryEvent(
        HistoryEventType.DAG_QUEUED, dag_id="app_1_xproc-sub1",
        data={"dag_name": plan.name, "tenant": "tA",
              "plan": plan.serialize().hex()}))
    am1.crash()
    script = (
        "import json, sys\n"
        "from tez_tpu_torch.am.recovery import RecoveryParser\n"
        "from tez_tpu_torch.dag.plan import DAGPlan\n"
        "staging, app_id = sys.argv[1], sys.argv[2]\n"
        "[rec] = RecoveryParser(staging, app_id).queued_submissions()\n"
        "plan = DAGPlan.deserialize(bytes.fromhex(rec['plan']))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'tez_tpu'))\n"
        "print(json.dumps({\n"
        "    'sub_id': rec['sub_id'], 'tenant': rec['tenant'],\n"
        "    'decode_error': rec['decode_error'], 'name': plan.name,\n"
        "    'vertices': [v.name for v in plan.vertices],\n"
        "    'num_tasks': [v.parallelism for v in plan.vertices],\n"
        "    'reserialized': plan.serialize().hex(), 'imported': bad}))\n")
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", script, staging, "app_1_xproc"],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"sub_id": "app_1_xproc-sub1", "tenant": "tA",
                   "decode_error": "", "name": "xproc", "vertices": ["v"],
                   "num_tasks": [3], "reserialized": plan.serialize().hex(),
                   "imported": []}


# -- one journal, both parsers ---------------------------------------------------
def plain(value):
    """A parser result as plain values: events as (type, ids, data),
    plans as their vertex names and parallelism."""
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return sorted(plain(v) for v in value)
    if hasattr(value, "event_type"):
        return (value.event_type.name, value.dag_id, value.vertex_id,
                value.task_id, value.attempt_id, value.container_id,
                plain(value.data))
    if hasattr(value, "vertices") and hasattr(value, "serialize"):
        return (value.name, [(v.name, v.parallelism)
                             for v in value.vertices])
    return value


class _PortPlans(__import__("pickle").Unpickler):
    """Unpickles a port DAGPlan as tez_tpu's: the same dataclasses under
    the other package's module names."""

    def find_class(self, module, name):
        if module.split(".")[0] == ROOTS[0]:
            module = ROOTS[1] + module[len(ROOTS[0]):]
        return super().find_class(module, name)


def test_both_parsers_read_one_journal_alike(tmp_path, monkeypatch):
    """A journal the port's AM wrote (OrderedWordCount, crashed after its
    tokenizers succeeded, replayed to its end, then a parked submission)
    read by both packages' RecoveryParser: every DAGRecoveryData field and
    the queued submissions equal as plain values.  A journaled plan is a
    pickle of its package's DAGPlan, so tez_tpu reads the port's through
    _PortPlans.  Every task-generated payload is host data: none needed
    pickle."""
    import dataclasses
    import io
    jplan = mod(ROOTS[1], "dag.plan")
    monkeypatch.setattr(
        jplan.DAGPlan, "deserialize",
        staticmethod(lambda data: _PortPlans(io.BytesIO(data)).load()))
    corpus = tmp_path / "in.txt"
    with open(corpus, "w") as fh:
        for i in range(400):
            fh.write(" ".join(f"w{(i * 7 + j) % 37}" for j in range(9))
                     + "\n")
    out = str(tmp_path / "out")
    staging = str(tmp_path / "stg")
    desc = chip_smoke.wordcount_description([str(corpus)], out)
    api = chip_smoke.dag_api(ROOTS[0], device="cpu")
    plan = chip_smoke.build_dag(api, desc).create_dag_plan()
    from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
    conf = {"tez.staging-dir": staging, "tez.am.local.num-containers": 2}
    am1 = new_am(ROOTS[0], "app_1_parse", conf, 1)
    am1.start()
    am1.submit_dag(plan)
    wait_vertex(am1, "tokenizer", lambda v: v["state"] == "SUCCEEDED")
    am1.crash()
    am2 = new_am(ROOTS[0], "app_1_parse", conf, 2)
    am2.start()
    try:
        dag_id = am2.recover_and_resume()
        assert am2.wait_for_dag(dag_id, timeout=60).name == "SUCCEEDED"
        # a parked submission no attempt promoted
        am2.history(HistoryEvent(
            HistoryEventType.DAG_QUEUED, dag_id="app_1_parse-sub9",
            data={"dag_name": "later", "tenant": "t",
                  "plan": plan.serialize().hex()}))
    finally:
        am2.stop()
    parsed = {}
    for root in ROOTS:
        parser = mod(root, "am.recovery").RecoveryParser(staging,
                                                         "app_1_parse")
        data = parser.parse_all()
        parsed[root] = {
            "files": [os.path.relpath(p, staging)
                      for p in parser.journal_files()],
            "dags": [plain({f.name: getattr(d, f.name)
                            for f in dataclasses.fields(d)}) for d in data],
            "queued": plain(parser.queued_submissions()),
            "last": plain(parser.parse().dag_id)}
    assert parsed[ROOTS[0]] == parsed[ROOTS[1]]
    (dag,) = parsed[ROOTS[0]]["dags"]
    assert dag["dag_state"] == "SUCCEEDED" and len(dag["task_data"]) >= 4
    kinds = {w["payload"]["__kind__"] for td in dag["task_data"].values()
             for _edge, w in td["generated_events"]}
    assert kinds and kinds <= {"shuffle", "bytes", "json"}
    assert [q["dag_name"] for q in parsed[ROOTS[0]]["queued"]] == ["later"]


def test_runner_pool_shutdown_never_joins_an_unstarted_runner(monkeypatch):
    """crash() and stop() shut the runner pool down while the scheduler
    may be starting a runner: the port's RunnerPool.shutdown takes its
    snapshot under the lock ensure_runners holds from a runner's insertion
    to its start, where tez_tpu's reads the table unlocked and joins a
    thread not yet started (RuntimeError; seen in attempt 2's crash in a
    loaded run of test_am_recovery_idempotent_across_three_attempts)."""
    import types
    real_thread = threading.Thread
    errors = {}
    for root in ROOTS:
        gate, inside = threading.Event(), threading.Event()

        class GatedThread(real_thread):
            def start(self):
                inside.set()
                gate.wait(10)
                super().start()

        comm = types.SimpleNamespace(get_task=lambda cid, timeout: None)
        ctx = types.SimpleNamespace(
            conf=mod(root, "common.config").TezConfiguration({}),
            app_id="app_1_pool", node_id="local-0", task_comm=comm,
            history=lambda ev: None, device="cpu")
        pool = mod(root, "am.launcher").RunnerPool(ctx, 1, idle_timeout=0.05)
        monkeypatch.setattr(threading, "Thread", GatedThread)
        starter = real_thread(target=pool.ensure_runners, args=(1,))
        starter.start()
        assert inside.wait(10)
        out = []

        def stop():
            try:
                pool.shutdown()
            except RuntimeError as e:
                out.append(str(e))
        stopper = real_thread(target=stop)
        stopper.start()
        time.sleep(0.2)
        monkeypatch.setattr(threading, "Thread", real_thread)
        gate.set()
        starter.join(10)
        stopper.join(20)
        errors[root] = out
    assert errors[ROOTS[0]] == []
    assert errors[ROOTS[1]] == ["cannot join thread before it is started"]


# -- a held zombie wakes to its kill ------------------------------------------
def _mark_processor(root):
    """A processor that leaves a file named after its attempt in
    payload["dir"] as soon as it runs."""
    name = f"MarkRun{'Port' if root == ROOTS[0] else 'Ref'}"
    cls = globals().get(name)
    if cls is None:
        base = mod(root, "library.processors").SimpleProcessor

        def run(self, inputs, outputs):
            d = (self.context.user_payload.load() or {})["dir"]
            with open(os.path.join(d, str(self.context.task_attempt_id)),
                      "w"):
                pass
        cls = type(name, (base,), {"run": run, "__module__": __name__})
        globals()[name] = cls
    return cls


def test_held_zombie_never_starts_its_processor(tmp_path):
    """A crashed AM's runner thread held by a task.run delay rule, fenced
    on its heartbeats by attempt 2's epoch while it sleeps: the port's
    wakes to its kill and never starts its processor; tez_tpu's runs it
    (ROADMAP Queue 3).  Held zombies of a test's crashed AM that woke
    later merged and registered in whatever test the worker ran next."""
    marks = {}
    for root in ROOTS:
        tmp = tmp_path / root
        (tmp / "marks").mkdir(parents=True)
        faults = mod(root, "common.faults")
        app = "app_1_zhold"
        am = new_am(root, app, {"tez.staging-dir": str(tmp),
                                "tez.am.local.num-containers": 1}, 1)
        am.start()
        faults.install("hold", faults.parse_spec(
            "task.run:delay:ms=1500,n=1"))
        try:
            d, p = mod(root, "dag.dag"), mod(root, "common.payload")
            v = d.Vertex.create("v", p.ProcessorDescriptor.create(
                _mark_processor(root), payload={"dir": str(tmp / "marks")}),
                1)
            am.submit_dag(d.DAG.create("held").add_vertex(v)
                          .create_dag_plan())
            chip_smoke.wait_for(lambda: any(
                e.event_type.name == "TASK_ATTEMPT_STARTED"
                for e in list(am.logging_service.events)),
                "the attempt's start", timeout=30)
            # the successor comes up while the attempt is held
            mod(root, "common.epoch").register(app, 2)
            am.crash()
        finally:
            faults.clear("hold")
        # crash() joined the runner thread, which woke from the hold
        marks[root] = sorted(os.listdir(tmp / "marks"))
    assert marks[ROOTS[0]] == []
    assert len(marks[ROOTS[1]]) == 1
