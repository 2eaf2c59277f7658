"""Port parity of the recovery-journal fsck (tez_tpu_torch/tools/
journal_fsck.py) against tez_tpu's, on the CPU.

Every case of tests/test_journal_fsck.py and the window-ledger cases of
tests/test_streaming.py runs on the port with the same checks, over
journals written by each package (its HistoryEvent and journal encoder, or
its AM), and each journal goes through both packages' fsck: the verdicts
(errors, warnings, every ledger and what recovery would infer from it, the
printed report and the exit code) are equal.  A journaled plan is a pickle
of its writer's DAGPlan, so each package reads the other's through a
module-renaming unpickler (renaming_plans).  fsck_matches_tez_tpu holds the
two against each other over a staging directory's journals; the host
rehearsals of chip_smoke's phases 17 and 19 run it over theirs.
"""
import contextlib
import dataclasses
import importlib
import io
import os
import pickle
import threading
import time

import pytest

from tez_tpu_torch.tools import journal_fsck

ROOTS = ("tez_tpu_torch", "tez_tpu")
PORT = ROOTS[0]


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


@contextlib.contextmanager
def renaming_plans():
    """Each package's DAGPlan.deserialize reads a plan pickled by either
    package, as its own classes."""
    saved = {}
    for root in ROOTS:
        other = ROOTS[1 - ROOTS.index(root)]

        class Renaming(pickle.Unpickler):
            def find_class(self, module, name, _root=root, _other=other):
                if module.split(".")[0] == _other:
                    module = _root + module[len(_other):]
                return super().find_class(module, name)

        plan = mod(root, "dag.plan").DAGPlan
        saved[root] = plan.__dict__["deserialize"]
        plan.deserialize = staticmethod(
            lambda data, _u=Renaming: _u(io.BytesIO(data)).load())
    try:
        yield
    finally:
        for root, fn in saved.items():
            mod(root, "dag.plan").DAGPlan.deserialize = fn


@pytest.fixture(autouse=True)
def _plans_read_across():
    with renaming_plans():
        yield


def verdict(root: str, files: list) -> dict:
    """root's fsck over files: the report as plain values, what recovery
    would infer for each ledger, the printed report and main's exit code."""
    fsck = mod(root, "tools.journal_fsck")
    report = fsck.fsck_files(files)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fsck.print_report(report)
        rc = fsck.main(list(files))
    out = dataclasses.asdict(report)
    out.update(ok=report.ok, rc=rc, text=buf.getvalue(),
               dag_terminal={k: v.inferred_terminal
                             for k, v in report.dags.items()},
               sub_inferred={k: v.inferred for k, v in report.subs.items()},
               stream_inferred={k: v.inferred
                                for k, v in report.streams.items()})
    return out


def fsck_both(files: list):
    """Both packages' fsck over files: equal verdicts; the port's report."""
    v = {root: verdict(root, files) for root in ROOTS}
    assert v[PORT] == v["tez_tpu"]
    return journal_fsck.fsck_files(files)


def fsck_matches_tez_tpu(staging: str) -> dict:
    """Both packages' fsck over each application's recovery journals under
    staging (the host rehearsals of phases 17 and 19 call this): equal
    verdicts, each clean.  Returns {recovery dir: the port's report}."""
    import chip_smoke
    out = {}
    with renaming_plans():
        for rec in chip_smoke.journal_dirs(staging):
            files = journal_fsck.discover_journals(rec)
            report = fsck_both(files)
            assert report.ok, (rec, report.errors)
            out[rec] = report
    assert out, staging
    return out


class Writer:
    """One package's journal writer: its HistoryEvent and encoder."""

    def __init__(self, root: str):
        self.root = root
        self.history = mod(root, "am.history")
        self.encode = mod(root, "am.recovery").encode_journal_line

    def ev(self, name: str, **kw):
        return self.history.HistoryEvent(
            self.history.HistoryEventType[name], **kw)

    def write(self, path, events, tail: str = "") -> str:
        os.makedirs(os.path.dirname(str(path)), exist_ok=True)
        with open(str(path), "w") as fh:
            for e in events:
                fh.write(self.encode(e) + "\n")
            if tail:
                fh.write(tail)
        return str(path)

    def ledger(self, dag_id, *names):
        return [self.ev("DAG_SUBMITTED", dag_id=dag_id)] + \
            [self.ev(n, dag_id=dag_id) for n in names]

    def finished(self, dag_id, state="SUCCEEDED"):
        return self.ev("DAG_FINISHED", dag_id=dag_id, data={"state": state})

    def plan_hex(self, name="qd") -> str:
        payload, dag = mod(self.root, "common.payload"), \
            mod(self.root, "dag.dag")
        v = dag.Vertex.create("v", payload.ProcessorDescriptor.create(
            f"{self.root}.library.processors:SleepProcessor",
            payload={"sleep_ms": 1}), 1)
        return dag.DAG.create(name).add_vertex(v).create_dag_plan()\
            .serialize().hex()

    def queued(self, sub_id, plan_hex, name="qd"):
        return self.ev("DAG_QUEUED", dag_id=sub_id, data={
            "dag_name": name, "tenant": "tA", "plan": plan_hex})

    def requeued(self, sub_id, plan_hex, name="qd"):
        return self.ev("DAG_REQUEUED_ON_RECOVERY", dag_id=sub_id, data={
            "dag_name": name, "tenant": "tA", "plan": plan_hex,
            "attempt": 2})

    def promoted(self, sub_id, dag_id="dag_1_q_1"):
        return self.ev("DAG_SUBMITTED", dag_id=dag_id,
                       data={"dag_name": "qd", "sub_id": sub_id})

    def stream(self, name, stream="s", w=None, **extra):
        data = {"stream": stream}
        if w is not None:
            data["window_id"] = w
        data.update(extra)
        return self.ev(name, data=data)


@pytest.fixture(params=ROOTS)
def w(request):
    return Writer(request.param)


# -- tests/test_journal_fsck.py on the port, each against tez_tpu ------------
def test_fsck_clean_commit_cycle(tmp_path, w):
    p = w.write(tmp_path / "journal.jsonl", w.ledger(
        "dag_1_a_1", "DAG_COMMIT_STARTED", "DAG_COMMIT_FINISHED")
        + [w.finished("dag_1_a_1")])
    report = fsck_both([p])
    assert report.ok and not report.torn_tail
    assert report.dags["dag_1_a_1"].inferred_terminal == "SUCCEEDED"
    assert journal_fsck.main([p]) == 0


def test_fsck_torn_tail_tolerated_midstream_not(tmp_path, w):
    evs = w.ledger("dag_1_b_1")
    p = w.write(tmp_path / "torn.jsonl", evs, tail="deadbeef {truncat")
    report = fsck_both([p])
    assert report.ok and report.torn_tail
    with open(p, "a") as fh:
        fh.write("\n" + w.encode(evs[0]) + "\n")
    report = fsck_both([p])
    assert not report.ok
    assert journal_fsck.main([p]) == 1


def test_fsck_ledger_pairing_violations(tmp_path, w):
    p1 = w.write(tmp_path / "j1.jsonl", w.ledger(
        "dag_1_c_1", "DAG_COMMIT_FINISHED"))
    assert not fsck_both([p1]).ok
    p2 = w.write(tmp_path / "j2.jsonl", w.ledger(
        "dag_1_c_2", "DAG_COMMIT_STARTED") + [w.finished("dag_1_c_2")])
    assert not fsck_both([p2]).ok
    p3 = w.write(tmp_path / "j3.jsonl", w.ledger(
        "dag_1_c_3", "DAG_COMMIT_STARTED"))
    report = fsck_both([p3])
    assert report.ok
    assert "IN-COMMIT" in report.dags["dag_1_c_3"].inferred_terminal
    p4 = w.write(tmp_path / "j4.jsonl", w.ledger(
        "dag_1_c_4", "DAG_COMMIT_STARTED", "DAG_COMMIT_ABORTED"))
    report = fsck_both([p4])
    assert report.dags["dag_1_c_4"].inferred_terminal.startswith("FAILED")


def test_fsck_ledger_threads_across_attempts(tmp_path, w):
    rec = tmp_path / "recovery"
    w.write(rec / "1" / "journal.jsonl", w.ledger(
        "dag_1_d_1", "DAG_COMMIT_STARTED"))
    w.write(rec / "2" / "journal.jsonl", [
        w.ev("DAG_COMMIT_FINISHED", dag_id="dag_1_d_1"),
        w.finished("dag_1_d_1")])
    files = journal_fsck.discover_journals(str(rec))
    assert files == mod("tez_tpu", "tools.journal_fsck").discover_journals(
        str(rec))
    assert [os.path.basename(os.path.dirname(f)) for f in files] == \
        ["1", "2"]
    report = fsck_both(files)
    assert report.ok
    assert report.dags["dag_1_d_1"].inferred_terminal == "SUCCEEDED"


def test_fsck_missing_target():
    for root in ROOTS:
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod(root, "tools.journal_fsck").main(
                [os.path.join("/nonexistent", "x")]) == 2


def _real_am_journal(root: str, staging: str) -> tuple:
    """One SleepProcessor DAG through root's DAGAppMaster (the port's on
    the CPU): (its recovery directory, its dag id)."""
    am_mod = mod(root, "am.app_master")
    conf = mod(root, "common.config").TezConfiguration(
        {"tez.staging-dir": staging})
    kw = {"device": "cpu"} if root == PORT else {}
    am = am_mod.DAGAppMaster("app_1_fsck", conf, attempt=1, **kw)
    am.start()
    payload, dag = mod(root, "common.payload"), mod(root, "dag.dag")
    v = dag.Vertex.create("v", payload.ProcessorDescriptor.create(
        f"{root}.library.processors:SleepProcessor",
        payload={"sleep_ms": 1}), 1)
    dag_id = am.submit_dag(dag.DAG.create("fsck").add_vertex(v)
                           .create_dag_plan())
    assert am.wait_for_dag(dag_id, timeout=30).name == "SUCCEEDED"
    am.stop()
    return os.path.join(staging, "app_1_fsck", "recovery"), str(dag_id)


@pytest.mark.parametrize("writer", ROOTS)
def test_fsck_real_am_journal(tmp_path, writer):
    """A journal an AM of each package wrote passes both fscks CLEAN with
    the right terminal state, through --staging / --app too."""
    staging = str(tmp_path / writer)
    rec, dag_id = _real_am_journal(writer, staging)
    files = journal_fsck.discover_journals(rec)
    assert files
    report = fsck_both(files)
    assert report.ok, report.errors
    assert report.dags[dag_id].inferred_terminal == "SUCCEEDED"
    for root in ROOTS:
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod(root, "tools.journal_fsck").main(
                ["--staging", staging, "--app", "app_1_fsck"]) == 0
    assert list(fsck_matches_tez_tpu(staging)) == [rec]


def test_fsck_admission_clean_pair_and_unresolved(tmp_path, w):
    hexp = w.plan_hex()
    p = w.write(tmp_path / "j.jsonl", [
        w.queued("app-sub1", hexp), w.promoted("app-sub1"),
        w.finished("dag_1_q_1")])
    report = fsck_both([p])
    assert report.ok, report.errors
    assert report.subs["app-sub1"].inferred == "PROMOTED"
    assert "app-sub1" not in report.dags
    p2 = w.write(tmp_path / "j2.jsonl", [w.queued("app-sub2", hexp)])
    report = fsck_both([p2])
    assert report.ok
    assert "UNRESOLVED" in report.subs["app-sub2"].inferred


def test_fsck_admission_requeue_threads_across_attempts(tmp_path, w):
    hexp = w.plan_hex()
    rec = tmp_path / "recovery"
    w.write(rec / "1" / "journal.jsonl", [w.queued("app-sub1", hexp)])
    w.write(rec / "2" / "journal.jsonl", [
        w.requeued("app-sub1", hexp), w.promoted("app-sub1")])
    report = fsck_both(journal_fsck.discover_journals(str(rec)))
    assert report.ok, report.errors
    led = report.subs["app-sub1"]
    assert led.queued == 1 and led.requeued == 1 and led.promoted


@pytest.mark.parametrize("case,events,message", [
    ("a", lambda w, h: [w.queued("s1", h), w.queued("s1", h)],
     "duplicate DAG_QUEUED"),
    ("b", lambda w, h: [w.requeued("s2", h)], "never DAG_QUEUED"),
    ("c", lambda w, h: [w.queued("s3", h), w.requeued("s3", h),
                        w.queued("s3", h)], "attempt order violated"),
    ("d", lambda w, h: [w.queued("s4", h), w.promoted("s4"),
                        w.requeued("s4", h)], "after its promotion"),
    ("e", lambda w, h: [w.promoted("ghost")], "never DAG_QUEUED"),
    ("f", lambda w, h: [w.queued("s5", h), w.promoted("s5"),
                        w.promoted("s5", dag_id="dag_1_q_2")],
     "duplicate promotion"),
    ("g", lambda w, h: [w.ev("DAG_QUEUED", dag_id=None,
                             data={"dag_name": "x"})], "without a sub_id"),
])
def test_fsck_admission_pairing_violations(tmp_path, w, case, events,
                                           message):
    p = w.write(tmp_path / f"{case}.jsonl", events(w, w.plan_hex()))
    report = fsck_both([p])
    assert any(message in e for e in report.errors), report.errors


def test_fsck_admission_undecodable_plan(tmp_path, w):
    p = w.write(tmp_path / "u.jsonl", [
        w.ev("DAG_QUEUED", dag_id="s6",
             data={"dag_name": "broken", "plan": "deadbeef"})])
    report = fsck_both([p])
    assert any("replay impossible" in e for e in report.errors)
    assert "LOST" in report.subs["s6"].inferred
    assert journal_fsck.main([p]) == 1
    p = w.write(tmp_path / "v.jsonl", [
        w.ev("DAG_QUEUED", dag_id="s7",
             data={"dag_name": "odd", "plan": "deadbeef"}),
        w.promoted("s7")])
    report = fsck_both([p])
    assert report.ok
    assert any("promoted anyway" in x for x in report.warnings)


def test_fsck_real_crashed_session_journal(tmp_path):
    """The port's AM: a crash with a parked submission, then attempt 2
    replays and promotes it; the journal pair passes both fscks CLEAN with
    the submission PROMOTED.  (tez_tpu's own AM cannot write this pair:
    its RunnerPool.shutdown joins an unstarted runner, ROADMAP Queue 3.)"""
    staging = str(tmp_path)
    config, app_master, payload, dag = (mod(PORT, n) for n in (
        "common.config", "am.app_master", "common.payload", "dag.dag"))
    history = mod(PORT, "am.history")
    conf = config.TezConfiguration({
        "tez.staging-dir": staging, "tez.am.max.app.attempts": 3,
        "tez.am.local.num-containers": 2,
        "tez.am.session.max-concurrent-dags": 1,
        "tez.am.session.queue-size": 4})

    def sleeper(ms):
        return dag.Vertex.create("v", payload.ProcessorDescriptor.create(
            f"{PORT}.library.processors:SleepProcessor",
            payload={"sleep_ms": ms}), 1)

    am1 = app_master.DAGAppMaster("app_1_fsckha", conf, attempt=1,
                                  device="cpu")
    am1.start()
    am1.submit_dag(dag.DAG.create("hold").add_vertex(sleeper(20_000))
                   .create_dag_plan())
    parked = dag.DAG.create("parked").add_vertex(sleeper(1))\
        .create_dag_plan()

    def try_submit():
        try:
            am1.submit_dag(parked)
        except Exception:  # noqa: BLE001 — AMCrashedError on the crash
            pass

    t = threading.Thread(target=try_submit, daemon=True)
    t.start()
    deadline = time.time() + 20
    while not am1.logging_service.of_type(
            history.HistoryEventType.DAG_QUEUED):
        assert time.time() < deadline, "submission never journaled"
        time.sleep(0.02)
    am1.crash()
    t.join(timeout=10)
    am2 = app_master.DAGAppMaster("app_1_fsckha", conf, attempt=2,
                                  device="cpu")
    am2.start()
    recovered = am2.recover_and_resume()
    am2.kill_dag(recovered)
    am2.wait_for_dag(recovered, timeout=30)
    deadline = time.time() + 30
    while am2.find_dag_id_by_name("parked") is None:
        assert time.time() < deadline, "parked DAG never promoted"
        time.sleep(0.05)
    dag_id = am2.find_dag_id_by_name("parked")
    assert am2.wait_for_dag(dag_id, timeout=30).name == "SUCCEEDED"
    am2.stop()
    files = journal_fsck.discover_journals(
        os.path.join(staging, "app_1_fsckha", "recovery"))
    assert len(files) == 2
    report = fsck_both(files)
    assert report.ok, report.errors
    [sub_id] = report.sub_order
    led = report.subs[sub_id]
    assert led.queued == 1 and led.requeued == 1 and led.promoted
    assert led.inferred == "PROMOTED"
    for root in ROOTS:
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod(root, "tools.journal_fsck").main(
                ["--staging", staging, "--app", "app_1_fsckha"]) == 0


# -- tests/test_streaming.py's window-ledger rules ---------------------------
@pytest.mark.parametrize("case,names,ok", [
    ("clean", [("STREAM_OPENED", None), ("WINDOW_COMMIT_STARTED", 1),
               ("WINDOW_COMMIT_FINISHED", 1), ("WINDOW_COMMIT_STARTED", 2),
               ("WINDOW_COMMIT_FINISHED", 2), ("STREAM_RETIRED", None)],
     True),
    ("duplicate", [("STREAM_OPENED", None), ("WINDOW_COMMIT_STARTED", 1),
                   ("WINDOW_COMMIT_FINISHED", 1),
                   ("WINDOW_COMMIT_FINISHED", 1)], False),
    ("order", [("STREAM_OPENED", None), ("WINDOW_COMMIT_STARTED", 2),
               ("WINDOW_COMMIT_FINISHED", 2), ("WINDOW_COMMIT_STARTED", 1),
               ("WINDOW_COMMIT_FINISHED", 1)], False),
    ("orphan", [("STREAM_OPENED", None), ("WINDOW_COMMIT_FINISHED", 1)],
     False),
    ("late", [("STREAM_OPENED", None), ("STREAM_RETIRED", None),
              ("WINDOW_COMMIT_STARTED", 1)], False),
    ("never_opened", [("WINDOW_COMMIT_STARTED", 1)], False),
    ("barge", [("STREAM_OPENED", None), ("WINDOW_COMMIT_STARTED", 1),
               ("WINDOW_COMMIT_STARTED", 2)], False),
    ("open", [("STREAM_OPENED", None), ("WINDOW_COMMIT_STARTED", 1)], True),
    ("aborted", [("STREAM_OPENED", None), ("WINDOW_COMMIT_STARTED", 1),
                 ("WINDOW_COMMIT_ABORTED", 1), ("WINDOW_COMMIT_STARTED", 2),
                 ("WINDOW_COMMIT_FINISHED", 2)], True),
])
def test_fsck_window_ledger_matches_tez_tpu(tmp_path, w, case, names, ok):
    p = w.write(tmp_path / f"{case}.jsonl",
                [w.stream(n, w=i) for n, i in names])
    report = fsck_both([p])
    assert report.ok is ok, report.errors
    if case == "clean":
        assert report.streams["s"].inferred.startswith("RETIRED")
    if case == "open":
        assert "IN-COMMIT" in report.streams["s"].inferred


def test_fsck_window_crash_rollforward_is_warning_not_error(tmp_path, w):
    rec = tmp_path / "recovery"
    w.write(rec / "1" / "journal.jsonl", [
        w.stream("STREAM_OPENED"), w.stream("WINDOW_COMMIT_STARTED", w=1),
        w.stream("WINDOW_COMMIT_FINISHED", w=1),
        w.stream("WINDOW_COMMIT_STARTED", w=2)])
    w.write(rec / "2" / "journal.jsonl", [
        w.stream("WINDOW_COMMIT_STARTED", w=2),
        w.stream("WINDOW_COMMIT_FINISHED", w=2),
        w.stream("STREAM_RETIRED")])
    report = fsck_both(journal_fsck.discover_journals(str(rec)))
    assert report.ok, report.errors
    assert any("re-opened" in x for x in report.warnings)
    assert report.streams["s"].committed == [1, 2]


def test_fsck_slo_and_telemetry_records(tmp_path, w):
    """SLO records need their tenant and kind labels; a telemetry
    snapshot's accounting is non-negative; the per-(tenant, kind, stream)
    tally and the snapshot count."""
    p = w.write(tmp_path / "slo.jsonl", [
        w.ev("TENANT_SLO_BREACH", data={"tenant": "tA", "kind": "p95_ms"}),
        w.ev("SLO_BURN_ALERT", data={"tenant": "tA", "kind": "p95_ms"}),
        w.ev("TENANT_SLO_BREACH", data={"tenant": "tA", "kind": "lag",
                                        "stream": "s1"}),
        w.ev("TELEMETRY_SNAPSHOT", data={"evicted": 0, "scrape_errors": 1})])
    report = fsck_both([p])
    assert report.ok, report.errors
    assert report.slo == {("tA", "p95_ms", ""): {"burn_alerts": 1,
                                                 "breaches": 1},
                          ("tA", "lag", "s1"): {"burn_alerts": 0,
                                                "breaches": 1}}
    assert report.telemetry_snapshots == 1
    p = w.write(tmp_path / "bad.jsonl", [
        w.ev("TENANT_SLO_BREACH", data={"kind": "p95_ms"}),
        w.ev("TELEMETRY_SNAPSHOT", data={"collector_errors": -1})])
    report = fsck_both([p])
    assert len(report.errors) == 2
