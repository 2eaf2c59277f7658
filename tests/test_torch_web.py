"""The port's AM web UI (tez_tpu_torch/am/web.py) against tez_tpu's, on the
CPU: the port's AM with device="cpu", tez_tpu's on JAX's CPU backend.

tests/test_tools.py::test_am_web_endpoint, tests/test_metrics_smoke.py and
the web legs of tests/test_tracing.py and tests/test_flight.py run on the
port with the same checks, each endpoint besides (/metrics, /metrics.json,
/trace, /doctor/live, /queue, /nodes, /slo, /history, /swimlane.svg), with
a secret in the conf that must come back redacted.  One DAG through each
package's AM with the UI on: the structural payloads (status, graph, tasks,
DAGs, analyzers, metric families, history) are equal but for ids and
times.  The handler's
pure surfaces are held against tez_tpu's on the same inputs.  A stopped
service that never started returns (tez_tpu's waits forever: ROADMAP
Queue 3).
"""
import importlib
import json
import re
import threading
import time
import types
import urllib.parse
import urllib.request

import pytest

import chip_smoke
from tez_tpu_torch.library.processors import SimpleProcessor

ROOTS = ("tez_tpu_torch", "tez_tpu")
PORT = ROOTS[0]
SECRET = "hunter2"


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _fresh_planes():
    def reset():
        for root in ROOTS:
            mod(root, "common.tracing").clear_all()
            mod(root, "common.metrics").registry().reset()
            mod(root, "obs.timeseries").registry().reset()
            mod(root, "common.epoch").reset()
    reset()
    yield
    reset()


def get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=60) as resp:
        assert resp.status == 200
        return resp.read()


def getj(url: str):
    return json.loads(get(url))


def web_client(root, tmp_path, name="web", **extra):
    kw = {"device": "cpu"} if root == PORT else {}
    return mod(root, "client.tez_client").TezClient.create(name, dict({
        "tez.staging-dir": str(tmp_path / root / name),
        "tez.fake.access.token": SECRET,
        "tez.am.web.enabled": True}, **extra), **kw).start()


def sleep_dag(root, name="webdag", tasks=2):
    payload, dag = mod(root, "common.payload"), mod(root, "dag.dag")
    return dag.DAG.create(name).add_vertex(dag.Vertex.create(
        "v", payload.ProcessorDescriptor.create(
            f"{root}.library.processors:SleepProcessor",
            payload={"sleep_ms": 1}), tasks))


def settled_history(url: str) -> list:
    """/history once it holds DAG_FINISHED: the AM logs it on its own thread,
    after the client may already have read the DAG's final state."""
    deadline = time.monotonic() + 30
    while True:
        history = getj(url + "history")
        if any(e["event_type"] == "DAG_FINISHED" for e in history) or \
                time.monotonic() > deadline:
            return history
        time.sleep(0.01)


def walk(url: str) -> dict:
    """Every endpoint of tests/test_tools.py::test_am_web_endpoint and the
    rest of the UI's, each parsed; the oracle's checks on each."""
    parse = mod(PORT, "obs.exposition").parse_exposition
    settled_history(url)
    out = {"status": getj(url + "status")}
    assert out["status"]["name"] == "webdag"
    assert out["status"]["state"] == "SUCCEEDED"
    assert out["status"]["vertices"]["v"]["succeeded"] == 2
    out["counters"] = getj(url + "counters")
    assert "TaskCounter" in out["counters"]
    assert b"<html" in get(url)
    out["graph"] = getj(url + "graph")
    assert [v["name"] for v in out["graph"]["vertices"]] == ["v"]
    assert out["graph"]["vertices"][0]["state"] == "SUCCEEDED"
    out["tasks"] = getj(url + "tasks?vertex=v")
    assert len(out["tasks"]) == 2
    assert all(t["attempts"][0]["state"] == "SUCCEEDED"
               for t in out["tasks"])
    out["dags"] = getj(url + "dags")
    assert any(d["state"] == "SUCCEEDED" for d in out["dags"])
    out["analyzers"] = getj(url + "analyzers")
    assert {"critical_path", "dag_overview"} <= \
        {r["analyzer"] for r in out["analyzers"]}
    aid = out["tasks"][0]["attempts"][0]["id"]
    out["attempt"] = getj(url + "attempt?id=" + urllib.parse.quote(aid))
    assert out["attempt"]["state"] == "SUCCEEDED"
    assert out["attempt"]["vertex"] == "v"
    assert "TaskCounter" in out["attempt"]["counters"]
    assert getj(url + "attempt?id=bogus")["error"]
    out["vertex_counters"] = getj(url + "counters?vertex=v")
    assert "TaskCounter" in out["vertex_counters"]
    assert getj(url + "counters?vertex=nosuch") == {}
    conf = getj(url + "conf")
    assert conf.get("tez.am.web.enabled") in (True, "True")
    assert conf["tez.fake.access.token"] == "<redacted>"
    assert SECRET not in json.dumps(conf)
    out["conf"] = conf
    fams = parse(get(url + "metrics").decode())
    assert "tez_running_tasks" in fams and "tez_am_epoch" in fams
    out["metrics"] = sorted(fams)
    body = getj(url + "metrics.json?window=30")
    assert body["window_s"] == 30.0
    out["trace"] = getj(url + "trace")
    assert out["trace"]["traceEvents"]
    out["live"] = getj(url + "doctor/live?window=30")
    assert "queue_depth" in out["live"]
    out["queue"] = getj(url + "queue")
    out["nodes"] = getj(url + "nodes")
    out["slo"] = getj(url + "slo")
    assert out["slo"]["enabled"] is False
    out["history"] = getj(url + "history")
    assert out["history"]
    svg = get(url + "swimlane.svg")
    assert svg.startswith(b"<svg") and svg.endswith(b"</svg>")
    out["swimlane"] = svg.decode()
    try:
        urllib.request.urlopen(url + "nosuch", timeout=60)
        raise AssertionError("an unknown path answered")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    return out


def untimed(x):
    """A payload with ids, times and numbers of the run masked: its
    structure, names and states."""
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items()}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    if isinstance(x, str):
        x = re.sub(r"\d{6,}", "N", x)
        return re.sub(r"[\d.]+(s|ms)?\b", "0", x) if re.fullmatch(
            r"[\d.]+(s|ms)?|.*\d+\.\d+.*", x) else x
    if isinstance(x, float):
        return 0.0
    return x


def test_am_web_endpoint_matches_tez_tpu(tmp_path):
    """The oracle's walk on the port's AM, each endpoint beside; one DAG
    through each package's AM: status, graph, task and attempt states,
    DAG list, counter groups, analyzer names and the conf's keys equal."""
    walks = {}
    for root in ROOTS:
        c = web_client(root, tmp_path)
        try:
            st = c.submit_dag(sleep_dag(root)).wait_for_completion(
                timeout=60)
            assert st.state.name == "SUCCEEDED", root
            am = c.framework_client.am
            walks[root] = walk(am.web_ui.url)
            assert type(am.web_ui).__module__ == f"{root}.am.web"
        finally:
            c.stop()
    p, j = walks[PORT], walks["tez_tpu"]
    for key in ("status", "graph"):
        assert untimed(p[key]) == untimed(j[key]), key
    # a DAG just finished may still be retiring from the live map
    assert {(d["name"], d["state"]) for d in p["dags"]} == \
        {(d["name"], d["state"]) for d in j["dags"]} == \
        {("webdag", "SUCCEEDED")}
    assert [[a["state"] for a in t["attempts"]] for t in p["tasks"]] == \
        [[a["state"] for a in t["attempts"]] for t in j["tasks"]]
    assert sorted(p["counters"]) == sorted(j["counters"])
    assert [r["analyzer"] for r in p["analyzers"]] == \
        [r["analyzer"] for r in j["analyzers"]]
    assert sorted(p["conf"]) == sorted(j["conf"])
    # the well-known latency families are exposed even when unobserved;
    # gauges come and go with the run's timing
    known = {f"tez_latency_{n.replace('.', '_')}_ms" for n in
             mod(PORT, "common.metrics").WELL_KNOWN_HISTOGRAMS}
    assert known <= set(p["metrics"]) and known <= set(j["metrics"])
    assert p["slo"] == j["slo"]
    assert sorted(p["live"]) == sorted(j["live"])
    # the two tasks' attempts run on two runner threads: the order of
    # their events across the tasks hangs on timing, their multiset not
    assert sorted(e["event_type"] for e in p["history"]) == \
        sorted(e["event_type"] for e in j["history"])


def test_metrics_smoke(tmp_path):
    """tests/test_metrics_smoke.py on the port: /metrics through the
    strict parser, /metrics.json with a sampler tick, the stream filter,
    /doctor/live through top's renderer and top's scrape, no scrape
    error."""
    import time
    top = mod(PORT, "tools.top")
    parse = mod(PORT, "obs.exposition").parse_exposition
    c = web_client(PORT, tmp_path, "metricsmoke", **{
        "tez.am.metrics.sample-period-ms": 25.0})
    try:
        st = c.submit_dag(sleep_dag(PORT, "smokedag")).wait_for_completion(
            timeout=180)
        assert st.state.name == "SUCCEEDED"
        url = c.framework_client.am.web_ui.url
        fams = parse(get(url + "metrics").decode())
        assert "tez_latency_am_heartbeat_rtt_ms" in fams
        assert any(i["type"] == "histogram" for i in fams.values())
        assert "tez_counter" in fams
        deadline = time.time() + 60
        body = getj(url + "metrics.json?window=30")
        while body["accounting"]["samples"] < 1 and time.time() < deadline:
            time.sleep(0.05)
            body = getj(url + "metrics.json?window=30")
        assert body["window_s"] == 30.0
        assert body["histograms"] and body["gauges"]
        assert "am.heartbeat.rtt" in {r["series"] for r in body["histograms"]}
        acct = body["accounting"]
        assert acct["samples"] >= 1
        assert acct["scrape_errors"] == 0 and acct["collector_errors"] == 0
        assert any("window" in r for r in body["histograms"])
        empty = getj(url + "metrics.json?stream=nosuch")
        assert empty["histograms"] == [] and empty["gauges"] == []
        live = getj(url + "doctor/live?window=30")
        assert live["sampler"]["enabled"] and live["sampler"]["ticks"] >= 1
        assert set(live["planes"]["busy_ms"]) >= {"admission", "store"}
        assert "queue_depth" in live
        frame = top.render(live)
        assert "graft top" in frame
        assert "rings:" in frame.splitlines()[-1]
        # the scraping path renders a live payload; the sampler may tick
        # between the two scrapes (tests/test_metrics_smoke.py compares
        # the tick counts too, and fails when it does)
        head = top.render(top.fetch(url, window_s=30)).splitlines()[0]
        ticks = re.fullmatch(r"== graft top ==  window 30s  sampler on "
                             r"\((\d+) ticks, period 0\.025s\)", head)
        assert ticks and int(ticks.group(1)) >= live["sampler"]["ticks"]
        assert frame == mod("tez_tpu", "tools.top").render(live)
    finally:
        c.stop()
    assert mod(PORT, "obs.timeseries").registry().accounting()[
        "scrape_errors"] == 0


def test_metrics_switch_off_answers_404(tmp_path):
    c = web_client(PORT, tmp_path, "nometrics",
                   **{"tez.metrics.enabled": False})
    try:
        url = c.framework_client.am.web_ui.url
        for path in ("metrics", "metrics.json"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(url + path, timeout=60)
            assert err.value.code == 404
        # an AM with no DAG yet
        assert getj(url + "status")["state"] == "IDLE"
        assert getj(url + "graph") == {"vertices": [], "edges": []}
        assert getj(url + "tasks?vertex=v") == []
    finally:
        c.stop()


class EmitProcessor(SimpleProcessor):
    def run(self, inputs, outputs):
        writer = outputs["consumer"].get_writer()
        for i in range(50):
            writer.write(f"key{i:03d}".encode(), 1)


class CountProcessor(SimpleProcessor):
    def run(self, inputs, outputs):
        sum(sum(vs) for _k, vs in inputs["producer"].get_reader())


def test_e2e_trace_and_metrics(tmp_path):
    """tests/test_tracing.py::test_e2e_trace_and_metrics on the port: a
    traced scatter-gather DAG; one trace id links the DAG, attempt and
    fetch spans; /metrics and /trace serve from the same run; the span
    critical-path analyzer names the dominant vertex."""
    from trace_schema import check_trace
    payload, dag_mod, prop = (mod(PORT, n) for n in (
        "common.payload", "dag.dag", "dag.edge_property"))
    tracing = mod(PORT, "common.tracing")
    kv = {"tez.runtime.key.class": "bytes",
          "tez.runtime.value.class": "long"}
    producer = dag_mod.Vertex.create("producer", payload.ProcessorDescriptor
                                     .create(EmitProcessor), 2)
    consumer = dag_mod.Vertex.create("consumer", payload.ProcessorDescriptor
                                     .create(CountProcessor), 1)
    dag = dag_mod.DAG.create("traced").add_vertex(producer)\
        .add_vertex(consumer)
    dag.add_edge(dag_mod.Edge.create(producer, consumer, prop.EdgeProperty
                                     .create(
        prop.DataMovementType.SCATTER_GATHER, prop.DataSourceType.PERSISTED,
        prop.SchedulingType.SEQUENTIAL,
        payload.OutputDescriptor.create(
            f"{PORT}.library.outputs:OrderedPartitionedKVOutput", payload=kv),
        payload.InputDescriptor.create(
            f"{PORT}.library.inputs:OrderedGroupedKVInput", payload=kv))))
    dag.set_conf("tez.trace.enabled", True)
    c = web_client(PORT, tmp_path, "traced")
    try:
        assert c.submit_dag(dag).wait_for_completion(timeout=60)\
            .state.name == "SUCCEEDED"
        am = c.framework_client.am
        prom = get(am.web_ui.url + "metrics").decode()
        trace_json = getj(am.web_ui.url + "trace")
        dag_impl = am.current_dag
    finally:
        c.stop()
    spans = tracing.snapshot()
    by_cat = {}
    for s in spans:
        by_cat.setdefault(s.cat, []).append(s)
    (dag_span,) = by_cat["dag"]
    assert dag_span.end is not None
    attempts = by_cat["task"]
    assert any(s.name.startswith("attempt:") for s in attempts)
    fetches = [s for s in by_cat.get("shuffle", [])
               if s.name == "shuffle.fetch"]
    assert fetches
    for s in attempts + fetches:
        assert s.trace_id == dag_span.trace_id, s.name
    check_trace(mod(PORT, "tools.trace_export").spans_to_trace(spans))
    assert trace_json["traceEvents"]
    check_trace(trace_json)
    assert "# TYPE tez_latency_shuffle_fetch_rtt_ms histogram" in prom
    assert "# TYPE tez_latency_spill_write_ms histogram" in prom
    assert "tez_running_tasks" in prom and "tez_am_epoch" in prom
    res = mod(PORT, "tools.analyzers").SpanCriticalPathAnalyzer()\
        .analyze(dag_impl)
    assert "dominant vertex:" in res.headline
    assert "producer" in res.headline or "consumer" in res.headline


def test_slo_surface_matches_tez_tpu():
    """tests/test_flight.py's _Handler._slo: the disabled shape, and a
    watchdog with a latched shed-rate breach, equal to tez_tpu's."""
    out = {}
    for root in ROOTS:
        handler = mod(root, "am.web")._Handler
        config, slo = mod(root, "common.config"), mod(root, "obs.slo")
        disabled = handler._slo(types.SimpleNamespace())
        assert disabled == {"enabled": False, "targets": {}, "active": [],
                            "total_breaches": 0, "log": []}
        wd = slo.SloWatchdog(config.TezConfiguration(
            {config.AM_SLO_SHED_RATE.name: 0.5,
             config.AM_SLO_MIN_COUNT.name: 1}))
        wd.evaluate({"acme": {"accepted": 1, "shed": 3}})
        status = handler._slo(types.SimpleNamespace(slo_watchdog=wd))
        assert status["enabled"] and status["total_breaches"] == 1
        assert ("acme", slo.KIND_SHED_RATE) in \
            {(b["tenant"], b["kind"]) for b in status["active"]}
        out[root] = untimed(status)
    assert out[PORT] == out["tez_tpu"]


def test_conf_redaction_and_attempt_rows_match_tez_tpu():
    """_conf redacts by key pattern and _attempt_dict serializes a row the
    same way in both packages."""
    conf = {"tez.job.token": "t0k", "my.secret.x": "s", "db.password": "p",
            "tez.runtime.ssl.key.path": "k", "tez.am.web.enabled": True,
            "plain": 3}
    attempt = types.SimpleNamespace(
        attempt_id="attempt_1_0001_1_00_000000_0",
        state=types.SimpleNamespace(name="SUCCEEDED"), node_id="",
        container_id="container_9", launch_time=100.0, finish_time=103.456)
    out = {}
    for root in ROOTS:
        handler = mod(root, "am.web")._Handler
        am = types.SimpleNamespace(current_dag=None, conf=conf)
        out[root] = (handler._conf(am), handler._attempt_dict(attempt),
                     handler._graph(am), handler._counters(am),
                     handler._attempt(am, "x"))
    assert out[PORT] == out["tez_tpu"]
    assert out[PORT][0] == {
        "tez.job.token": "<redacted>", "my.secret.x": "<redacted>",
        "db.password": "<redacted>", "tez.runtime.ssl.key.path":
        "<redacted>", "tez.am.web.enabled": True, "plain": 3}


def test_metrics_scrape_never_drops_a_retiring_dag():
    """tests/test_flight.py's scrape race on the port's _Handler._metrics:
    a DAG moving between the live and retired maps under the AM's lock is
    never missing from a scrape."""
    counters = mod(PORT, "common.counters").TezCounters()
    counters.find_counter("shuffle", "FLIGHT_SCRAPE_RACE_BYTES").increment(7)
    dag = types.SimpleNamespace(dag_id="dag_r", counters=counters,
                                vertices={})
    am = types.SimpleNamespace(_dag_done=threading.Condition(),
                               live_dags={"dag_r": dag}, retired_dags={},
                               current_dag=None, attempt=1, conf=None)
    stop = threading.Event()

    def mover():
        while not stop.is_set():
            with am._dag_done:
                am.retired_dags["dag_r"] = am.live_dags.pop("dag_r")
            with am._dag_done:
                am.live_dags["dag_r"] = am.retired_dags.pop("dag_r")

    t = threading.Thread(target=mover)
    t.start()
    handler = mod(PORT, "am.web")._Handler
    try:
        for _ in range(300):
            assert "FLIGHT_SCRAPE_RACE_BYTES" in handler._metrics(am)
    finally:
        stop.set()
        t.join(timeout=10)


def test_stop_of_an_unstarted_web_ui_returns():
    """WebUIService.stop on a service that never started: the port's
    returns and frees the port; tez_tpu's waits forever in shutdown()
    (tez_tpu/am/web.py, WebUIService.stop), shown on a daemon thread."""
    done = {}
    for root in ROOTS:
        service = mod(root, "am.web").WebUIService(types.SimpleNamespace())
        t = threading.Thread(target=service.stop, daemon=True)
        t.start()
        t.join(timeout=2)
        done[root] = not t.is_alive()
    assert done == {PORT: True, "tez_tpu": False}
    service = mod(PORT, "am.web").WebUIService(types.SimpleNamespace())
    service.start()
    service.stop()
    service.stop()   # twice: a crash() and then a stop()


def test_crashed_am_stops_its_web_ui(tmp_path):
    """crash() stops the UI as tez_tpu's does: nothing listens on its
    port."""
    import socket
    config = mod(PORT, "common.config")
    am = mod(PORT, "am.app_master").DAGAppMaster(
        "app_1_web", config.TezConfiguration({
            "tez.staging-dir": str(tmp_path),
            "tez.am.web.enabled": True}), attempt=1, device="cpu")
    am.start()
    port = am.web_ui.port
    assert getj(am.web_ui.url + "status")["state"] == "IDLE"
    am.crash()
    with socket.socket() as s:
        assert s.connect_ex(("127.0.0.1", port)) != 0


def test_phase21_web_scrape_on_the_host(tmp_path):
    """chip_smoke's leg A scrape on a held DAG: every endpoint of the UI
    and top --once answer inside the DAG's run."""
    import numpy as np
    rng = np.random.default_rng(7)
    recs = rng.integers(0, 256, (4096, 100), dtype=np.uint8)
    path = tmp_path / "tera.bin"
    path.write_bytes(recs.tobytes())
    hist = tmp_path / "hist"
    hist.mkdir()
    import collections
    run = chip_smoke.run_mr(
        "web", chip_smoke.terasort_dag(str(path), str(tmp_path / "out")),
        chip_smoke.mr_conf(str(tmp_path), "web"), "cpu",
        collections.Counter(), str(hist), web=True, hold_ms=3000)
    assert run.state == "SUCCEEDED"
    chip_smoke.check_terasort("web", str(tmp_path / "out"), recs, 4)
