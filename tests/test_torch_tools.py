"""Port parity of the offline operations tools (tez_tpu_torch/tools/
{swimlane, analyzers, history_cache, counter_diff, log_split, top}.py)
against tez_tpu's, on the CPU.

One history is written by each package's AM (OrderedWordCount through its
own TezClient with the JSONL history service; the port's on device="cpu"),
and each file goes through both packages' tools: the analyzers' results,
the swimlane SVG bytes, the analyzer CLI's text (over files and through the
history cache), counter_diff's report (each file against itself and the
port's file against tez_tpu's) are equal without tolerance.  Every case of
tests/test_tools.py's analyzer, swimlane, counter_diff and log_split tests
and of tests/test_history_cache.py runs on the port with the same checks;
log_split and top's renderer are held against tez_tpu's on seeded inputs.
"""
import contextlib
import dataclasses
import importlib
import io
import os
import re
import sys
import time

import numpy as np
import pytest

import chip_smoke
from tez_tpu_torch.library.processors import SimpleProcessor

ROOTS = ("tez_tpu_torch", "tez_tpu")
PORT = ROOTS[0]


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def jsonl_conf(root: str, staging, log_dir) -> dict:
    return {"tez.staging-dir": str(staging),
            "tez.am.local.num-containers": 2,
            "tez.history.logging.service.class":
                f"{root}.am.history:JsonlHistoryLoggingService",
            "tez.history.logging.log-dir": str(log_dir)}


@pytest.fixture(scope="module")
def histories(tmp_path_factory):
    """{writer root: (its history directory, its files)}: one
    OrderedWordCount (2 tokenizers) a package, as tests/test_tools.py's
    fixture runs it."""
    base = tmp_path_factory.mktemp("tool_histories")
    corpus = base / "in.txt"
    corpus.write_text("alpha beta gamma alpha\n" * 200)
    out = {}
    for root in ROOTS:
        api = chip_smoke.dag_api(
            root, device="cpu" if root == PORT else None)
        log_dir = base / f"history_{root}"
        desc = chip_smoke.wordcount_description(
            [str(corpus)], str(base / f"out_{root}"),
            tokenizer_parallelism=2)
        client = api.TezClient.create(
            "owc", jsonl_conf(root, base / f"staging_{root}", log_dir),
            **api.client_kw)
        client.start()
        try:
            status = client.submit_dag(chip_smoke.build_dag(api, desc))\
                .wait_for_completion(timeout=300)
        finally:
            client.stop()
        assert status.state.name == "SUCCEEDED", root
        files = sorted(str(p) for p in log_dir.rglob("*.jsonl"))
        assert files, root
        out[root] = (str(log_dir), files)
    return out


def parsed(writer_files: list) -> dict:
    """{root: the DAG each package's parser reads from the files}; the
    plan's edges decode only in the writer's own package (its pickle
    names the writer's classes), so the other takes the writer's."""
    dags = {root: list(mod(root, "tools.history_parser").parse_jsonl_files(
        writer_files).values()) for root in ROOTS}
    assert len(dags[PORT]) == len(dags["tez_tpu"]) == 1
    a, b = dags[PORT][0], dags["tez_tpu"][0]
    if not b.edges:
        b.edges = a.edges
    if not a.edges:
        a.edges = b.edges
    assert a.edges
    return {PORT: a, "tez_tpu": b}


def cli(module, argv) -> tuple:
    old, buf = sys.argv, io.StringIO()
    sys.argv = argv
    try:
        with contextlib.redirect_stdout(buf):
            rc = module.main()
    finally:
        sys.argv = old
    return rc, buf.getvalue()


@pytest.mark.parametrize("writer", ROOTS)
def test_analyzers_match_tez_tpu(histories, writer):
    """tests/test_tools.py::test_analyzers_produce_results on the port,
    over each package's history; every analyzer's result equal to
    tez_tpu's over the same file."""
    dags = parsed(histories[writer][1])
    results = {root: [r.to_dict() for r in mod(root, "tools.analyzers")
                      .analyze_dag(dags[root])] for root in ROOTS}
    assert results[PORT] == results["tez_tpu"]
    port = mod(PORT, "tools.analyzers")
    res = port.analyze_dag(dags[PORT])
    assert len(res) == len(port.ALL_ANALYZERS)
    by_name = {r.analyzer: r for r in res}
    assert "tokenizer" in str(by_name["critical_path"].rows)
    assert any(r["shuffle_bytes"] > 0 for r in by_name["shuffle_time"].rows)
    assert by_name["hung_tasks"].rows == []
    assert sum(r.get("tasks_run", 0)
               for r in by_name["container_reuse"].rows) >= 5
    overview = by_name["dag_overview"]
    assert {r["vertex"] for r in overview.rows} == \
        {"tokenizer", "summation", "sorter"}
    assert all(r["task_states"].get("SUCCEEDED") for r in overview.rows)
    assert by_name["input_read_errors"].rows == []
    loc = by_name["locality"].rows
    assert loc and all(r["local_fraction"] == 1.0 for r in loc)
    assert [r["vertex"] for r in by_name["vertex_critical_path"].rows] == \
        ["tokenizer", "summation", "sorter"]
    assert by_name["task_assignment"].rows
    assert by_name["attempt_result_stats"].rows
    assert by_name["slow_nodes"].rows
    assert by_name["one_on_one_edges"].rows == []


@pytest.mark.parametrize("writer", ROOTS)
def test_swimlane_svg_matches_tez_tpu(histories, writer, tmp_path):
    """tests/test_tools.py::test_swimlane_svg on the port: the same SVG
    bytes as tez_tpu's, from render_svg and from the CLI."""
    dags = parsed(histories[writer][1])
    svgs = {root: mod(root, "tools.swimlane").render_svg(dags[root])
            for root in ROOTS}
    assert svgs[PORT] == svgs["tez_tpu"]
    svg = svgs[PORT]
    assert svg.startswith("<svg") and svg.endswith("</svg>")
    assert "tokenizer" in svg and "attempt_" in svg
    for root in ROOTS:
        rc, _out = cli(mod(root, "tools.swimlane"), [
            "swimlane", *histories[writer][1], "-o",
            str(tmp_path / f"{root}.svg")])
        assert rc in (0, None)
    assert (tmp_path / f"{PORT}.svg").read_bytes() == \
        (tmp_path / "tez_tpu.svg").read_bytes()


@pytest.mark.parametrize("writer", ROOTS)
def test_analyzer_cli_matches_tez_tpu(histories, writer):
    """tests/test_tools.py::test_analyzer_cli on the port, over the files
    and through the history cache (--cache-dir): tez_tpu's text."""
    log_dir, files = histories[writer]
    outs = {}
    for root in ROOTS:
        analyzers = mod(root, "tools.analyzers")
        rc, text = cli(analyzers, ["analyzers", log_dir])
        assert rc == 0
        rc, cached = cli(analyzers, ["analyzers", "--cache-dir", log_dir])
        assert rc == 0
        outs[root] = (text, cached)
    assert "critical_path" in outs[PORT][0]
    assert "OrderedWordCount" in outs[PORT][0]
    assert outs[PORT][0] == outs[PORT][1]
    # the plan's edges decode only in the writer's package, and the vertex
    # critical path walks them: the other reader's section is the sink
    # vertex alone
    assert "critical path tokenizer -> summation -> sorter" in \
        outs[writer][0]
    assert [without_edges(t) for t in outs[PORT]] == \
        [without_edges(t) for t in outs["tez_tpu"]]


def without_edges(text: str) -> str:
    """The analyzer CLI's text less its vertex_critical_path section."""
    out, skip = [], False
    for line in text.splitlines():
        if line.startswith("["):
            skip = line.startswith("[vertex_critical_path]")
        if not skip:
            out.append(line)
    return "\n".join(out)


def test_analyzer_cli_usage_and_no_dags(tmp_path):
    for root in ROOTS:
        analyzers = mod(root, "tools.analyzers")
        assert cli(analyzers, ["analyzers"])[0] == 2
        assert cli(analyzers, ["analyzers", "--cache-dir"])[0] == 2
        assert cli(analyzers, ["analyzers", str(tmp_path)])[0] == 1


class OneToOneEmitter(SimpleProcessor):
    def run(self, inputs, outputs):
        outputs["b"].get_writer().write(b"k", b"v")


class OneToOneReader(SimpleProcessor):
    def run(self, inputs, outputs):
        list(inputs["a"].get_reader())


def test_one_on_one_edge_analyzer(tmp_path):
    """tests/test_tools.py::test_one_on_one_edge_analyzer on the port: a
    ONE_TO_ONE DAG through the port's AM, its history through both
    packages' OneOnOneEdgeAnalyzer."""
    api = chip_smoke.dag_api(PORT, device="cpu")
    payload, dag_mod, prop = (mod(PORT, n) for n in (
        "common.payload", "dag.dag", "dag.edge_property"))
    hist = tmp_path / "hist"
    c = api.TezClient.create("oo", jsonl_conf(PORT, tmp_path / "s", hist),
                             **api.client_kw).start()
    try:
        kv = {"tez.runtime.key.class": "bytes",
              "tez.runtime.value.class": "bytes"}
        a = dag_mod.Vertex.create("a", payload.ProcessorDescriptor.create(
            OneToOneEmitter), 2)
        b = dag_mod.Vertex.create("b", payload.ProcessorDescriptor.create(
            OneToOneReader), 2)
        edge = prop.EdgeProperty.create(
            prop.DataMovementType.ONE_TO_ONE, prop.DataSourceType.PERSISTED,
            prop.SchedulingType.SEQUENTIAL,
            payload.OutputDescriptor.create(
                f"{PORT}.library.unordered:UnorderedKVOutput", payload=kv),
            payload.InputDescriptor.create(
                f"{PORT}.library.unordered:UnorderedKVInput", payload=kv))
        dag = dag_mod.DAG.create("oodag").add_vertex(a).add_vertex(b)
        dag.add_edge(dag_mod.Edge.create(a, b, edge))
        assert c.submit_dag(dag).wait_for_completion(timeout=60)\
            .state.name == "SUCCEEDED"
    finally:
        c.stop()
    dags = parsed(sorted(str(p) for p in hist.rglob("*.jsonl")))
    assert dags[PORT].edges[0]["movement"] == "ONE_TO_ONE"
    rows = {root: mod(root, "tools.analyzers").OneOnOneEdgeAnalyzer()
            .analyze(dags[root]).rows for root in ROOTS}
    assert rows[PORT] == rows["tez_tpu"] == \
        [{"edge": "a->b", "pairs": 2, "colocated": 2}]


@pytest.mark.parametrize("pair", ["self_port", "self_tez_tpu", "across"])
def test_counter_diff_cli_matches_tez_tpu(histories, pair):
    """tests/test_tools.py::test_counter_diff_cli on the port (a file
    against itself), and the port's file against tez_tpu's: the same
    report from both packages."""
    p = histories[PORT][1][0]
    j = histories["tez_tpu"][1][0]
    a, b = {"self_port": (p, p), "self_tez_tpu": (j, j),
            "across": (p, j)}[pair]
    outs = {}
    for root in ROOTS:
        rc, out = cli(mod(root, "tools.counter_diff"),
                      ["counter_diff", a, b])
        assert rc == 0
        outs[root] = out
    assert "wall delta" in outs[PORT]
    assert outs[PORT] == outs["tez_tpu"]
    assert cli(mod(PORT, "tools.counter_diff"), ["counter_diff", a])[0] == 2


def test_counter_diff_sections_match_tez_tpu():
    """Each counter-group section of counter_diff (latency histograms,
    device and merge stages, failover, store, push, exchange) over seeded
    counters: tez_tpu's rows, regressions flagged alike."""
    rng = np.random.default_rng(5)
    port, jax = (mod(r, "tools.counter_diff") for r in ROOTS)
    buckets = mod(PORT, "common.metrics")._BUCKET_COUNTER_NAMES

    def counters() -> dict:
        out = {}
        for name in (port.DEVICE_STAGE_HISTS + port.MERGE_STAGE_HISTS
                     + port.PUSH_HISTS + port.EXCHANGE_HISTS
                     + port.STREAM_HISTS + port.OBS_HISTS):
            counts = rng.integers(0, 6, len(buckets)) * \
                (rng.random(len(buckets)) < 0.4)
            out[port.HIST_GROUP_PREFIX + name] = dict(
                {b: int(c) for b, c in zip(buckets, counts) if c},
                COUNT=int(counts.sum()),
                SUM_US=int(rng.integers(0, 10 ** 7)))
        for group, names in (
                (port.DEVICE_FAILOVER_GROUP, port.DEVICE_FAILOVER_COUNTERS),
                (port.STORE_GROUP, port.STORE_EFFICIENCY_COUNTERS
                 + port.STORE_PRESSURE_COUNTERS),
                (port.PUSH_GROUP, port.PUSH_EFFICIENCY_COUNTERS
                 + port.PUSH_PRESSURE_COUNTERS),
                (port.EXCHANGE_GROUP, port.EXCHANGE_EFFICIENCY_COUNTERS
                 + port.EXCHANGE_PRESSURE_COUNTERS)):
            out.setdefault(group, {}).update(
                {n: int(rng.integers(0, 4)) for n in names})
        return out

    for _ in range(4):
        a, b = counters(), counters()
        for name in ("diff_histograms", "diff_device_stages",
                     "diff_device_failover", "diff_store", "diff_push",
                     "diff_exchange"):
            assert getattr(port, name)(a, b) == getattr(jax, name)(a, b), \
                name
        for names in (port.MERGE_STAGE_HISTS, port.PUSH_HISTS,
                      port.OBS_HISTS):
            assert port.diff_device_stages(a, b, names=names) == \
                jax.diff_device_stages(a, b, names=names)
        assert port.flatten(a) == jax.flatten(a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_split_matches_tez_tpu(tmp_path, seed):
    """tests/test_tools.py::test_log_split's log on the port (seed 0), and
    seeded interleavings of 5 attempts' records, continuation lines and
    untagged lines (seeds 1-2, 300 records, past 64 open handles at seed
    2): the same counts and files as tez_tpu's."""
    a1 = "attempt_1785290000_0001_1_00_000000_0"
    a2 = "attempt_1785290000_0001_1_00_000001_0"
    if seed == 0:
        lines = [
            "2026-07-29 01:00:00 INFO am: dag submitted\n",
            f"2026-07-29 01:00:01 INFO [{a1}] task: starting\n",
            f"2026-07-29 01:00:01 ERROR [{a2}] task: boom\n",
            "Traceback (most recent call last):\n",
            "  File \"x.py\", line 1\n",
            f"2026-07-29 01:00:02 INFO [{a1}] task: done\n",
            "2026-07-29 01:00:03 INFO am: dag finished\n",
        ]
    else:
        rng = np.random.default_rng(seed)
        n_att = 5 if seed == 1 else 80
        atts = [f"attempt_1785290000_0001_1_{v:02d}_{t:06d}_{a}"
                for v in range(2) for t in range(n_att) for a in range(1)]
        lines = []
        for i in range(300):
            kind = rng.integers(0, 4)
            if kind == 0:
                lines.append(f"2026-07-29 01:{i // 60:02d}:{i % 60:02d} INFO "
                             f"am: event {i}\n")
            elif kind == 3:
                lines.append(f"    continuation {i}\n")
            else:
                att = atts[int(rng.integers(0, len(atts)))]
                lines.append(f"2026-07-29 01:00:00 WARNING [{att}] task: "
                             f"record {i}\n")
    outs = {}
    for root in ROOTS:
        out = tmp_path / root
        counts = mod(root, "tools.log_split").split_log(lines, str(out))
        outs[root] = (counts, {f: (out / f).read_text()
                               for f in sorted(os.listdir(out))})
    assert outs[PORT] == outs["tez_tpu"]
    if seed == 0:
        assert outs[PORT][0] == {"main.log": 2, f"{a1}.log": 2,
                                 f"{a2}.log": 3}
        body = outs[PORT][1][f"{a2}.log"]
        assert "Traceback" in body and "File" in body
    assert sum(outs[PORT][0].values()) == len(lines)


TOP_PAYLOADS = {
    "idle": {},
    "busy": {"window_s": 30.0, "sampler": {"enabled": True, "ticks": 12,
                                           "period_s": 0.025},
             "planes": {"busy_ms": {"compute": 812.5, "device": 40.25,
                                    "store": 0.0, "transport": 7.0},
                        "dominant": "compute"},
             "queue_depth": 2, "running_dags": 1,
             "tenants": {"tA": {"running": 2, "queued": 1, "shed": 0,
                                "nested": {"x": 1}},
                         "tB": "paused"},
             "streams": {"s1": {"state": "RUNNING", "committed": 4,
                                "replayed": 1, "lag": 0,
                                "window_latency": {"count": 3,
                                                   "p95_ms": 41.7,
                                                   "rate_per_s": 0.5}}},
             "lanes": {"0": 0.5, "1": 1.0, "10": 0.125},
             "accounting": {"series": 14, "evicted": 3,
                            "scrape_errors": 0}},
    "breached": {"window_s": 5, "sampler": {"enabled": False},
                 "slo": {"breaches": [{"tenant": "tA", "kind": "p95_ms",
                                       "observed": 80, "target": 10}],
                         "burn": [{"stream": "s1", "kind": "lag",
                                   "observed": 5, "target": 2}]},
                 "accounting": {"series": 2, "collector_errors": 1}},
}


@pytest.mark.parametrize("payload", sorted(TOP_PAYLOADS))
def test_top_render_matches_tez_tpu(payload):
    """top's frame from canned /doctor/live payloads: tez_tpu's text."""
    frames = {root: mod(root, "tools.top").render(TOP_PAYLOADS[payload])
              for root in ROOTS}
    assert frames[PORT] == frames["tez_tpu"]
    assert "graft top" in frames[PORT]
    assert "rings:" in frames[PORT].splitlines()[-1]


def test_top_reports_an_unreachable_am():
    for root in ROOTS:
        assert mod(root, "tools.top").main(
            ["http://127.0.0.1:9/", "--once"]) == 1


# -- tests/test_history_cache.py on the port ---------------------------------
@pytest.fixture()
def shapes_history(tmp_path):
    """A simple_dag shape through the port's AM with the JSONL service."""
    log_dir = tmp_path / "hist"
    client = mod(PORT, "client.tez_client").TezClient.create(
        "hc", jsonl_conf(PORT, tmp_path / "s", log_dir), device="cpu")
    with client as c:
        st = c.submit_dag(mod(PORT, "models.shapes").simple_dag(payload={}))\
            .wait_for_completion(timeout=60)
        assert st.state.name == "SUCCEEDED"
    return str(log_dir)


def test_cache_parses_and_caches(shapes_history):
    cache = mod(PORT, "tools.history_cache").DagInfoCache(shapes_history)
    ids = cache.dag_ids()
    assert len(ids) == 1
    dag = cache.get(ids[0])
    assert dag is not None and dag.state == "SUCCEEDED"
    assert dag.vertex("v1") is not None
    files_before = dict(cache._fingerprints)
    assert cache.get(ids[0]) is dag
    assert cache.hits >= 1
    assert cache._fingerprints == files_before


def test_cache_invalidates_on_append(shapes_history):
    cache = mod(PORT, "tools.history_cache").DagInfoCache(shapes_history)
    ids = cache.dag_ids()
    first = cache.get(ids[0])
    src = mod(PORT, "am.history").scan_history_store(shapes_history)[0]
    with open(os.path.join(shapes_history, src)) as fh:
        body = re.sub(r"dag_(\d)", r"dagX_\1", fh.read())
    with open(os.path.join(shapes_history, "extra.jsonl"), "w") as fh:
        fh.write(body)
    assert len(cache.dag_ids()) == 2
    assert cache.get(ids[0]) is first


def _write_dags(log_dir, n):
    history = mod(PORT, "am.history")
    for i in range(n):
        with open(os.path.join(log_dir, f"h{i}.jsonl"), "w") as fh:
            for kind, data in ((history.HistoryEventType.DAG_SUBMITTED,
                                {"dag_name": f"d{i}"}),
                               (history.HistoryEventType.DAG_FINISHED,
                                {"state": "SUCCEEDED"})):
                fh.write(history.HistoryEvent(
                    kind, dag_id=f"dag_{i}", timestamp=time.time(),
                    data=data).to_json() + "\n")


def test_cache_lru_eviction(tmp_path):
    _write_dags(str(tmp_path), 3)
    cache = mod(PORT, "tools.history_cache").DagInfoCache(str(tmp_path),
                                                          max_dags=2)
    assert len(cache.dag_ids()) == 2


def test_cache_evicted_dag_still_readable(tmp_path):
    _write_dags(str(tmp_path), 3)
    cache = mod(PORT, "tools.history_cache").DagInfoCache(str(tmp_path),
                                                          max_dags=2)
    evicted = ({"dag_0", "dag_1", "dag_2"} - set(cache.dag_ids())).pop()
    info = cache.get(evicted)
    assert info is not None and info.state == "SUCCEEDED"


def test_store_layout_is_date_partitioned(shapes_history):
    entries = sorted(os.listdir(shapes_history))
    assert entries and all(re.fullmatch(r"date=\d{4}-\d{2}-\d{2}", e)
                           for e in entries), entries
    files = os.listdir(os.path.join(shapes_history, entries[0]))
    assert files and all(re.fullmatch(r"app_.+_\d+\.jsonl", f)
                         for f in files), files


def _fake_day(tmp_path, day, app, events):
    history = mod(PORT, "am.history")
    d = tmp_path / f"date={day}"
    d.mkdir(parents=True, exist_ok=True)
    with open(d / f"app_{app}_1.jsonl", "a") as fh:
        for dag_id, etype, data in events:
            fh.write(history.HistoryEvent(
                history.HistoryEventType[etype], dag_id=dag_id,
                data=data).to_json() + "\n")


def test_manifest_scan_multi_day_and_date_bounds(tmp_path):
    """scan_history_store walks the date partitions and the flat legacy
    files, honours inclusive date bounds, and lists what tez_tpu's does."""
    _fake_day(tmp_path, "2026-07-27", "a1",
              [("dag_1", "DAG_SUBMITTED", {"dag_name": "d1"})])
    _fake_day(tmp_path, "2026-07-28", "a2",
              [("dag_2", "DAG_SUBMITTED", {"dag_name": "d2"})])
    _fake_day(tmp_path, "2026-07-29", "a3",
              [("dag_3", "DAG_SUBMITTED", {"dag_name": "d3"})])
    (tmp_path / "legacy.jsonl").write_text("")
    scans = {}
    for root in ROOTS:
        scan = mod(root, "am.history").scan_history_store
        scans[root] = [scan(str(tmp_path)),
                       scan(str(tmp_path), date_from="2026-07-28"),
                       scan(str(tmp_path), date_from="2026-07-28",
                            date_to="2026-07-28")]
    assert scans[PORT] == scans["tez_tpu"]
    everything, later, one = scans[PORT]
    assert len(everything) == 4 and everything[-1].endswith("legacy.jsonl")
    assert len(later) == 2 and all("date=" in p for p in later)
    assert len(one) == 1 and "date=2026-07-28" in one[0]


def test_cache_and_parser_over_multi_day_store(tmp_path):
    _fake_day(tmp_path, "2026-07-28", "am1", [
        ("dag_x", "DAG_SUBMITTED", {"dag_name": "overnight"}),
        ("dag_x", "DAG_STARTED", {})])
    _fake_day(tmp_path, "2026-07-29", "am1", [
        ("dag_x", "DAG_FINISHED", {"state": "SUCCEEDED"}),
        ("dag_y", "DAG_SUBMITTED", {"dag_name": "fresh"}),
        ("dag_y", "DAG_FINISHED", {"state": "FAILED"})])
    cache = mod(PORT, "tools.history_cache").DagInfoCache(str(tmp_path))
    assert set(cache.dag_ids()) == {"dag_x", "dag_y"}
    assert cache.get("dag_x").state == "SUCCEEDED"
    assert cache.get("dag_y").state == "FAILED"
    dags = mod(PORT, "tools.history_parser").parse_jsonl_files(
        [str(tmp_path)])
    assert set(dags) == {"dag_x", "dag_y"}
    assert dags["dag_x"].name == "overnight"


@pytest.mark.parametrize("writer", ROOTS)
def test_history_cache_matches_tez_tpu(histories, writer):
    """Both packages' DagInfoCache over each package's history directory:
    the same DAG ids, the same DagInfo (edges apart, as above), a hit on
    the second read."""
    log_dir, _files = histories[writer]
    got = {}
    for root in ROOTS:
        cache = mod(root, "tools.history_cache").DagInfoCache(log_dir)
        ids = cache.dag_ids()
        infos = {i: cache.get(i) for i in ids}
        assert all(cache.get(i) is infos[i] for i in ids)
        assert cache.hits >= len(ids)
        got[root] = {i: dict(dataclasses.asdict(d), edges=None)
                     for i, d in infos.items()}
    assert got[PORT] == got["tez_tpu"] and len(got[PORT]) == 1
