"""Port parity of the DAG runtime: OrderedWordCount and small failing DAGs
built from one description (chip_smoke.build_dag) in both packages and run
through each package's own TezClient and DAGAppMaster in local thread mode,
tez_tpu's on JAX's CPU backend, the port's with device="cpu" (the kernels'
plain versions).

Compared without tolerance: the DSL's verdicts and the DAG plans (with
descriptor names mapped from tez_tpu. to tez_tpu_torch.), the committed
part files byte for byte, the final states, the untimed DAG counters,
each entity's sequence of history event types and the decoded lines of
the recovery journal.

Both packages run at tez_tpu's defaults, each on its own host library:
the vectorised tokenizer feeds the word-count aggregator when the edge
combines with the sum combiner and splits with tz_split_ws otherwise, and
the precombine, the host engine's span sorts and merges and the large
gathers call the library in both.  Counters are compared with every part
of both libraries on; a spy on the port's library shows which of its
functions a case ran.

Which spans spill follows their completion order, and which batches a
merge takes follows the commits' race with the merger, so both packages
get one readback worker and paced commits (tests/test_torch_task_io.py),
and two runner threads.
"""
import dataclasses
import enum
import os

import numpy as np
import pytest

import chip_smoke
from tez_tpu.common import faults as jfaults
from tez_tpu.library import merge_manager as jmm
from tez_tpu.library.processors import SimpleProcessor as JSimpleProcessor
from tez_tpu.ops import async_stage as jasync
from tez_tpu.ops import native as jnative
from tez_tpu_torch.common import faults as tfaults
from tez_tpu_torch.library import merge_manager as tmm
from tez_tpu_torch.library.processors import (
    SimpleProcessor as TSimpleProcessor)
from tez_tpu_torch.ops import async_stage as tasync

ROOTS = ("tez_tpu_torch", "tez_tpu")
#: two runner threads; the device sorter on both edges
BASE_CONF = {"tez.am.local.num-containers": 2,
             "tez.runtime.sorter.class": "device",
             "tez.runtime.tpu.device.sort.min.records": 0}
#: pipelined shuffle with synchronous spans (tests/test_torch_task_io.py:
#: tez_tpu's pipelined output on its async plane trips tests/conftest.py's
#: lock-order witness)
PIPELINED_CONF = {"tez.runtime.sort.pipeline.depth": 0}

#: case -> (description kw, conf, corpus files, corpus words)
CASES = {
    "combine": (dict(combine=True), {}, 1, 6000),
    "no_combine": (dict(combine=False), {}, 1, 6000),
    #: io.sort.mb 1: several spills a tokenizer, each shipped on its own
    "combine_pipelined": (dict(combine=True, pipelined=True),
                          dict(PIPELINED_CONF, **{
                              "tez.runtime.io.sort.mb": 1}), 1, 200_000),
    "multi_file": (dict(tokenizer_parallelism=4), {}, 3, 3000),
    "vector": (dict(tokenizer_mode="vector"), {}, 1, 6000),
    "vector_no_combine": (dict(tokenizer_mode="vector", combine=False), {},
                          1, 6000),
    "two_sorters": (dict(sorter_parallelism=2, summation_parallelism=3), {},
                    1, 6000),
    #: spans of over 65,536 records at io.sort.mb 4 with the library's
    #: device floor
    "device_floor": (dict(tokenizer_mode="vector", combine=False),
                     {"tez.runtime.io.sort.mb": 4,
                      "tez.runtime.tpu.device.sort.min.records": 65536},
                     1, 400_000),
}


def pace_both(monkeypatch):
    """Both packages: planes reset, one readback worker, paced commits."""
    for faults, asyncs in ((tfaults, tasync), (jfaults, jasync)):
        faults.clear_all()
        asyncs.reset_process_breaker()

        def one_worker(self, *a, _real=asyncs.AsyncSpanPipeline.__init__,
                       **kw):
            _real(self, *a, **dict(kw, readback_workers=1))
        monkeypatch.setattr(asyncs.AsyncSpanPipeline, "__init__", one_worker)
    for mm in (tmm, jmm):
        def paced(self, *a, _real=mm.ShuffleMergeManager.commit, **kw):
            out = _real(self, *a, **kw)
            assert self.quiesce(timeout=120), "merger never went idle"
            return out
        monkeypatch.setattr(mm.ShuffleMergeManager, "commit", paced)


def unpace_both():
    for faults, asyncs in ((tfaults, tasync), (jfaults, jasync)):
        faults.clear_all()
        asyncs.reset_process_breaker()


@pytest.fixture(autouse=True)
def _deterministic_planes(monkeypatch):
    pace_both(monkeypatch)
    yield
    unpace_both()


def api_of(root):
    return chip_smoke.dag_api(root, device="cpu" if root == ROOTS[0]
                              else None)


def corpus(tmp_path, files, words, seed=0):
    """`files` seeded corpora in bench.py's layout; their paths."""
    rng = np.random.default_rng(seed)
    mat, lens = chip_smoke.bulk_word_vocab(rng, 3000)
    paths = []
    for i in range(files):
        path = str(tmp_path / f"in{i}.txt")
        chip_smoke.write_corpus(path, rng, mat, lens, words * 9,
                                words_per_line=64, chunk_lines=16)
        paths.append(path)
    return paths


class KernelSpy:
    """Calls of the port's two kernels' wrappers (on the CPU, their plain
    versions), and the calls into the port's host library."""

    def __init__(self, monkeypatch):
        from tez_tpu_torch.ops import kernels, native
        self.calls = dict.fromkeys(("fnv_hash_lanes", "merge_path_pair"), 0)
        for name in self.calls:
            def spy(*a, _real=getattr(kernels, name), _name=name, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(kernels, name, spy)
        native.reset_calls()
        self.native = native.calls


def run_case(tmp_path, root, desc_kw, conf, paths):
    out = str(tmp_path / root / "out")
    desc = chip_smoke.wordcount_description(paths, out, **desc_kw)
    run = chip_smoke.run_dag(api_of(root), desc, dict(
        BASE_CONF, **conf, **{"tez.staging-dir": str(tmp_path / root)}))
    data, _rows = chip_smoke.read_wordcount(out)
    return run, data, os.path.exists(os.path.join(out, "_SUCCESS"))


def untimed(counters):
    """Every DAG counter but the times, the process's memory and the
    latency histograms."""
    skip = ("MILLI", "_TIME", "MEMORY", "HEAP", "time_taken")
    return {g: {c: v for c, v in cs.items() if not any(s in c for s in skip)}
            for g, cs in counters.items()
            if not g.startswith("LatencyHistogram")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ordered_wordcount_matches_tez_tpu(tmp_path, monkeypatch, case):
    desc_kw, conf, files, words = CASES[case]
    spy = KernelSpy(monkeypatch)
    paths = corpus(tmp_path, files, words)
    (t, t_parts, t_ok), (j, j_parts, j_ok) = (
        run_case(tmp_path, root, desc_kw, conf, paths) for root in ROOTS)
    assert t.state == j.state == "SUCCEEDED"
    assert t_ok and j_ok
    assert t_parts == j_parts and t_parts
    assert untimed(t.counters) == untimed(j.counters)
    assert spy.calls["fnv_hash_lanes"] > 0 and \
        spy.calls["merge_path_pair"] > 0
    vector = desc_kw.get("tokenizer_mode") == "vector"
    combine = desc_kw.get("combine", True)
    # the aggregator feeds each combining vector tokenizer; the split
    # feeds the others
    assert (spy.native["tz_wc_feed"] > 0) == (vector and combine)
    assert (spy.native["tz_split_ws"] > 0) == (vector and not combine)


def test_ordered_wordcount_matches_tez_tpu_with_its_native_library(
        tmp_path):
    """Both tokenizers on their own native word-count aggregators
    (tez_tpu's libtezhost.so loads here, as its tier-1 tests need): the
    same part files."""
    assert jnative.native_available()
    paths = corpus(tmp_path, 1, 6000)
    parts = [run_case(tmp_path, root, dict(tokenizer_mode="vector"), {},
                      paths)[1] for root in ROOTS]
    assert parts[0] == parts[1] and parts[0]


# -- (a) the DSL and the plan ------------------------------------------------
def plan_tree(obj):
    """A DAG plan as plain Python: dataclasses as dicts, enums by name,
    payloads loaded, names of the port's modules as tez_tpu's."""
    if dataclasses.is_dataclass(obj):
        if type(obj).__name__ == "UserPayload":
            return plan_tree(obj.load())
        return {f.name: plan_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, dict):
        return {plan_tree(k): plan_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plan_tree(v) for v in obj]
    if isinstance(obj, str):
        return obj.replace("tez_tpu_torch.", "tez_tpu.")
    return obj


WORDCOUNT_SHAPES = {
    "default": {},
    "bench": dict(tokenizer_parallelism=4, summation_parallelism=4,
                  tokenizer_mode="vector"),
    "pipelined": dict(combine=False, pipelined=True, sorter_parallelism=2),
}


@pytest.mark.parametrize("shape", sorted(WORDCOUNT_SHAPES))
def test_wordcount_plan_matches_tez_tpu(shape):
    """The description's DAG is each package's own OrderedWordCount
    (examples/ordered_wordcount.py build_dag), and the two packages' plans
    are equal but for the package names."""
    import importlib
    kw = WORDCOUNT_SHAPES[shape]
    conf = {"tez.runtime.io.sort.mb": 64}
    trees = []
    for root in ROOTS:
        desc = chip_smoke.wordcount_description(["/in/a", "/in/b"], "/out",
                                                **kw)
        plan = chip_smoke.build_dag(api_of(root), desc).create_dag_plan(conf)
        owc = importlib.import_module(f"{root}.examples.ordered_wordcount")
        own = owc.build_dag(["/in/a", "/in/b"], "/out", **kw)
        assert plan_tree(plan) == plan_tree(own.create_dag_plan(conf))
        trees.append(plan_tree(plan))
    assert trees[0] == trees[1]


def _v(name, parallelism=1):
    return {"name": name, "parallelism": parallelism,
            "processor": "{root}.library.processors:SimpleProcessor"}


def _e(src, dst):
    return (src, dst, "bytes", "long", {})


#: the DSL's shapes from tests/test_dag_api.py, each a description
DSL_SHAPES = {
    "linear": ([_v("a", 2), _v("b", 2), _v("c")],
               [_e("a", "b"), _e("b", "c")]),
    "cycle": ([_v("a"), _v("b")], [_e("a", "b"), _e("b", "a")]),
    "self_edge": ([_v("a")], [_e("a", "a")]),
    "duplicate_vertex": ([_v("a"), _v("a")], []),
    "dangling_edge": ([_v("a")], [_e("a", "b")]),
    "disconnected": ([_v(n) for n in "abcd"], [_e("a", "b"), _e("c", "d")]),
    "bad_parallelism": ([_v("a", 0)], []),
}


def dsl_outcome(root, shape):
    vertices, edges = DSL_SHAPES[shape]
    desc = {"name": "d", "vertices": vertices, "edges": edges}
    api = api_of(root)
    try:
        dag = chip_smoke.build_dag(api, desc)
        return ("ok", dag.verify(), plan_tree(dag.create_dag_plan()))
    except api.dag.TezUncheckedException as e:
        return ("rejected", str(e))


@pytest.mark.parametrize("shape", sorted(DSL_SHAPES))
def test_dsl_verdicts_match_tez_tpu(shape):
    verdicts = [dsl_outcome(root, shape) for root in ROOTS]
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][0] == ("ok" if shape in ("linear", "disconnected")
                              else "rejected")


# -- (c) failing processors --------------------------------------------------
class _FailFirstAttempt:
    def run(self, inputs, outputs):
        if self.context.task_attempt_number == 0:
            raise RuntimeError("the first attempt fails")


class _AlwaysFail:
    def run(self, inputs, outputs):
        raise RuntimeError("every attempt fails")


class FailOnce_tez_tpu(_FailFirstAttempt, JSimpleProcessor):
    pass


class FailOnce_tez_tpu_torch(_FailFirstAttempt, TSimpleProcessor):
    pass


class AlwaysFail_tez_tpu(_AlwaysFail, JSimpleProcessor):
    pass


class AlwaysFail_tez_tpu_torch(_AlwaysFail, TSimpleProcessor):
    pass


def attempt_states(run):
    """task key -> the final states of its attempts, in order."""
    out = {}
    for ev in run.events:
        if ev.event_type.name == "TASK_ATTEMPT_FINISHED":
            out.setdefault(ev.task_id.split("_", 3)[-1], []).append(
                ev.data["state"])
    return out


@pytest.mark.parametrize("processor,parallelism,state",
                         [("FailOnce", 2, "SUCCEEDED"),
                          ("AlwaysFail", 1, "FAILED")])
def test_failing_processors_match_tez_tpu(tmp_path, processor, parallelism,
                                          state):
    desc = {"name": "failing", "edges": [], "vertices": [
        {"name": "v", "parallelism": parallelism,
         "processor": f"{__name__}:{processor}_{{root}}"}]}
    runs = [chip_smoke.run_dag(api_of(root), desc, dict(BASE_CONF, **{
        "tez.staging-dir": str(tmp_path / root)})) for root in ROOTS]
    assert runs[0].state == runs[1].state == state
    assert attempt_states(runs[0]) == attempt_states(runs[1])
    assert all(len(a) >= 2 for a in attempt_states(runs[0]).values())
    assert untimed(runs[0].counters) == untimed(runs[1].counters)
    assert runs[0].entity_sequences() == runs[1].entity_sequences()


# -- (d) history and the recovery journal ------------------------------------
def test_history_and_journal_match_tez_tpu(tmp_path):
    """Each entity's history event types, in order, are the same in both
    packages; every journal line decodes in both packages to the same
    event, and the journal holds each entity's history in order."""
    paths = corpus(tmp_path, 1, 6000)
    runs = {root: run_case(tmp_path, root, {}, {}, paths)[0]
            for root in ROOTS}
    t, j = runs["tez_tpu_torch"], runs["tez_tpu"]
    assert t.entity_sequences() == j.entity_sequences()
    assert t.entity_sequences()[("dag_id", "dag")] == [
        "DAG_SUBMITTED", "DAG_INITIALIZED", "DAG_STARTED",
        "DAG_COMMIT_STARTED", "DAG_COMMIT_FINISHED", "DAG_FINISHED"]
    decoders = {root: api_of(root).recovery.decode_journal_line
                for root in ROOTS}
    for root, run in runs.items():
        assert run.journal
        mine = [decoders[root](line) for line in run.journal]
        assert run.entity_sequences(mine) == run.entity_sequences()
        for other in ROOTS:
            theirs = [decoders[other](line) for line in run.journal]
            assert [(e.event_type.name, e.dag_id, e.vertex_id, e.task_id,
                     e.attempt_id, e.data) for e in theirs] == \
                [(e.event_type.name, e.dag_id, e.vertex_id, e.task_id,
                  e.attempt_id, e.data) for e in mine]


# -- (e) the device and what is not ported -----------------------------------
def test_default_device_is_the_card(tmp_path):
    """TezClient and ordered_wordcount.run default to the card: without
    one they raise before any AM or DAG starts (no output, no staging)."""
    import torch
    from tez_tpu_torch.client.tez_client import TezClient
    from tez_tpu_torch.examples import ordered_wordcount
    conf = {"tez.staging-dir": str(tmp_path / "stg")}
    if torch.cuda.is_available():
        assert TezClient.create("x", conf).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TezClient.create("x", conf)
    paths = corpus(tmp_path, 1, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ordered_wordcount.run(paths, str(tmp_path / "out"), conf=conf)
    assert not (tmp_path / "out").exists()
    assert not (tmp_path / "stg").exists()


def _start(conf):
    from tez_tpu_torch.client.tez_client import TezClient
    client = TezClient.create("x", conf, device="cpu")
    try:
        client.start()
    finally:
        client.stop()


def test_unknown_runner_mode_is_refused(tmp_path):
    """The AM refuses a tez.runner.mode it does not know, at the AM's conf
    and at a DAG's, rather than run in another mode."""
    with pytest.raises(NotImplementedError, match="tez.runner.mode"):
        _start({"tez.staging-dir": str(tmp_path / "am"),
                "tez.runner.mode": "yarn"})
    from tez_tpu_torch.client.tez_client import TezClient
    from tez_tpu_torch.common.payload import ProcessorDescriptor
    from tez_tpu_torch.dag.dag import DAG, Vertex
    dag = DAG.create("moded").add_vertex(Vertex.create(
        "v", ProcessorDescriptor.create(
            "tez_tpu_torch.library.processors:SleepProcessor",
            payload={"sleep_ms": 1}), 1))
    dag.set_conf("tez.runner.mode", "yarn")
    with TezClient.create("x", {"tez.staging-dir": str(tmp_path / "dag")},
                          device="cpu") as client:
        with pytest.raises(NotImplementedError, match="tez.runner.mode"):
            client.submit_dag(dag).wait_for_completion(timeout=60)


def test_dag_phase_on_the_host():
    """chip_smoke's phase 11 at TINY_DAG on the CPU: both legs SUCCEEDED,
    each output equal to the corpus's golden, B's part file A's."""
    import types
    chip_smoke.dag_phase(types.SimpleNamespace(seed=0), device="cpu",
                         **chip_smoke.TINY_DAG)


def test_telemetry_rings_match_tez_tpu():
    """The AM's telemetry plane: the same latency observations and gauges
    sampled at the same instants give the same windowed aggregates and
    accounting in both packages' time-series registries."""
    from tez_tpu.common import metrics as jmetrics
    from tez_tpu.obs import timeseries as jts
    from tez_tpu_torch.common import metrics as tmetrics
    from tez_tpu_torch.obs import timeseries as tts
    out = []
    for metrics, ts in ((tmetrics, tts), (jmetrics, jts)):
        reg = ts.TimeSeriesRegistry(capacity=4)
        rng = np.random.default_rng(3)
        for tick in range(6):
            for ms in rng.exponential(40.0, 50):
                metrics.observe("test.dag.parity", float(ms))
            metrics.set_gauge("test.dag.gauge", float(tick))
            reg.sample(now_ns=tick * 250_000_000)
        now = 5 * 250_000_000
        out.append([(reg.window(name, 0.6, now_ns=now),
                     reg._series[name].evicted)
                    for name in ("test.dag.parity", "test.dag.gauge")])
    assert out[0] == out[1]
    (hist, evicted), (gauge, _) = out[0]
    assert hist["count"] == 150 and evicted == 2 and gauge["last"] == 5.0


def test_live_status_and_window_rows_match_tez_tpu():
    """The AM's continuous-doctor payload (TelemetrySampler.live_status)
    and telemetry.window_rows over the same observations between two
    ticks, on both packages: per-plane busy ms, the dominant plane, a
    mesh lane's occupancy and the label-split rows."""
    import importlib
    import types
    names = ("shuffle.fetch.test_live", "device.sort.test_live",
             "tenant.ta.test_live")
    out = []
    for root in ROOTS:
        def m(name):
            return importlib.import_module(f"{root}.{name}")
        metrics, telemetry = m("common.metrics"), m("am.telemetry")
        reg = m("obs.timeseries").registry()
        reg.reset()
        sampler = telemetry.TelemetrySampler(types.SimpleNamespace(
            app_id="app_live", conf=m("common.config").TezConfiguration(
                {})))
        for name in names:     # each series has a point at the first tick
            metrics.observe(name, 0.5)
        sampler.tick()
        for i, name in enumerate(names):
            for ms in (1.0, 2.0, 4.0 * (i + 1)):
                metrics.observe(name, ms)
        metrics.set_gauge("mesh.lane.3.occupancy", 0.5)
        sampler.tick()
        st = sampler.live_status(window_s=600)
        rows = sorted(
            (r["name"], sorted(r["labels"].items()), r["count"],
             r["sum_ms"]) for r in telemetry.window_rows(600, kind="hist")
            if r["series"] in names)
        out.append((st["window_s"], st["planes"], st["lanes"].get("3"),
                    st["sampler"]["ticks"], rows))
        reg.reset()
    assert out[0] == out[1]
    _w, planes, lane, ticks, rows = out[0]
    assert planes["dominant"] == "device" and lane == 0.5 and ticks == 2
    assert planes["busy_ms"]["transport"] == 7.0
    assert ("tenant.test_live", [("tenant", "ta")], 3, 15.0) in rows


def test_remote_phase_on_the_host(tmp_path):
    """chip_smoke's phase 12 at TINY_DAG on the CPU, over phase 11's
    corpus: both legs in 4 runner processes (leg B through the native
    server) give phase 11's part files, with fetches across processes, and
    every runner reports the CPU."""
    import types
    args = types.SimpleNamespace(seed=0)
    corpus = chip_smoke.DagCorpus(str(tmp_path), args, **chip_smoke.TINY_DAG)
    phase11 = {}
    chip_smoke.dag_phase(args, device="cpu", corpus=corpus, legs_out=phase11,
                         **chip_smoke.TINY_DAG)
    assert sorted(phase11) == ["A", "B"]
    launches = chip_smoke.remote_phase(args, corpus, phase11, device="cpu",
                                       **chip_smoke.TINY_DAG)
    assert launches == {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                        "merge_rank": 0, "merge_path_pair": 0}


def test_standalone_phase_on_the_host():
    """chip_smoke's phase 17 at TINY_STANDALONE on the CPU, over phase
    15(b)'s tiny corpus and its host-exchange part file: A, a standalone
    AM process (--device cpu) with two runner pods reached only through
    the remote client, both pods up before the DAG and both taking its
    tasks; B, an AM crash between the tokenizers' success and the
    summations', attempt 2 restoring the tokenizers from the journal and
    re-binding the live handle; both part files 15(b)'s."""
    import tempfile
    import types
    from tez_tpu_torch.parallel import coordinator
    args = types.SimpleNamespace(seed=0)
    coordinator.reset_coordinator()
    with tempfile.TemporaryDirectory(prefix="tez_standalone_") as root:
        tiny = chip_smoke.TINY_MESH
        corpus = chip_smoke.DagCorpus(
            root, args, marks_mb=(tiny["mesh_mb"],),
            **chip_smoke.corpus_sizes(tiny))
        mesh = chip_smoke.mesh_phase(args, device="cpu", corpus=corpus,
                                     **tiny)
        launches = chip_smoke.standalone_phase(
            args, corpus, mesh["host_part"], device="cpu",
            **chip_smoke.TINY_STANDALONE)
        # phase 21 D's fsck of these journals, held against tez_tpu's
        from test_torch_journal_fsck import fsck_matches_tez_tpu
        for leg in ("A", "B"):
            fsck_matches_tez_tpu(os.path.join(root, f"sa_staging_{leg}"))
    assert launches == {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                        "merge_rank": 0, "merge_path_pair": 0}
