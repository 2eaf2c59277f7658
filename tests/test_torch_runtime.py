"""Port parity of the task runtime (runtime/task_runner.py and what it
runs on: the contexts, the memory distributor, the API's events and edge
manager, the shuffle service) against tez_tpu's, on the CPU.

The task-level cases run one scatter-gather edge through the same harness
for both packages (chip_smoke.run_edge and its in-process umbilical, the
port on device="cpu"): events that reach a reducer before its inputs are
initialized are trapped and replayed, and a processor that raises, or
reports a fatal error, fails its task the same way in both.  The unit
cases hold the copied modules to tez_tpu's answers; the buffer store,
push shuffle and the fetch from another host, which earlier slices
refused, run (tests/test_torch_store.py, test_torch_push.py and
test_torch_remote.py hold them against tez_tpu's).
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import chip_smoke
from tez_tpu.api import edge_manager as j_em
from tez_tpu.api import events as j_ev
from tez_tpu.common import config as j_config
from tez_tpu.common import counters as j_counters
from tez_tpu.common import epoch as j_epoch
from tez_tpu.common import faults as j_faults
from tez_tpu.common import ids as j_ids
from tez_tpu.am import edge as j_edge
from tez_tpu.library import inputs as j_inputs
from tez_tpu.ops import async_stage as j_async
from tez_tpu.ops import runformat as j_rf
from tez_tpu.ops import serde as j_serde
from tez_tpu.runtime import memory as j_memory
from tez_tpu.shuffle import service as j_service
from tez_tpu_torch.api import edge_manager as t_em
from tez_tpu_torch.api import events as t_ev
from tez_tpu_torch.common import config as t_config
from tez_tpu_torch.common import counters as t_counters
from tez_tpu_torch.common import epoch as t_epoch
from tez_tpu_torch.common import faults as t_faults
from tez_tpu_torch.common import ids as t_ids
from tez_tpu_torch.am import edge as t_edge
from tez_tpu_torch.library import inputs as t_inputs
from tez_tpu_torch.ops import async_stage as t_async
from tez_tpu_torch.ops import runformat as t_rf
from tez_tpu_torch.ops import serde as t_serde
from tez_tpu_torch.runtime import memory as t_memory
from tez_tpu_torch.shuffle import service as t_service

ROOTS = ("tez_tpu_torch", "tez_tpu")


@pytest.fixture(autouse=True)
def _isolated_planes():
    for faults, asyncs, epoch in ((t_faults, t_async, t_epoch),
                                  (j_faults, j_async, j_epoch)):
        faults.clear_all()
        asyncs.reset_process_breaker()
        epoch.reset()
    yield
    for faults, asyncs, epoch in ((t_faults, t_async, t_epoch),
                                  (j_faults, j_async, j_epoch)):
        faults.clear_all()
        asyncs.reset_process_breaker()
        epoch.reset()


def api_of(root):
    return chip_smoke.task_api(root, device="cpu" if root == ROOTS[0]
                               else None)


def small_edge(api, maps=2, n=20_000, seed=3):
    """Each map's batches: n Zipf words of 1-8 letters, each value 1."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, int(k)).astype(np.uint8))
             for k in rng.integers(1, 9, 400)]
    out = []
    for _m in range(maps):
        keys = [words[i] for i in rng.zipf(1.3, n) % len(words)]
        ko = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(k) for k in keys], out=ko[1:])
        out.append([api.KVBatch(
            np.frombuffer(b"".join(keys), np.uint8).copy(), ko,
            np.tile(chip_smoke.ONE_LONG, n),
            np.arange(n + 1, dtype=np.int64) * 8)])
    return out


CONF = dict(chip_smoke.TASK_CONF, **{
    "tez.runtime.io.sort.mb": 1, "tez.runtime.sorter.class": "device",
    "tez.runtime.tpu.device.sort.min.records": 0})


# -- trapped events -----------------------------------------------------------
class GateReduceProcessor(chip_smoke.EdgeReduceProcessor):
    """Holds the task's initialize() until its heartbeat has trapped the
    routed events (the inputs are not initialized yet), and records how
    many were trapped."""

    def initialize(self):
        runner = self.context._runner
        deadline = time.monotonic() + 60
        while not runner._trapped_incoming:
            assert time.monotonic() < deadline, "no event was trapped"
            time.sleep(0.005)
        self.context.object_registry.add(
            "session", "trapped", len(runner._trapped_incoming))


def test_events_before_initialize_are_trapped_and_replayed(tmp_path):
    out = {}
    for root in ROOTS:
        api = api_of(root)
        run = chip_smoke.run_edge(
            api, CONF, small_edge(api), 2, str(tmp_path / root),
            processors=("chip_smoke:EdgeMapProcessor",
                        f"{__name__}:GateReduceProcessor"))
        assert set(run.umbilical.states.values()) == {"SUCCEEDED"}, \
            run.umbilical.diagnostics
        # one routed event from each of the two maps
        assert [reg.get("trapped") for _r, reg, _s in run.reducers] == \
            [2, 2]
        out[root] = [tuple(a.tobytes() for a in res)
                     for res in run.results()]
    assert out[ROOTS[0]] == out[ROOTS[1]]
    api = api_of(ROOTS[0])
    plain = chip_smoke.run_edge(api, CONF, small_edge(api), 2,
                                str(tmp_path / "plain"))
    assert out[ROOTS[0]] == [tuple(a.tobytes() for a in res)
                             for res in plain.results()]


# -- failing processors -------------------------------------------------------
class BoomProcessor(chip_smoke.EdgeMapProcessor):
    def run(self, inputs, outputs):
        raise RuntimeError("boom")


class FatalProcessor(chip_smoke.EdgeMapProcessor):
    def run(self, inputs, outputs):
        self.context.fatal_error(ValueError("bad input"), "fatal in run")
        self.context.notify_progress()


@pytest.mark.parametrize("processor,fatal,first_line", [
    ("BoomProcessor", False, "RuntimeError: boom"),
    ("FatalProcessor", True, "fatal in run: ValueError('bad input')")])
def test_processor_failure_fails_the_task(tmp_path, processor, fatal,
                                          first_line):
    """The map task ends FAILED and reports through task_failed with the
    same diagnostics and fatal flag in both packages; the reduce wave
    never starts."""
    reports = {}
    for root in ROOTS:
        api = api_of(root)
        run = chip_smoke.run_edge(
            api, CONF, small_edge(api, maps=1), 2, str(tmp_path / root),
            processors=(f"{__name__}:{processor}",
                        "chip_smoke:EdgeReduceProcessor"))
        umb = run.umbilical
        assert [s for _r, _g, s in run.maps] == ["FAILED"]
        assert run.reducers == []
        (attempt, diag), = umb.diagnostics.items()
        assert umb.states[attempt] == "FAILED"
        assert umb.counters[attempt] is run.maps[0][0].counters
        reports[root] = (diag.splitlines()[0], umb.fatal[attempt])
    assert reports[ROOTS[0]] == reports[ROOTS[1]] == (first_line, fatal)


# -- the copied modules against tez_tpu's -------------------------------------
def test_negative_slot_count_raises():
    for inputs in (t_inputs, j_inputs):
        with pytest.raises(ValueError, match="unresolved physical input "
                                             "count -1"):
            inputs.ShuffleFetchTable(object(), -1, my_partition=0)


MEMORY_CASES = [
    (1 << 30, [(256 << 20, "PARTITIONED_SORTED_OUTPUT"),
               (int(0.9 * (256 << 20)), "SORTED_MERGED_INPUT")], "", 0.05,
     "weighted"),
    (300 << 20, [(256 << 20, "PARTITIONED_SORTED_OUTPUT"),
                 (int(0.9 * (256 << 20)), "SORTED_MERGED_INPUT"),
                 (64 << 20, "UNSORTED_INPUT"), (5 << 20, "PROCESSOR")],
     "", 0.05, "weighted"),
    (300 << 20, [(256 << 20, "PARTITIONED_SORTED_OUTPUT"),
                 (200 << 20, "UNSORTED_INPUT"), (10 << 20, "CUSTOM")],
     "UNSORTED_INPUT=5,CUSTOM=2", 0.1, "weighted"),
    (300 << 20, [(256 << 20, "PARTITIONED_SORTED_OUTPUT"),
                 (200 << 20, "SORTED_MERGED_INPUT")], "bad", 0.0,
     "uniform"),
]


@pytest.mark.parametrize("case", range(len(MEMORY_CASES)))
def test_memory_distributor_grants_match(case):
    budget, requests, ratios, reserve, alloc = MEMORY_CASES[case]
    grants = {}
    for mem in (t_memory, j_memory):
        d = mem.MemoryDistributor(
            budget, weights=mem.parse_weight_ratios(ratios),
            reserve_fraction=reserve, weighted=alloc != "uniform")
        got = []
        for size, kind in requests:
            d.request_memory(size, got.append, component_type=kind)
        d.make_initial_allocations()
        grants[mem.__name__] = (got, d.total_granted(), d.budget)
    assert grants["tez_tpu_torch.runtime.memory"] == \
        grants["tez_tpu.runtime.memory"]
    assert t_memory.DEFAULT_TASK_BUDGET == j_memory.DEFAULT_TASK_BUDGET
    assert t_memory.DEFAULT_WEIGHTS == j_memory.DEFAULT_WEIGHTS


@pytest.mark.parametrize("flags", [[], [False] * 5, [True, False, True],
                                   [True] * 9, [False] * 8 + [True]])
def test_empty_partitions_payload_matches(flags):
    packed = t_ev.pack_empty_partitions(flags)
    assert packed == j_ev.pack_empty_partitions(flags)
    tp = t_ev.ShufflePayload("h", 0, "p", packed, spill_id=2,
                             last_event=False)
    jp = j_ev.ShufflePayload("h", 0, "p", packed, spill_id=2,
                             last_event=False)
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
    for p in range(len(flags) + 9):
        assert tp.is_empty(p) == jp.is_empty(p)


def test_serdes_match():
    samples = {"bytes": [b"", b"ab", bytearray(b"xy"), "str"],
               "text": ["", "héllo"],
               "long": [0, 1, -1, 2 ** 63 - 1, -2 ** 63, 12345],
               "pickle": [None, {"a": [1, 2]}, (1, "x")]}
    for name, objs in samples.items():
        ts, js = t_serde.get_serde(name), j_serde.get_serde(name)
        for obj in objs:
            data = ts.to_bytes(obj)
            assert data == js.to_bytes(obj)
            assert ts.from_bytes(data) == js.from_bytes(data)
    with pytest.raises(TypeError):
        t_serde.get_serde("bytes").to_bytes(3)
    for serde in (t_serde, j_serde):
        with pytest.raises(ValueError, match="unknown serde"):
            serde.get_serde("avro")
    vals = np.array([0, -5, 7, 2 ** 40], dtype=np.int64)
    enc = t_serde.encode_longs_be(vals)
    assert enc.tobytes() == j_serde.encode_longs_be(vals).tobytes()
    assert np.array_equal(t_serde.decode_longs_be(enc, 4), vals)


def test_counters_limits_aggregate_and_from_dict():
    assert [c.name for c in t_counters.TaskCounter] == \
        [c.name for c in j_counters.TaskCounter]
    assert [c.name for c in t_counters.DAGCounter] == \
        [c.name for c in j_counters.DAGCounter]
    assert [c.name for c in t_counters.FileSystemCounter] == \
        [c.name for c in j_counters.FileSystemCounter]
    out = {}
    for mod in (t_counters, j_counters):
        a, b = mod.TezCounters(), mod.TezCounters()
        a.increment(mod.TaskCounter.OUTPUT_RECORDS, 5)
        b.increment(mod.TaskCounter.OUTPUT_RECORDS, 7)
        b.find_counter("Custom", "x" * 100).increment(3)
        a.aggregate(b)
        again = mod.TezCounters.from_dict(a.to_dict())
        mod.Limits.configure({"tez.counters.max": 2})
        try:
            g = mod.TezCounters().group("G")
            g.find_counter("one")
            g.find_counter("two")
            with pytest.raises(mod.CounterLimitExceeded):
                g.find_counter("three")
        finally:
            mod.Limits.configure({})
        out[mod.__name__] = (a.to_dict(), again.to_dict())
    assert out["tez_tpu_torch.common.counters"] == \
        out["tez_tpu.common.counters"]


def test_config_registry_matches():
    """Every key, default and scope of tez_tpu's registry, the class
    names retargeted to the port's modules."""
    def registry(mod, root):
        return {k: (str(v.default).replace(root + ".", "PKG."),
                    v.scope.value)
                for k, v in mod._REGISTRY.items()}
    t = registry(t_config, "tez_tpu_torch")
    j = registry(j_config, "tez_tpu")
    assert t == j
    assert t_config.REPORT_PARTITION_STATS.default is True
    conf = t_config.TezConfiguration({"tez.runtime.io.sort.mb": 64})
    assert conf.get("tez.runtime.io.sort.mb") == 64


def test_ids_and_edge_routing_match():
    for ids in (t_ids, j_ids):
        a = ids.DAGId("app_1_0002", 3).vertex(1).task(7).attempt(2)
        assert str(a) == "attempt_1_0002_3_01_000007_2"
        assert str(a.dag_id) == "dag_1_0002_3"

    def routes(em_mod, edge_mod):
        class Ctx(em_mod.EdgeManagerPluginContext):
            source_vertex_name = "m"
            destination_vertex_name = "r"
            source_vertex_num_tasks = 3
            destination_vertex_num_tasks = 4
            user_payload = None
        m = edge_mod.ScatterGatherEdgeManager(Ctx())
        m.initialize()
        out = []
        for s in range(3):
            for d in range(4):
                out.append((
                    m.route_composite_data_movement_event_to_destination(
                        s, d),
                    m.route_data_movement_event_to_destination(s, d, d),
                    m.route_data_movement_event_to_destination(s, 0, 1),
                    m.route_input_source_task_failed_event_to_destination(
                        s, d),
                    m.route_input_error_event_to_source(d, s),
                    m.get_num_destination_task_physical_inputs(d),
                    m.get_num_source_task_physical_outputs(s)))
        return [tuple(dataclasses.astuple(x) if dataclasses.is_dataclass(x)
                      else x for x in row) for row in out]
    assert routes(t_em, t_edge) == routes(j_em, j_edge)


def test_shuffle_service_fences_and_lookups(tmp_path):
    """Registration fences (a stale epoch, a sealed window), misses, the
    disk-direct source of a file-backed run and prefix deletion answer as
    tez_tpu's service does."""
    out = {}
    for svc_mod, epoch, rf in ((t_service, t_epoch, t_rf),
                               (j_service, j_epoch, j_rf)):
        svc = svc_mod.ShuffleService()
        batch = rf.KVBatch.from_pairs([(b"a", b"1"), (b"b", b"2"),
                                       (b"c", b"3")])
        run = rf.Run(batch, np.array([0, 2, 2, 3], dtype=np.int64))
        epoch.register("app", 2)
        epoch.register_window("app", "s", 5)
        events = []
        with pytest.raises(epoch.EpochFencedError):
            svc.register("dag_1/a/r", -1, run, epoch=1, app_id="app")
        with pytest.raises(epoch.WindowFencedError):
            svc.register("dag_1/a/r", -1, run, app_id="app", window_id=4,
                         stream="s")
        svc.register("dag_1/a/r", -1, run, epoch=2, app_id="app")
        svc.register("dag_1/b/r", 0, run)     # unstamped: never fenced
        path = str(tmp_path / f"{svc_mod.__name__}.prun")
        rf.save_run_partitioned(run, path)
        svc.register("dag_2/c/r", -1, rf.FileRun(path))
        for p in range(3):
            events.append(svc.fetch_partition("dag_1/a/r", -1, p)
                          .key_bytes.tobytes())
            events.append(svc.partition_size("dag_1/b/r", 0, p))
        events.append(svc.local_file_source("dag_1/a/r", -1, 0))
        src = svc.local_file_source("dag_2/c/r", -1, 2)
        events.append((os.path.basename(src[0]).split(".")[-1], src[1]))
        with pytest.raises(epoch.WindowFencedError):
            svc.fetch_partition("dag_1/a/r", -1, 0, app_id="app",
                                window_id=1, stream="s")
        with pytest.raises(svc_mod.ShuffleDataNotFound):
            svc.fetch_partition("dag_9/x/r", -1, 0)
        events.append(svc.stats())
        events.append(svc.unregister_prefix("dag_1/"))
        events.append(svc.unregister_prefix("dag_2/"))
        events.append(os.path.exists(path))
        events.append(svc.stats())
        out[svc_mod.__name__] = events
    assert out["tez_tpu_torch.shuffle.service"] == \
        out["tez_tpu.shuffle.service"]


def test_fault_points_keep_tez_tpu_texts():
    for point in ("shuffle.fetch.read", "shuffle.data", "task.run",
                  "fence.stale_epoch", "fence.stale_window",
                  "store.replica.lost"):
        assert t_faults.KNOWN_POINTS[point] == j_faults.KNOWN_POINTS[point]


# -- what earlier slices refused ---------------------------------------------
def _canon(obj):
    """Arrays as (dtype, bytes), so results compare with ==."""
    if isinstance(obj, np.ndarray):
        return (str(obj.dtype), obj.tobytes())
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    return obj


def test_store_and_push_edges_match_tez_tpu(tmp_path):
    """Nothing of the buffer store or push shuffle raises
    NotImplementedError any more (the write-through file store and the
    fetch from another host are ported too: tests/test_torch_remote.py
    holds them against tez_tpu's): the service attaches both, ensure_store
    makes the store, and the edge runs with either knob on, each reducer's
    result equal to tez_tpu's."""
    from tez_tpu.store import reset_store as j_reset_store
    from tez_tpu_torch.store import ensure_store, reset_store
    svc = t_service.ShuffleService()
    svc.attach_buffer_store(object())
    svc.attach_push_admission(object())
    assert svc.buffer_store() is not None and svc.push_admission() is not None
    try:
        for enabled in (True, "yes"):
            assert ensure_store({"tez.runtime.store.enabled": enabled,
                                 "tez.runtime.store.dir":
                                     str(tmp_path / "s")}) is not None
            reset_store()
        assert ensure_store({}) is None
        assert not svc.has_store()
        for knob in ("tez.runtime.store.enabled",
                     "tez.runtime.shuffle.push.enabled"):
            results = []
            for root in ROOTS:
                api = api_of(root)
                # push forces pipelined output: synchronous spans, as
                # tests/test_torch_task_io.py's pipelined cases run
                run = chip_smoke.run_edge(
                    api, dict(CONF, **{knob: True,
                                       "tez.runtime.sort.pipeline.depth": 0}),
                    small_edge(api, maps=1, n=100), 1,
                    str(tmp_path / knob / root))
                assert run.umbilical.diagnostics == {}
                results.append(_canon(run.results()))
                reset_store()
                j_reset_store()
            assert results[0] == results[1] and results[0][0]
    finally:
        reset_store()
        j_reset_store()


def test_runner_device_defaults_to_the_card():
    """A runner built without a device takes the card and, on a host
    without one, raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: tests/test_torch_cuda.py checks "
                    "the default there")
    api = api_of(ROOTS[0])
    spec = api.TaskSpec(
        attempt_id=api.ids.DAGId("app_1_0001", 1).vertex(0).task(0)
        .attempt(0), dag_name="d", vertex_name="v", vertex_parallelism=1,
        processor_descriptor=api.payload.ProcessorDescriptor.create(
            "tez_tpu_torch.library.processors:SimpleProcessor"),
        inputs=(), outputs=())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.TaskRunner(spec, chip_smoke.LocalUmbilical(api, 1, 1))


def test_profile_dir_writes_a_trace(tmp_path):
    """tez.task.jax-profile.dir traces the processor with torch.profiler
    into <dir>/<attempt id>/trace.json."""
    api = api_of(ROOTS[0])
    attempt = api.ids.DAGId("app_1_0001", 1).vertex(0).task(0).attempt(0)
    spec = api.TaskSpec(
        attempt_id=attempt, dag_name="d", vertex_name="v",
        vertex_parallelism=1,
        processor_descriptor=api.payload.ProcessorDescriptor.create(
            "tez_tpu_torch.library.processors:SleepProcessor",
            {"sleep_ms": 5}),
        inputs=(), outputs=(),
        conf={"tez.task.jax-profile.dir": str(tmp_path)})
    umb = chip_smoke.LocalUmbilical(api, 1, 1)
    state = api.TaskRunner(spec, umb, work_dir=str(tmp_path),
                           device="cpu").run()
    assert state == "SUCCEEDED", umb.diagnostics
    assert os.path.getsize(tmp_path / str(attempt) / "trace.json") > 0


def test_lineage_hashes_match():
    """A vertex's lineage hash covers its processor, parallelism, conf and
    in-edges, and the hashes upstream of it, as tez_tpu's does."""
    import types
    from tez_tpu.common import payload as j_payload
    from tez_tpu.store import lineage as j_lineage
    from tez_tpu_torch.common import payload as t_payload
    from tez_tpu_torch.store import lineage as t_lineage

    def plan(pl, window):
        def vertex(name, par, conf):
            return types.SimpleNamespace(
                name=name, parallelism=par, conf=conf, root_inputs=[],
                leaf_outputs=[], processor=pl.ProcessorDescriptor(
                    "proc:" + name, pl.UserPayload(b"p" + name.encode())))
        prop = types.SimpleNamespace(
            data_movement_type="SCATTER_GATHER",
            edge_source=pl.OutputDescriptor("out:C"),
            edge_destination=pl.InputDescriptor("in:C"))
        return types.SimpleNamespace(
            vertices=[vertex("m", 4, {"a": 1}), vertex("r", 2, {})],
            edges=[types.SimpleNamespace(id="e0", input_vertex="m",
                                         output_vertex="r",
                                         edge_property=prop)],
            dag_conf={"tez.runtime.stream.id": "s",
                      "tez.runtime.stream.window-id": window}
            if window else {})
    for window in (0, 3):
        t = t_lineage.vertex_lineage_hashes(plan(t_payload, window))
        j = j_lineage.vertex_lineage_hashes(plan(j_payload, window))
        assert t == j and len(t["r"]) == 24
        assert t_lineage.task_lineage(t["r"], 1, "sink") == \
            j_lineage.task_lineage(j["r"], 1, "sink")
    assert t_lineage.task_lineage("", 1, "sink") == ""
