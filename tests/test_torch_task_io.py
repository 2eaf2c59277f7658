"""Port parity of the library's ordered shuffle IO run as tasks: map tasks
through OrderedPartitionedKVOutput and the in-process shuffle service,
reduce tasks through OrderedGroupedKVInput and its merge manager, each
task a TaskRunner reporting to the harness's in-process umbilical
(chip_smoke.LocalUmbilical, which routes the maps' composite events with
each package's ScatterGatherEdgeManager).  The same harness and the same
seeded records run tez_tpu's tasks and the port's (device="cpu", the
kernels' plain versions), and every comparison is byte for byte, with no
tolerance: each map's registered run per partition, each event's shuffle
payload and VertexManagerEvent sizes, every counter the tasks set except
times, and each reducer's grouped stream.

Which spans spill follows their completion order, and which batches a
merge takes follows the commits' race with the merger, so both packages
get one readback worker and each commit waits for the merger to go idle
(ShuffleMergeManager.quiesce), as tests/test_torch_merge_manager.py's
paced cases do; tasks run one at a time.
"""
import numpy as np
import pytest

import chip_smoke
from tez_tpu.common import faults as jfaults
from tez_tpu.library import merge_manager as jmm
from tez_tpu.ops import async_stage as jasync
from tez_tpu.ops.serde import encode_longs_be
from tez_tpu_torch.common import faults as tfaults
from tez_tpu_torch.library import merge_manager as tmm
from tez_tpu_torch.ops import async_stage as tasync

ROOTS = ("tez_tpu_torch", "tez_tpu")
MAPS, REDUCERS = 3, 3
#: small spans and merge budgets: io.sort.mb 1 makes two spans a map and
#: puts a reducer's ~1.9 MB over its 0.9 MiB merge budget; every span and
#: merge takes the device engine (the port's plain versions, tez_tpu's
#: device engine on JAX's CPU backend)
BASE_CONF = dict(chip_smoke.TASK_CONF, **{
    "tez.runtime.io.sort.mb": 1,
    "tez.runtime.sorter.class": "device",
    "tez.runtime.tpu.device.sort.min.records": 0})
#: a budget no reducer of these cases passes: the in-RAM final merge
IN_RAM = {"tez.runtime.shuffle.merge.budget.mb": 64}
#: pipelined shuffle with synchronous spans: on its async plane tez_tpu's
#: output ships a spill (registering it, queueing its event) under the
#: pipeline's completion lock, an order tez_tpu's static lock graph does
#: not list, and tests/conftest.py's lock-order witness fails the session
#: on it; at depth 0 the spill ships from the writer's thread
PIPELINED = {"tez.runtime.pipelined-shuffle.enabled": True,
             "tez.runtime.sort.pipeline.depth": 0}


class FirstBytePartitioner:
    """A custom Partitioner: the key's first byte mod the partitions."""

    def get_partition(self, key, value, num_partitions):
        return key[0] % num_partitions


def comparator_conf(root):
    return {"tez.runtime.key.comparator.class":
            f"{root}.library.comparators:CaseInsensitiveKeyComparator"}


#: case -> (conf for a package root, map mode, reduce mode, mixed case)
CASES = {
    "plain": (lambda r: IN_RAM, "batch", "blocks", False),
    "combiner": (lambda r: dict(IN_RAM, **{
        "tez.runtime.combiner.class": "sum_long"}), "batch", "blocks", False),
    "pipelined": (lambda r: dict(IN_RAM, **PIPELINED), "batch", "blocks",
                  False),
    "zlib": (lambda r: dict(IN_RAM, **{
        "tez.runtime.compress": True,
        "tez.runtime.compress.codec": "zlib"}), "batch", "blocks", False),
    "partitioner": (lambda r: dict(IN_RAM, **{
        "tez.runtime.partitioner.class":
            f"{__name__}:FirstBytePartitioner"}), "records", "blocks", False),
    "comparator": (lambda r: dict(IN_RAM, **comparator_conf(r)), "batch",
                   "blocks", True),
    "over_budget": (lambda r: {
        "tez.runtime.shuffle.memory.limit.percent": 1.0}, "batch", "blocks",
        False),
    "over_budget_pipelined": (lambda r: PIPELINED, "batch", "blocks",
                              False),
    "records": (lambda r: IN_RAM, "records", "groups", False),
    "records_over_budget": (lambda r: comparator_conf(r), "records",
                            "groups", True),
}


@pytest.fixture(autouse=True)
def _deterministic_planes(monkeypatch):
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
    yield
    for faults, asyncs in ((tfaults, tasync), (jfaults, jasync)):
        faults.clear_all()
        asyncs.reset_process_breaker()


def word_records(seed, n=60_000, maps=MAPS, vocab=1500, mixed=False):
    """Each map's records as (key bytes, key offsets, long values): Zipf
    words of 1-12 letters, lowercase (or mixed case, where words that
    differ only in case are distinct keys), values 1-7."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz" +
                            (b"ABCDEFGHIJKLMNOPQRSTUVWXYZ" if mixed else b""),
                            dtype=np.uint8)
    words = [rng.choice(letters, k).tobytes()
             for k in rng.integers(1, 13, vocab)]
    out = []
    for _m in range(maps):
        ids = rng.zipf(1.3, n) % vocab
        keys = [words[i] for i in ids]
        ko = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(k) for k in keys], out=ko[1:])
        kb = np.frombuffer(b"".join(keys), dtype=np.uint8).copy()
        out.append((kb, ko, rng.integers(1, 8, n).astype(np.int64)))
    return out


def map_inputs(api, records, mode, chunk=4096):
    """What each map task writes: KVBatches of `chunk` records of the
    package (values as 8-byte longs), or (key, value) pairs."""
    out = []
    for kb, ko, vals in records:
        n = len(vals)
        if mode == "records":
            out.append([(kb[ko[i]:ko[i + 1]].tobytes(), int(vals[i]))
                        for i in range(n)])
            continue
        vb = encode_longs_be(vals)
        batches = []
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            batches.append(api.KVBatch(
                kb[ko[s]:ko[e]].copy(), ko[s:e + 1] - ko[s],
                vb[8 * s:8 * e].copy(), np.arange(e - s + 1,
                                                  dtype=np.int64) * 8))
        out.append(batches)
    return out


def registered_runs(api, umb, partitions):
    """Each map's registered runs, per (path, spill id), partition by
    partition as arrays."""
    out = {}
    for _src, _v, ev in umb.log:
        p = ev.user_payload
        parts = api.service.fetch_partition_range(p.path_component,
                                                  p.spill_id, 0, partitions)
        out[(p.path_component, p.spill_id)] = [
            (b.key_bytes.tobytes(), b.key_offsets.tobytes(),
             b.val_bytes.tobytes()) for b in parts]
    return out


def event_fields(umb):
    """The maps' events as comparable fields, in routing order."""
    out = []
    for src, version, ev in umb.log:
        p = ev.user_payload
        out.append((src, version, type(ev).__name__, ev.source_index_start,
                    ev.count, p.host, p.port, p.path_component, p.spill_id,
                    p.empty_partitions, p.last_event))
    return out, sorted(umb.vm_payloads, key=lambda e: e[0])


def untimed(counters):
    """Every counter but the times, the process's memory and the latency
    histograms."""
    skip = ("MILLI", "_TIME", "MEMORY", "HEAP")
    return {g: {c: v for c, v in cs.items() if not any(s in c for s in skip)}
            for g, cs in counters.to_dict().items()
            if not g.startswith("LatencyHistogram")}


def run_case(tmp_path, root, case, seed=0, **kw):
    """One package through the case's edge: the EdgeRun, the maps' runs
    and events as the reducers saw them."""
    conf_of, map_mode, reduce_mode, mixed = CASES[case]
    api = chip_smoke.task_api(root, device="cpu" if root == ROOTS[0]
                              else None)
    records = word_records(seed, mixed=mixed)
    seen = {}

    def keep_runs(umb):
        seen["runs"] = registered_runs(api, umb, REDUCERS)
    run = chip_smoke.run_edge(
        api, dict(BASE_CONF, **conf_of(root)), map_inputs(api, records,
                                                          map_mode),
        REDUCERS, str(tmp_path / root), map_payload={"mode": map_mode},
        reduce_payload={"mode": reduce_mode}, concurrent=False,
        on_maps_done=keep_runs, **kw)
    return api, run, seen.get("runs")


def states(run):
    return sorted(run.umbilical.states.values())


def assert_same_edge(runs):
    (tapi, t, truns), (japi, j, jruns) = runs[ROOTS[0]], runs[ROOTS[1]]
    assert states(t) == states(j) == ["SUCCEEDED"] * (MAPS + REDUCERS), \
        (t.umbilical.diagnostics, j.umbilical.diagnostics)
    assert truns == jruns
    assert event_fields(t.umbilical) == event_fields(j.umbilical)
    assert [untimed(c) for c in t.counters("maps")] == \
        [untimed(c) for c in j.counters("maps")]
    assert [untimed(c) for c in t.counters("reducers")] == \
        [untimed(c) for c in j.counters("reducers")]
    tres, jres = t.results(), j.results()
    assert len(tres) == REDUCERS
    for a, b in zip(tres, jres):
        if isinstance(a, list) and a and isinstance(a[0], tuple) and \
                len(a[0]) == 5:
            a, b = ([tuple(x.tobytes() for x in blk) for blk in r]
                    for r in (a, b))
        assert a == b


@pytest.mark.parametrize("case", list(CASES))
def test_edge_matches_tez_tpu(tmp_path, case):
    runs = {root: run_case(tmp_path, root, case) for root in ROOTS}
    assert_same_edge(runs)
    api, run, _ = runs[ROOTS[0]]
    TC = api.TaskCounter
    red = run.counters("reducers")
    written = sum(c.find_counter(TC.OUTPUT_RECORDS).value
                  for c in run.counters("maps"))
    assert written == MAPS * 60_000
    if "pipelined" in case:
        assert all(ev.user_payload.spill_id >= 0
                   for _s, _v, ev in run.umbilical.log)
    if "over_budget" in case:
        # the partition went to disk (the DISK target or a mem-to-disk
        # merge) and the reader streamed it
        assert any(c.find_counter(TC.SHUFFLE_BYTES_TO_DISK).value +
                   c.find_counter(TC.ADDITIONAL_SPILLS_BYTES_WRITTEN).value
                   > 0 for c in red)
        if CASES[case][2] == "blocks":
            assert any(len(blocks) > 1 for blocks in run.results())


def test_input_failed_event_resets_a_slot(tmp_path):
    """Reducer 0's first delivery also carries an InputFailedEvent for
    slot 0 after map 0's event, then map 0's event again from its next
    attempt: the slot is reset (its committed batch dropped from the merge
    manager) and fetched again, and every output, counter and stream
    equals tez_tpu's."""
    import dataclasses

    def rewrite_for(api):
        def rewrite(dest, events):
            if dest != 0:
                return events
            first = events[0]
            assert first.target_index_start == 0
            return [first, api.events.InputFailedEvent(target_index=0,
                                                       version=0),
                    dataclasses.replace(first, version=1)] + events[1:]
        return rewrite
    runs = {}
    for root in ROOTS:
        api = chip_smoke.task_api(root, device="cpu" if root == ROOTS[0]
                                  else None)
        runs[root] = run_case(tmp_path, root, "plain",
                              rewrite=rewrite_for(api))
    assert_same_edge(runs)
    plain = run_case(tmp_path / "plain", ROOTS[0], "plain")[1]
    got = runs[ROOTS[0]][1]
    assert [tuple(x.tobytes() for x in blk) for blk in got.results()[0]] == \
        [tuple(x.tobytes() for x in blk) for blk in plain.results()[0]]
    TC = runs[ROOTS[0]][0].TaskCounter
    fetched = got.counters("reducers")[0].find_counter(
        TC.NUM_SHUFFLED_INPUTS).value
    assert fetched == MAPS + 1


def test_task_phase_on_the_host():
    """chip_smoke's phase 10 at TINY_TASKS with the plain versions: 4 maps
    and 4 reducers, each wave concurrent, legs A-C each equal to the
    numpy golden and to each other, with the phase's counter checks."""
    import types
    launches = chip_smoke.task_phase(types.SimpleNamespace(seed=4),
                                     device="cpu", **chip_smoke.TINY_TASKS)
    assert launches == {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                        "merge_rank": 0, "merge_path_pair": 0}
