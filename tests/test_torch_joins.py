"""Port parity of the join examples, the custom edges and the example
driver (tez_tpu_torch/examples/{sort_merge_join,hash_join,
cartesian_product,driver}.py, tez_tpu_torch/library/{cartesian_product,
fair_shuffle}.py) against tez_tpu's, on the CPU: tez_tpu on JAX's CPU
backend, the port with device="cpu".

The same seeded input files go through both packages and everything
compared is bytes or integers, so equality is exact: the examples' part
files byte for byte and their DAG plans with the package prefix mapped
(no descriptor of the port naming a tez_tpu class), the cartesian
combination math, the fair-shuffle slicing on seeded and generated
totals, the fair-shuffle vertex manager's decisions over a stub context
(tests/test_custom_edges.py's cases), and the fair-shuffle DAGs of
tests/test_custom_edges.py (the hot partition split, two sources) with
their counts and task totals.  examples/driver.py: its usage, an
unknown program and one program run with --device cpu; without a card
every example's run() at its default device raises.
"""
import collections
import importlib
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from test_torch_query import names_tez_tpu, plan_tree
from tez_tpu.library.processors import SimpleProcessor as JaxSimpleProcessor
from tez_tpu_torch.library.processors import \
    SimpleProcessor as PortSimpleProcessor

ROOTS = ("tez_tpu_torch", "tez_tpu")
PORT = ROOTS[0]


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _fresh_planes():
    def reset():
        for root in ROOTS:
            mod(root, "store").reset_store()
            mod(root, "common.epoch").reset()
            mod(root, "common.faults").clear_all()
            mod(root, "ops.async_stage").reset_process_breaker()
    reset()
    yield
    reset()


def client(root, tmp_path, name="t"):
    conf = {"tez.staging-dir": str(tmp_path / root / "staging"),
            "tez.am.local.num-containers": 4}
    kw = {"device": "cpu"} if root == PORT else {}
    return mod(root, "client.tez_client").TezClient.create(
        name, conf, **kw).start()


def run_kw(root, tmp_path, **kw):
    """Keyword arguments of an example's run() for one package."""
    kw["conf"] = {"tez.staging-dir": str(tmp_path / root / "staging"),
                  **kw.get("conf", {})}
    if root == PORT:
        kw["device"] = "cpu"
    return kw


def part_files(out_dir: str) -> dict:
    assert os.path.exists(os.path.join(out_dir, "_SUCCESS")), out_dir
    return {f: open(os.path.join(out_dir, f), "rb").read()
            for f in sorted(os.listdir(out_dir)) if f.startswith("part-")}


def check_plans(dags: dict) -> None:
    """Both packages' DAGs plan alike, and the port's names no tez_tpu
    module."""
    plans = {root: dag.create_dag_plan() for root, dag in dags.items()}
    assert plan_tree(plans[PORT]) == plan_tree(plans["tez_tpu"])
    assert names_tez_tpu(plans[PORT]) == []


def zipf_words(rng, n: int, vocab: int, lines: int) -> str:
    ids = rng.zipf(1.3, n) % vocab
    words = [f"w{i:05d}" for i in ids]
    return "\n".join(" ".join(words[i::lines]) for i in range(lines)) + "\n"


# -- SortMergeJoin (BASELINE config 3) ----------------------------------------
SMJ_CASES = {
    "ranges": dict(kw=dict(num_joiners=2, side_parallelism=2)),
    "zipf": dict(n=20_000, vocab=4_000, lines=40,
                 kw=dict(num_joiners=2, side_parallelism=2)),
    "zipf_spans": dict(n=60_000, vocab=30_000, lines=60,
                       kw=dict(num_joiners=3, side_parallelism=3,
                               conf={"tez.runtime.io.sort.mb": 1})),
}


def smj_inputs(tmp_path, case: str) -> tuple:
    left, right = tmp_path / "l.txt", tmp_path / "r.txt"
    c = SMJ_CASES[case]
    if case == "ranges":
        left.write_text("\n".join(f"k{i:03d}" for i in range(0, 200, 2))
                        + "\n")
        right.write_text("\n".join(f"k{i:03d}" for i in range(0, 200, 3))
                         + "\n")
    else:
        rng = np.random.default_rng(len(case))
        left.write_text(zipf_words(rng, c["n"], c["vocab"], c["lines"]))
        right.write_text(zipf_words(rng, c["n"], c["vocab"], c["lines"]))
    return str(left), str(right)


@pytest.mark.parametrize("case", sorted(SMJ_CASES))
def test_sort_merge_join_matches_tez_tpu(tmp_path, case):
    """One (word, "1") record per distinct word on both sides, the part
    files byte-identical to tez_tpu's; the planned DAGs alike."""
    left, right = smj_inputs(tmp_path, case)
    kw = SMJ_CASES[case]["kw"]
    parts = {}
    for root in ROOTS:
        out = str(tmp_path / root / "out")
        state = mod(root, "examples.sort_merge_join").run(
            [left], [right], out, **run_kw(root, tmp_path, **kw))
        assert state == "SUCCEEDED", root
        parts[root] = part_files(out)
    assert parts[PORT] == parts["tez_tpu"]
    got = sorted(line.split(b"\t")[0] for data in parts[PORT].values()
                 for line in data.splitlines())
    both = set(open(left).read().split()) & set(open(right).read().split())
    assert got == sorted(w.encode() for w in both)
    assert len(parts[PORT]) == kw["num_joiners"]
    check_plans({root: mod(root, "examples.sort_merge_join").build_dag(
        [left], [right], str(tmp_path / "plan"), **kw) for root in ROOTS})


# -- HashJoin (BASELINE config 5) ---------------------------------------------
HASH_CASES = {"ranges": dict(num_joiners=2),
              "zipf": dict(num_joiners=3)}


@pytest.mark.parametrize("case", sorted(HASH_CASES))
def test_hash_join_matches_tez_tpu(tmp_path, case):
    """One (word, "1") record per stream occurrence whose word is on the
    hash side, the part files byte-identical to tez_tpu's."""
    stream, hashf = tmp_path / "stream.txt", tmp_path / "hash.txt"
    if case == "ranges":
        stream.write_text("\n".join(f"item{i:03d}" for i in range(300))
                          + "\n")
        hashf.write_text("\n".join(f"item{i:03d}"
                                   for i in range(0, 300, 7)) + "\n")
    else:
        rng = np.random.default_rng(7)
        ids = rng.zipf(1.3, 30_000) % 5_000
        stream.write_text("".join(f"w{i:05d}\n" for i in ids))
        keep = rng.choice(5_000, 400, replace=False)
        hashf.write_text("".join(f"w{i:05d}\n" for i in keep))
    kw = HASH_CASES[case]
    parts = {}
    for root in ROOTS:
        out = str(tmp_path / root / "out")
        state = mod(root, "examples.hash_join").run(
            [str(stream)], [str(hashf)], out,
            **run_kw(root, tmp_path, **kw))
        assert state == "SUCCEEDED", root
        parts[root] = part_files(out)
    assert parts[PORT] == parts["tez_tpu"]
    side = set(hashf.read_text().split())
    golden = collections.Counter(w for w in stream.read_text().split()
                                 if w in side)
    got = collections.Counter()
    for data in parts[PORT].values():
        for line in data.splitlines():
            word, one = line.split(b"\t")
            assert one == b"1"
            got[word.decode()] += 1
    assert got == golden
    check_plans({root: mod(root, "examples.hash_join").build_dag(
        [str(stream)], [str(hashf)], str(tmp_path / "plan"), **kw)
        for root in ROOTS})


# -- CartesianProduct ---------------------------------------------------------
@pytest.mark.parametrize("sizes", [(3, 4), (17, 40)])
def test_cartesian_product_matches_tez_tpu(tmp_path, sizes):
    """Every (left, right) token pair, the part files byte-identical to
    tez_tpu's."""
    left, right = tmp_path / "l.txt", tmp_path / "r.txt"
    left.write_text(" ".join(f"a{i}" for i in range(sizes[0])) + "\n")
    right.write_text("\n".join(f"b{i}" for i in range(sizes[1])) + "\n")
    parts = {}
    for root in ROOTS:
        out = str(tmp_path / root / "out")
        state = mod(root, "examples.cartesian_product").run(
            str(left), [str(right)], out, **run_kw(root, tmp_path))
        assert state == "SUCCEEDED", root
        parts[root] = part_files(out)
    assert parts[PORT] == parts["tez_tpu"]
    pairs = [line.split(b"\t")[0] for data in parts[PORT].values()
             for line in data.splitlines()]
    assert sorted(pairs) == sorted(f"a{i}|b{j}".encode()
                                   for i in range(sizes[0])
                                   for j in range(sizes[1]))
    check_plans({root: mod(root, "examples.cartesian_product").build_dag(
        str(left), str(right), str(tmp_path / "plan")) for root in ROOTS})


def test_combination_math_matches_tez_tpu():
    got = {}
    for root in ROOTS:
        C = mod(root, "library.cartesian_product").CartesianProductCombination
        c = C([2, 3])
        assert c.total == 6 and c.dests_for(0, 1) == [3, 4, 5]
        got[root] = [(C(n).total, [[C(n).coordinate(d, p)
                                    for p in range(len(n))]
                                   for d in range(C(n).total)],
                      [C(n).dests_for(p, 0) for p in range(len(n))])
                     for n in ([2, 3], [1], [4, 1, 3], [2, 2, 2, 2])]
    assert got[PORT] == got["tez_tpu"]


# -- fair shuffle: the slicing ------------------------------------------------
def slicing(root, totals, num_sources, size, max_tasks):
    fs = mod(root, "library.fair_shuffle")
    return (fs.compute_fair_slices(totals, size, max_tasks, num_sources),
            fs.compute_fair_mappings(totals, num_sources, size, max_tasks),
            [fs.source_range(i, n, num_sources)
             for n in range(1, 6) for i in range(n)])


@pytest.mark.parametrize("seed", range(6))
def test_fair_slicing_matches_tez_tpu(seed):
    """Seeded skewed partition totals: the slices, the mappings and the
    source ranges equal tez_tpu's, and each partition's ranges tile the
    sources."""
    rng = np.random.default_rng(seed)
    parts = int(rng.integers(1, 12))
    totals = (rng.zipf(1.5, parts) * rng.integers(10, 400)).tolist()
    sources = int(rng.integers(1, 9))
    size = int(rng.integers(50, 2000))
    cap = int(rng.choice([0, parts, parts + 3, 2 * parts]))
    got = slicing(PORT, totals, sources, size, cap)
    assert got == slicing("tez_tpu", totals, sources, size, cap)
    for p in range(parts):
        ranges = sorted((lo, hi) for q, lo, hi in got[1] if q == p)
        assert ranges[0][0] == 0 and ranges[-1][1] == sources
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_fair_mapping_splits_skew_matches_tez_tpu():
    """tests/test_custom_edges.py's case: partition 1, ten times the
    others, splits into ceil(1000/300) = 4 slices over 4 sources."""
    got = slicing(PORT, [100, 1000, 50], 4, 300, 0)
    assert got == slicing("tez_tpu", [100, 1000, 50], 4, 300, 0)
    parts = collections.Counter(p for p, _, _ in got[1])
    assert (parts[0], parts[1], parts[2]) == (1, 4, 1)


@settings(max_examples=60, deadline=None)
@given(totals=st.lists(st.integers(0, 5000), min_size=1, max_size=10),
       sources=st.integers(1, 8), size=st.integers(1, 3000),
       cap=st.integers(0, 24))
def test_fair_slicing_generated_matches_tez_tpu(totals, sources, size, cap):
    assert slicing(PORT, totals, sources, size, cap) == \
        slicing("tez_tpu", totals, sources, size, cap)


# -- fair shuffle: the vertex manager's decisions -----------------------------
class FakeVMContext:
    """A VertexManagerPluginContext stub (tests/test_custom_edges.py's)
    over one package's UserPayload."""

    def __init__(self, root, payload, in_edges, num_tasks):
        self._payload = mod(root, "common.payload").UserPayload.of(payload)
        self._in_edges = in_edges
        self._num_tasks = dict(num_tasks)
        self.vertex_name = "consumer"
        self.scheduled = []
        self.reconfigured = None

    @property
    def user_payload(self):
        return self._payload

    def get_vertex_num_tasks(self, name):
        return self._num_tasks[name]

    def get_input_vertex_edge_properties(self):
        return dict(self._in_edges)

    def get_output_vertex_edge_properties(self):
        return {}

    def get_input_vertex_groups(self):
        return {}

    def schedule_tasks(self, requests):
        self.scheduled.extend(r.task_index for r in requests)

    def reconfigure_vertex(self, parallelism, source_edge_properties=None,
                           **_kw):
        self.reconfigured = (parallelism, source_edge_properties)
        self._num_tasks[self.vertex_name] = parallelism

    def vertex_reconfiguration_planned(self):
        pass

    def vertex_reconfiguration_restored(self):
        return False

    def done_reconfiguring_vertex(self):
        pass

    def register_for_vertex_state_updates(self, vertex_name, states):
        pass


def edge_prop(root, kind: str):
    ep = mod(root, "dag.edge_property")
    payload = mod(root, "common.payload")
    if kind == "sg":
        kv = {"tez.runtime.key.class": "bytes",
              "tez.runtime.value.class": "long"}
        return ep.EdgeProperty.create(
            ep.DataMovementType.SCATTER_GATHER, ep.DataSourceType.PERSISTED,
            ep.SchedulingType.SEQUENTIAL,
            payload.OutputDescriptor.create(
                f"{root}.library.outputs:OrderedPartitionedKVOutput",
                payload=kv),
            payload.InputDescriptor.create(
                f"{root}.library.inputs:OrderedGroupedKVInput", payload=kv))
    kv = {"tez.runtime.key.class": "bytes",
          "tez.runtime.value.class": "bytes"}
    return ep.EdgeProperty.create(
        ep.DataMovementType.BROADCAST, ep.DataSourceType.PERSISTED,
        ep.SchedulingType.SEQUENTIAL,
        payload.OutputDescriptor.create(
            f"{root}.library.unordered:UnorderedKVOutput", payload=kv),
        payload.InputDescriptor.create(
            f"{root}.library.unordered:UnorderedKVInput", payload=kv))


def vm_event(root, vec, vertex, task):
    class _Att:
        class task_id:
            id = task
        vertex_id = vertex
    ev = mod(root, "api.events").VertexManagerEvent(
        "consumer", {"partition_sizes": vec, "output_size": sum(vec)})
    ev.producer_attempt = _Att()
    ev.producer_vertex_name = vertex
    return ev


def reconfigured_view(ctx):
    if ctx.reconfigured is None:
        return None
    n, props = ctx.reconfigured
    return n, {name: plan_tree(p) for name, p in sorted(props.items())}


def broadcast_case(root):
    """A finished broadcast side-input does not count toward the split
    decision's completion fraction; the skewed SG source then splits."""
    tai = mod(root, "api.vertex_manager").TaskAttemptIdentifier
    ctx = FakeVMContext(root, {"desired_task_input_size": 100,
                               "min_fraction": 1.0, "max_fraction": 1.0},
                        {"sg": edge_prop(root, "sg"),
                         "bc": edge_prop(root, "bc")},
                        {"sg": 4, "bc": 4, "consumer": 2})
    vm = mod(root, "library.fair_shuffle").FairShuffleVertexManager(ctx)
    vm.initialize()
    vm.on_vertex_started([])
    for i in range(4):
        vm.on_source_task_completed(tai("bc", i, 0))
    early = vm._parallelism_determined
    for i in range(4):
        vm.on_vertex_manager_event_received(vm_event(root, [400, 10], "sg",
                                                     i))
        vm.on_source_task_completed(tai("sg", i, 0))
    return early, reconfigured_view(ctx), sorted(ctx.scheduled)


def unreported_case(root):
    """An SG source with no stats yet is projected at the observed
    per-task average, so the split happens with both edges ranged."""
    tai = mod(root, "api.vertex_manager").TaskAttemptIdentifier
    ctx = FakeVMContext(root, {"desired_task_input_size": 1500,
                               "min_fraction": 0.5, "max_fraction": 0.5},
                        {"a": edge_prop(root, "sg"),
                         "b": edge_prop(root, "sg")},
                        {"a": 3, "b": 2, "consumer": 2})
    vm = mod(root, "library.fair_shuffle").FairShuffleVertexManager(ctx)
    vm.initialize()
    vm.on_vertex_started([])
    for i in range(3):
        vm.on_vertex_manager_event_received(vm_event(root, [400, 10], "a",
                                                     i))
        vm.on_source_task_completed(tai("a", i, 0))
    return vm._parallelism_determined, reconfigured_view(ctx), \
        sorted(ctx.scheduled)


@pytest.mark.parametrize("case", [broadcast_case, unreported_case],
                         ids=["broadcast_fraction", "unreported_source"])
def test_fair_shuffle_vertex_manager_matches_tez_tpu(case):
    got = case(PORT)
    assert got == case("tez_tpu")
    n, props = got[1]
    assert n > 2
    for prop in props.values():
        assert prop["edge_manager_descriptor"]["class_name"] == \
            "tez_tpu.library.fair_shuffle:FairShuffleEdgeManager"


# -- fair shuffle: the DAGs of tests/test_custom_edges.py ---------------------
class SkewedEmitterRun:
    """tests/test_custom_edges.py's SkewedEmitter: one hot key heavily
    and a few cold keys (payload: n_hot)."""

    def run(self, inputs, outputs):
        payload = self.context.user_payload.load() or {}
        w = outputs["sum"].get_writer()
        for _ in range(payload.get("n_hot", 200)):
            w.write(b"hotkey", 1)
        for i in range(10):
            w.write(f"cold{i}".encode(), 1)


class TwoInputSummerRun:
    """tests/test_custom_edges.py's TwoInputSummer: the grouped counts of
    both source edges summed into a file per task."""

    def run(self, inputs, outputs):
        payload = self.context.user_payload.load() or {}
        totals = collections.Counter()
        for name in ("a", "b"):
            for k, vs in inputs[name].get_reader():
                totals[k] += sum(vs)
        path = os.path.join(payload["out_dir"],
                            f"part-{self.context.task_index}")
        with open(path, "w") as fh:
            for k, v in sorted(totals.items()):
                fh.write(f"{k.decode()}\t{v}\n")


class PortSkewedEmitter(SkewedEmitterRun, PortSimpleProcessor):
    pass


class PortTwoInputSummer(TwoInputSummerRun, PortSimpleProcessor):
    pass


class JaxSkewedEmitter(SkewedEmitterRun, JaxSimpleProcessor):
    pass


class JaxTwoInputSummer(TwoInputSummerRun, JaxSimpleProcessor):
    pass


PROCESSORS = {PORT: (PortSkewedEmitter, PortTwoInputSummer),
              "tez_tpu": (JaxSkewedEmitter, JaxTwoInputSummer)}


def test_fair_shuffle_multi_source_matches_tez_tpu(tmp_path):
    """Two scatter-gather sources of 3 and 2 tasks into one fair-shuffle
    consumer: the hot partition split with per-edge source ranges, the
    sums right, each task's file and the task total equal tez_tpu's."""
    seen = {}
    for root in ROOTS:
        payload = mod(root, "common.payload")
        dag_mod = mod(root, "dag.dag")
        emitter, summer = PROCESSORS[root]
        out_dir = str(tmp_path / root / "out")
        os.makedirs(out_dir)
        a = dag_mod.Vertex.create("a", payload.ProcessorDescriptor.create(
            emitter, payload={"n_hot": 300}), 3)
        b = dag_mod.Vertex.create("b", payload.ProcessorDescriptor.create(
            emitter, payload={"n_hot": 200}), 2)
        consumer = dag_mod.Vertex.create(
            "sum", payload.ProcessorDescriptor.create(
                summer, payload={"out_dir": out_dir}), 2)
        consumer.set_vertex_manager_plugin(
            payload.VertexManagerPluginDescriptor.create(
                f"{root}.library.fair_shuffle:FairShuffleVertexManager",
                payload={"desired_task_input_size": 512,
                         "min_fraction": 1.0, "max_fraction": 1.0}))
        dag = dag_mod.DAG.create("fair_multi").add_vertex(a).add_vertex(b) \
            .add_vertex(consumer)
        dag.add_edge(dag_mod.Edge.create(a, consumer, edge_prop(root, "sg")))
        dag.add_edge(dag_mod.Edge.create(b, consumer, edge_prop(root, "sg")))
        c = client(root, tmp_path)
        try:
            status = c.submit_dag(dag).wait_for_completion(timeout=60)
        finally:
            c.stop()
        assert status.state.name == "SUCCEEDED", root
        files = {f: open(os.path.join(out_dir, f)).read()
                 for f in sorted(os.listdir(out_dir))}
        got = collections.Counter()
        for text in files.values():
            for line in text.splitlines():
                k, v = line.split("\t")
                got[k] += int(v)
        want = collections.Counter({"hotkey": 3 * 300 + 2 * 200})
        for i in range(10):
            want[f"cold{i}"] = 5
        assert got == want, root
        total = status.vertex_status["sum"].progress.total_task_count
        assert total > 2, root
        seen[root] = (files, total)
    assert seen[PORT] == seen["tez_tpu"]


def test_fair_shuffle_splits_hot_partition_matches_tez_tpu(tmp_path):
    """OrderedWordCount without the combiner, FairShuffleVertexManager on
    the summation (4 tokenizers, 4 summations): the hot partition split,
    more summation tasks than declared, the counts a Counter golden's and
    the part files and task total tez_tpu's."""
    corpus = tmp_path / "in.txt"
    with open(corpus, "w") as fh:
        for i in range(3000):
            fh.write("hotkey filler%d\n" % (i % 7))
    golden = collections.Counter(open(corpus).read().split())
    seen = {}
    for root in ROOTS:
        out = str(tmp_path / root / "out")
        dag = mod(root, "examples.ordered_wordcount").build_dag(
            [str(corpus)], out, tokenizer_parallelism=4,
            summation_parallelism=4, combine=False)
        dag.vertices["summation"].set_vertex_manager_plugin(
            mod(root, "common.payload").VertexManagerPluginDescriptor
            .create(f"{root}.library.fair_shuffle:FairShuffleVertexManager",
                    payload={"desired_task_input_size": 4096,
                             "min_fraction": 0.9, "max_fraction": 0.9}))
        c = client(root, tmp_path)
        try:
            status = c.submit_dag(dag).wait_for_completion(timeout=60)
        finally:
            c.stop()
        assert status.state.name == "SUCCEEDED", root
        parts = part_files(out)
        got = collections.Counter()
        for data in parts.values():
            for line in data.splitlines():
                w, n = line.split(b"\t")
                got[w.decode()] += int(n)
        assert got == golden, root
        total = status.vertex_status["summation"].progress.total_task_count
        assert total > 4, root
        seen[root] = (parts, total)
    assert seen[PORT] == seen["tez_tpu"]


# -- the driver ---------------------------------------------------------------
def test_driver_usage_and_unknown_program(capsys):
    from tez_tpu_torch.examples import driver
    assert driver.main([]) == 2
    usage = capsys.readouterr().out
    for name in ("wordcount", "orderedwordcount", "mrr", "sortmergejoin",
                 "hashjoin", "cartesianproduct", "simplesessionexample"):
        assert name in usage
    assert "--device" in usage
    assert driver.main(["--help"]) == 0
    assert driver.main(["nosuchprogram", "a", "b"]) == 2
    assert driver.main(["--device", "cpu", "hashjoin", "only_one"]) == 2
    assert "usage: tez-examples hashjoin" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        driver.main(["--device"])


def test_driver_dispatches_on_the_cpu(tmp_path, monkeypatch, capsys):
    """`driver --device cpu sortmergejoin L R OUT` runs the port's example
    on the CPU; its part files equal those of tez_tpu's
    examples/driver.py."""
    left, right = smj_inputs(tmp_path, "zipf")
    monkeypatch.chdir(tmp_path)
    parts = {}
    for root in ROOTS:
        out = str(tmp_path / root / "out")
        argv = ["sortmergejoin", left, right, out]
        if root == PORT:
            assert mod(root, "examples.driver").main(
                ["--device", "cpu"] + argv) == 0
        else:
            monkeypatch.setattr("sys.argv", ["tez-examples"] + argv)
            assert mod(root, "examples.driver").main() == 0
        assert capsys.readouterr().out.strip().endswith("SUCCEEDED")
        parts[root] = part_files(out)
    assert parts[PORT] == parts["tez_tpu"]


# -- no card ------------------------------------------------------------------
@pytest.mark.parametrize("example", ["sort_merge_join", "hash_join",
                                     "cartesian_product", "driver"])
def test_examples_default_device_needs_a_card(tmp_path, example):
    """Each example runs on the card by default: without one it raises
    before any task runs, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    f = tmp_path / "in.txt"
    f.write_text("a b\n")
    out = str(tmp_path / "out")
    m = mod(PORT, f"examples.{example}")
    with pytest.raises(RuntimeError):
        if example == "driver":
            m.main(["hashjoin", str(f), str(f), out])
        else:
            m.run([str(f)], [str(f)], out,
                  conf={"tez.staging-dir": str(tmp_path / "s")})
    assert not os.path.exists(out)


# -- chip_smoke's phase 18 at a tiny size -------------------------------------
def test_query_phase_on_the_host():
    """Phase 18's legs A-D at TINY_QUERY on the CPU: every check of the
    card run but the launch counts (the plain versions launch nothing)."""
    import types
    import chip_smoke
    out = chip_smoke.query_phase(types.SimpleNamespace(seed=0),
                                 device="cpu", **chip_smoke.TINY_QUERY)
    assert sorted(out["legs"]) == ["A", "B", "C", "D"]
    assert sum(out["launches"].values()) == 0
