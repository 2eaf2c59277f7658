"""Port parity of the canned DAG shapes and the test doubles
(tez_tpu_torch/models/shapes.py, tez_tpu_torch/library/test_components.py)
against tez_tpu's, on the CPU: tez_tpu on JAX's CPU backend, the port with
device="cpu".

Every case of tests/test_model_shapes.py runs on the port with the same
checks.  Each shape's DAG plan equals tez_tpu's with the package prefix
mapped (no descriptor naming a tez_tpu class); chip_smoke's SHAPE_RUNS go
through one session of each package and end in the same states with the
same DAG counters (attempts launched, succeeded, failed, killed).  The
doubles: TestInput's and TestOutput's failures fail a DAG in both, and a
sorted edge whose input is FlakyFetchOrderedInput reruns a producer and
gives the clean run's part files in both.
"""
import importlib

import pytest

import chip_smoke
from test_torch_query import names_tez_tpu, plan_tree

ROOTS = ("tez_tpu_torch", "tez_tpu")
PORT = ROOTS[0]
BUILDERS = ("simple_dag", "simple_dag_3_vertices", "simple_v_dag",
            "simple_reverse_v_dag", "two_levels_failing_dag",
            "three_levels_failing_dag", "multi_attempt_dag")


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _fresh_planes():
    def reset():
        for root in ROOTS:
            mod(root, "store").reset_store()
            mod(root, "common.epoch").reset()
            mod(root, "common.faults").clear_all()
    reset()
    yield
    reset()


def client(root, tmp_path):
    kw = {"device": "cpu"} if root == PORT else {}
    return mod(root, "client.tez_client").TezClient.create(
        "shapes", {"tez.staging-dir": str(tmp_path / root / "staging"),
                   "tez.am.local.num-containers": 4}, **kw).start()


def diamond(root):
    shapes = mod(root, "models.shapes")
    return (shapes.ShapeBuilder("diamond", payload={"do_fail": True})
            .vertex("a", 2).vertex("b", 3).vertex("c", 3).vertex("d", 2)
            .edge("a", "b").edge("a", "c")
            .edge("b", "d").edge("c", "d").build())


@pytest.mark.parametrize("builder", BUILDERS + ("diamond",))
def test_shape_plans_match_tez_tpu(builder):
    """tests/test_model_shapes.py::test_shapes_verify on the port (each
    plan verifies), and each plan equal to tez_tpu's."""
    trees = {}
    for root in ROOTS:
        dag = diamond(root) if builder == "diamond" else \
            getattr(mod(root, "models.shapes"), builder)()
        plan = dag.create_dag_plan()   # runs verify()
        trees[root] = plan_tree(plan)
        if root == PORT:
            assert names_tez_tpu(plan) == []
    assert trees[PORT] == trees["tez_tpu"]


def test_models_package_exports_shapes():
    assert mod(PORT, "models").__all__ == mod("tez_tpu", "models").__all__
    assert mod(PORT, "models").shapes is mod(PORT, "models.shapes")


def test_three_levels_shape_runs(tmp_path):
    for root in ROOTS:
        c = client(root, tmp_path)
        try:
            status = c.submit_dag(mod(root, "models.shapes")
                                  .three_levels_failing_dag(payload={}))\
                .wait_for_completion(timeout=120)
        finally:
            c.stop()
        assert status.state.name == "SUCCEEDED", root


def test_multi_attempt_dag_retries_then_succeeds(tmp_path):
    launched = {}
    for root in ROOTS:
        c = client(root, tmp_path)
        try:
            status = c.submit_dag(mod(root, "models.shapes")
                                  .multi_attempt_dag(failing_upto_attempt=1))\
                .wait_for_completion(timeout=120)
            d = c.framework_client.am.dag_counters.to_dict()\
                .get("DAGCounter", {})
        finally:
            c.stop()
        assert status.state.name == "SUCCEEDED", root
        assert d.get("TOTAL_LAUNCHED_TASKS", 0) >= 6
        launched[root] = (d.get("TOTAL_LAUNCHED_TASKS"),
                          d.get("NUM_SUCCEEDED_TASKS"))
    assert launched[PORT] == launched["tez_tpu"]


def test_failing_shape_fails(tmp_path):
    for root in ROOTS:
        c = client(root, tmp_path)
        try:
            dag = mod(root, "models.shapes").simple_dag(
                payload={"do_fail": True, "failing_task_indices": [-1]})
            status = c.submit_dag(dag).wait_for_completion(timeout=120)
        finally:
            c.stop()
        assert status.state.name == "FAILED", root


def test_shape_runs_match_tez_tpu(tmp_path):
    """chip_smoke's SHAPE_RUNS (phase 21 C) through one session of each
    package: the same final states, each the expected one, and the same
    DAG counters for the DAGs that succeed."""
    runs = {root: chip_smoke.run_shapes(
        root, str(tmp_path / root), device="cpu" if root == PORT else None)
        for root in ROOTS}
    assert [(n, s) for n, s, _c in runs[PORT]] == \
        [(n, s) for n, s, _c in runs["tez_tpu"]] == \
        [(n, want) for n, _kw, want in chip_smoke.SHAPE_RUNS]
    for (name, state, mine), (_n, _s, theirs) in zip(runs[PORT],
                                                     runs["tez_tpu"]):
        if state == "SUCCEEDED":
            assert mine == theirs, name
    multi = [c for n, _s, c in runs[PORT] if n == "multi_attempt_dag"][0]
    assert multi["TOTAL_LAUNCHED_TASKS"] >= 6
    assert multi["NUM_SUCCEEDED_TASKS"] == 3


def doubles_dag(root, input_payload, output_payload):
    """v1 -> v2 over an edge of TestOutput and TestInput, each with its own
    payload."""
    payload, dag, prop = (mod(root, n) for n in (
        "common.payload", "dag.dag", "dag.edge_property"))
    doubles = f"{root}.library.test_components:"
    v1, v2 = (dag.Vertex.create(name, payload.ProcessorDescriptor.create(
        doubles + "TestProcessor", payload={}), 2) for name in ("v1", "v2"))
    edge = prop.EdgeProperty.create(
        prop.DataMovementType.SCATTER_GATHER, prop.DataSourceType.PERSISTED,
        prop.SchedulingType.SEQUENTIAL,
        payload.OutputDescriptor.create(doubles + "TestOutput",
                                        payload=output_payload),
        payload.InputDescriptor.create(doubles + "TestInput",
                                       payload=input_payload))
    return dag.DAG.create("doubles").add_vertex(v1).add_vertex(v2)\
        .add_edge(dag.Edge.create(v1, v2, edge))


FAIL_TASK_1 = {"do_fail": True, "failing_task_indices": [1]}


@pytest.mark.parametrize("input_payload,output_payload,state", [
    ({}, {}, "SUCCEEDED"),
    (FAIL_TASK_1, {}, "FAILED"),
    (dict(FAIL_TASK_1, fatal=True), {}, "FAILED"),
    ({}, FAIL_TASK_1, "FAILED"),
    ({"do_fail": True, "failing_task_indices": [-1],
      "failing_upto_attempt": 0}, {}, "SUCCEEDED"),
])
def test_doubles_match_tez_tpu(tmp_path, input_payload, output_payload,
                               state):
    """TestInput failing at its reader (fatal or not) and TestOutput
    failing at close fail the DAG in both packages; quiet doubles, and a
    reader failing only attempt 0, let it succeed, with the same attempt
    counts (a failing DAG's hang on when its other tasks were killed)."""
    launched = {}
    for root in ROOTS:
        c = client(root, tmp_path)
        try:
            status = c.submit_dag(doubles_dag(
                root, input_payload, output_payload))\
                .wait_for_completion(timeout=120)
            d = c.framework_client.am.dag_counters.to_dict()\
                .get("DAGCounter", {})
        finally:
            c.stop()
        assert status.state.name == state, root
        launched[root] = {k: d.get(k, 0) for k in chip_smoke.SHAPE_COUNTERS}
    if state == "SUCCEEDED":
        assert launched[PORT] == launched["tez_tpu"]


def test_flaky_fetch_reruns_a_producer_as_tez_tpu_does(tmp_path):
    """A sorted TeraSort edge whose input is FlakyFetchOrderedInput (task
    0's first fetch reported failed): a producer reruns in both packages
    (more attempts than the clean run), and the part files equal the
    clean run's and each other's."""
    import numpy as np
    rng = np.random.default_rng(21)
    recs = rng.integers(0, 256, (2000, 100), dtype=np.uint8)
    path = tmp_path / "flaky.bin"
    path.write_bytes(recs.tobytes())
    parts, launched = {}, {}
    for root in ROOTS:
        for run in ("clean", "flaky"):
            out = str(tmp_path / root / run)
            dag = mod(root, "io.mapreduce").simple_mr_dag(
                f"flaky-{run}", [str(path)], out,
                map_fn=chip_smoke.MR_JOBS + "identity_map",
                reduce_fn=chip_smoke.MR_JOBS + "identity_reduce",
                num_mappers=4, num_reducers=4, input_format="fixed",
                format_params={"key_bytes": 10, "value_bytes": 90})
            if run == "flaky":
                chip_smoke.with_flaky_fetch(dag, [0], root)
            c = client(root, tmp_path / run)
            try:
                status = c.submit_dag(dag).wait_for_completion(timeout=120)
                d = c.framework_client.am.dag_counters.to_dict()\
                    .get("DAGCounter", {})
            finally:
                c.stop()
            assert status.state.name == "SUCCEEDED", (root, run)
            parts[root, run] = chip_smoke.part_bytes(out)
            launched[root, run] = d["TOTAL_LAUNCHED_TASKS"]
        assert parts[root, "flaky"] == parts[root, "clean"]
        assert launched[root, "flaky"] > launched[root, "clean"]
    # how many attempts the rerun takes hangs on timing (a consumer
    # holding a lost input may be relaunched too): more than clean in both
    assert parts[PORT, "flaky"] == parts["tez_tpu", "flaky"]
    chip_smoke.check_terasort("flaky", str(tmp_path / PORT / "flaky"),
                              recs, 4)

