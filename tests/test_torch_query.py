"""Port parity of the relational query layer (tez_tpu_torch/query/,
tez_tpu_torch/tools/query_corpus.py) against tez_tpu's, on the CPU:
tez_tpu on JAX's CPU backend, the port with device="cpu".

The same seeded corpus files go through both packages.  The data plane
is all integer and bytes, so the bar is bit-exact with no tolerance:
fingerprints and schemas, the planned DAGs (vertices, parallelism, edge
types and payloads, the package prefix mapped), the strategy decisions,
every CORPUS_QUERIES output under auto and both forced strategies on the
uniform and the Zipf corpus (each also equal to its numpy oracle), and
the session cases of tests/test_query.py (lineage reuse, the replan flip,
the kill storm) run on both.  No planned DAG of the port names a tez_tpu
class.  Without a card, QuerySession() at its default device raises.
"""
import dataclasses
import enum
import importlib
import os
from types import SimpleNamespace

import pytest
import torch

ROOTS = ("tez_tpu_torch", "tez_tpu")
PORT = ROOTS[0]
CONF_BASE = {"tez.am.local.num-containers": 4}
STRATEGIES = ("auto", "broadcast", "repartition")


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _fresh_planes():
    """Both packages' process planes reset around each case
    (tests/conftest.py resets only tez_tpu's)."""
    def reset():
        for root in ROOTS:
            mod(root, "store").reset_store()
            mod(root, "common.epoch").reset()
            mod(root, "common.faults").clear_all()
            mod(root, "ops.async_stage").reset_process_breaker()
    reset()
    yield
    reset()


def corpus_pair(workdir, **kw) -> dict:
    """Each package's corpus generator into a directory of its own (the
    files byte-identical), then each package's Corpus over the port's
    files, so plans, fingerprints and decisions name the same paths."""
    made = {root: mod(root, "tools.query_corpus").generate(
        os.path.join(workdir, root), **kw) for root in ROOTS}
    port = made[PORT]
    for table, path in port.paths.items():
        with open(path, "rb") as a, open(made["tez_tpu"].paths[table],
                                         "rb") as b:
            assert a.read() == b.read(), table
    return {root: mod(root, "tools.query_corpus").Corpus(
        workdir=port.workdir, scale=port.scale, skew=port.skew,
        seed=port.seed, paths=dict(port.paths)) for root in ROOTS}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    return {"uni": corpus_pair(str(tmp_path_factory.mktemp("qc_uni")),
                               scale=0.25, skew=0.0, seed=3),
            "zipf": corpus_pair(str(tmp_path_factory.mktemp("qc_zipf")),
                                scale=0.25, skew=1.2, seed=5)}


def queries(root: str) -> dict:
    return {q.name: q for q in mod(root, "tools.query_corpus").CORPUS_QUERIES}


def session(root, tmp_path, name, extra=None):
    conf = dict(CONF_BASE)
    conf["tez.staging-dir"] = str(tmp_path / root / name / "staging")
    conf.update(extra or {})
    kw = {"device": "cpu"} if root == PORT else {}
    return mod(root, "query").QuerySession(name, conf, **kw)


def events(sess, name: str) -> list:
    kind = getattr(mod(type(sess).__module__.split(".")[0], "am.history")
                   .HistoryEventType, name)
    return [ev for ev in sess._am.logging_service.events
            if ev.event_type is kind]


def plan_tree(obj, mapped: bool = True):
    """A DAG plan as plain Python: dataclasses as dicts, enums by name,
    payloads loaded; with `mapped`, the port's module names as
    tez_tpu's."""
    if dataclasses.is_dataclass(obj):
        if type(obj).__name__ == "UserPayload":
            return plan_tree(obj.load(), mapped)
        return {f.name: plan_tree(getattr(obj, f.name), mapped)
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, dict):
        return {plan_tree(k, mapped): plan_tree(v, mapped)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plan_tree(v, mapped) for v in obj]
    if isinstance(obj, str) and mapped:
        return obj.replace("tez_tpu_torch.", "tez_tpu.")
    return obj


def strings(tree) -> list:
    if isinstance(tree, dict):
        return [s for k, v in tree.items() for s in strings(k) + strings(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in strings(v)]
    return [tree] if isinstance(tree, str) else []


def names_tez_tpu(plan) -> list:
    """Strings of a plan that name a tez_tpu module (not the port's)."""
    return [s for s in strings(plan_tree(plan, mapped=False))
            if "tez_tpu." in s.replace("tez_tpu_torch.", "")]


def tiny_scan(root, tmp_path, name="t", rows=("a|1", "b|2")):
    p = tmp_path / f"{name}.tbl"
    p.write_text("\n".join(rows) + "\n")
    return mod(root, "query").Table.scan(name, [str(p)], ["k", "v"])


# -- logical plans -----------------------------------------------------------
def test_fingerprints_and_schemas_match_tez_tpu(tmp_path, corpora):
    """tests/test_query.py's fingerprint and schema cases on both, and
    every corpus query's plan: each node's fingerprint, schema and label
    equal tez_tpu's."""
    out = {}
    for root in ROOTS:
        left = tiny_scan(root, tmp_path, "l")
        right = mod(root, "query").Table.scan(
            "r", [str(tmp_path / "r.tbl")], ["k", "w"])
        f1 = tiny_scan(root, tmp_path).filter("v", "ge", "1", numeric=True)
        f2 = tiny_scan(root, tmp_path).filter("v", "ge", "1", numeric=True)
        f3 = tiny_scan(root, tmp_path).filter("v", "ge", "2", numeric=True)
        assert f1.plan.fingerprint == f2.plan.fingerprint != \
            f3.plan.fingerprint
        inner = left.join(right, "k")
        tables = [f1, f3, inner, left.join(right, "k", how="semi"),
                  left.join(right, "k", how="semi_distinct"),
                  left.hash_join(right, "k"),
                  left.sort_merge_join(right, "k"),
                  inner.aggregate(["k"], [("n", "count", "k"),
                                          ("s", "sum", "v")]),
                  inner.window("k", "v", func="row_number", out_col="rk"),
                  inner.window("k", "v", func="cume_sum"),
                  inner.limit(5, ["k"]), inner.project(["w", "k"])]
        tables += [q.build(corpora["uni"][root])
                   for q in queries(root).values()]
        out[root] = [[(n.op, n.fingerprint, n.schema, n.describe(),
                       n.estimated_bytes()) for n in t.plan.walk()]
                     for t in tables]
    assert out[PORT] == out["tez_tpu"]
    assert out[PORT][2][-1][2] == ("k", "v", "w")


def test_table_rejections_match_tez_tpu(tmp_path):
    def attempts(root):
        t = tiny_scan(root, tmp_path)
        Table = mod(root, "query").Table
        calls = [lambda: t.filter("v", "approx", "1"),
                 lambda: t.filter("zz", "eq", "1"),
                 lambda: t.project(["k", "zz"]),
                 lambda: t.join(t, "k", how="outer"),
                 lambda: t.aggregate(["k"], [("x", "median", "v")]),
                 lambda: t.window("k", "v", func="rank"),
                 lambda: t.limit(3, ["zz"]),
                 lambda: Table.scan("x", [], ["a"], mode="json"),
                 lambda: Table.scan("x", [], ["a", "b"], mode="words")]
        got = []
        for call in calls:
            with pytest.raises((KeyError, ValueError)) as exc:
                call()
            got.append((exc.type.__name__, str(exc.value)))
        return got
    assert attempts(PORT) == attempts("tez_tpu")


# -- the planner -------------------------------------------------------------
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_planned_dags_match_tez_tpu(tmp_path, corpora, strategy):
    """Each corpus query planned by both packages (stats dir on, a
    feedback-free planner): the same DAG plan with the package prefix
    mapped, the same operators and decisions, and no descriptor of the
    port's plan names a tez_tpu class."""
    conf = {"tez.query.join.strategy": strategy,
            "tez.query.stats.dir": str(tmp_path / "qstats")}
    for label in ("uni", "zipf"):
        plans = {}
        for root in ROOTS:
            c = corpora[label][root]
            plans[root] = {}
            for name, q in queries(root).items():
                p = mod(root, "query").plan_query(
                    q.build(c), conf, str(tmp_path / "out" / name),
                    dag_name=name, sink=q.sink)
                plans[root][name] = (
                    plan_tree(p.dag.create_dag_plan(conf)), p.name,
                    p.fingerprint, p.sink_vertex, p.operators, p.decisions)
                if root == PORT:
                    assert names_tez_tpu(p.dag.create_dag_plan(conf)) \
                        == [], name
        assert plans[PORT] == plans["tez_tpu"], label


def test_planner_strategy_bases_match_tez_tpu(tmp_path):
    """tests/test_query.py's strategy bases (forced, pinned, required,
    estimate) on both packages."""
    def decisions(root):
        left = tiny_scan(root, tmp_path, "l")
        right = mod(root, "query").Table.scan(
            "r", [str(tmp_path / "l.tbl")], ["k", "w"])
        conf = {"tez.query.scan.splits": 1}
        got = []
        for table, extra in (
                (left.join(right, "k"),
                 {"tez.query.join.strategy": "repartition"}),
                (left.hash_join(right, "k"), {}),
                (left.sort_merge_join(right, "k"), {}),
                (left.join(right, "k", how="semi_distinct"),
                 {"tez.query.join.strategy": "broadcast"}),
                (left.join(right, "k"), {}),
                (left.join(right, "k"),
                 {"tez.query.broadcast.max-mb": 0.0})):
            p = mod(root, "query").plan_query(
                table.plan, {**conf, **extra}, str(tmp_path / "out"))
            got.append([(d["kind"], d["choice"], d["basis"], d["detail"])
                        for d in p.decisions])
            assert names_tez_tpu(p.dag.create_dag_plan()) == [] or \
                root != PORT
        return got
    got = decisions(PORT)
    assert got == decisions("tez_tpu")
    strategies = [next(d[1:3] for d in ds if d[0] == "join_strategy")
                  for ds in got]
    assert strategies == [("repartition", "forced"),
                          ("broadcast", "pinned"),
                          ("repartition", "pinned"),
                          ("repartition", "required"),
                          ("broadcast", "estimate"),
                          ("repartition", "estimate")]


# -- feedback ----------------------------------------------------------------
def feedback(root, **over):
    conf = {"tez.query.replan.enabled": True,
            "tez.query.replan.skew-factor": 4.0,
            "tez.query.replan.max-reducers": 8}
    conf.update(over)
    return mod(root, "query").PlanFeedback(conf)


def strategy_run(fb, fp, strategy, build_bytes, blamed="exchange"):
    fb.record_run(
        [{"node": fp, "operator": "join", "kind": "join_strategy",
          "choice": strategy, "basis": "estimate", "detail": ""}],
        {(fp, "build"): {"bytes": build_bytes, "partitions": [build_bytes]}},
        blamed, 1.0)


def test_feedback_advice_matches_tez_tpu():
    """tests/test_query.py's strategy flips, reducer bumps and disabled
    feedback, every piece of advice equal on both packages."""
    def advice(root):
        got = []
        fb = feedback(root)
        got.append(fb.advise_strategy("fp", 1.0))
        strategy_run(fb, "fp", "repartition", 1024)
        got.append(fb.advise_strategy("fp", 1.0))
        strategy_run(fb, "fp_t", "repartition", 1024, blamed="device")
        got.append(fb.advise_strategy("fp_t", 1.0))
        strategy_run(fb, "fp2", "broadcast", 8 << 20)
        got.append(fb.advise_strategy("fp2", 1.0))
        strategy_run(fb, "fp3", "broadcast", 1024)
        got.append(fb.advise_strategy("fp3", 1.0))
        fb.record_run(
            [{"node": "fa", "operator": "agg", "kind": "parallelism",
              "choice": 2, "basis": "default", "detail": ""}],
            {("fa", "group"): {"bytes": 1100, "partitions": [1000, 100]}},
            "exchange", 1.0)
        got.append(fb.advise_reducers("fa", 2))
        fb.record_run(
            [{"node": "fa", "operator": "agg", "kind": "parallelism",
              "choice": 4, "basis": "replan", "detail": ""}],
            {("fa", "group"): {"bytes": 1200,
                               "partitions": [300, 300, 300, 300]}},
            "exchange", 1.0)
        got.append(fb.advise_reducers("fa", 2))
        fb.max_reducers = 4
        fb.record_run([], {("fa", "group"): {
            "bytes": 1100, "partitions": [1000, 50, 25, 25]}},
            "exchange", 1.0)
        got.append(fb.advise_reducers("fa", 2))
        got.append(fb.advise_reducers("nothing", 2))
        off = feedback(root, **{"tez.query.replan.enabled": False})
        strategy_run(off, "fp", "repartition", 1024)
        got.append((off.advise_strategy("fp", 1.0),
                    off.advise_reducers("fp", 2)))
        got.append({k: dataclasses.asdict(v) for k, v in fb.nodes.items()})
        return got
    got = advice(PORT)
    assert got == advice("tez_tpu")
    assert got[1][0] == "broadcast" and got[3][0] == "repartition"
    assert got[5][0] == 4 and got[9] == (None, None)


def test_blame_from_histograms_matches_tez_tpu():
    h = lambda ms: SimpleNamespace(sum_ms=ms)  # noqa: E731
    before = {"shuffle.fetch.wait_ms": h(10.0)}
    after = {"shuffle.fetch.wait_ms": h(510.0),
             "device.dispatch_ms": h(20.0),
             "unrelated.metric_ms": h(9999.0)}
    got = {root: (mod(root, "query.feedback").blame_from_histograms(
        before, after), mod(root, "query.feedback").blame_from_histograms(
        after, after)) for root in ROOTS}
    assert got[PORT] == got["tez_tpu"] == (("transport", 500.0), ("", 0.0))


# -- the corpus suite end to end ---------------------------------------------
def submitted_view(ev) -> dict:
    """A QUERY_SUBMITTED record less its timing and its blamed plane."""
    return {k: v for k, v in ev.data.items() if k not in ("wall_s",
                                                           "blamed")}


@pytest.mark.parametrize("label,strategy", [
    (label, s) for label in ("uni", "zipf") for s in STRATEGIES])
def test_corpus_matches_tez_tpu(tmp_path, corpora, label, strategy):
    """Every CORPUS_QUERIES query through one session of each package:
    the port's records equal tez_tpu's and the oracle's, its decisions
    and QUERY_SUBMITTED records equal tez_tpu's.  Under a forced
    strategy every join takes it, save semi_distinct's required
    repartition."""
    extra = {} if strategy == "auto" else \
        {"tez.query.join.strategy": strategy}
    seen = {}
    for root in ROOTS:
        c = corpora[label][root]
        seen[root] = []
        with session(root, tmp_path, f"{label}_{strategy}", extra) as s:
            for name, q in queries(root).items():
                r = s.run(q.build(c), str(tmp_path / root / f"o_{name}"),
                          query_name=name, sink=q.sink)
                assert r.state == "SUCCEEDED", (root, name)
                records = r.read_output()
                assert records == q.oracle(c), (root, name)
                seen[root].append((name, records, r.fingerprint,
                                   r.decisions, r.replans, r.cache_hits))
            seen[root].append([submitted_view(ev) for ev in
                               events(s, "QUERY_SUBMITTED")])
    assert seen[PORT] == seen["tez_tpu"]
    for _name, _rec, _fp, decisions, _rp, _h in seen[PORT][:-1]:
        for d in decisions:
            if d["kind"] == "join_strategy" and strategy != "auto" and \
                    d["basis"] != "required":
                assert (d["choice"], d["basis"]) == (strategy, "forced")


# -- session behaviour: tests/test_query.py on both packages ------------------
def test_session_lineage_reuse_matches_tez_tpu(tmp_path, corpora):
    """An identical rerun in one session with the store on is served from
    sealed lineage (cache hits), the records unchanged, on both."""
    seen = {}
    for root in ROOTS:
        c = corpora["uni"][root]
        q = queries(root)["nation_revenue"]
        with session(root, tmp_path, "reuse",
                     {"tez.runtime.store.enabled": True,
                      "tez.query.replan.enabled": False}) as s:
            r1 = s.run(q.build(c), str(tmp_path / root / "reuse1"),
                       query_name=q.name, sink=q.sink)
            r2 = s.run(q.build(c), str(tmp_path / root / "reuse2"),
                       query_name=q.name, sink=q.sink)
            submitted = events(s, "QUERY_SUBMITTED")
        want = q.oracle(c)
        assert r1.read_output() == want and r2.read_output() == want
        assert r1.cache_hits == 0 and r2.cache_hits > 0, root
        assert submitted[-1].data["cache_hits"] == r2.cache_hits
        seen[root] = (r1.fingerprint == r2.fingerprint, r1.cache_hits,
                      r2.cache_hits, r1.decisions, r2.decisions)
    assert seen[PORT] == seen["tez_tpu"]


def test_replan_flips_exchange_bound_join_matches_tez_tpu(tmp_path,
                                                           corpora):
    """Run 1 repartitions by estimate; the observed build side fits, so
    run 2 is replanned to broadcast (QUERY_REPLANNED journaled), the
    records unchanged; each decision and replan equal tez_tpu's, less
    the blamed plane, which the run's timings decide."""
    def view(decision):
        extras = {k: v for k, v in (decision.get("extras") or {}).items()
                  if k != "blamed"}
        return (decision["node"], decision["kind"], decision["choice"],
                decision["basis"], extras)

    seen = {}
    for root in ROOTS:
        c = corpora["zipf"][root]

        def build():
            small = c.scan("orders").filter("o_total", "ge", "95000",
                                            numeric=True)
            return (c.scan("lineitem")
                    .join(small, "l_orderkey", "o_orderkey")
                    .aggregate(["l_flag"], [("n", "count", "l_flag"),
                                            ("rev", "sum", "l_price")]))

        with session(root, tmp_path, "replan",
                     {"tez.query.broadcast.max-mb": 0.004}) as s:
            r1 = s.run(build(), str(tmp_path / root / "rp1"),
                       query_name="rp")
            r2 = s.run(build(), str(tmp_path / root / "rp2"),
                       query_name="rp")
            replanned = events(s, "QUERY_REPLANNED")
        d1 = next(d for d in r1.decisions if d["kind"] == "join_strategy")
        d2 = next(d for d in r2.decisions if d["kind"] == "join_strategy")
        assert (d1["choice"], d1["basis"]) == ("repartition", "estimate")
        assert (d2["choice"], d2["basis"]) == ("broadcast", "replan")
        assert r1.replans == [] and len(r2.replans) >= 1
        flip = next(p for p in r2.replans if p["kind"] == "join_strategy")
        assert (flip["from"], flip["to"]) == ("repartition", "broadcast")
        assert r1.read_output() == r2.read_output() != []
        assert len(replanned) == len(r2.replans)
        seen[root] = ([view(d) for d in r1.decisions],
                      [view(d) for d in r2.decisions],
                      [{k: v for k, v in p.items()
                        if k not in ("blamed", "detail")}
                       for p in r2.replans], r2.read_output())
    assert seen[PORT] == seen["tez_tpu"]


def test_query_kill_storm_matches_tez_tpu(tmp_path, corpora):
    """Two corpus queries under seeded recoverable task kills with the
    result cache on: the records equal the oracle's and tez_tpu's, and
    both packages' fault plans fail the same attempts."""
    seen = {}
    for root in ROOTS:
        c = corpora["uni"][root]
        qs = queries(root)
        seen[root] = []
        with session(root, tmp_path, "storm",
                     {"tez.runtime.store.enabled": True,
                      "tez.am.task.max.failed.attempts": 4}) as s:
            for i, name in enumerate(("nation_revenue", "supply_chain")):
                q = qs[name]
                r = s.run(q.build(c), str(tmp_path / root / f"storm_{i}"),
                          query_name=name, sink=q.sink,
                          dag_conf={"tez.test.fault.spec":
                                    "task.run:fail:n=2,exc=runtime",
                                    "tez.test.fault.seed": i,
                                    "tez.dag.tenant": f"tenant{i % 2}"})
                assert r.state == "SUCCEEDED", (root, name)
                assert r.read_output() == q.oracle(c), (root, name)
                seen[root].append(r.read_output())
            finished = events(s, "TASK_ATTEMPT_FINISHED")
        killed = sum(1 for ev in finished
                     if (ev.data or {}).get("state") == "FAILED")
        assert killed >= 2, root
        seen[root].append(killed)
    assert seen[PORT] == seen["tez_tpu"]


# -- a fault of tez_tpu's, repaired in the port -------------------------------
def test_limit_orders_by_every_order_column(tmp_path):
    """limit(n, [a, b]): tez_tpu keys its funnel edge by a and orders each
    group of equal a by the full row, so b is ignored; the port orders
    each group by b (then the full row), as Table.limit promises.  One
    order column plans and runs the same on both."""
    p = tmp_path / "t.tbl"
    rows = ["a|2|x", "a|1|y", "b|0|z", "b|9|c", "a|5|x", "c|3|a"]
    p.write_text("\n".join(rows) + "\n")
    split = [tuple(r.split("|")) for r in rows]
    want = {n: sorted((r[0], f"{r[1]}|{r[2]}") for r in sorted(
        split, key=lambda r: (r[0], r[2], r))[:n]) for n in (1, 2, 4)}
    got = {}
    for root in ROOTS:
        table = mod(root, "query").Table.scan("t", [str(p)], ["k", "v", "w"])
        with session(root, tmp_path, "limit") as s:
            got[root] = {n: s.run(table.limit(n, ["k", "w"]),
                                  str(tmp_path / root / f"l{n}")).read_output()
                         for n in (1, 2, 4)}
            got[root]["one"] = s.run(table.limit(3, ["v"]),
                                     str(tmp_path / root / "l_one")
                                     ).read_output()
    assert {n: got[PORT][n] for n in (1, 2, 4)} == want
    assert got["tez_tpu"][1] == [("a", "1|y")] != want[1]
    assert got[PORT]["one"] == got["tez_tpu"]["one"] == sorted(
        (r[0], f"{r[1]}|{r[2]}") for r in sorted(split,
                                                 key=lambda r: (r[1], r))[:3])


# -- no card -----------------------------------------------------------------
def test_query_session_default_device_needs_a_card(tmp_path):
    """QuerySession() runs on the card by default: without one it raises
    and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    from tez_tpu_torch.query import QuerySession
    with pytest.raises(RuntimeError):
        QuerySession("nocard", {"tez.staging-dir": str(tmp_path / "s")})
