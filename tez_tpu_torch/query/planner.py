"""Lower logical plans to DAGs over the library edges.

Lowering rules (docs/query.md):

- ``scan`` + any run of ``filter``/``project``/broadcast ``hash_join``
  fuses into ONE vertex (QueryPipelineProcessor) — pipelined operators
  never pay an exchange.
- A join lowers to one of two physical strategies:

  * **broadcast**: the build (right) side terminates into a one-to-all
    ``UnorderedKVEdge``; the probe side *stays open* — the join becomes
    a fused ``hash_join`` op inside the probe stage.  Chosen when the
    build side's estimated (or observed, after a replan) size fits
    ``tez.query.broadcast.max-mb``.
  * **repartition**: both sides terminate into key-partitioned
    ``OrderedPartitionedKVEdge``s feeding a QuerySortMergeJoinProcessor
    at ``tez.query.reducers`` parallelism.

- ``aggregate`` terminates its child with map-side partial aggregation
  (the combiner analog) into an ordered edge grouped on the keys;
  ``window`` and ``limit`` terminate into ordered edges keyed by the
  partition / order columns (limit funnels to 1 partition).

Every vertex is named ``q_<kind>_<fp12>`` from the logical fingerprint
of the operator chain it executes and tagged with ``tez.query.operator``
— so history/flight events attribute back to plan operators, and
identical subplans lower to byte-identical vertices that the
sealed-lineage store serves as cache hits across queries.

The port's copy of tez_tpu.query.planner: every descriptor it writes
names a tez_tpu_torch class, and the DAG it plans is tez_tpu's with the
package prefix mapped (the same vertices, parallelism, edges and
payloads).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from tez_tpu_torch.common import config as C
from tez_tpu_torch.common.payload import (InputDescriptor,
                                          InputInitializerDescriptor,
                                          OutputCommitterDescriptor,
                                          OutputDescriptor,
                                          ProcessorDescriptor)
from tez_tpu_torch.dag.dag import (DAG, DataSinkDescriptor,
                                   DataSourceDescriptor, Edge, Vertex)
from tez_tpu_torch.library.conf import (OrderedPartitionedKVEdgeConfig,
                                        UnorderedKVEdgeConfig)
from tez_tpu_torch.query.logical import Node, Table

_PROCESSORS = {
    "scan": "tez_tpu_torch.query.processors:QueryPipelineProcessor",
    "smj": "tez_tpu_torch.query.processors:QuerySortMergeJoinProcessor",
    "agg": "tez_tpu_torch.query.processors:QueryAggregateProcessor",
    "win": "tez_tpu_torch.query.processors:QueryWindowProcessor",
    "limit": "tez_tpu_torch.query.processors:QueryLimitProcessor",
}


def _get(conf: Any, key) -> Any:
    v = conf.get(key.name) if conf is not None else None
    return key.default if v is None else v


@dataclasses.dataclass
class PlannedQuery:
    """A lowered query: the DAG plus the attribution/decision record
    the session journals (QUERY_SUBMITTED) and feeds PlanFeedback."""
    dag: DAG
    name: str
    fingerprint: str
    sink_vertex: str
    output_path: str
    #: vertex name -> operator tag ("scan(x)+filter(...)@fp")
    operators: Dict[str, str]
    #: per-choice records: {"node", "operator", "kind", "choice", "basis",
    #: "detail"} — kind is join_strategy or parallelism
    decisions: List[Dict[str, Any]]


class _Stage:
    """An open (not yet terminated) physical stage being fused."""

    def __init__(self, kind: str, node: Node, parallelism: int,
                 payload: Dict[str, Any], label_parts: List[str]):
        self.kind = kind
        self.node = node          # deepest logical node fused so far
        self.parallelism = parallelism
        self.payload = payload    # stage-specific fields (no ops/emit yet)
        self.ops: List[Dict[str, Any]] = []
        self.labels = list(label_parts)
        #: (source Vertex, "broadcast" | "ordered") resolved at terminate
        self.in_edges: List[Tuple[Vertex, str]] = []
        self.scan_source: Optional[Dict[str, Any]] = None


class _Planner:
    def __init__(self, conf: Any, feedback: Any, stats_dir: str):
        self.conf = conf
        self.feedback = feedback
        self.stats_dir = stats_dir
        self.vertices: Dict[str, Vertex] = {}
        self.edges: List[Edge] = []
        self.operators: Dict[str, str] = {}
        self.decisions: List[Dict[str, Any]] = []

    # -- knobs ---------------------------------------------------------

    def _reducers(self, node: Node, operator: str) -> int:
        base = int(_get(self.conf, C.QUERY_REDUCERS))
        if self.feedback is not None:
            advised = self.feedback.advise_reducers(node.fingerprint, base)
            if advised is not None:
                self.decisions.append({
                    "node": node.fingerprint, "operator": operator,
                    "kind": "parallelism", "choice": advised[0],
                    "basis": "replan", "detail": advised[1],
                    "extras": advised[2]})
                return advised[0]
        self.decisions.append({
            "node": node.fingerprint, "operator": operator,
            "kind": "parallelism", "choice": base, "basis": "default",
            "detail": f"tez.query.reducers={base}"})
        return base

    def _join_strategy(self, node: Node
                       ) -> Tuple[str, str, str, Dict[str, Any]]:
        """-> (strategy, basis, detail, journal-extras)."""
        forced = str(_get(self.conf, C.QUERY_JOIN_STRATEGY))
        how = node.spec["how"]
        if how == "semi_distinct":
            # distinct-on-key needs the key-partitioned exchange
            return "repartition", "required", "semi_distinct join", {}
        if forced != "auto":
            return forced, "forced", f"tez.query.join.strategy={forced}", {}
        pinned = node.spec["strategy"]
        if pinned != "auto":
            return pinned, "pinned", f"builder pinned {pinned}", {}
        max_mb = float(_get(self.conf, C.QUERY_BROADCAST_MAX_MB))
        if self.feedback is not None:
            advised = self.feedback.advise_strategy(
                node.fingerprint, max_mb)
            if advised is not None:
                return advised[0], "replan", advised[1], advised[2]
        est_mb = node.children[1].estimated_bytes() / (1024.0 * 1024.0)
        if est_mb <= max_mb:
            return ("broadcast", "estimate",
                    f"build est {est_mb:.2f}MB <= {max_mb}MB", {})
        return ("repartition", "estimate",
                f"build est {est_mb:.2f}MB > {max_mb}MB", {})

    # -- vertex assembly -----------------------------------------------

    def _vertex_name(self, kind: str, node: Node) -> str:
        name = f"q_{kind}_{node.fingerprint[:12]}"
        while name in self.vertices:   # self-join duplicate subplan
            name += "b"
        return name

    def _stats_spec(self, node: Node, role: str) -> Optional[Dict[str, Any]]:
        if not self.stats_dir:
            return None
        return {"dir": self.stats_dir, "node": node.fingerprint,
                "role": role}

    def terminate(self, stage: _Stage, emit: Dict[str, Any]) -> Vertex:
        """Close a stage: build its vertex, payload, and in-edges.  A
        stage created for an exchange keeps the name its upstreams'
        emit specs were built against (``_forced_name``) even after
        further ops fused into it."""
        vname = getattr(stage, "_forced_name", None) or \
            self._vertex_name(stage.kind, stage.node)
        payload = dict(stage.payload)
        payload["stage"] = stage.kind
        payload["ops"] = stage.ops
        payload["emit"] = emit
        vertex = Vertex.create(vname, ProcessorDescriptor.create(
            _PROCESSORS[stage.kind], payload=payload), stage.parallelism)
        tag = f"{'+'.join(stage.labels)}@{stage.node.fingerprint}"
        vertex.set_conf(C.QUERY_OPERATOR_TAG.name, tag)
        if stage.scan_source is not None:
            src = stage.scan_source
            vertex.add_data_source("input", DataSourceDescriptor.create(
                InputDescriptor.create("tez_tpu_torch.io.text:TextInput"),
                InputInitializerDescriptor.create(
                    "tez_tpu_torch.io.text:TextSplitGenerator",
                    payload={"paths": src["paths"],
                             "desired_splits": stage.parallelism})))
        for src_vertex, edge_kind in stage.in_edges:
            if edge_kind == "broadcast":
                cfg = UnorderedKVEdgeConfig.new_builder("bytes", "bytes") \
                    .set_from_configuration(self.conf).build()
                prop = cfg.create_default_broadcast_edge_property()
            else:
                cfg = OrderedPartitionedKVEdgeConfig.new_builder(
                    "bytes", "bytes") \
                    .set_from_configuration(self.conf).build()
                prop = cfg.create_default_edge_property()
            self.edges.append(Edge.create(src_vertex, vertex, prop))
        self.vertices[vname] = vertex
        self.operators[vname] = tag
        return vertex

    # -- lowering ------------------------------------------------------

    def compile(self, node: Node) -> _Stage:
        """-> an open stage whose row schema is ``node.schema``."""
        op = node.op
        if op == "scan":
            splits = int(_get(self.conf, C.QUERY_SCAN_SPLITS))
            stage = _Stage("scan", node, splits,
                           {"source": {"mode": node.spec["mode"],
                                       "delimiter": node.spec["delimiter"],
                                       "input": "input"}},
                           [node.describe()])
            stage.scan_source = {"paths": list(node.spec["paths"])}
            return stage

        if op == "filter":
            stage = self.compile(node.children[0])
            child_schema = node.children[0].schema
            stage.ops.append({
                "op": "filter",
                "idx": child_schema.index(node.spec["col"]),
                "cmp": node.spec["cmp"], "value": node.spec["value"],
                "numeric": node.spec["numeric"]})
            stage.node = node
            stage.labels.append(node.describe())
            return stage

        if op == "project":
            stage = self.compile(node.children[0])
            child_schema = node.children[0].schema
            stage.ops.append({
                "op": "project",
                "idxs": [child_schema.index(c)
                         for c in node.spec["columns"]]})
            stage.node = node
            stage.labels.append(node.describe())
            return stage

        if op == "join":
            return self._compile_join(node)

        if op == "aggregate":
            return self._compile_aggregate(node)

        if op == "window":
            return self._compile_window(node)

        if op == "limit":
            return self._compile_limit(node)

        raise ValueError(f"unknown logical op {op!r}")

    def _compile_join(self, node: Node) -> _Stage:
        left_node, right_node = node.children
        lkey = left_node.schema.index(node.spec["left_key"])
        rkey = right_node.schema.index(node.spec["right_key"])
        how = node.spec["how"]
        strategy, basis, detail, extras = self._join_strategy(node)
        self.decisions.append({
            "node": node.fingerprint, "operator": node.describe(),
            "kind": "join_strategy", "choice": strategy, "basis": basis,
            "detail": detail, "extras": extras})
        keep = [i for i, c in enumerate(right_node.schema)
                if c != node.spec["right_key"]] if how == "inner" else []

        if strategy == "broadcast":
            probe = self.compile(left_node)
            build = self.compile(right_node)
            # the probe stage stays OPEN (more ops may fuse into it), so
            # its final vertex name is unknown here; the build side's
            # emit names no output ("") and the runtime resolves the
            # single output a build vertex has (processors._EdgeEmit)
            build_vertex = self.terminate(
                build, {"kind": "edge", "output": "", "key_idx": rkey,
                        "partitions": 1,
                        "stats": self._stats_spec(node, "build")})
            probe.in_edges.append((build_vertex, "broadcast"))
            probe.ops.append({"op": "hash_join",
                              "build": build_vertex.name,
                              "key_idx": lkey, "how": how, "keep": keep})
            probe.node = node
            probe.labels.append(node.describe())
            return probe

        reducers = self._reducers(node, node.describe())
        smj_name = self._vertex_name("smj", node)
        left = self.compile(left_node)
        right = self.compile(right_node)
        left_vertex = self.terminate(
            left, {"kind": "edge", "output": smj_name, "key_idx": lkey,
                   "partitions": reducers,
                   "stats": self._stats_spec(node, "left")})
        right_vertex = self.terminate(
            right, {"kind": "edge", "output": smj_name, "key_idx": rkey,
                    "partitions": reducers,
                    "stats": self._stats_spec(node, "build")})
        stage = _Stage("smj", node, reducers,
                       {"left_input": left_vertex.name,
                        "right_input": right_vertex.name,
                        "how": how, "right_keep": keep},
                       [node.describe()])
        stage.in_edges.append((left_vertex, "ordered"))
        stage.in_edges.append((right_vertex, "ordered"))
        stage._forced_name = smj_name
        return stage

    def _compile_aggregate(self, node: Node) -> _Stage:
        child = node.children[0]
        child_schema = child.schema
        key_idxs = [child_schema.index(k) for k in node.spec["keys"]]
        aggs = [[fn, child_schema.index(col) if fn != "count" else 0]
                for _out, fn, col in node.spec["aggs"]]
        reducers = self._reducers(node, node.describe())
        agg_name = self._vertex_name("agg", node)
        upstream = self.compile(child)
        up_vertex = self.terminate(
            upstream, {"kind": "agg_edge", "output": agg_name,
                       "key_idxs": key_idxs, "aggs": aggs,
                       "partitions": reducers,
                       "stats": self._stats_spec(node, "group")})
        stage = _Stage("agg", node, reducers,
                       {"agg_input": up_vertex.name,
                        "key_width": len(key_idxs),
                        "aggs": [fn for fn, _idx in aggs]},
                       [node.describe()])
        stage.in_edges.append((up_vertex, "ordered"))
        stage._forced_name = agg_name
        return stage

    def _compile_window(self, node: Node) -> _Stage:
        child = node.children[0]
        child_schema = child.schema
        part_idx = child_schema.index(node.spec["partition"])
        reducers = self._reducers(node, node.describe())
        win_name = self._vertex_name("win", node)
        upstream = self.compile(child)
        up_vertex = self.terminate(
            upstream, {"kind": "edge", "output": win_name,
                       "key_idx": part_idx, "partitions": reducers,
                       "stats": self._stats_spec(node, "group")})
        stage = _Stage("win", node, reducers,
                       {"win_input": up_vertex.name,
                        "order_idx": child_schema.index(node.spec["order"]),
                        "func": node.spec["func"]},
                       [node.describe()])
        stage.in_edges.append((up_vertex, "ordered"))
        stage._forced_name = win_name
        return stage

    def _compile_limit(self, node: Node) -> _Stage:
        child = node.children[0]
        child_schema = child.schema
        order = node.spec["order"]
        key_idx = child_schema.index(order[0]) if order else 0
        limit_name = self._vertex_name("limit", node)
        upstream = self.compile(child)
        up_vertex = self.terminate(
            upstream, {"kind": "edge", "output": limit_name,
                       "key_idx": key_idx, "partitions": 1,
                       "stats": self._stats_spec(node, "order")})
        payload = {"limit_input": up_vertex.name, "n": node.spec["n"]}
        if len(order) > 1:
            # the edge is keyed by the first order column only: the rest
            # order the rows within each key group (tez_tpu drops them)
            payload["then_by"] = [child_schema.index(c) for c in order[1:]]
        stage = _Stage("limit", node, 1, payload, [node.describe()])
        stage.in_edges.append((up_vertex, "ordered"))
        stage._forced_name = limit_name
        return stage


def plan_query(table: "Table | Node", conf: Any, output_path: str,
               dag_name: str = "query", feedback: Any = None,
               stats_dir: str = "",
               sink: Optional[Dict[str, Any]] = None,
               dag_conf: Optional[Dict[str, Any]] = None) -> PlannedQuery:
    """Lower ``table`` (or a raw plan Node) to a ready-to-submit DAG
    writing (key, value) text records under ``output_path``.

    ``sink`` overrides the output record shape: ``{"key_col": name,
    "value_cols": [names], "literal": str}`` — default key = first
    column, value = '|'-joined remaining columns.  ``dag_conf`` entries
    land on the DAG itself (tenant tags, fault specs, tracing).
    """
    root = table.plan if isinstance(table, Table) else table
    if stats_dir == "":
        stats_dir = str(_get(conf, C.QUERY_STATS_DIR) or "")
    planner = _Planner(conf, feedback, stats_dir)
    stage = planner.compile(root)

    schema = list(root.schema)
    sink = sink or {}
    key_col = sink.get("key_col", schema[0])
    value_cols = sink.get("value_cols")
    if value_cols is None:
        value_cols = [c for c in schema if c != key_col] or []
    emit = {"kind": "sink", "output": "output",
            "key_idx": schema.index(key_col),
            "value_idxs": [schema.index(c) for c in value_cols],
            "literal": sink.get("literal")}
    sink_vertex = planner.terminate(stage, emit)
    sink_vertex.add_data_sink("output", DataSinkDescriptor.create(
        OutputDescriptor.create("tez_tpu_torch.io.file_output:FileOutput",
                                payload={"path": output_path,
                                         "key_serde": "text",
                                         "value_serde": "text"}),
        OutputCommitterDescriptor.create(
            "tez_tpu_torch.io.file_output:FileOutputCommitter",
            payload={"path": output_path})))
    dag = DAG.create(dag_name)
    for k, v in (dag_conf or {}).items():
        dag.set_conf(k, v)
    for v in planner.vertices.values():
        dag.add_vertex(v)
    for e in planner.edges:
        dag.add_edge(e)
    return PlannedQuery(dag=dag, name=dag_name,
                        fingerprint=root.fingerprint,
                        sink_vertex=sink_vertex.name,
                        output_path=output_path,
                        operators=dict(planner.operators),
                        decisions=list(planner.decisions))
