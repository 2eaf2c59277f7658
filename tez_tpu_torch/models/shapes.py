"""Canned DAG topologies — the framework's reusable "model" shapes.

Reference role: the tez-tests canned DAGs used by every fault-tolerance and
recovery suite — SimpleTestDAG / SimpleTestDAG3Vertices
(tez-tests/src/test/java/org/apache/tez/test/SimpleTestDAG.java),
SimpleVTestDAG / SimpleReverseVTestDAG / MultiAttemptDAG / FailingDagBuilder
(tez-tests/src/test/java/org/apache/tez/test/dag/FailingDagBuilder.java:62).

Every builder wires the fault-injectable TestInput/TestProcessor/TestOutput
doubles (tez_tpu_torch/library/test_components.py), so any shape can be turned
into a failure scenario by passing the shared `payload` dict (do_fail,
failing_task_indices, ...).  The same topologies double as user-facing
skeletons: swap the descriptors for real processors via the `processor`,
`input_descriptor`, `output_descriptor` hooks.

The port's copy of tez_tpu.models.shapes: every builder wires the port's
doubles, so a shape runs on the port's AM on any device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from tez_tpu_torch.common.payload import (InputDescriptor, OutputDescriptor,
                                          ProcessorDescriptor)
from tez_tpu_torch.dag.dag import DAG, Edge, Vertex
from tez_tpu_torch.dag.edge_property import (DataMovementType, DataSourceType,
                                             EdgeProperty, SchedulingType)

_TEST_PROC = "tez_tpu_torch.library.test_components:TestProcessor"
_TEST_IN = "tez_tpu_torch.library.test_components:TestInput"
_TEST_OUT = "tez_tpu_torch.library.test_components:TestOutput"


class ShapeBuilder:
    """Fluent canned-DAG builder (FailingDagBuilder analog).

    >>> dag = (ShapeBuilder("diamond", payload={"do_fail": True})
    ...        .vertex("a", 2).vertex("b", 3).vertex("c", 3).vertex("d", 2)
    ...        .edge("a", "b").edge("a", "c")
    ...        .edge("b", "d").edge("c", "d").build())
    """

    def __init__(self, name: str,
                 payload: Optional[Dict[str, Any]] = None,
                 processor: str = _TEST_PROC,
                 input_descriptor: str = _TEST_IN,
                 output_descriptor: str = _TEST_OUT):
        self.name = name
        self.payload = dict(payload or {})
        self.processor = processor
        self.input_descriptor = input_descriptor
        self.output_descriptor = output_descriptor
        self._vertices: Dict[str, Vertex] = {}
        self._edges = []

    def vertex(self, name: str, parallelism: int = 1,
               payload: Optional[Dict[str, Any]] = None) -> "ShapeBuilder":
        self._vertices[name] = Vertex.create(
            name, ProcessorDescriptor.create(
                self.processor, payload=payload if payload is not None
                else self.payload), parallelism)
        return self

    def edge(self, src: str, dst: str,
             movement: DataMovementType = DataMovementType.SCATTER_GATHER,
             payload: Optional[Dict[str, Any]] = None) -> "ShapeBuilder":
        p = payload if payload is not None else self.payload
        self._edges.append(Edge.create(
            self._vertices[src], self._vertices[dst], EdgeProperty.create(
                movement, DataSourceType.PERSISTED,
                SchedulingType.SEQUENTIAL,
                OutputDescriptor.create(self.output_descriptor, payload=p),
                InputDescriptor.create(self.input_descriptor, payload=p))))
        return self

    def build(self) -> DAG:
        dag = DAG.create(self.name)
        for v in self._vertices.values():
            dag.add_vertex(v)
        for e in self._edges:
            dag.add_edge(e)
        return dag


def simple_dag(name: str = "SimpleTestDAG", parallelism: int = 2,
               payload: Optional[Dict[str, Any]] = None) -> DAG:
    """v1 -SG-> v2 (SimpleTestDAG.java)."""
    return (ShapeBuilder(name, payload)
            .vertex("v1", parallelism).vertex("v2", parallelism)
            .edge("v1", "v2").build())


def simple_dag_3_vertices(name: str = "SimpleTestDAG3Vertices",
                          parallelism: int = 2,
                          payload: Optional[Dict[str, Any]] = None) -> DAG:
    """v1 -SG-> v2 -SG-> v3 (SimpleTestDAG3Vertices.java)."""
    return (ShapeBuilder(name, payload)
            .vertex("v1", parallelism).vertex("v2", parallelism)
            .vertex("v3", parallelism)
            .edge("v1", "v2").edge("v2", "v3").build())


def simple_v_dag(name: str = "SimpleVTestDAG", parallelism: int = 2,
                 payload: Optional[Dict[str, Any]] = None) -> DAG:
    """v1, v2 -SG-> v3 fan-in (SimpleVTestDAG.java:51)."""
    return (ShapeBuilder(name, payload)
            .vertex("v1", parallelism).vertex("v2", parallelism)
            .vertex("v3", parallelism)
            .edge("v1", "v3").edge("v2", "v3").build())


def simple_reverse_v_dag(name: str = "SimpleReverseVTestDAG",
                         parallelism: int = 2,
                         payload: Optional[Dict[str, Any]] = None) -> DAG:
    """v1 -SG-> v2, v3 fan-out (SimpleReverseVTestDAG.java:51)."""
    return (ShapeBuilder(name, payload)
            .vertex("v1", parallelism).vertex("v2", parallelism)
            .vertex("v3", parallelism)
            .edge("v1", "v2").edge("v1", "v3").build())


def two_levels_failing_dag(name: str = "TwoLevelsFailingDAG",
                           payload: Optional[Dict[str, Any]] = None) -> DAG:
    """Four independent l1->l2 pairs, one BROADCAST
    (FailingDagBuilder.Levels.TWO, FailingDagBuilder.java:71)."""
    b = ShapeBuilder(name, payload)
    for i, (p1, p2) in enumerate(((1, 1), (2, 3), (3, 2), (2, 3)), start=1):
        b.vertex(f"l1v{i}", p1).vertex(f"l2v{i}", p2)
    for i in range(1, 4):
        b.edge(f"l1v{i}", f"l2v{i}")
    b.edge("l1v4", "l2v4", DataMovementType.BROADCAST)
    return b.build()


def three_levels_failing_dag(name: str = "ThreeLevelsFailingDAG",
                             payload: Optional[Dict[str, Any]] = None) -> DAG:
    """Adds l3v1/l3v2 over the two-level shape with mixed fan-in
    (FailingDagBuilder.Levels.THREE, FailingDagBuilder.java:85)."""
    b = ShapeBuilder(name, payload)
    for i, (p1, p2) in enumerate(((1, 1), (2, 3), (3, 2), (2, 3)), start=1):
        b.vertex(f"l1v{i}", p1).vertex(f"l2v{i}", p2)
    for i in range(1, 4):
        b.edge(f"l1v{i}", f"l2v{i}")
    b.edge("l1v4", "l2v4", DataMovementType.BROADCAST)
    b.vertex("l3v1", 4).vertex("l3v2", 4)
    b.edge("l2v1", "l3v1").edge("l2v2", "l3v1")
    b.edge("l2v2", "l3v2", DataMovementType.BROADCAST)
    b.edge("l2v3", "l3v2").edge("l2v4", "l3v2")
    return b.build()


def multi_attempt_dag(name: str = "MultiAttemptDAG",
                      failing_upto_attempt: int = 1,
                      parallelism: int = 1) -> DAG:
    """Every vertex fails its first `failing_upto_attempt` attempts then
    succeeds — drives retry + recovery paths (MultiAttemptDAG.java)."""
    payload = {"do_fail": True, "failing_task_indices": [-1],
               "failing_upto_attempt": failing_upto_attempt}
    return (ShapeBuilder(name, payload)
            .vertex("v1", parallelism).vertex("v2", parallelism)
            .vertex("v3", parallelism)
            .edge("v1", "v2").edge("v2", "v3").build())
