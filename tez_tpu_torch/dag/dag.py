"""Client-side DAG construction DSL.

Reference parity: tez-api/.../dag/api/DAG.java:90 (addVertex:138, addEdge:287,
verify:574, createDag:844), Vertex.java:131, Edge.java, VertexGroup /
GroupInputEdge (DAG.java:315).  verify() keeps the reference semantics:
duplicate names rejected at add time, unknown vertices at addEdge time,
cycle detection at build time (disconnected components allowed, with a
warning), illegal output-vertex-as-edge-source checks.

The port's copy of tez_tpu.dag.dag.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

from tez_tpu_torch.common.payload import (EntityDescriptor, InputDescriptor,
                                          InputInitializerDescriptor,
                                          OutputCommitterDescriptor,
                                          OutputDescriptor,
                                          ProcessorDescriptor,
                                          VertexManagerPluginDescriptor)
from tez_tpu_torch.dag.edge_property import DataMovementType, EdgeProperty
from tez_tpu_torch.dag.plan import (DAGPlan, EdgePlan, GroupInputEdgePlan,
                                    LeafOutputSpec, RootInputSpec,
                                    VertexGroupPlan, VertexPlan)


LOG = logging.getLogger(__name__)


class TezUncheckedException(Exception):
    """Reference: org.apache.tez.dag.api.TezUncheckedException."""


class DataSourceDescriptor:
    """Reference: DataSourceDescriptor.java — a root input + optional
    AM-side initializer."""

    def __init__(self, input_descriptor: InputDescriptor,
                 initializer: Optional[InputInitializerDescriptor] = None,
                 parallelism: int = -1,
                 events: Sequence[Any] = ()):
        self.input_descriptor = input_descriptor
        self.initializer = initializer
        self.parallelism = parallelism
        self.events = tuple(events)

    @staticmethod
    def create(input_descriptor: InputDescriptor,
               initializer: Optional[InputInitializerDescriptor] = None,
               parallelism: int = -1) -> "DataSourceDescriptor":
        return DataSourceDescriptor(input_descriptor, initializer, parallelism)


class DataSinkDescriptor:
    """Reference: DataSinkDescriptor.java — a leaf output + optional committer."""

    def __init__(self, output_descriptor: OutputDescriptor,
                 committer: Optional[OutputCommitterDescriptor] = None):
        self.output_descriptor = output_descriptor
        self.committer = committer

    @staticmethod
    def create(output_descriptor: OutputDescriptor,
               committer: Optional[OutputCommitterDescriptor] = None
               ) -> "DataSinkDescriptor":
        return DataSinkDescriptor(output_descriptor, committer)


class Vertex:
    """Reference: Vertex.java:131 (Vertex.create)."""

    def __init__(self, name: str, processor: ProcessorDescriptor,
                 parallelism: int = -1):
        if not name or name != name.strip():
            raise TezUncheckedException(f"illegal vertex name {name!r}")
        if parallelism < -1 or parallelism == 0:
            raise TezUncheckedException(
                f"parallelism must be -1 (determined at runtime) or > 0: {parallelism}")
        self.name = name
        self.processor = processor
        self.parallelism = parallelism
        self.data_sources: Dict[str, DataSourceDescriptor] = {}
        self.data_sinks: Dict[str, DataSinkDescriptor] = {}
        self.vertex_manager: Optional[VertexManagerPluginDescriptor] = None
        self.conf: Dict[str, Any] = {}
        self.task_resource_mb = 0
        self.locality_hints: tuple = ()
        self._in_edges: List["Edge"] = []
        self._out_edges: List["Edge"] = []
        self._group_inputs: List[str] = []

    @staticmethod
    def create(name: str, processor: ProcessorDescriptor,
               parallelism: int = -1) -> "Vertex":
        return Vertex(name, processor, parallelism)

    def add_data_source(self, name: str, source: DataSourceDescriptor) -> "Vertex":
        if name in self.data_sources:
            raise TezUncheckedException(f"duplicate data source {name}")
        self.data_sources[name] = source
        return self

    def add_data_sink(self, name: str, sink: DataSinkDescriptor) -> "Vertex":
        if name in self.data_sinks:
            raise TezUncheckedException(f"duplicate data sink {name}")
        self.data_sinks[name] = sink
        return self

    def set_vertex_manager_plugin(
            self, desc: VertexManagerPluginDescriptor) -> "Vertex":
        self.vertex_manager = desc
        return self

    def set_conf(self, key: str, value: Any) -> "Vertex":
        self.conf[key] = value
        return self

    def __repr__(self) -> str:
        return f"Vertex({self.name}, parallelism={self.parallelism})"


class Edge:
    """Reference: Edge.java (api)."""

    def __init__(self, input_vertex: Vertex, output_vertex: Vertex,
                 edge_property: EdgeProperty):
        self.input_vertex = input_vertex    # producer
        self.output_vertex = output_vertex  # consumer
        self.edge_property = edge_property

    @staticmethod
    def create(input_vertex: Vertex, output_vertex: Vertex,
               edge_property: EdgeProperty) -> "Edge":
        return Edge(input_vertex, output_vertex, edge_property)

    @property
    def id(self) -> str:
        return f"{self.input_vertex.name}->{self.output_vertex.name}"

    def __repr__(self) -> str:
        return f"Edge({self.id}, {self.edge_property.data_movement_type.name})"


class VertexGroup:
    """Reference: VertexGroup (DAG.java:315) — alias for a set of vertices
    whose outputs feed one consumer through a merged input."""

    def __init__(self, name: str, members: Sequence[Vertex]):
        if len(members) < 2:
            raise TezUncheckedException("vertex group needs >= 2 members")
        self.name = name
        self.members = list(members)
        self.outputs: Dict[str, DataSinkDescriptor] = {}

    def add_data_sink(self, name: str, sink: DataSinkDescriptor) -> "VertexGroup":
        self.outputs[name] = sink
        for v in self.members:
            v.add_data_sink(name, sink)
        return self


class GroupInputEdge:
    """Reference: GroupInputEdge.java — group -> vertex edge with a merged
    input combining the per-member inputs."""

    def __init__(self, group: VertexGroup, output_vertex: Vertex,
                 edge_property: EdgeProperty, merged_input: EntityDescriptor):
        self.group = group
        self.output_vertex = output_vertex
        self.edge_property = edge_property
        self.merged_input = merged_input

    @staticmethod
    def create(group: VertexGroup, output_vertex: Vertex,
               edge_property: EdgeProperty,
               merged_input: EntityDescriptor) -> "GroupInputEdge":
        return GroupInputEdge(group, output_vertex, edge_property, merged_input)


class DAG:
    """Reference: DAG.java:90."""

    def __init__(self, name: str):
        if not name:
            raise TezUncheckedException("DAG needs a name")
        self.name = name
        self.vertices: Dict[str, Vertex] = {}
        self.edges: List[Edge] = []
        self.vertex_groups: Dict[str, VertexGroup] = {}
        self.group_edges: List[GroupInputEdge] = []
        self.conf: Dict[str, Any] = {}
        self.credentials: Dict[str, bytes] = {}

    @staticmethod
    def create(name: str) -> "DAG":
        return DAG(name)

    # -- construction -------------------------------------------------------
    def add_vertex(self, vertex: Vertex) -> "DAG":
        """Reference: DAG.addVertex:138 — duplicate names rejected."""
        if vertex.name in self.vertices:
            raise TezUncheckedException(f"duplicate vertex name {vertex.name}")
        if vertex.name in self.vertex_groups:
            raise TezUncheckedException(
                f"vertex name clashes with group {vertex.name}")
        self.vertices[vertex.name] = vertex
        return self

    def add_edge(self, edge: Edge) -> "DAG":
        """Reference: DAG.addEdge:287 — both endpoints must already exist;
        at most one edge per (src, dst) pair (the reference's VertexImpl keys
        source vertices by name, so a second edge would be unreachable)."""
        for v in (edge.input_vertex, edge.output_vertex):
            if self.vertices.get(v.name) is not v:
                raise TezUncheckedException(
                    f"vertex {v.name} not part of DAG {self.name}")
        if any(e.id == edge.id for e in self.edges):
            raise TezUncheckedException(f"duplicate edge {edge.id}")
        edge.input_vertex._out_edges.append(edge)
        edge.output_vertex._in_edges.append(edge)
        self.edges.append(edge)
        return self

    def create_vertex_group(self, name: str,
                            members: Sequence[Vertex]) -> VertexGroup:
        if name in self.vertex_groups or name in self.vertices:
            raise TezUncheckedException(f"duplicate group name {name}")
        for v in members:
            if self.vertices.get(v.name) is not v:
                raise TezUncheckedException(
                    f"group member {v.name} not part of DAG")
        group = VertexGroup(name, members)
        self.vertex_groups[name] = group
        return group

    def add_group_edge(self, edge: GroupInputEdge) -> "DAG":
        if self.vertex_groups.get(edge.group.name) is not edge.group:
            raise TezUncheckedException("group not part of DAG")
        if self.vertices.get(edge.output_vertex.name) is not edge.output_vertex:
            raise TezUncheckedException("output vertex not part of DAG")
        self.group_edges.append(edge)
        return self

    def set_conf(self, key: str, value: Any) -> "DAG":
        self.conf[key] = value
        return self

    # -- validation (DAG.verify:574) ----------------------------------------
    def verify(self) -> List[str]:
        """Topological check: rejects cycles, warns on disconnected
        sub-graphs; validates edge properties.  Returns topo order."""
        if not self.vertices:
            raise TezUncheckedException("empty DAG")

        adj: Dict[str, List[str]] = {v: [] for v in self.vertices}
        radj: Dict[str, List[str]] = {v: [] for v in self.vertices}
        all_edges: List[tuple] = [
            (e.input_vertex.name, e.output_vertex.name, e.edge_property)
            for e in self.edges
        ]
        for ge in self.group_edges:
            for m in ge.group.members:
                all_edges.append((m.name, ge.output_vertex.name, ge.edge_property))

        for src, dst, prop in all_edges:
            if src == dst:
                raise TezUncheckedException(f"self-edge on {src}")
            # ONE_TO_ONE requires equal (or runtime-determined) parallelism
            if prop.data_movement_type is DataMovementType.ONE_TO_ONE:
                sp = self.vertices[src].parallelism
                dp = self.vertices[dst].parallelism
                if sp != -1 and dp != -1 and sp != dp:
                    raise TezUncheckedException(
                        f"ONE_TO_ONE edge {src}->{dst} with unequal parallelism "
                        f"{sp} vs {dp}")
            adj[src].append(dst)
            radj[dst].append(src)

        # Kahn topo sort; leftover nodes => cycle (DAG.java checkCycles)
        indeg = {v: len(radj[v]) for v in self.vertices}
        order = [v for v in self.vertices if indeg[v] == 0]
        i = 0
        while i < len(order):
            for w in adj[order[i]]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    order.append(w)
            i += 1
        if len(order) != len(self.vertices):
            cyclic = sorted(v for v in self.vertices if indeg[v] > 0)
            raise TezUncheckedException(f"DAG contains a cycle through {cyclic}")

        # Disconnect check: every vertex reachable in the undirected sense
        # from vertex 0.  The reference runs disconnected component sets as
        # one DAG (DAG.java:574 verify only rejects cycles/dups — e.g.
        # tez-tests TwoLevelsFailingDAG is four disconnected pairs), so
        # this only WARNS; single fully-orphaned vertices are still legal.
        if len(self.vertices) > 1:
            seen: set = set()
            stack = [next(iter(self.vertices))]
            und: Dict[str, set] = {v: set() for v in self.vertices}
            for src, dst, _ in all_edges:
                und[src].add(dst)
                und[dst].add(src)
            while stack:
                v = stack.pop()
                if v in seen:
                    continue
                seen.add(v)
                stack.extend(und[v] - seen)
            if len(seen) != len(self.vertices):
                orphans = sorted(set(self.vertices) - seen)
                LOG.warning("DAG %s has disconnected components "
                            "(vertices %s not connected to %s)", self.name,
                            orphans, sorted(seen))
        return order

    # -- plan build (DAG.createDag:844) -------------------------------------
    def create_dag_plan(self, conf: Optional[Dict[str, Any]] = None) -> DAGPlan:
        self.verify()
        dag_conf = dict(conf or {})
        dag_conf.update(self.conf)

        edge_plans = tuple(
            EdgePlan(e.id, e.input_vertex.name, e.output_vertex.name,
                     e.edge_property) for e in self.edges)
        group_edge_plans = []
        synth_edges: List[EdgePlan] = []
        for ge in self.group_edges:
            gid = f"{ge.group.name}->{ge.output_vertex.name}"
            group_edge_plans.append(GroupInputEdgePlan(
                gid, ge.group.name, ge.output_vertex.name, ge.edge_property,
                ge.merged_input))
            # Materialize one concrete edge per member (reference expands
            # group edges into member edges inside DAGImpl).
            for m in ge.group.members:
                eid = f"{m.name}->{ge.output_vertex.name}#group:{ge.group.name}"
                synth_edges.append(EdgePlan(eid, m.name,
                                            ge.output_vertex.name,
                                            ge.edge_property))

        all_edge_plans = edge_plans + tuple(synth_edges)
        by_in: Dict[str, List[str]] = {v: [] for v in self.vertices}
        by_out: Dict[str, List[str]] = {v: [] for v in self.vertices}
        for ep in all_edge_plans:
            by_out[ep.input_vertex].append(ep.id)
            by_in[ep.output_vertex].append(ep.id)

        vertex_plans = []
        for v in self.vertices.values():
            vertex_plans.append(VertexPlan(
                name=v.name,
                processor=v.processor,
                parallelism=v.parallelism,
                vertex_manager=v.vertex_manager,
                root_inputs=tuple(
                    RootInputSpec(n, s.input_descriptor, s.initializer,
                                  s.parallelism, s.events)
                    for n, s in v.data_sources.items()),
                leaf_outputs=tuple(
                    LeafOutputSpec(n, s.output_descriptor, s.committer)
                    for n, s in v.data_sinks.items()),
                in_edge_ids=tuple(by_in[v.name]),
                out_edge_ids=tuple(by_out[v.name]),
                conf=dict(v.conf),
                task_resource_mb=v.task_resource_mb,
                locality_hints=v.locality_hints,
            ))

        return DAGPlan(
            name=self.name,
            vertices=tuple(vertex_plans),
            edges=all_edge_plans,
            vertex_groups=tuple(
                VertexGroupPlan(g.name, tuple(m.name for m in g.members),
                                tuple(g.outputs))
                for g in self.vertex_groups.values()),
            group_edges=tuple(group_edge_plans),
            dag_conf=dag_conf,
            credentials=dict(self.credentials),
            tenant=str(dag_conf.get("tez.dag.tenant", "") or ""),
        )
