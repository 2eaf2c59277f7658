"""Serializable DAG plan — the wire format a client ships to the orchestrator.

Reference parity: tez-api/src/main/proto/DAGApiRecords.proto (DAGPlan,
VertexPlan, EdgePlan, ConfigurationProto...) built by DAG.createDag
(DAG.java:844).  Plain frozen dataclasses serialized with pickle; structure
mirrors the proto so recovery/history can persist and reload plans.

The port's copy of tez_tpu.dag.plan.
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Dict, Optional, Tuple

from tez_tpu_torch.common.payload import (EntityDescriptor, InputDescriptor,
                                          InputInitializerDescriptor,
                                          OutputCommitterDescriptor,
                                          OutputDescriptor,
                                          ProcessorDescriptor,
                                          VertexManagerPluginDescriptor)
from tez_tpu_torch.dag.edge_property import EdgeProperty


@dataclasses.dataclass(frozen=True)
class RootInputSpec:
    """A data source attached to a vertex (reference: DataSourceDescriptor +
    RootInputLeafOutputProto)."""
    name: str
    input_descriptor: InputDescriptor
    initializer_descriptor: Optional[InputInitializerDescriptor] = None
    # If the client already knows parallelism (e.g. pre-computed splits):
    parallelism: int = -1
    events: Tuple[Any, ...] = ()   # pre-serialized InputDataInformationEvents


@dataclasses.dataclass(frozen=True)
class LeafOutputSpec:
    """A data sink attached to a vertex (reference: DataSinkDescriptor)."""
    name: str
    output_descriptor: OutputDescriptor
    committer_descriptor: Optional[OutputCommitterDescriptor] = None


@dataclasses.dataclass(frozen=True)
class VertexPlan:
    name: str
    processor: ProcessorDescriptor
    parallelism: int
    vertex_manager: Optional[VertexManagerPluginDescriptor]
    root_inputs: Tuple[RootInputSpec, ...]
    leaf_outputs: Tuple[LeafOutputSpec, ...]
    in_edge_ids: Tuple[str, ...]
    out_edge_ids: Tuple[str, ...]
    conf: Dict[str, Any]
    task_resource_mb: int = 0
    locality_hints: Tuple[Tuple[str, ...], ...] = ()


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    id: str
    input_vertex: str     # producer
    output_vertex: str    # consumer
    edge_property: EdgeProperty


@dataclasses.dataclass(frozen=True)
class VertexGroupPlan:
    name: str
    members: Tuple[str, ...]
    outputs: Tuple[str, ...]          # shared leaf-output names


@dataclasses.dataclass(frozen=True)
class GroupInputEdgePlan:
    id: str
    group_name: str
    output_vertex: str
    edge_property: EdgeProperty
    merged_input: EntityDescriptor


@dataclasses.dataclass(frozen=True)
class DAGPlan:
    name: str
    vertices: Tuple[VertexPlan, ...]
    edges: Tuple[EdgePlan, ...]
    vertex_groups: Tuple[VertexGroupPlan, ...] = ()
    group_edges: Tuple[GroupInputEdgePlan, ...] = ()
    dag_conf: Dict[str, Any] = dataclasses.field(default_factory=dict)
    credentials: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    #: tenant id for multi-tenant session AMs (admission caps, fair-share,
    #: store quotas — docs/multitenancy.md); "" = the anonymous tenant.
    #: Populated from ``tez.dag.tenant`` by DAG.create_dag_plan.
    tenant: str = ""

    def vertex(self, name: str) -> VertexPlan:
        for v in self.vertices:
            if v.name == name:
                return v
        raise KeyError(name)

    def edge(self, edge_id: str) -> EdgePlan:
        for e in self.edges:
            if e.id == edge_id:
                return e
        raise KeyError(edge_id)

    def serialize(self) -> bytes:
        return pickle.dumps(self)

    @staticmethod
    def deserialize(data: bytes) -> "DAGPlan":
        plan = pickle.loads(data)
        assert isinstance(plan, DAGPlan)
        return plan
