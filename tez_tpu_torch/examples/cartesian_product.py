"""CartesianProduct example: cross product of two datasets via the
first-class CUSTOM edge.

Reference parity: tez-examples/.../CartesianProduct.java (two source
vertices cross-joined into one consumer through
CartesianProductVertexManager + CartesianProductEdgeManager; output is
every (left, right) token pair).

The port's copy of tez_tpu.examples.cartesian_product: ``run(...,
device="cuda")`` submits the DAG through the port's TezClient and AM on
that device (the card unless the caller passes "cpu").  Its edges are
CUSTOM unordered edges, so the product is host work.
"""
from __future__ import annotations

import sys
from typing import Dict

from tez_tpu_torch.api.runtime import LogicalInput, LogicalOutput
from tez_tpu_torch.client.tez_client import TezClient
from tez_tpu_torch.common.payload import (EdgeManagerPluginDescriptor,
                                          InputDescriptor,
                                          InputInitializerDescriptor,
                                          OutputCommitterDescriptor,
                                          OutputDescriptor,
                                          ProcessorDescriptor,
                                          VertexManagerPluginDescriptor)
from tez_tpu_torch.dag.dag import (DAG, DataSinkDescriptor,
                                   DataSourceDescriptor, Edge, Vertex)
from tez_tpu_torch.dag.edge_property import DataSourceType, EdgeProperty
from tez_tpu_torch.library.processors import SimpleProcessor


class TokenForwardProcessor(SimpleProcessor):
    """Reads this task's text split, forwards each token downstream."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        writer = next(iter(outputs.values())).get_writer()
        for _off, line in inputs["input"].get_reader():
            for token in line.split():
                writer.write(token, b"")


class PairWriterProcessor(SimpleProcessor):
    """Emits 'left|right' for every pair of tokens across its two inputs."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        writer = outputs["output"].get_writer()
        left = [k for k, _v in inputs["left"].get_reader()]
        right = [k for k, _v in inputs["right"].get_reader()]
        for a in left:
            for b in right:
                writer.write(a + b"|" + b, b"1")


def _source_vertex(name: str, path: str, parallelism: int) -> Vertex:
    v = Vertex.create(name, ProcessorDescriptor.create(
        TokenForwardProcessor), parallelism)
    v.add_data_source("input", DataSourceDescriptor.create(
        InputDescriptor.create("tez_tpu_torch.io.formats:MRInput",
                               payload={"format": "text"}),
        InputInitializerDescriptor.create(
            "tez_tpu_torch.io.formats:MRSplitGenerator",
            payload={"paths": [path], "desired_splits": parallelism,
                     "format": "text"})))
    return v


def build_dag(left_path: str, right_path: str, output_path: str,
              source_parallelism: int = 2,
              joiner_parallelism: int = 4) -> DAG:
    left = _source_vertex("left", left_path, source_parallelism)
    right = _source_vertex("right", right_path, source_parallelism)
    joiner = Vertex.create("joiner", ProcessorDescriptor.create(
        PairWriterProcessor), joiner_parallelism)
    joiner.add_data_sink("output", DataSinkDescriptor.create(
        OutputDescriptor.create(
            "tez_tpu_torch.io.file_output:FileOutput",
            payload={"path": output_path, "key_serde": "text",
                     "value_serde": "text"}),
        OutputCommitterDescriptor.create(
            "tez_tpu_torch.io.file_output:FileOutputCommitter",
            payload={"path": output_path})))
    joiner.set_vertex_manager_plugin(VertexManagerPluginDescriptor.create(
        "tez_tpu_torch.library.cartesian_product:"
        "CartesianProductVertexManager",
        payload={"sources": ["left", "right"]}))
    conf = {"tez.runtime.key.class": "bytes",
            "tez.runtime.value.class": "bytes"}

    def cp_edge() -> EdgeProperty:
        return EdgeProperty.create_custom(
            EdgeManagerPluginDescriptor.create(
                "tez_tpu_torch.library.cartesian_product:"
                "CartesianProductEdgeManager", payload={}),
            DataSourceType.PERSISTED,
            OutputDescriptor.create(
                "tez_tpu_torch.library.unordered:UnorderedKVOutput",
                payload=conf),
            InputDescriptor.create(
                "tez_tpu_torch.library.unordered:UnorderedKVInput",
                payload=conf))

    dag = DAG.create("CartesianProduct")
    for v in (left, right, joiner):
        dag.add_vertex(v)
    dag.add_edge(Edge.create(left, joiner, cp_edge()))
    dag.add_edge(Edge.create(right, joiner, cp_edge()))
    return dag


def run(left_path, right_path, output_path: str, conf=None,
        device="cuda", **kw) -> str:
    """Run CartesianProduct through the port's TezClient and AM on
    `device`; returns the DAG's final state."""
    if isinstance(left_path, (list, tuple)):
        left_path = left_path[0]
    if isinstance(right_path, (list, tuple)):
        right_path = right_path[0]
    with TezClient.create("CartesianProduct", conf or {},
                          device=device) as client:
        status = client.submit_dag(build_dag(
            left_path, right_path, output_path, **kw)).wait_for_completion()
        return status.state.name


if __name__ == "__main__":
    if len(sys.argv) != 4:
        print("usage: cartesian_product <left_file> <right_file> "
              "<output_dir>")
        sys.exit(2)
    print(run(sys.argv[1], sys.argv[2], sys.argv[3]))
