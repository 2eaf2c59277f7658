"""Fluent edge configuration builders.

The port's copy of tez_tpu.library.conf: the ordered edge names the port's
OrderedPartitionedKVOutput and OrderedGroupedKVInput; the unordered and
mesh edges raise NotImplementedError until their IO is ported.

Reference parity: tez-runtime-library/.../library/conf/
{OrderedPartitionedKVEdgeConfig,UnorderedKVEdgeConfig,
UnorderedPartitionedKVEdgeConfig}.java — build EdgeProperty instances with
the runtime config serialized into the IO payloads (the "runtime config
travels inside the edge payload" rule, SURVEY.md §5.6).
"""
from __future__ import annotations

from typing import Any, Dict

from tez_tpu_torch.common.payload import InputDescriptor, OutputDescriptor
from tez_tpu_torch.dag.edge_property import (DataMovementType, DataSourceType,
                                             EdgeProperty, SchedulingType)


class _BaseEdgeConfigBuilder:
    _output_class: str = ""
    _input_class: str = ""
    _movement: DataMovementType = DataMovementType.SCATTER_GATHER

    def __init__(self, key_serde: str = "bytes", value_serde: str = "bytes"):
        self.conf: Dict[str, Any] = {
            "tez.runtime.key.class": key_serde,
            "tez.runtime.value.class": value_serde,
        }

    def set_conf(self, key: str, value: Any) -> "_BaseEdgeConfigBuilder":
        self.conf[key] = value
        return self

    def set_from_configuration(self, conf: Dict[str, Any]
                               ) -> "_BaseEdgeConfigBuilder":
        for k, v in conf.items():
            if k.startswith("tez.runtime."):
                self.conf[k] = v
        return self

    def build(self) -> "_EdgeConfig":
        return _EdgeConfig(self._output_class, self._input_class,
                           self._movement, dict(self.conf))


class _EdgeConfig:
    def __init__(self, output_class: str, input_class: str,
                 movement: DataMovementType, conf: Dict[str, Any]):
        self.output_class = output_class
        self.input_class = input_class
        self.movement = movement
        self.conf = conf

    def _descriptors(self) -> tuple:
        return (OutputDescriptor.create(self.output_class, payload=self.conf),
                InputDescriptor.create(self.input_class, payload=self.conf))

    def create_default_edge_property(self) -> EdgeProperty:
        out, inp = self._descriptors()
        return EdgeProperty.create(self.movement, DataSourceType.PERSISTED,
                                   SchedulingType.SEQUENTIAL, out, inp)

    def create_default_broadcast_edge_property(self) -> EdgeProperty:
        out, inp = self._descriptors()
        return EdgeProperty.create(DataMovementType.BROADCAST,
                                   DataSourceType.PERSISTED,
                                   SchedulingType.SEQUENTIAL, out, inp)

    def create_default_one_to_one_edge_property(self) -> EdgeProperty:
        out, inp = self._descriptors()
        return EdgeProperty.create(DataMovementType.ONE_TO_ONE,
                                   DataSourceType.PERSISTED,
                                   SchedulingType.SEQUENTIAL, out, inp)

    def create_default_custom_edge_property(self, edge_manager) -> EdgeProperty:
        out, inp = self._descriptors()
        return EdgeProperty.create_custom(edge_manager,
                                          DataSourceType.PERSISTED, out, inp)


class OrderedPartitionedKVEdgeConfig(_BaseEdgeConfigBuilder):
    """Sorted scatter-gather edge (DeviceSorter -> grouped merge input)."""
    _output_class = "tez_tpu_torch.library.outputs:OrderedPartitionedKVOutput"
    _input_class = "tez_tpu_torch.library.inputs:OrderedGroupedKVInput"
    _movement = DataMovementType.SCATTER_GATHER

    @staticmethod
    def new_builder(key_serde: str = "bytes", value_serde: str = "bytes"
                    ) -> "OrderedPartitionedKVEdgeConfig":
        return OrderedPartitionedKVEdgeConfig(key_serde, value_serde)

    def set_combiner(self, combiner: str) -> "OrderedPartitionedKVEdgeConfig":
        self.conf["tez.runtime.combiner.class"] = combiner
        return self

    def set_key_width(self, width: int) -> "OrderedPartitionedKVEdgeConfig":
        self.conf["tez.runtime.tpu.key.width.bytes"] = width
        return self

    def set_pipelined(self, enabled: bool = True
                      ) -> "OrderedPartitionedKVEdgeConfig":
        self.conf["tez.runtime.pipelined-shuffle.enabled"] = enabled
        return self

    def set_sort_mb(self, mb: int) -> "OrderedPartitionedKVEdgeConfig":
        self.conf["tez.runtime.io.sort.mb"] = mb
        return self


class _NotPortedEdgeConfig(_BaseEdgeConfigBuilder):
    """An edge whose IO the port lacks: building one raises."""
    _what = ""

    def __init__(self, key_serde: str = "bytes", value_serde: str = "bytes"):
        raise NotImplementedError(
            f"{type(self).__name__}: {self._what} is not ported yet "
            "(ROADMAP Queue 1 item 7)")

    @classmethod
    def new_builder(cls, key_serde: str = "bytes", value_serde: str = "bytes"):
        return cls(key_serde, value_serde)


class UnorderedKVEdgeConfig(_NotPortedEdgeConfig):
    """Unsorted single-partition edge (broadcast / pass-through)."""
    _what = "library/unordered.py"


class UnorderedPartitionedKVEdgeConfig(_NotPortedEdgeConfig):
    """Hash-partitioned unsorted scatter-gather edge."""
    _what = "library/unordered.py"


class MeshOrderedPartitionedKVEdgeConfig(_NotPortedEdgeConfig):
    """Sorted scatter-gather edge over the device mesh exchange."""
    _what = "the mesh exchange (library/mesh_io.py)"
