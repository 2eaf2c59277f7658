"""MapReduce compatibility layer: run map/reduce-style user code on DAGs.

Reference parity: tez-mapreduce (MapProcessor.java:403 / ReduceProcessor.java
:369 running real Mapper/Reducer code on Tez, plus the client shim that
translates MR jobs into 2-vertex DAGs).  User functions are plain Python:

    def mapper(key, value) -> iterable[(k, v)]
    def reducer(key, values) -> iterable[(k, v)]

`simple_mr_dag` builds the canonical map->reduce DAG over text input /
file output with a sorted scatter-gather edge in between.

The port's copy of tez_tpu.io.mapreduce: the DAGs it builds name the
port's formats, outputs and committer; their sorted edges run the port's
sorter and merges (on the card, its kernels).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from tez_tpu_torch.api.runtime import (KeyValueReader, KeyValuesReader,
                                       LogicalInput, LogicalOutput)
from tez_tpu_torch.common.payload import (InputDescriptor,
                                          InputInitializerDescriptor,
                                          OutputCommitterDescriptor,
                                          OutputDescriptor, ProcessorDescriptor)
from tez_tpu_torch.dag.dag import (DAG, DataSinkDescriptor, DataSourceDescriptor,
                                   Edge, Vertex)
from tez_tpu_torch.library.conf import OrderedPartitionedKVEdgeConfig
from tez_tpu_torch.library.processors import SimpleProcessor

MapFn = Callable[[Any, Any], Iterable[Tuple[Any, Any]]]
ReduceFn = Callable[[Any, Iterable[Any]], Iterable[Tuple[Any, Any]]]


def _resolve_fn(payload: dict, key: str) -> Callable:
    from tez_tpu_torch.common.payload import resolve_class
    target = payload[key]
    if callable(target):
        return target
    return resolve_class(target)


class MapProcessor(SimpleProcessor):
    """Drives the user map function over every (key, value) of every input;
    emits to every non-leaf output (reference: MapProcessor.java)."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        payload = self.context.user_payload.load() or {}
        mapper: MapFn = _resolve_fn(payload, "map_fn")
        writers = [o.get_writer() for o in outputs.values()]
        for inp in inputs.values():
            reader = inp.get_reader()
            if isinstance(reader, KeyValuesReader):
                items = ((k, v) for k, vs in reader for v in vs)
            else:
                items = iter(reader)
            for k, v in items:
                for ok, ov in mapper(k, v):
                    for w in writers:
                        w.write(ok, ov)


class ReduceProcessor(SimpleProcessor):
    """Drives the user reduce function over grouped input (reference:
    ReduceProcessor.java)."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        payload = self.context.user_payload.load() or {}
        reducer: ReduceFn = _resolve_fn(payload, "reduce_fn")
        writers = [o.get_writer() for o in outputs.values()]
        for inp in inputs.values():
            reader = inp.get_reader()
            if isinstance(reader, KeyValuesReader):
                groups = iter(reader)
            else:  # unordered input: group in memory
                acc: Dict[Any, list] = {}
                for k, v in reader:
                    acc.setdefault(k, []).append(v)
                groups = iter(sorted(acc.items()))
            from tez_tpu_torch.common.counters import TaskCounter
            out_records = self.context.counters.find_counter(
                TaskCounter.REDUCE_OUTPUT_RECORDS)
            for k, vs in groups:
                for ok, ov in reducer(k, vs):
                    out_records.increment()
                    for w in writers:
                        w.write(ok, ov)


def simple_mr_dag(name: str, input_paths, output_path: str,
                  map_fn: str, reduce_fn: str,
                  num_mappers: int = -1, num_reducers: int = 2,
                  key_serde: str = "bytes", value_serde: str = "bytes",
                  intermediate_serdes: Tuple[str, str] = ("bytes", "bytes"),
                  combiner: str = "",
                  input_format: str = "text",
                  format_params: Optional[dict] = None,
                  multi_input: bool = False) -> DAG:
    """The YARNRunner-analog translation: one map vertex over format-driven
    splits (io/formats.py SPI — "text", "fixed", or a module:Class path;
    reference: MRInput.java:87 arbitrary InputFormats), one reduce vertex
    over a sorted shuffle, file-committed output.  multi_input swaps in the
    MultiMRInput analog (one reader per split).  map_fn/reduce_fn are
    "module:callable" strings (must be importable in runner processes)."""
    return mr_chain_dag(name, input_paths, output_path, map_fn,
                        reduce_fns=[reduce_fn], num_mappers=num_mappers,
                        num_reducers=num_reducers, key_serde=key_serde,
                        value_serde=value_serde,
                        stage_serdes=[intermediate_serdes],
                        combiner=combiner, input_format=input_format,
                        format_params=format_params,
                        multi_input=multi_input)


def _map_vertex(map_fn: str, input_paths, num_mappers: int,
                input_format: str, format_params: Optional[dict],
                multi_input: bool) -> Vertex:
    """The map vertex + its MRInput data source (shared by the conf
    translation and the programmatic builders)."""
    input_cls = "tez_tpu_torch.io.formats:MultiMRInput" if multi_input \
        else "tez_tpu_torch.io.formats:MRInput"
    mapper = Vertex.create("map", ProcessorDescriptor.create(
        MapProcessor, payload={"map_fn": map_fn}), num_mappers)
    mapper.add_data_source("input", DataSourceDescriptor.create(
        InputDescriptor.create(input_cls,
                               payload={"format": input_format,
                                        "format_params": format_params}),
        InputInitializerDescriptor.create(
            "tez_tpu_torch.io.formats:MRSplitGenerator",
            payload={"paths": list(input_paths),
                     "desired_splits": num_mappers,
                     "format": input_format,
                     "format_params": format_params})))
    return mapper


def _file_sink(output_path: str, key_serde: str,
               value_serde: str) -> DataSinkDescriptor:
    return DataSinkDescriptor.create(
        OutputDescriptor.create(
            "tez_tpu_torch.io.file_output:FileOutput",
            payload={"path": output_path, "key_serde": key_serde,
                     "value_serde": value_serde}),
        OutputCommitterDescriptor.create(
            "tez_tpu_torch.io.file_output:FileOutputCommitter",
            payload={"path": output_path}))


#: Hadoop Writable / format class names -> native serde / format names.
#: Native names pass through, so a conf can mix both vocabularies.
_WRITABLE_TO_SERDE = {
    "org.apache.hadoop.io.Text": "text",
    "org.apache.hadoop.io.LongWritable": "long",
    "org.apache.hadoop.io.IntWritable": "long",
    "org.apache.hadoop.io.BytesWritable": "bytes",
    "org.apache.hadoop.io.NullWritable": "bytes",
}
_FORMAT_TO_NATIVE = {
    "org.apache.hadoop.mapreduce.lib.input.TextInputFormat": "text",
    "org.apache.hadoop.mapred.TextInputFormat": "text",
    "org.apache.hadoop.mapreduce.lib.input.KeyValueTextInputFormat": "text",
}


def _job_conf(conf: dict, new_key: str, old_key: str, default=None):
    """mapreduce.* wins over the legacy mapred.* alias (YARNRunner's
    dual-vocabulary conf handling)."""
    if new_key in conf:
        return conf[new_key]
    if old_key in conf:
        return conf[old_key]
    return default


def _serde_for(cls_name: Optional[str], default: str = "bytes") -> str:
    if not cls_name:
        return default
    return _WRITABLE_TO_SERDE.get(cls_name, cls_name)


def mr_job_to_dag(job_conf: dict) -> DAG:
    """Translate an MR JOB CONF into a DAG — the YARNRunner seam
    (reference: tez-mapreduce/.../client/YARNRunner.java translating a
    submitted MR job's Configuration into a 2-vertex Tez DAG;
    MRRuntimeProtos.proto carries the conf to the runtime).

    Honored keys (mapreduce.* with legacy mapred.* aliases):
      job name        mapreduce.job.name            / mapred.job.name
      mapper          mapreduce.job.map.class       / mapred.mapper.class
      reducer         mapreduce.job.reduce.class    / mapred.reducer.class
      combiner        mapreduce.job.combine.class   / mapred.combiner.class
      map count hint  mapreduce.job.maps            / mapred.map.tasks
      reduce count    mapreduce.job.reduces         / mapred.reduce.tasks
      input paths     mapreduce.input.fileinputformat.inputdir
                                                    / mapred.input.dir
      output path     mapreduce.output.fileoutputformat.outputdir
                                                    / mapred.output.dir
      input format    mapreduce.job.inputformat.class
                                                    / mapred.input.format.class
      map out K/V     mapreduce.map.output.key.class / .value.class
      job out K/V     mapreduce.job.output.key.class / .value.class

    Mapper/reducer/combiner classes are "module:callable" paths (the
    Python analog of class names); Hadoop Writable and TextInputFormat
    class names map onto native serdes/formats, and native names pass
    through.  mapreduce.job.reduces=0 builds the map-only DAG (mapper
    commits straight to the output), exactly like the reference."""
    g = lambda nk, ok, d=None: _job_conf(job_conf, nk, ok, d)  # noqa: E731
    name = g("mapreduce.job.name", "mapred.job.name", "mr-job")
    map_fn = g("mapreduce.job.map.class", "mapred.mapper.class")
    if not map_fn:
        raise ValueError(
            "job conf has no mapper (mapreduce.job.map.class)")
    reduce_fn = g("mapreduce.job.reduce.class", "mapred.reducer.class")
    combiner = g("mapreduce.job.combine.class", "mapred.combiner.class", "")
    num_maps = int(g("mapreduce.job.maps", "mapred.map.tasks", -1))
    num_reduces = int(g("mapreduce.job.reduces", "mapred.reduce.tasks", 1))
    inputs = g("mapreduce.input.fileinputformat.inputdir",
               "mapred.input.dir")
    output = g("mapreduce.output.fileoutputformat.outputdir",
               "mapred.output.dir")
    if not inputs or not output:
        raise ValueError("job conf needs input dir(s) and an output dir")
    input_paths = [p.strip() for p in str(inputs).split(",") if p.strip()]
    in_fmt = g("mapreduce.job.inputformat.class",
               "mapred.input.format.class", "text")
    in_fmt = _FORMAT_TO_NATIVE.get(in_fmt, in_fmt)
    out_k = _serde_for(g("mapreduce.job.output.key.class",
                         "mapred.output.key.class"))
    out_v = _serde_for(g("mapreduce.job.output.value.class",
                         "mapred.output.value.class"))
    # Hadoop semantics: map-output classes DEFAULT to the job output
    # classes when unset (JobConf.getMapOutputKeyClass)
    mid_k = _serde_for(g("mapreduce.map.output.key.class",
                         "mapred.mapoutput.key.class"), default=out_k)
    mid_v = _serde_for(g("mapreduce.map.output.value.class",
                         "mapred.mapoutput.value.class"), default=out_v)

    if num_reduces <= 0:
        # map-only job: the mapper commits straight to the sink
        mapper = _map_vertex(map_fn, input_paths, num_maps, in_fmt, None,
                             multi_input=False)
        mapper.add_data_sink("output", _file_sink(output, out_k, out_v))
        return DAG.create(name).add_vertex(mapper)

    if not reduce_fn:
        raise ValueError(
            f"job conf sets {num_reduces} reduces but no reducer class")
    return simple_mr_dag(
        name, input_paths, output, map_fn, reduce_fn,
        num_mappers=num_maps, num_reducers=num_reduces,
        key_serde=out_k, value_serde=out_v,
        intermediate_serdes=(mid_k, mid_v),
        combiner=combiner, input_format=in_fmt)


def mr_chain_dag(name: str, input_paths, output_path: str,
                 map_fn: str, reduce_fns, num_mappers: int = -1,
                 num_reducers=2,
                 key_serde: str = "bytes", value_serde: str = "bytes",
                 stage_serdes=None,
                 combiner: str = "",
                 input_format: str = "text",
                 format_params: Optional[dict] = None,
                 multi_input: bool = False) -> DAG:
    """Chained-job translation (MRR): one map vertex plus N reduce stages —
    map -> r1 -> ... -> rN — each stage joined by its own sorted
    scatter-gather edge, the last stage file-committed.

    Reference role: the MR client shim translating a SEQUENCE of dependent
    MR jobs into one DAG (YARNRunner-style; the canonical MRR workloads are
    tez-tests TestOrderedWordCount.java / MRRSleepJob.java).

    reduce_fns: list of "module:callable" strings, one per stage.
    num_reducers: int (same for all stages) or list per stage.
    stage_serdes: per-EDGE (key, value) serde names, len(reduce_fns)
    entries; defaults to ("bytes", "bytes") everywhere.
    """
    if not reduce_fns:
        raise ValueError("mr_chain_dag needs at least one reduce stage")
    n_stages = len(reduce_fns)
    if isinstance(num_reducers, int):
        num_reducers = [num_reducers] * n_stages
    if len(num_reducers) != n_stages:
        raise ValueError(f"num_reducers: want {n_stages} entries")
    stage_serdes = stage_serdes or [("bytes", "bytes")] * n_stages
    if len(stage_serdes) != n_stages:
        raise ValueError(f"stage_serdes: want {n_stages} entries")

    mapper = _map_vertex(map_fn, input_paths, num_mappers, input_format,
                         format_params, multi_input)
    dag = DAG.create(name).add_vertex(mapper)
    upstream = mapper
    for i, (fn, par, serdes) in enumerate(
            zip(reduce_fns, num_reducers, stage_serdes)):
        last = i == n_stages - 1
        reducer = Vertex.create(
            f"reduce{i + 1}" if n_stages > 1 else "reduce",
            ProcessorDescriptor.create(ReduceProcessor,
                                       payload={"reduce_fn": fn}), par)
        if last:
            reducer.add_data_sink("output", _file_sink(
                output_path, key_serde, value_serde))
        builder = OrderedPartitionedKVEdgeConfig.new_builder(*serdes)
        if combiner and i == 0:
            builder.set_combiner(combiner)   # map-side combine only
        dag.add_vertex(reducer)
        dag.add_edge(Edge.create(
            upstream, reducer,
            builder.build().create_default_edge_property()))
        upstream = reducer
    return dag
