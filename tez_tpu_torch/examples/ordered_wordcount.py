"""OrderedWordCount: the reference's flagship example and the north-star
benchmark workload.

Reference parity: tez-examples/.../OrderedWordCount.java:56 (DAG at :124):
tokenizer --(word,1 sorted+combined)--> summation --(count,word sorted)-->
sorter, writing words ordered by count.  Both edges are sorted scatter-gather
running on the DeviceSorter; the count key uses the order-preserving
big-endian long serde so numeric order == byte order.

The port's copy of tez_tpu.examples.ordered_wordcount: ``run(...,
device="cuda")`` submits the DAG through the port's own TezClient and AM,
whose tasks sort and merge on the card.  The vectorised tokenizer runs on
the host library (ops/native.py) as tez_tpu's does: its word-count
aggregator when the edge combines with the sum combiner, its whitespace
split otherwise.  ``exchange="mesh"`` raises NotImplementedError until the
mesh exchange is ported.
"""
from __future__ import annotations

import sys
from typing import Dict

from tez_tpu_torch.api.runtime import LogicalInput, LogicalOutput
from tez_tpu_torch.client.tez_client import TezClient
from tez_tpu_torch.common.payload import (InputDescriptor,
                                          InputInitializerDescriptor,
                                          OutputCommitterDescriptor,
                                          OutputDescriptor,
                                          ProcessorDescriptor)
from tez_tpu_torch.dag.dag import (DAG, DataSinkDescriptor,
                                   DataSourceDescriptor, Edge, Vertex)
from tez_tpu_torch.library.conf import OrderedPartitionedKVEdgeConfig
from tez_tpu_torch.library.processors import SimpleProcessor


class TokenProcessor(SimpleProcessor):
    """Split lines into words, emit (word, 1)."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        reader = inputs["input"].get_reader()
        writer = outputs["summation"].get_writer()
        for _offset, line in reader:
            for word in line.split():
                writer.write(word, 1)


class VectorTokenProcessor(SimpleProcessor):
    """Batch-first tokenizer over large line-aligned chunks, records shipped
    as pre-serialized KVBatches (write_batch): no per-record Python on the
    hot path.  This is the batch-first shape of the reference's per-record
    map loop (the bench path)."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        import numpy as np
        from tez_tpu_torch.ops import native
        from tez_tpu_torch.ops.runformat import KVBatch
        from tez_tpu_torch.ops.serde import VarLongSerde, encode_longs_be
        from tez_tpu_torch.ops.sorter import sum_long_combiner

        reader = inputs["input"].get_reader()
        writer = outputs["summation"].get_writer()
        sorter = getattr(outputs["summation"], "sorter", None)
        if sorter is not None and sorter.combiner is sum_long_combiner:
            # fused tokenize and count: the task emits the partial counts
            # the combiner would have produced, one record a distinct word
            agg = native.WordCountAggregator()
            try:
                for chunk in reader.iter_chunks():
                    agg.feed(chunk)
                key_bytes, key_offsets, counts = agg.emit()
            finally:
                agg.close()
            # the keys are unique already: a single-span sort skips its
            # precombine
            writer.write_batch(KVBatch(
                key_bytes, key_offsets, encode_longs_be(counts),
                np.arange(len(counts) + 1, dtype=np.int64) * 8,
                pre_combined=True))
            return
        one = VarLongSerde().to_bytes(1)
        for chunk in reader.iter_chunks():
            key_bytes, key_offsets = native.split_ws_native(chunk)
            n = len(key_offsets) - 1
            if n == 0:
                continue
            val_bytes = np.frombuffer(one * n, dtype=np.uint8).copy()
            val_offsets = np.arange(n + 1, dtype=np.int64) * len(one)
            writer.write_batch(KVBatch(key_bytes, key_offsets,
                                       val_bytes, val_offsets))


class SumProcessor(SimpleProcessor):
    """Sum counts per word, emit (count, word) toward the sorter.

    Batch-first when the reader supports it: per-group sums via one
    np.add.reduceat, output shipped as a single pre-serialized KVBatch."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        import numpy as np
        reader = inputs["tokenizer"].get_reader()
        writer = outputs["sorter"].get_writer()
        # probe the writer config BEFORE consuming the reader: a custom
        # Partitioner rejects write_batch, and falling back mid-stream
        # would lose already-consumed groups
        if hasattr(reader, "grouped_blocks") and \
                getattr(writer, "supports_batch", False):
            from tez_tpu_torch.ops.runformat import KVBatch, gather_ragged
            from tez_tpu_torch.ops.serde import (decode_longs_be,
                                                 encode_longs_be)
            for batch, starts in reader.grouped_blocks():
                n = batch.num_records
                if n == 0:
                    continue
                if bool(np.all(np.diff(batch.val_offsets) == 8)):
                    decoded = decode_longs_be(batch.val_bytes, n)
                    sums = np.add.reduceat(decoded, starts)
                    words_b, words_o = gather_ragged(
                        batch.key_bytes, batch.key_offsets, starts)
                    key_bytes = encode_longs_be(sums)
                    key_offsets = np.arange(len(sums) + 1,
                                            dtype=np.int64) * 8
                    writer.write_batch(KVBatch(key_bytes, key_offsets,
                                               words_b, words_o))
                else:
                    # mixed-width values (non-long serde): per-record via
                    # the reader's OWN serdes for this block only — groups
                    # are complete per block, so correctness is unaffected
                    bounds = np.append(starts, n)
                    for s, e in zip(bounds[:-1], bounds[1:]):
                        word = reader.key_serde.from_bytes(batch.key(int(s)))
                        total = sum(
                            reader.val_serde.from_bytes(batch.value(i))
                            for i in range(int(s), int(e)))
                        writer.write(total, word)
            return
        for word, counts in reader:
            writer.write(sum(counts), word)


class NoOpSorterProcessor(SimpleProcessor):
    """Write the (count, word) stream — already globally count-ordered when
    sorter parallelism is 1 (reference: OrderedWordCount NoOpSorter).

    Batch-first when reader and writer support it: output lines assemble
    via ONE ragged gather over a pool of [word rows + per-group
    '\\t<count>\\n' tails] (zero per-record Python)."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        import numpy as np
        reader = inputs["summation"].get_reader()
        writer = outputs["output"].get_writer()
        if hasattr(reader, "grouped_blocks") and hasattr(writer, "write_raw"):
            from tez_tpu_torch.ops.runformat import gather_ragged
            from tez_tpu_torch.ops.serde import decode_longs_be
            # honor a configured output separator (the iterator path writes
            # through _PartWriter, which does) — format the same bytes here
            sep = getattr(writer, "sep", b"\t")
            for batch, starts in reader.grouped_blocks():
                n = batch.num_records
                if n == 0:
                    continue
                if not bool(np.all(np.diff(batch.key_offsets) == 8)):
                    # non-long count keys: per-record for this block only
                    bounds = np.append(starts, n)
                    for s, e in zip(bounds[:-1], bounds[1:]):
                        count = reader.key_serde.from_bytes(batch.key(int(s)))
                        for i in range(int(s), int(e)):
                            word = reader.val_serde.from_bytes(batch.value(i))
                            writer.write(word, str(count))
                    continue
                counts = decode_longs_be(batch.key_bytes, n)
                tails = [sep + b"%d\n" % int(counts[s]) for s in starts]
                tail_bytes = np.frombuffer(b"".join(tails), dtype=np.uint8)
                tail_lens = np.array([len(t) for t in tails],
                                     dtype=np.int64)
                pool_bytes = np.concatenate([batch.val_bytes, tail_bytes])
                pool_offsets = np.concatenate([
                    batch.val_offsets,
                    batch.val_offsets[-1] + np.cumsum(tail_lens)])
                # record i -> rows (word_i, tail_of_group(i))
                group_of = np.zeros(n, dtype=np.int64)
                group_of[starts[1:]] = 1
                group_of = np.cumsum(group_of)
                perm = np.empty(2 * n, dtype=np.int64)
                perm[0::2] = np.arange(n)
                perm[1::2] = n + group_of
                lines, _ = gather_ragged(pool_bytes, pool_offsets, perm)
                writer.write_raw(lines.tobytes(), n)
            return
        for count, words in reader:
            for word in words:
                writer.write(word, str(count))


def build_dag(input_paths, output_path: str, tokenizer_parallelism: int = -1,
              summation_parallelism: int = 2, sorter_parallelism: int = 1,
              combine: bool = True, pipelined: bool = False,
              exchange: str = "host", tokenizer_mode: str = "simple") -> DAG:
    """tokenizer_mode="vector" uses the batch-first tokenizer (the bench
    path).  exchange="mesh" (tez_tpu's device-mesh exchange of the
    first edge) is not ported yet and raises NotImplementedError."""
    if exchange != "host":
        raise NotImplementedError(
            f"exchange={exchange!r}: only the host shuffle is ported")
    tok_cls = VectorTokenProcessor if tokenizer_mode == "vector" \
        else TokenProcessor
    tokenizer = Vertex.create("tokenizer", ProcessorDescriptor.create(
        tok_cls), tokenizer_parallelism)
    tokenizer.add_data_source("input", DataSourceDescriptor.create(
        InputDescriptor.create("tez_tpu_torch.io.text:TextInput"),
        InputInitializerDescriptor.create(
            "tez_tpu_torch.io.text:TextSplitGenerator",
            payload={"paths": list(input_paths),
                     "desired_splits": tokenizer_parallelism}),
    ))
    summation = Vertex.create("summation", ProcessorDescriptor.create(
        SumProcessor), summation_parallelism)
    sorter = Vertex.create("sorter", ProcessorDescriptor.create(
        NoOpSorterProcessor), sorter_parallelism)
    sorter.add_data_sink("output", DataSinkDescriptor.create(
        OutputDescriptor.create("tez_tpu_torch.io.file_output:FileOutput",
                                payload={"path": output_path,
                                         "key_serde": "text",
                                         "value_serde": "text"}),
        OutputCommitterDescriptor.create(
            "tez_tpu_torch.io.file_output:FileOutputCommitter",
            payload={"path": output_path})))

    e1_builder = OrderedPartitionedKVEdgeConfig.new_builder("bytes", "long")
    if combine:
        e1_builder.set_combiner("sum_long")
    if pipelined:
        e1_builder.set_pipelined(True)
    e1 = e1_builder.build()
    e2 = OrderedPartitionedKVEdgeConfig.new_builder("long", "bytes").build()

    dag = DAG.create("OrderedWordCount")
    dag.add_vertex(tokenizer).add_vertex(summation).add_vertex(sorter)
    dag.add_edge(Edge.create(tokenizer, summation,
                             e1.create_default_edge_property()))
    dag.add_edge(Edge.create(summation, sorter,
                             e2.create_default_edge_property()))
    return dag


def run(input_paths, output_path: str, conf=None, device="cuda",
        **kw) -> str:
    """Run OrderedWordCount through the port's TezClient and AM; the tasks
    run on `device` (the card unless the caller passes "cpu").  Returns the
    DAG's final state name."""
    with TezClient.create("OrderedWordCount", conf or {},
                          device=device) as client:
        dag = build_dag(input_paths, output_path, **kw)
        status = client.submit_dag(dag).wait_for_completion()
        return status.state.name


def main() -> int:
    if len(sys.argv) < 3:
        print("usage: ordered_wordcount <input...> <output_dir>")
        return 2
    state = run(sys.argv[1:-1], sys.argv[-1])
    print(state)
    return 0 if state == "SUCCEEDED" else 1


if __name__ == "__main__":
    sys.exit(main())
