"""Sort-merge join: two sorted scatter-gather edges into one joiner.

Reference parity: tez-examples/.../SortMergeJoinExample.java:72 (benchmark
workload 3, BASELINE.md): both sides shuffle sorted on the join key to the
same partition space; the joiner walks the two grouped iterators in lockstep.

This example is a thin shim over the relational query layer
(tez_tpu_torch/query/): the whole workload is one logical plan —
``left SEMI-DISTINCT JOIN right`` on the tokenized word — whose
semi_distinct join REQUIRES the repartition strategy, so the planner
lowers it onto exactly the DAG shape the hand-built original used (both
scan sides terminating into key-partitioned OrderedPartitionedKVEdges
feeding a lockstep sort-merge joiner).  The output is bit-exact with the
pre-query-layer example: one ``(word, "1")`` record per distinct word
present on both sides.

The port's copy of tez_tpu.examples.sort_merge_join: ``run(...,
device="cuda")`` submits the DAG through the port's TezClient and AM, so
both sides' ordered edges partition (``fnv_hash_lanes``), sort and merge
(``merge_path_pair``) on the card unless the caller passes "cpu".
"""
from __future__ import annotations

import sys

from tez_tpu_torch.client.tez_client import TezClient
from tez_tpu_torch.query import Table, plan_query


def build_plan(left_paths, right_paths) -> Table:
    left = Table.scan("left", list(left_paths), ["word"], mode="words")
    right = Table.scan("right", list(right_paths), ["word"], mode="words")
    # semi_distinct: one row per distinct key on both sides — the
    # lockstep emit-once-per-matching-key the original joiner performed
    return left.join(right, "word", how="semi_distinct")


def build_dag(left_paths, right_paths, output_path: str,
              num_joiners: int = 2, side_parallelism: int = 2, conf=None):
    merged = {"tez.query.reducers": num_joiners,
              "tez.query.scan.splits": side_parallelism, **(conf or {})}
    planned = plan_query(build_plan(left_paths, right_paths), merged,
                         output_path, dag_name="SortMergeJoin",
                         sink={"key_col": "word", "literal": "1"})
    return planned.dag


def run(left_paths, right_paths, output_path: str, conf=None,
        device="cuda", **kw) -> str:
    """Run SortMergeJoin through the port's TezClient and AM on `device`;
    returns the DAG's final state."""
    with TezClient.create("SortMergeJoin", conf or {},
                          device=device) as client:
        dag = build_dag(left_paths, right_paths, output_path,
                        conf=conf, **kw)
        status = client.submit_dag(dag).wait_for_completion()
        return status.state.name


if __name__ == "__main__":
    if len(sys.argv) != 4:
        print("usage: sort_merge_join <left_file> <right_file> <output_dir>")
        sys.exit(2)
    print(run([sys.argv[1]], [sys.argv[2]], sys.argv[3]))
