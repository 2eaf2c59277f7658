"""Broadcast hash join: small dim table broadcast to every fact task.

Reference parity: tez-examples/.../HashJoinExample.java:74 (benchmark
workload 5, BASELINE.md): the small side ships over a BROADCAST edge with
UnorderedKVOutput; each streaming (fact) task builds a hash set/table and
joins its split of the big side.

This example is a thin shim over the relational query layer
(tez_tpu_torch/query/): the whole workload is one logical plan —
``stream SEMI JOIN hash_side`` with the join strategy pinned to broadcast
— lowered by the planner onto exactly the DAG shape the hand-built
original used (a 1-task build vertex over a broadcast UnorderedKVEdge
into a fused scan+hash_join probe vertex with a FileOutput sink).  The
output is bit-exact with the pre-query-layer example: one
``(word, "1")`` record per stream occurrence whose word appears in the
hash side.

The port's copy of tez_tpu.examples.hash_join: ``run(...,
device="cuda")`` submits the DAG through the port's TezClient and AM on
that device (the card unless the caller passes "cpu"); the broadcast
edge is unordered and unpartitioned, so the join is host work.
"""
from __future__ import annotations

import sys

from tez_tpu_torch.client.tez_client import TezClient
from tez_tpu_torch.query import Table, plan_query


def build_plan(stream_paths, hash_paths) -> Table:
    stream = Table.scan("stream", list(stream_paths), ["word"],
                        mode="lines")
    hash_side = Table.scan("hashside", list(hash_paths), ["word"],
                           mode="lines")
    # semi join: keep every stream occurrence whose word is in the hash
    # side; hash_join pins the broadcast strategy the example is about
    return stream.hash_join(hash_side, "word", how="semi")


def build_dag(stream_paths, hash_paths, output_path: str,
              num_joiners: int = 2, conf=None):
    merged = {"tez.query.scan.splits": num_joiners, **(conf or {})}
    planned = plan_query(build_plan(stream_paths, hash_paths), merged,
                         output_path, dag_name="HashJoin",
                         sink={"key_col": "word", "literal": "1"})
    return planned.dag


def run(stream_paths, hash_paths, output_path: str, conf=None,
        device="cuda", **kw) -> str:
    """Run HashJoin through the port's TezClient and AM on `device`;
    returns the DAG's final state."""
    with TezClient.create("HashJoin", conf or {},
                          device=device) as client:
        dag = build_dag(stream_paths, hash_paths, output_path,
                        conf=conf, **kw)
        status = client.submit_dag(dag).wait_for_completion()
        return status.state.name


if __name__ == "__main__":
    if len(sys.argv) != 4:
        print("usage: hash_join <stream_file> <hash_file> <output_dir>")
        sys.exit(2)
    print(run([sys.argv[1]], [sys.argv[2]], sys.argv[3]))
