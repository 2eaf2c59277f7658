"""Lineage keys for cross-DAG output reuse (session mode).

A vertex's lineage hash is a content address for "the output this vertex
will produce": its processor descriptor (class + payload bytes), its
parallelism, its root inputs, its in-edge plumbing (movement type +
edge IO descriptors), the vertex conf, and — topologically — the lineage
of every upstream vertex.  Two DAGs submitted to one session that agree
on a vertex's hash would compute byte-identical output for it, so the
store can serve the sealed runs of the first DAG to the second
(``ShuffleBufferStore.seal_lineage`` / ``republish_lineage``).

The hash deliberately excludes the DAG name and id (recurring DAGs get
fresh names) and anything scheduling-only (locality hints, container
counts).  Leaf outputs are INCLUDED: a vertex that also publishes to an
external sink must re-run so the sink sees its side effects.

Per-task lineage keys are ``<vertex_hash>/<task_index>/<dest_vertex>`` —
the task index pins the partition range, the destination vertex pins
which edge output the segment feeds.

Streaming mode: a per-window DAG plan carries ``tez.runtime.stream.id``
and ``tez.runtime.stream.window-id`` in its DAG conf, and both are folded
into every vertex hash — the lineage key is effectively
``(lineage, window_id)``, so window N's sealed runs can never be served
as a cache hit to window M, while a window-exact REPLAY of window N
(same stream, same window id, same spool) hits and skips recomputation.

The port's copy of tez_tpu.store.lineage.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict

from tez_tpu_torch.common.payload import EntityDescriptor


def _descriptor_bytes(d: Any) -> bytes:
    if d is None:
        return b"-"
    if isinstance(d, EntityDescriptor):
        payload = d.payload.data if d.payload is not None else b""
        return d.class_name.encode() + b"\x00" + payload
    return repr(d).encode()


def _conf_bytes(conf: Any) -> bytes:
    if not conf:
        return b"-"
    items = sorted((str(k), str(v)) for k, v in dict(conf).items())
    return b";".join(f"{k}={v}".encode() for k, v in items)


def vertex_lineage_hashes(plan: Any) -> Dict[str, str]:
    """{vertex_name: lineage_hash} for every vertex in a DAGPlan,
    computed topologically so a hash transitively covers the whole
    upstream subgraph (input signature)."""
    hashes: Dict[str, str] = {}
    # window-scoped lineage: the stream/window coordinates (DAG-level conf)
    # salt every vertex hash so sealed entries are keyed (lineage, window)
    dag_conf = dict(getattr(plan, "dag_conf", None) or {})
    stream = str(dag_conf.get("tez.runtime.stream.id", "") or "")
    window_salt = b""
    if stream:
        window_salt = (
            f"|stream:{stream}"
            f"/w{dag_conf.get('tez.runtime.stream.window-id', 0)}"
        ).encode()
    pending = {v.name: v for v in plan.vertices}
    edges_in: Dict[str, list] = {v.name: [] for v in plan.vertices}
    for e in plan.edges:
        edges_in.setdefault(e.output_vertex, []).append(e)
    guard = 0
    while pending and guard <= len(plan.vertices):
        guard += 1
        for name in list(pending):
            ins = edges_in.get(name, [])
            if any(e.input_vertex not in hashes for e in ins):
                continue
            v = pending.pop(name)
            h = hashlib.sha256()
            h.update(v.name.encode() + b"\x00")
            h.update(_descriptor_bytes(v.processor))
            h.update(b"|par=%d" % int(v.parallelism))
            for ri in v.root_inputs:
                h.update(b"|root:" + _descriptor_bytes(
                    getattr(ri, "descriptor", ri)))
            for lo in v.leaf_outputs:
                h.update(b"|leaf:" + _descriptor_bytes(
                    getattr(lo, "descriptor", lo)))
            h.update(b"|conf:" + _conf_bytes(v.conf))
            h.update(window_salt)
            for e in sorted(ins, key=lambda e: e.id):
                p = e.edge_property
                h.update(b"|edge:" + str(p.data_movement_type).encode())
                h.update(_descriptor_bytes(p.edge_source))
                h.update(_descriptor_bytes(p.edge_destination))
                h.update(b"<" + hashes[e.input_vertex].encode())
            hashes[name] = h.hexdigest()[:24]
    # a cycle (never valid in a verified DAG) leaves vertices unpinned:
    # give them no lineage rather than a wrong one
    for name in pending:
        hashes[name] = ""
    return hashes


def task_lineage(vertex_hash: str, task_index: int,
                 dest_vertex: str) -> str:
    """The store key tag for one task's output toward one edge."""
    if not vertex_hash:
        return ""
    return f"{vertex_hash}/{task_index}/{dest_vertex}"
