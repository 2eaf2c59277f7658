"""DAG-level priority assignment + scheduling gate variants.

Reference parity: tez-dag/.../dag/impl/DAGSchedulerNaturalOrder.java:75 —
priority = topological depth (deeper vertices run at lower priority so
upstream work drains first) — and DAGSchedulerNaturalOrderControlled.java:54,
which additionally HOLDS BACK a vertex's task scheduling until every
SEQUENTIAL source vertex has scheduled all of its own tasks (downstream
tasks must not grab slots before their sources are even queued).
Selected via tez.am.dag.scheduler.class.

The port's copy of tez_tpu.am.dag_scheduler.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict

if TYPE_CHECKING:
    from tez_tpu_torch.am.dag_impl import DAGImpl


def _assign_depth_priorities(dag: "DAGImpl") -> None:
    """Longest-path-from-root depth, priority = (depth+1)*3 with the +/-1
    band reserved for retries/speculation (reference multiplies by 3 to give
    each vertex a priority band)."""
    order = []
    indeg = {v.name: 0 for v in dag.plan.vertices}
    adj: Dict[str, list] = {v.name: [] for v in dag.plan.vertices}
    for e in dag.plan.edges:
        adj[e.input_vertex].append(e.output_vertex)
        indeg[e.output_vertex] += 1
    ready = [n for n, d in indeg.items() if d == 0]
    depth = {n: 0 for n in ready}
    while ready:
        n = ready.pop()
        order.append(n)
        for m in adj[n]:
            depth[m] = max(depth.get(m, 0), depth[n] + 1)
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)

    for name, v in dag.vertices.items():
        v.distance_from_root = depth.get(name, 0)
        v.priority = (depth.get(name, 0) + 1) * 3


def _push_coschedule(dag: "DAGImpl") -> None:
    """Map-wave / merge-wave co-scheduling for push-based shuffle.

    With eager push enabled, scatter-gather consumers run in INGEST mode:
    the ShuffleVertexManager releases them at the push start fraction, and
    here they get (a) priority bumped one notch INTO the vertex's reserved
    +/-1 band — deeper-than-source but ahead of the source's retry band —
    so released reducers interleave with the still-running map wave
    instead of queueing strictly behind it, and (b) the controlled gate
    lifted (the sources-fully-scheduled hold-back is exactly the barrier
    push exists to break).  Priorities elsewhere are untouched.
    """
    from tez_tpu_torch.common import config as C
    push_on = dag.conf.get(C.PUSH_ENABLED.name, C.PUSH_ENABLED.default)
    if isinstance(push_on, str):
        push_on = push_on.lower() in ("1", "true", "yes")
    if not push_on:
        return
    from tez_tpu_torch.dag.edge_property import DataMovementType
    consumers = {e.output_vertex for e in dag.plan.edges
                 if e.edge_property.data_movement_type in (
                     DataMovementType.SCATTER_GATHER,
                     DataMovementType.CUSTOM)}
    for name in consumers:
        v = dag.vertices.get(name)
        if v is None:
            continue
        v.priority -= 1
        v.controlled_scheduling = False


class DAGSchedulerNaturalOrder:
    """Priorities only; vertex managers decide when tasks schedule."""

    controlled = False

    def apply(self, dag: "DAGImpl") -> None:
        _assign_depth_priorities(dag)
        for v in dag.vertices.values():
            v.controlled_scheduling = self.controlled
        _push_coschedule(dag)


class DAGSchedulerNaturalOrderControlled(DAGSchedulerNaturalOrder):
    """Same priorities + the sources-fully-scheduled gate
    (VertexImpl.schedule_tasks defers until every SEQUENTIAL source vertex
    has scheduled all of its tasks)."""

    controlled = True


def apply_dag_scheduler(dag: "DAGImpl") -> None:
    from tez_tpu_torch.common import config as C
    from tez_tpu_torch.common.payload import resolve_class
    resolve_class(dag.conf.get(C.DAG_SCHEDULER_CLASS))().apply(dag)
