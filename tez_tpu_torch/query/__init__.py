"""Relational query layer: logical plans compiled onto the DAG substrate.

The port's copy of tez_tpu.query.  A dataframe-ish builder
(:mod:`tez_tpu_torch.query.logical`) produces logical plans; the planner
(:mod:`tez_tpu_torch.query.planner`) lowers them to DAGs over the port's
library edges, choosing the physical join strategy from partition stats;
:mod:`tez_tpu_torch.query.session` runs them through a resident TezClient
session on its device (the card unless the caller passes "cpu") with
lineage/result-cache reuse and feeds observed run telemetry back into
:mod:`tez_tpu_torch.query.feedback` for adaptive re-optimization.  The
operators are per-row host code; the ordered edges they run over sort and
merge on the session's device.
"""
from tez_tpu_torch.query.logical import Table  # noqa: F401
from tez_tpu_torch.query.planner import plan_query  # noqa: F401
from tez_tpu_torch.query.feedback import PlanFeedback  # noqa: F401
from tez_tpu_torch.query.session import QuerySession  # noqa: F401
