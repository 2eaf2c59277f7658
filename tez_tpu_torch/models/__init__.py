"""Canned DAG topologies ("model" shapes) built on the public DSL.

See tez_tpu_torch.models.shapes for the tez-tests dag-shape analogs
(SimpleTestDAG, V / reverse-V, multi-level failing DAGs, MultiAttemptDAG).

The port's copy of tez_tpu.models.
"""

from tez_tpu_torch.models import shapes

__all__ = ["shapes"]
