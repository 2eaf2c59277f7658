"""Typed client-facing errors for the multi-tenant session AM.

Kept in a leaf module (no tez_tpu_torch.am imports) so both sides of the
umbilical can import it: the AM's AdmissionController raises
DAGRejectedError, DAGClientServer pickles it verbatim onto the wire
(exceptions round-trip as ``(False, exc)`` frames), and the remote
client re-raises the same type with the retry hint intact.

The port's copy of tez_tpu.client.errors; AMCrashedError and DAGLostError
come with AM recovery, which is not ported yet.
"""
from __future__ import annotations


class DAGRejectedError(RuntimeError):
    """A submit was shed by admission control — a verdict, not a failure.

    Carries the shed contract (docs/multitenancy.md): the AM promises it
    kept no state for this submission, and the client should wait at
    least ``retry_after_s`` (plus its own full-jitter backoff — see
    TezClient.submit_dag_with_retry) before resubmitting.
    """

    def __init__(self, reason: str, retry_after_s: float = 0.5,
                 tenant: str = "", queue_depth: int = 0,
                 tenant_inflight: int = 0):
        super().__init__(reason)
        self.reason = reason
        #: minimum client-side wait before resubmitting, in seconds
        self.retry_after_s = float(retry_after_s)
        #: tenant the verdict was issued against ("" = anonymous)
        self.tenant = tenant
        #: admission queue depth observed at the verdict (the "queue
        #: position" a resubmit would land behind)
        self.queue_depth = int(queue_depth)
        #: DAGs this tenant already had running + queued at the verdict
        self.tenant_inflight = int(tenant_inflight)

    # RuntimeError.__reduce__ only replays ``args``; spell out the full
    # constructor so the pickled copy that crosses the umbilical keeps
    # the retry hint and queue position.
    def __reduce__(self):
        return (DAGRejectedError,
                (self.reason, self.retry_after_s, self.tenant,
                 self.queue_depth, self.tenant_inflight))

    def __str__(self) -> str:
        who = self.tenant or "<anon>"
        return (f"DAG rejected ({self.reason}); tenant={who} "
                f"inflight={self.tenant_inflight} "
                f"queue_depth={self.queue_depth} "
                f"RETRY-AFTER {self.retry_after_s:.3f}s")
