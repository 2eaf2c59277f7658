"""TezClient: session & non-session DAG submission.

Reference parity: tez-api/.../client/TezClient.java:228 (builder, start:384,
submitDAG:613, stop:727, preWarm:897) + FrameworkClient SPI (YARN vs
LocalClient).  Here the stock framework client is local/in-process (the
reference's LocalClient path); a cluster deployment would swap a gRPC
FrameworkClient behind the same surface.

The port's copy of tez_tpu.client.tez_client: ``TezClient.create(name,
conf, device="cuda")`` hands the device to its in-process AM, which
resolves it once.  The remote framework client and AM crash survival
(``reattach`` / ``attach_dag``) are not ported yet.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

from tez_tpu_torch.am.app_master import DAGAppMaster
from tez_tpu_torch.client.dag_client import DAGClient
from tez_tpu_torch.client.errors import DAGRejectedError
from tez_tpu_torch.common import config as C
from tez_tpu_torch.common.ids import new_app_id
from tez_tpu_torch.dag.dag import DAG
from tez_tpu_torch.ops.device import resolve_device
from tez_tpu_torch.utils.backoff import ExponentialBackoff, retry_call

log = logging.getLogger(__name__)

__all__ = ["TezClient", "FrameworkClient", "LocalFrameworkClient",
           "DAGRejectedError"]


class _RetryAfterBackoff:
    """Backoff policy flooring each delay at the AM's RETRY-AFTER hint.

    The server's hint is a floor, not the whole story: sleeping exactly
    retry-after re-synchronizes every shed client into the same resubmit
    instant, so full-jittered exponential delay rides on top (the same
    decorrelation argument as utils/backoff.py)."""

    def __init__(self, inner: ExponentialBackoff):
        self.inner = inner
        self.hint = 0.0

    def delay(self, attempt: int) -> float:
        return self.hint + self.inner.delay(attempt)

    def sleep(self, attempt: int) -> None:
        time.sleep(self.delay(attempt))


class FrameworkClient:
    """SPI: how to reach/launch an AM (reference: FrameworkClient.java:58)."""

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def submit_dag(self, plan: Any) -> Any:
        raise NotImplementedError


class LocalFrameworkClient(FrameworkClient):
    """In-process AM (reference: LocalClient.java:80)."""

    def __init__(self, conf: C.TezConfiguration, device: Any = "cuda"):
        self.conf = conf
        self.device = device
        self.app_id = new_app_id()
        self.am: Optional[DAGAppMaster] = None

    def start(self) -> None:
        self.am = DAGAppMaster(self.app_id, self.conf, device=self.device)
        self.am.start()

    def stop(self) -> None:
        if self.am is not None:
            self.am.stop()
            self.am = None

    def submit_dag(self, plan: Any) -> Any:
        return self.am.submit_dag(plan)


class TezClient:
    def __init__(self, name: str, conf: Optional[Dict[str, Any]] = None,
                 session: bool = False, device: Any = "cuda"):
        self.name = name
        self.conf = C.TezConfiguration(conf or {})
        #: where the AM's tasks run, checked here so that a client asking
        #: for a card that is absent fails before it starts an AM
        self.device = resolve_device(device)
        self.session_mode = session or self.conf.get(C.SESSION_MODE)
        self.framework_client: Optional[FrameworkClient] = None
        self._started = False

    @staticmethod
    def create(name: str, conf: Optional[Dict[str, Any]] = None,
               session: bool = False, device: Any = "cuda") -> "TezClient":
        return TezClient(name, conf, session, device=device)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "TezClient":
        assert not self._started
        if self.conf.get("tez.framework.mode") == "remote":
            raise NotImplementedError(
                "tez.framework.mode=remote: the remote framework client is "
                "not ported yet")
        self.framework_client = LocalFrameworkClient(self.conf, self.device)
        self.framework_client.start()
        self._started = True
        return self

    #: client-side-only keys never shipped into DAG plans (the job token
    #: must not leak into the plan -> history journal on disk)
    _CLIENT_ONLY_KEYS = ("tez.job.token", "tez.am.address",
                         "tez.framework.mode")

    def submit_dag(self, dag: DAG) -> DAGClient:
        assert self._started, "client not started"
        conf = {k: v for k, v in self.conf.items()
                if k not in self._CLIENT_ONLY_KEYS}
        plan = dag.create_dag_plan(conf)
        dag_id = self.framework_client.submit_dag(plan)
        return DAGClient(self.framework_client.am, dag_id)

    def submit_dag_with_retry(self, dag: DAG, retries: int = 5,
                              backoff: Optional[ExponentialBackoff] = None,
                              rng: Any = None) -> DAGClient:
        """submit_dag that honors load shedding: a typed
        :class:`DAGRejectedError` (the AM's SHED verdict) is resubmitted
        after sleeping at least its RETRY-AFTER hint plus full-jitter
        exponential backoff.  Any other failure — and the final rejection
        after ``retries`` attempts — propagates unchanged."""
        policy = _RetryAfterBackoff(
            backoff or ExponentialBackoff(base=0.2, cap=10.0, jitter=True,
                                          rng=rng))

        def once() -> DAGClient:
            try:
                return self.submit_dag(dag)
            except DAGRejectedError as e:
                policy.hint = max(0.0, float(e.retry_after_s))
                log.info("dag %s shed by AM (%s); retry after >= %.3fs",
                         dag.name, e.reason, policy.hint)
                raise

        return retry_call(once, retries, retryable=(DAGRejectedError,),
                          backoff=policy)

    def queue_status(self) -> Dict[str, Any]:
        """The AM's admission/queue snapshot (works for local and remote
        framework clients — the remote proxy has the same method)."""
        return self.framework_client.am.queue_status()

    def reattach(self) -> "TezClient":
        """AM crash survival: rebind to a successor AM incarnation."""
        raise NotImplementedError("AM recovery (reattach) is not ported yet")

    def pre_warm(self) -> None:
        """Spin runners up before the first DAG (reference: preWarm:897).
        Works for both local and remote framework clients."""
        self.framework_client.am.prewarm()

    def stop(self) -> None:
        if self._started:
            self.framework_client.stop()
            self._started = False

    def __enter__(self) -> "TezClient":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
