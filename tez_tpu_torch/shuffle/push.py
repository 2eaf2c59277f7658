"""Push-based pipelined shuffle: the map-wave eager push transport.

Exoshuffle / Exoshuffle-CloudSort (PAPERS.md) invert Tez's pull shuffle:
mappers *push* partitioned blocks into reducer-side storage while the map
wave is still running, so reduce-side ingest and merge pipeline with the
map wave instead of starting after it.  This module is that transport for
the data plane, connecting the producer's pipelined spills to the
reducer-side ``ShuffleBufferStore``:

``SpillPusher``
    mapper side — a bounded thread pool that ships each finished spill
    asynchronously.  Same-host destinations publish straight through the
    buffer store (zero copy); remote ones ride the shuffle server's push
    verb (``shuffle/server.py``).  Full-jitter retry honors the admission
    controller's RETRY-AFTER hint; a per-destination in-flight byte cap
    blocks ``submit()`` so an over-eager mapper backpressures at the
    source instead of ballooning the queue.

``PushAdmissionController``
    reducer side — per-source byte quotas plus store host-watermark
    backpressure.  A rejected push raises ``PushRejected`` carrying the
    retry-after hint.

Correctness: the pull path is the backstop.  Every spill is registered
with the shuffle service (DME events and all) BEFORE its push is even
queued, so a dead pusher, a rejection storm, or a partial remote push
never loses data — consumers that miss the store simply fetch.  Pushes
are epoch fenced exactly like registers: a re-attempted mapper's stale
pushes are rejected at the landing zone.

Fault points: ``shuffle.push.send`` (each send attempt; fail mode kills
the eager push — the push-storm chaos lever) and ``shuffle.push.admit``
(each admission decision; fail mode turns it into a rejection, delay mode
stretches ``shuffle.push.admit_wait``).

The port's copy of tez_tpu.shuffle.push.  A push moves host arrays only:
a same-host push aliases the run (its device lanes included) into the
store, and a remote one ships single-partition Run blobs, which never
carry device tensors.
"""
from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from tez_tpu_torch.common import faults, metrics
from tez_tpu_torch.common.counters import TaskCounter
from tez_tpu_torch.common.epoch import EpochFencedError
from tez_tpu_torch.common.security import (JobTokenSecretManager,
                                           hash_from_request)
from tez_tpu_torch.obs import flight as _flight
from tez_tpu_torch.ops.runformat import Run
from tez_tpu_torch.utils.backoff import ExponentialBackoff, retry_call

log = logging.getLogger(__name__)


def push_key(path_component: str, partition: int) -> str:
    """Store key for one remotely-pushed partition of a spill.

    Remote pushes land per partition (the wire moves single-partition Run
    blobs), so they key as ``path#p<partition>`` with partition index 0
    inside the stored run.  The '#' never appears in attempt path
    components, and the prefix match in ``unregister_prefix`` still
    catches these keys when the owning DAG is torn down.
    """
    return f"{path_component}#p{partition}"


def replica_key(key_path: str) -> str:
    """Store key for the coded buddy copy of a pushed spill.

    With ``tez.runtime.shuffle.push.replicas=2`` every push also lands
    under ``<key>#r`` — the buddy slot.  In a multi-host deployment the
    buddy STORE is the one owning partition ``coded_buddy(p, n)``
    (parallel/mesh.py, the coded-exchange placement); the in-process
    simulation keys both copies into the host-wide store under distinct
    namespaces instead, which exercises the identical failover chain: a
    consumer whose primary entry is lost reconstructs from ``<key>#r``
    without re-running the producer (docs/recovery.md).  '#' never
    appears in attempt path components and the prefix match in
    ``unregister_prefix`` reclaims replica keys with their DAG."""
    return f"{key_path}#r"


class PushRejected(Exception):
    """Admission said no (quota / watermark / no landing zone).  Carries
    the retry-after hint; the pusher sleeps it and retries, then falls
    back to the pull path for good."""

    def __init__(self, retry_after_ms: float, reason: str):
        super().__init__(reason)
        self.retry_after_ms = float(retry_after_ms)
        self.reason = reason


class PushAdmissionController:
    """Reducer-side gatekeeper for eager pushes.

    Two rules, both deliberately conservative because pushed bytes are an
    optimization (the pull path still holds the data):

    * host-watermark backpressure — a push that would lift the store's
      HOST tier above ``admit_watermark * host_capacity`` is rejected.
      The watermark sits BELOW the store's own high watermark, so eager
      pushes never trigger the demotion cascade that registered (pull)
      data is entitled to ride.
    * per-source quota — one source attempt may hold at most
      ``source_quota_bytes`` admitted in this store, so a single hot
      mapper cannot crowd out the rest of the wave.

    ``release_prefix`` returns quota when the owning DAG (or attempt) is
    unregistered.  Thread-safe; one instance per host, attached to the
    ``ShuffleService``.
    """

    def __init__(self, store_provider: Callable[[], Any],
                 source_quota_bytes: int = 256 << 20,
                 admit_watermark: float = 0.85,
                 retry_after_ms: float = 50.0):
        self._store = store_provider
        self.source_quota = int(source_quota_bytes)
        self.admit_watermark = float(admit_watermark)
        self.retry_after_ms = float(retry_after_ms)
        self._lock = threading.Lock()
        self._by_source: Dict[str, int] = {}
        self.admitted = 0
        self.rejected = 0

    def admit(self, source: str, nbytes: int, counters: Any = None) -> None:
        """Admit ``nbytes`` from ``source`` or raise PushRejected."""
        try:
            faults.fire("shuffle.push.admit",
                        detail=f"{source} nbytes={nbytes}")
        except Exception as e:
            # fail mode = the decision becomes a rejection (the
            # backpressure chaos lever), never an unclassified error
            self._count_reject()
            raise PushRejected(self.retry_after_ms,
                               f"fault-injected reject: {e!r}") from e
        store = self._store()
        if store is None:
            self._count_reject()
            raise PushRejected(self.retry_after_ms,
                               "no buffer store on this host (push needs a "
                               "landing zone; spill stays pull-served)")
        from tez_tpu_torch.store.buffer_store import HOST
        cap = int(getattr(store, "host_capacity", 0))
        if cap > 0 and store.tier_bytes(HOST) + nbytes > \
                cap * self.admit_watermark:
            self._count_reject()
            raise PushRejected(
                self.retry_after_ms,
                f"store host tier past admit watermark "
                f"({store.tier_bytes(HOST)} + {nbytes} > "
                f"{cap} * {self.admit_watermark})")
        with self._lock:
            held = self._by_source.get(source, 0)
            # a single spill larger than the whole quota is admitted while
            # the source holds nothing — otherwise it could never push
            if held > 0 and held + nbytes > self.source_quota:
                self.rejected += 1
                _flight.record(_flight.PUSH, "reject.quota", source,
                               a=nbytes)
                raise PushRejected(
                    self.retry_after_ms,
                    f"source quota exhausted for {source} "
                    f"({held} + {nbytes} > {self.source_quota})")
            self._by_source[source] = held + nbytes
            self.admitted += 1
        _flight.record(_flight.PUSH, "admit", source, a=nbytes)

    def _count_reject(self) -> None:
        with self._lock:
            self.rejected += 1
        _flight.record(_flight.PUSH, "reject")

    def release_prefix(self, prefix: str) -> int:
        """Return the quota held by every source under ``prefix`` (called
        from the service's deletion tracker on DAG/vertex cleanup)."""
        with self._lock:
            victims = [s for s in self._by_source if s.startswith(prefix)]
            freed = sum(self._by_source.pop(s) for s in victims)
        return freed

    def held(self, source: str) -> int:
        with self._lock:
            return self._by_source.get(source, 0)


def _partition_blob(batch: Any) -> bytes:
    """One partition as a checksummed single-partition Run blob (the same
    wire shape the fetch path serves)."""
    run = Run(batch, np.array([0, batch.num_records], dtype=np.int64))
    return run.to_bytes()


class PushSession:
    """One connection pushing one spill to a remote host's store.

    Client side of the shuffle server's push verb: after the 16-byte
    nonce greeting, sends ``u32 len | JSON {op:"push", path, spill,
    partition_lo, partition_hi, sizes:[...], epoch, app, hmac}`` followed
    by the concatenated single-partition Run blobs, and reads the usual
    ``u32 len | JSON`` reply.  The HMAC covers the same canonical request
    bytes as a fetch (path|spill|lo|hi|nonce) — a captured push neither
    re-targets another output nor replays on a new connection.
    """

    def __init__(self, secrets: JobTokenSecretManager, host: str, port: int,
                 connect_timeout: float = 5.0, read_timeout: float = 30.0,
                 ssl_context=None, epoch: int = 0, app_id: str = ""):
        self.secrets = secrets
        self.epoch = epoch
        self.app_id = app_id
        self._sk = socket.create_connection((host, port),
                                            timeout=connect_timeout)
        if ssl_context is not None:
            self._sk = ssl_context.wrap_socket(self._sk)
        self._sk.settimeout(read_timeout)
        self._fh = self._sk.makefile("rb")
        self._nonce = self._fh.read(16)
        if len(self._nonce) != 16:
            self.close()
            raise ConnectionError("shuffle server closed before nonce")

    def push_run(self, path: str, spill: int, run: Any) -> None:
        """Push every partition of ``run``; raises PushRejected on a
        RETRY-AFTER reply, EpochFencedError on a fence, PermissionError on
        auth failure."""
        num = int(run.num_partitions)
        blobs = [_partition_blob(run.partition(p)) for p in range(num)]
        req = json.dumps({
            "op": "push", "path": path, "spill": spill,
            "partition_lo": 0, "partition_hi": num,
            "sizes": [len(b) for b in blobs],
            "epoch": self.epoch, "app": self.app_id,
            "hmac": hash_from_request(self.secrets, path, spill, 0, num,
                                      self._nonce).hex(),
        }).encode()
        self._sk.sendall(struct.pack("<I", len(req)) + req)
        for b in blobs:
            self._sk.sendall(b)
        (hdr_len,) = struct.unpack("<I", self._fh.read(4))
        header = json.loads(self._fh.read(hdr_len))
        status = header.get("status")
        if status == "ok":
            return
        if status == "retry":
            raise PushRejected(float(header.get("retry_after_ms", 0.0)),
                               f"remote rejected push: {path}/{spill}")
        if status == "fenced":
            raise EpochFencedError(f"push fenced: {path}/{spill}")
        raise PermissionError(f"shuffle push {status}: {path}")

    def close(self) -> None:
        for closer in (self._fh.close, self._sk.close):
            try:
                closer()
            except OSError:
                pass


class SpillPusher:
    """Mapper-side async pusher: one per OrderedPartitionedKVOutput.

    ``submit()`` is called from the sorter's spill-completion callback; it
    blocks while the destination's in-flight bytes exceed the cap (map-
    side backpressure) then hands the push to the pool.  Push failures are
    terminal for the *push only* — the spill was registered for pull
    before submit, so failure just means the consumer fetches it.
    """

    def __init__(self, service: Any, threads: int = 2, retries: int = 3,
                 inflight_limit_bytes: int = 64 << 20,
                 counters: Any = None, epoch: int = 0, app_id: str = "",
                 tenant: str = "",
                 secrets: Optional[JobTokenSecretManager] = None,
                 backoff_base: float = 0.05, rng: Any = None,
                 replicas: int = 1, window_id: int = 0, stream: str = ""):
        self.service = service
        self.retries = max(1, int(retries))
        self.inflight_limit = int(inflight_limit_bytes)
        self.counters = counters
        #: copies per pushed spill (tez.runtime.shuffle.push.replicas);
        #: >1 lands a coded buddy copy alongside every primary push
        self.replicas = max(1, int(replicas))
        self.epoch = epoch
        self.app_id = app_id
        self.tenant = tenant
        #: generalized fence's second coordinate (0/"" = batch, unfenced)
        self.window_id = int(window_id)
        self.stream = stream
        self.secrets = secrets
        self.backoff_base = backoff_base
        self._rng = rng
        self._cv = threading.Condition()
        self._inflight: Dict[Tuple[str, int], int] = {}
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(threads)),
            thread_name_prefix="shuffle-pusher")
        self._closed = False
        self.pushes_sent = 0
        self.pushes_rejected = 0

    # -- producer API --------------------------------------------------------

    def submit(self, path: str, spill_id: int, run: Any,
               host: str = "local", port: int = 0) -> bool:
        """Queue one spill for eager push.  Blocks while the destination
        is over its in-flight byte cap; returns False when the pusher is
        already closed (spill stays pull-only)."""
        nbytes = int(getattr(run, "nbytes", 0))
        dest = (host, int(port))
        with self._cv:
            if self._closed:
                return False
            while self._inflight.get(dest, 0) > 0 and \
                    self._inflight.get(dest, 0) + nbytes > \
                    self.inflight_limit:
                self._cv.wait(0.05)
                if self._closed:
                    return False
            self._inflight[dest] = self._inflight.get(dest, 0) + nbytes
        try:
            self._pool.submit(self._push_one, path, spill_id, run, dest,
                              nbytes)
        except RuntimeError:        # pool shut down under us
            self._release(dest, nbytes)
            return False
        return True

    def close(self) -> None:
        """Drain: every queued push finishes (or exhausts its retries)
        before close returns, so push counters are settled by the time the
        task reports DONE."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._pool.shutdown(wait=True)

    # -- internals -----------------------------------------------------------

    def _release(self, dest: Tuple[str, int], nbytes: int) -> None:
        with self._cv:
            self._inflight[dest] = max(
                0, self._inflight.get(dest, 0) - nbytes)
            self._cv.notify_all()

    def _is_local(self, dest: Tuple[str, int]) -> bool:
        return dest[1] == 0 or dest[0] in ("local", "", "localhost")

    def _push_one(self, path: str, spill_id: int, run: Any,
                  dest: Tuple[str, int], nbytes: int) -> None:
        t0 = time.perf_counter()
        admit_wait_ms = 0.0

        def one_try() -> None:
            nonlocal admit_wait_ms
            faults.fire("shuffle.push.send",
                        detail=f"{path}/{spill_id} -> {dest[0]}:{dest[1]}")
            try:
                if self._is_local(dest):
                    # same-host: straight through the buffer store, zero
                    # copy — the store entry aliases the run the pull
                    # registry already holds
                    self.service.push_publish(
                        path, spill_id, run, epoch=self.epoch,
                        app_id=self.app_id, tenant=self.tenant,
                        counters=self.counters, replicas=self.replicas,
                        window_id=self.window_id, stream=self.stream)
                else:
                    if self.secrets is None:
                        raise PermissionError(
                            "remote push needs a job-token secret")
                    session = PushSession(self.secrets, dest[0], dest[1],
                                          epoch=self.epoch,
                                          app_id=self.app_id)
                    try:
                        session.push_run(path, spill_id, run)
                    finally:
                        session.close()
            except PushRejected as e:
                wait = max(0.0, e.retry_after_ms) / 1000.0
                admit_wait_ms += e.retry_after_ms
                time.sleep(wait)
                raise

        try:
            retry_call(
                one_try, self.retries,
                retryable=(PushRejected, OSError, ValueError, struct.error,
                           RuntimeError),
                backoff=ExponentialBackoff(self.backoff_base, jitter=True,
                                           rng=self._rng),
                fatal=(EpochFencedError, PermissionError))
            rtt_ms = (time.perf_counter() - t0) * 1000.0
            metrics.observe("shuffle.push.rtt", rtt_ms,
                            counters=self.counters)
            _flight.record(_flight.PUSH, "send", path, a=nbytes,
                           b=int(admit_wait_ms * 1000.0))
            if self.counters is not None:
                self.counters.increment(TaskCounter.SHUFFLE_PUSH_BYTES,
                                        nbytes)
            with self._cv:
                self.pushes_sent += 1
        except Exception as e:
            # terminal for the push only: the pull registration preceding
            # submit() is the correctness backstop
            log.debug("push abandoned (pull backstop serves %s/%s): %r",
                      path, spill_id, e)
            if self.counters is not None:
                self.counters.increment(TaskCounter.SHUFFLE_PUSH_REJECTED)
            with self._cv:
                self.pushes_rejected += 1
            _flight.record(_flight.PUSH, "abandon", path, a=nbytes)
        finally:
            metrics.observe("shuffle.push.admit_wait", admit_wait_ms,
                            counters=self.counters)
            self._release(dest, nbytes)
