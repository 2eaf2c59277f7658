"""Shuffle object service: producers register runs, consumers fetch slices.

Reference parity: tez-plugins/tez-aux-services ShuffleHandler.java:159 (the
NM-resident shuffle server with per-reduce index lookup) + the local-disk
short-circuit (Fetcher.java:288).  In-process deployments hand buffers over
directly (the "local fetch" path — zero copies of host-RAM data, and a run's
device key lanes travel with it); the socket server for fetches from other
processes and hosts lives in tez_tpu_torch.shuffle.server and serves the
same registry.

Keys: (path_component, spill_id) where path_component identifies a producer
attempt's output (reference: attempt path component in the shuffle URL).
DAG/vertex deletion tracking mirrors the reference's DeletionTracker.

The port's copy of tez_tpu.shuffle.service: the bare registry, the
write-through file store (the native sendfile server's,
shuffle/native_server.py), the tiered buffer store (store/) and the push
landing zone (shuffle/push.py).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tez_tpu_torch.common import epoch as epoch_registry
from tez_tpu_torch.common import faults, tracing
from tez_tpu_torch.common.epoch import EpochFencedError, WindowFencedError
from tez_tpu_torch.ops.runformat import KVBatch, Run, RUN_HEADER_NBYTES
from tez_tpu_torch.shuffle.push import PushRejected, push_key, replica_key


def _window_fence(seam: str, app_id: str, window_id: int, stream: str,
                  src: str) -> None:
    """The window coordinate of the generalized (epoch, window) fence at a
    shuffle seam: a straggler from a sealed streaming window is rejected
    exactly like a stale-epoch zombie (batch traffic — window 0 / no
    stream — is never fenced)."""
    if not epoch_registry.is_stale_window(app_id, stream, window_id):
        return
    faults.fire("fence.stale_window", detail=f"{seam} {src}")
    tracing.event("fence.stale_window", seam=seam, reason="stale_window",
                  window_id=window_id, stream=stream,
                  current=epoch_registry.current_window(app_id, stream),
                  src=src)
    raise WindowFencedError(
        f"{seam} from stale window {window_id} of stream {stream} "
        f"(current {epoch_registry.current_window(app_id, stream)}): {src}")


def _maybe_corrupt(path_component: str, spill_id: int,
                   batch: KVBatch) -> KVBatch:
    """shuffle.data corrupt seam: round-trip the served partition through
    the checksummed Run wire blob with one byte flipped, so the injected
    damage surfaces as the genuine CRC IOError on the consumer side."""
    wire = Run(batch,
               np.array([0, batch.num_records], dtype=np.int64)).to_bytes()
    bad = faults.corrupt_bytes("shuffle.data", f"{path_component}/{spill_id}",
                               wire, lo=RUN_HEADER_NBYTES)
    if bad is wire:          # no corrupt rule claimed this fetch
        return batch
    return Run.from_bytes(bad, where=f"{path_component}/{spill_id}").batch


class ShuffleDataNotFound(Exception):
    pass


class ShuffleService:
    """Registry of completed (or pipelined-spill) runs on this host."""

    def __init__(self) -> None:
        self._runs: Dict[Tuple[str, int], Run] = {}
        self._lock = threading.Lock()
        self._store: Any = None
        self._buffer: Any = None
        self._push_admission: Any = None
        self._push_listeners: List[Any] = []

    def attach_store(self, store: Any) -> None:
        """Write-through persistence (FileShuffleStore): every registered
        run is also serialized to disk so the native sendfile server can
        serve it without touching Python.  Local fetches keep hitting the
        in-RAM registry."""
        self._store = store

    def has_store(self) -> bool:
        return self._store is not None

    def attach_buffer_store(self, store: Any) -> None:
        """Delegate run storage to the tiered buffer store
        (tez_tpu_torch.store.ShuffleBufferStore): new registrations publish
        into its capacity-governed device/host/disk tiers and fetches serve
        from it under leases.  Runs registered before attach stay in the
        bare registry and keep working."""
        self._buffer = store

    def buffer_store(self) -> Any:
        return self._buffer

    def attach_push_admission(self, admission: Any) -> None:
        """Gatekeeper for eager pushes landing on this host
        (tez_tpu_torch.shuffle.push.PushAdmissionController); None detaches —
        push_publish then rejects everything and producers stay on the
        pull path."""
        self._push_admission = admission

    def push_admission(self) -> Any:
        return self._push_admission

    def add_push_listener(self, fn: Any) -> None:
        """``fn(path_component, spill_id)`` fires after every admitted
        push publish — the merge-wake seam: consumers poke their merge
        manager so the async merge lane reacts to pushed arrivals
        mid-map-wave.  Listener errors are swallowed (a broken consumer
        must not fail the producer's push)."""
        self._push_listeners.append(fn)

    def remove_push_listener(self, fn: Any) -> None:
        try:
            self._push_listeners.remove(fn)
        except ValueError:
            pass

    # -- producer side -------------------------------------------------------
    def register(self, path_component: str, spill_id: int, run: Run,
                 epoch: int = 0, app_id: str = "",
                 lineage: str = "", tenant: str = "",
                 counters: Any = None,
                 use_store: bool = True, window_id: int = 0,
                 stream: str = "") -> None:
        """Producers stamped with an AM epoch are fenced: a zombie task from
        a pre-restart incarnation must not (re-)register outputs the live
        AM's re-runs now own.  Unstamped registrations (epoch 0, e.g. direct
        test callers) are never fenced.  Pre-crash data already registered
        stays fetchable — recovery's short-circuited consumers read it.
        In streaming mode the window coordinate is fenced the same way: a
        straggler from a sealed window cannot register into the open one."""
        _window_fence("shuffle.register", app_id, window_id, stream,
                      f"{path_component}/{spill_id}")
        if epoch > 0 and epoch_registry.is_stale(app_id, epoch):
            faults.fire("fence.stale_epoch",
                        detail=f"shuffle.register {path_component}")
            tracing.event("fence.stale_epoch", seam="shuffle.register",
                          reason="stale_producer", msg_epoch=epoch,
                          src=f"{path_component}/{spill_id}")
            raise EpochFencedError(
                f"shuffle register from stale epoch {epoch} "
                f"(current {epoch_registry.current(app_id)}): "
                f"{path_component}/{spill_id}")
        if self._buffer is not None and use_store:
            from tez_tpu_torch.store.buffer_store import StoreQuotaExceeded
            try:
                self._buffer.publish(path_component, spill_id, run,
                                     epoch=epoch, app_id=app_id,
                                     lineage=lineage, tenant=tenant,
                                     counters=counters)
            except StoreQuotaExceeded:
                # per-tenant quota refusal is isolation, not data loss:
                # the run stays in the bare registry (the producer's own
                # memory), pull-served like the pre-store path
                with self._lock:
                    self._runs[(path_component, spill_id)] = run
        else:
            # use_store=False is the push path's pull backstop: the run
            # lands in the bare registry synchronously (events may never
            # race a missing key) and the ASYNC push later aliases the
            # same object into the store — zero copy, no double-count
            with self._lock:
                self._runs[(path_component, spill_id)] = run
        tracing.event("shuffle.register", src=f"{path_component}/{spill_id}",
                      nbytes=getattr(run, "nbytes", 0))
        if self._store is not None:
            self._store.register(path_component, spill_id, run)
            # a concurrent unregister_prefix between the RAM insert and the
            # file write would miss our files (its disk sweep ran first);
            # re-check and self-clean so deleted outputs never linger on
            # disk where the native server would keep serving them
            with self._lock:
                still = (path_component, spill_id) in self._runs
            if not still:
                self._store.unregister_prefix(path_component)

    def push_publish(self, path_component: str, spill_id: int, run: Any,
                     partition: Optional[int] = None, epoch: int = 0,
                     app_id: str = "", tenant: str = "",
                     counters: Any = None, replicas: int = 1,
                     window_id: int = 0, stream: str = "") -> None:
        """Eager-push landing zone (docs/push_shuffle.md).

        Admission-checked publish into the buffer store.  ``partition``
        None = a same-host push of the WHOLE run under the plain
        ``(path, spill)`` key (complete — every partition — so a consumer
        probe can never be served a partial view); an int = one remotely
        pushed partition under ``push_key(path, partition)`` holding a
        single-partition run.  ``replicas`` > 1 additionally lands a coded
        buddy copy under ``replica_key(...)`` — best-effort (quota refusal
        skips the copy, the primary stands) and charged to the primary's
        admission grant.  Raises PushRejected (admission said no —
        caller retries then falls back to pull) or EpochFencedError (a
        re-attempted mapper's stale push, rejected exactly like a stale
        register; a stale-WINDOW push raises the WindowFencedError
        subclass)."""
        _window_fence("shuffle.push", app_id, window_id, stream,
                      f"{path_component}/{spill_id}")
        if epoch > 0 and epoch_registry.is_stale(app_id, epoch):
            faults.fire("fence.stale_epoch",
                        detail=f"shuffle.push {path_component}")
            tracing.event("fence.stale_epoch", seam="shuffle.push",
                          reason="stale_producer", msg_epoch=epoch,
                          src=f"{path_component}/{spill_id}")
            raise EpochFencedError(
                f"shuffle push from stale epoch {epoch} "
                f"(current {epoch_registry.current(app_id)}): "
                f"{path_component}/{spill_id}")
        if self._buffer is None or self._push_admission is None:
            raise PushRejected(
                0.0, "push has no landing zone on this host (no buffer "
                     "store / admission controller attached)")
        nbytes = int(getattr(run, "nbytes", 0))
        self._push_admission.admit(path_component, nbytes,
                                   counters=counters)
        key_path = path_component if partition is None else \
            push_key(path_component, partition)
        from tez_tpu_torch.store.buffer_store import StoreQuotaExceeded
        try:
            self._buffer.publish(key_path, spill_id, run, epoch=epoch,
                                 app_id=app_id, tenant=tenant,
                                 counters=counters)
        except StoreQuotaExceeded as e:
            # surfaces like any admission refusal: the pusher backs off,
            # retries, then abandons to the pull backstop
            raise PushRejected(0.0, str(e)) from e
        buddy = -1
        if replicas > 1:
            # coded buddy copy (docs/recovery.md): placement follows the
            # coded-exchange ring — the buddy store for a whole-run
            # push is the one owning coded_buddy(p, n) per partition; the
            # in-process simulation keys both copies into the host store
            # under distinct namespaces, same failover chain.  Best-effort
            # — a quota refusal keeps the primary, just without the
            # redundancy.
            n = int(getattr(run, "num_partitions", 0) or 0)
            if n > 1:
                from tez_tpu_torch.parallel.mesh import coded_buddy
                buddy = coded_buddy(0 if partition is None else partition, n)
            try:
                self._buffer.publish(replica_key(key_path), spill_id, run,
                                     epoch=epoch, app_id=app_id,
                                     tenant=tenant, counters=counters,
                                     replica=True)
            except StoreQuotaExceeded:
                pass
        tracing.event("shuffle.push", src=f"{path_component}/{spill_id}",
                      nbytes=nbytes,
                      partition=-1 if partition is None else partition,
                      replicas=replicas, buddy=buddy)
        for fn in list(self._push_listeners):
            try:
                fn(path_component, spill_id)
            except Exception:       # merge-wake is advisory, never fatal
                pass

    def unregister_prefix(self, prefix: str) -> int:
        """Deletion tracker: drop all outputs whose path starts with prefix
        (per-DAG / per-vertex cleanup).  Disk-backed runs (FileRun) also
        remove their backing file."""
        with self._lock:
            victims = [k for k in self._runs if k[0].startswith(prefix)]
            dead = [self._runs.pop(k) for k in victims]
        for run in dead:
            deleter = getattr(run, "delete", None)
            if deleter is not None:
                deleter()
        n = len(victims)
        if self._buffer is not None:
            # push keys (path#pN) share the path prefix, so pushed
            # partitions die with their DAG here too
            n += self._buffer.unregister_prefix(prefix)
        if self._push_admission is not None:
            self._push_admission.release_prefix(prefix)
        if self._store is not None:
            self._store.unregister_prefix(prefix)
        return n

    # -- consumer side (local short-circuit) ---------------------------------
    def _lookup(self, path_component: str, spill_id: int) -> Optional[Any]:
        """The run under a key: bare registry first, then the buffer
        store (unleased peek — slicing a returned run is safe because
        demotion never invalidates live views, see docs/store.md)."""
        with self._lock:
            run = self._runs.get((path_component, spill_id))
        if run is None and self._buffer is not None:
            run = self._buffer.get(path_component, spill_id)
        return run

    def _store_probe(self, key_path: str, spill_id: int, partition: int,
                     counters: Any) -> Optional[KVBatch]:
        """One buffer-store probe, miss -> None (StoreKeyNotFound and a
        concurrently-deleted backing file both count as a miss — the next
        link in the fetch chain decides what a total miss means)."""
        try:
            return self._buffer.fetch_partition(
                key_path, spill_id, partition, counters=counters)
        except FileNotFoundError:
            return None
        except Exception as e:
            if type(e).__name__ != "StoreKeyNotFound":
                raise
            return None

    def _replica_probe(self, key_path: str, spill_id: int, partition: int,
                       counters: Any) -> Optional[KVBatch]:
        """Failover to the coded buddy copy of a lost primary entry.  A
        hit is accounted as a store.replica.failover — a producer re-run
        avoided (docs/recovery.md)."""
        batch = self._store_probe(replica_key(key_path), spill_id,
                                  partition, counters)
        if batch is not None:
            self._buffer.note_replica_failover(
                f"{key_path}/{spill_id}", counters=counters)
        return batch

    def fetch_partition(self, path_component: str, spill_id: int,
                        partition: int, counters: Any = None,
                        app_id: str = "", window_id: int = 0,
                        stream: str = "") -> KVBatch:
        # consumer-side window fence: a reducer attempt from a sealed
        # streaming window must not keep pulling data the open window's
        # re-run now owns (stamped fetches only; batch is unfenced)
        _window_fence("shuffle.fetch", app_id, window_id, stream,
                      f"{path_component}/{spill_id}")
        # store.replica.lost seam (consumer side): fail mode declares the
        # PRIMARY copies gone — store entries and the producer's local
        # registration both — forcing the coded-replica failover path, the
        # chaos lever proving reconstruction without producer re-execution
        primary_lost = False
        try:
            faults.fire("store.replica.lost",
                        detail=f"{path_component}/{spill_id}")
        except Exception:
            primary_lost = True
        if self._buffer is not None:
            batch = None
            if not primary_lost:
                batch = self._store_probe(path_component, spill_id,
                                          partition, counters)
            if batch is None:
                batch = self._replica_probe(path_component, spill_id,
                                            partition, counters)
            if batch is not None:
                if faults.armed():
                    batch = _maybe_corrupt(path_component, spill_id, batch)
                return batch
        run = None
        if not primary_lost:
            with self._lock:
                run = self._runs.get((path_component, spill_id))
        if run is None:
            # third probe: a remotely PUSHED partition — the producer has
            # no local registration here, but its pusher may have landed
            # this partition under push_key (a single-partition run, so
            # partition index 0 inside the stored run); its coded replica
            # is the last resort
            if self._buffer is not None:
                pk = push_key(path_component, partition)
                batch = None
                if not primary_lost:
                    batch = self._store_probe(pk, spill_id, 0, counters)
                if batch is None:
                    batch = self._replica_probe(pk, spill_id, 0, counters)
                if batch is not None:
                    if faults.armed():
                        batch = _maybe_corrupt(path_component, spill_id,
                                               batch)
                    return batch
            raise ShuffleDataNotFound(f"{path_component}/{spill_id}")
        try:
            batch = run.partition(partition)
        except FileNotFoundError:
            # disk-backed run deleted by a concurrent unregister_prefix
            # (DAG teardown) between the registry lookup and the read —
            # same contract as a missing registration
            raise ShuffleDataNotFound(
                f"{path_component}/{spill_id}") from None
        if faults.armed():
            batch = _maybe_corrupt(path_component, spill_id, batch)
        return batch

    def fetch_partition_range(self, path_component: str, spill_id: int,
                              start: int, stop: int) -> List[KVBatch]:
        run = self._lookup(path_component, spill_id)
        if run is None:
            raise ShuffleDataNotFound(f"{path_component}/{spill_id}")
        try:
            return [run.partition(p) for p in range(start, stop)]
        except FileNotFoundError:
            raise ShuffleDataNotFound(
                f"{path_component}/{spill_id}") from None

    def local_file_source(self, path_component: str, spill_id: int,
                          partition: int) -> Optional[Tuple[str, int]]:
        """Disk-direct short-circuit (LocalDiskFetchedInput analog): when
        the registered run is disk-backed (FileRun), return its (path,
        partition_nbytes) so a same-host consumer can merge straight off
        the producer's partition-indexed file — no materialization, no
        re-spill.  None when the run is RAM-resident or unknown."""
        run = self._lookup(path_component, spill_id)
        if run is None or not hasattr(run, "iter_partition_blocks"):
            return None
        return run.path, run.partition_nbytes(partition)

    def partition_size(self, path_component: str, spill_id: int,
                       partition: int) -> int:
        run = self._lookup(path_component, spill_id)
        if run is None:
            raise ShuffleDataNotFound(f"{path_component}/{spill_id}")
        try:
            return run.partition_nbytes(partition)
        except FileNotFoundError:
            raise ShuffleDataNotFound(
                f"{path_component}/{spill_id}") from None

    def stats(self) -> Tuple[int, int]:
        with self._lock:
            n = len(self._runs)
            nbytes = sum(r.nbytes for r in self._runs.values())
        if self._buffer is not None:
            s = self._buffer.stats()
            n += s["entries"]
            nbytes += sum(s["bytes"].values())
        return n, nbytes


_local = ShuffleService()


def local_shuffle_service() -> ShuffleService:
    """The per-process service (one per host; shared by AM and runners in
    local mode, exactly like the NM-singleton ShuffleHandler)."""
    return _local


def telemetry_collector() -> Dict[str, float]:
    """Live-telemetry hook (obs/timeseries registry): registered-run
    inventory as gauges on every sampler tick — the transport plane's
    resident footprint, next to the store collector's tier bytes."""
    n, nbytes = _local.stats()
    return {"shuffle.registered_runs": float(n),
            "shuffle.registered_bytes": float(nbytes)}
