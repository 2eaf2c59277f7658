"""Shuffle object service: producers register runs, consumers fetch slices.

Reference parity: tez-plugins/tez-aux-services ShuffleHandler.java:159 (the
NM-resident shuffle server with per-reduce index lookup) + the local-disk
short-circuit (Fetcher.java:288).  In-process deployments hand buffers over
directly (the "local fetch" path — zero copies of host-RAM data).

Keys: (path_component, spill_id) where path_component identifies a producer
attempt's output (reference: attempt path component in the shuffle URL).
DAG/vertex deletion tracking mirrors the reference's DeletionTracker.

The port's copy of tez_tpu.shuffle.service, less what needs the modules
that come with later slices: the write-through file store of the socket
server, the tiered buffer store and the push landing zone.  Attaching any
of them raises NotImplementedError, so the registry is the one place a
run lives, and a fetch probes it alone (tez_tpu probes the buffer store
first, and a pushed partition's key last, only when a store is attached).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tez_tpu_torch.common import epoch as epoch_registry
from tez_tpu_torch.common import faults, tracing
from tez_tpu_torch.common.epoch import EpochFencedError, WindowFencedError
from tez_tpu_torch.ops.runformat import KVBatch, Run, RUN_HEADER_NBYTES


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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tez_tpu_torch yet: the port's shuffle "
        f"service keeps runs in its own registry only")


class ShuffleService:
    """Registry of completed (or pipelined-spill) runs on this host."""

    def __init__(self) -> None:
        self._runs: Dict[Tuple[str, int], Run] = {}
        self._lock = threading.Lock()

    def attach_store(self, store: Any) -> None:
        """Write-through persistence for the socket server's file store
        (tez_tpu.shuffle.service): comes with the shuffle server."""
        raise _not_ported("the write-through file store (attach_store)")

    def has_store(self) -> bool:
        return False

    def attach_buffer_store(self, store: Any) -> None:
        """Delegation to the tiered buffer store: comes with the store."""
        raise _not_ported("the tiered buffer store (attach_buffer_store)")

    def buffer_store(self) -> Any:
        return None

    def attach_push_admission(self, admission: Any) -> None:
        """The push landing zone's gatekeeper: comes with push shuffle."""
        raise _not_ported("push admission (attach_push_admission)")

    def push_admission(self) -> Any:
        return None

    def push_publish(self, *args: Any, **kw: Any) -> None:
        raise _not_ported("the push landing zone (push_publish)")

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
        straggler from a sealed window cannot register into the open one.
        lineage, tenant, counters and use_store steer the buffer store,
        which the port does not have: the run lands in the registry."""
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
        with self._lock:
            self._runs[(path_component, spill_id)] = run
        tracing.event("shuffle.register", src=f"{path_component}/{spill_id}",
                      nbytes=getattr(run, "nbytes", 0))

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
        return len(victims)

    # -- consumer side (local short-circuit) ---------------------------------
    def _lookup(self, path_component: str, spill_id: int) -> Optional[Any]:
        with self._lock:
            return self._runs.get((path_component, spill_id))

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
        # PRIMARY copies gone — with no store to hold a coded replica, the
        # fetch misses as a lost registration would
        primary_lost = False
        try:
            faults.fire("store.replica.lost",
                        detail=f"{path_component}/{spill_id}")
        except Exception:
            primary_lost = True
        run = None if primary_lost else self._lookup(path_component,
                                                     spill_id)
        if run is None:
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
            return len(self._runs), sum(r.nbytes for r in self._runs.values())


_local = ShuffleService()


def local_shuffle_service() -> ShuffleService:
    """The per-process service (one per host; shared by AM and runners in
    local mode, exactly like the NM-singleton ShuffleHandler)."""
    return _local


def telemetry_collector() -> Dict[str, float]:
    """Live-telemetry hook (obs/timeseries registry): registered-run
    inventory as gauges on every sampler tick — the transport plane's
    resident footprint."""
    n, nbytes = _local.stats()
    return {"shuffle.registered_runs": float(n),
            "shuffle.registered_bytes": float(nbytes)}
